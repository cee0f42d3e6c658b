"""Port vs reference: the bigram LM over word lattices (the lattice pass,
the rescorer and the deep-trie bigram decode) and the plain versions of
kernels K6 (lattice pass) and K7 (rescoring).

* ``langmodel.bigram``: every cost and backoff array equal;
* ``viterbi_lattice_tb`` against the reference XLA scan: final costs,
  every ``ends_cost`` and every ``ends_tau`` entry bit-identical (dead
  arcs included), streams of length 0, 1, T and in between; the live
  entries also against the Pallas lattice kernel and its wide twin in
  interpret mode;
* ``lattice_rescore_ref`` against the reference ``lattice_rescore`` in
  its dense-K backoff and dense forms, with a truncating ``max_dur``:
  ``cost``, ``best_leaf`` and every ``pred_w`` entry bit-identical; its
  costs against the Pallas ring lookup in interpret mode;
* the K6 / K7 plain versions against the public functions, in the
  kernels' ``[T, B, L]`` layouts;
* ``decode_lextree_bigram`` against the reference's XLA path: words
  equal, costs at rtol 1e-5 (the emission GEMMs sum in different
  orders), the truncation warning where the reference warns;
* an all-zero LM reduces the rescore to the pass-1 decode.

Emissions are made with numpy seeds and handed to both sides as f32.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.langmodel import bigram as jbg
from speech_recognition_tpu.models import lexgraph as jlg
from speech_recognition_tpu.ops import lattice as jlat
from speech_recognition_tpu.ops.viterbi_lex_pallas import (
    lex_pallas_plan,
    viterbi_lex_pallas_lattice,
    viterbi_lex_pallas_wide_lattice,
)
from speech_recognition_tpu_torch.langmodel import bigram as tbg
from speech_recognition_tpu_torch.models import lexgraph as tlg
from speech_recognition_tpu_torch.ops import lattice as tlat
from speech_recognition_tpu_torch.ops import lattice_kernels as tlk
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology
from tests.test_torch_gmm_hmm import both_banks
from tests.test_torch_lextree import emissions, graphs

T = 25
NF = np.array([T, 13, 0, 1, T, 9, 17, 5], np.int32)  # 0, 1, T and between


def lm_for(kind, n_words, seed=0):
    """A word-indexed LM: an add-k fit (backoff structure) or random
    costs (none)."""
    rng = np.random.default_rng(seed)
    if kind == "fit":
        return jbg.fit_bigram([[int(x) for x in rng.integers(0, n_words, 6)]
                               for _ in range(15)], n_words)
    return jbg.BigramLM(cost=rng.uniform(0.1, 3.0, (n_words, n_words)).astype(np.float32),
                        start_cost=rng.uniform(0.1, 2.0, n_words).astype(np.float32),
                        end_cost=rng.uniform(0.1, 2.0, n_words).astype(np.float32))


def j_lattice(kind, nf=NF, seed=3):
    """Reference lattice planes ``[T, L, B]`` (numpy) of a no-LM graph."""
    jg, tg, n_bank = graphs(kind)
    e = emissions(seed, T, n_bank, len(nf))
    bs = tg.banded.bank_state.numpy()
    fj, ecj, etj = jlat.viterbi_lattice_tb(jnp.asarray(e[:, bs, :]), jg.banded,
                                           jnp.asarray(nf))
    return e, np.asarray(fj), np.asarray(ecj), np.asarray(etj)


# ---------------------------------------------------------------------------
# the bigram LM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fit", "fit_k2", "uniform", "uniform_log", "scaled"])
def test_bigram_matches_reference(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    v = 9
    seqs = [[int(x) for x in rng.integers(0, v, rng.integers(0, 7))] for _ in range(12)]
    make = {"fit": lambda m: m.fit_bigram(seqs, v),
            "fit_k2": lambda m: m.fit_bigram(seqs, v, add_k=0.5),
            "uniform": lambda m: m.uniform_bigram(v),
            "uniform_log": lambda m: m.uniform_bigram(v, flat=False),
            "scaled": lambda m: m.scale(m.fit_bigram(seqs, v), 0.7)}[case]
    lj, lt = make(jbg), make(tbg)
    for f in ("cost", "start_cost", "end_cost"):
        np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f), err_msg=f)
        assert getattr(lt, f).dtype == getattr(lj, f).dtype
    assert lt.vocab_size == lj.vocab_size == v
    for s in seqs[:4] + [[]]:
        assert tbg.sequence_cost(lt, s) == jbg.sequence_cost(lj, s)
    bj, bt = jbg.bigram_backoff(lj.cost), tbg.bigram_backoff(lt.cost)
    assert bt.k == bj.k
    for f in ("base", "pred_idx", "pred_cost"):
        np.testing.assert_array_equal(getattr(bt, f), getattr(bj, f), err_msg=f)


def test_bigram_backoff_rejects_unstructured_like_reference():
    cost = np.random.default_rng(3).uniform(0, 5, (200, 200)).astype(np.float32)
    assert tbg.bigram_backoff(cost) is None and jbg.bigram_backoff(cost) is None
    lm = lm_for("random", 50)  # 49 below-level predecessors per word, above 16
    assert tlat.rescore_backoff(lm, graphs("random50")[1].leaf_word) is None
    assert jlat.rescore_backoff(lm, graphs("random50")[1].leaf_word) is None


# ---------------------------------------------------------------------------
# pass 1: K6's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["toy", "toy_unigram", "random50", "unused_units"])
def test_lattice_pass_matches_reference_scan(kind):
    e, fj, ecj, etj = j_lattice(kind)
    tg = graphs(kind)[1]
    bs = tg.banded.bank_state.numpy()
    ft, ect, ett = tlat.viterbi_lattice_tb(torch.from_numpy(np.ascontiguousarray(e[:, bs, :])),
                                           tg.banded, torch.from_numpy(NF))
    assert ect.dtype == torch.float32 and ett.dtype == torch.int32
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_array_equal(ect.numpy(), ecj)
    np.testing.assert_array_equal(ett.numpy(), etj)  # dead arcs' taus too
    live = ecj < 1e29
    assert live.any() and not live.all()
    # the streams of length 0 and 1 repeat frame 0 in every later frame
    assert (ecj[:, :, 2:4] == ecj[:1, :, 2:4]).all()
    # K6's plain version: the same planes in [T, B, L], final [B, S]
    nll = torch.from_numpy(np.ascontiguousarray(e.transpose(1, 0, 2)))
    g = tg.banded
    fk, eck, etk = tlk.viterbi_lattice_ref(nll, g, lex_topology(g), torch.from_numpy(NF))
    np.testing.assert_array_equal(fk.numpy(), fj.T)
    np.testing.assert_array_equal(eck.numpy(), ecj.transpose(0, 2, 1))
    np.testing.assert_array_equal(etk.numpy(), etj.transpose(0, 2, 1))


@pytest.mark.parametrize("kind,wide", [("toy", False), ("random50", False), ("toy", True)])
def test_lattice_pass_live_entries_match_pallas(kind, wide):
    """The Pallas lattice kernel (B8) in interpret mode: every cost and the
    live arcs' entry times equal the port's (the Pallas kernel does not
    run frame 0 of a length-0 stream, so those streams are left out)."""
    nf = NF[NF > 0]
    e, _, _, _ = j_lattice(kind, nf, seed=4)
    jg, tg, _ = graphs(kind)
    bs = tg.banded.bank_state.numpy()
    _, ect, ett = tlat.viterbi_lattice_tb(torch.from_numpy(np.ascontiguousarray(e[:, bs, :])),
                                          tg.banded, torch.from_numpy(nf))
    plan = lex_pallas_plan(jg, layout="wide" if wide else "soa")
    kern = viterbi_lex_pallas_wide_lattice if wide else viterbi_lex_pallas_lattice
    ecp, etp = (np.asarray(x) for x in kern(jnp.asarray(e), plan, jnp.asarray(nf), plan.topo,
                                            interpret=True))
    live = ect.numpy() < 1e29
    np.testing.assert_array_equal(ect.numpy(), ecp)
    np.testing.assert_array_equal(ett.numpy()[live], etp[live])


# ---------------------------------------------------------------------------
# pass 2: K7's plain version
# ---------------------------------------------------------------------------


def _rescore_both(kind, lm, max_dur, backoff):
    e, _, ecj, etj = j_lattice(kind)
    jg, tg, _ = graphs(kind)
    lw = tg.leaf_word
    args = (lm.cost, lm.start_cost, lm.end_cost)
    bo_j = jlat.rescore_backoff(lm, lw) if backoff else None
    rj = jlat.lattice_rescore(jnp.asarray(ecj), jnp.asarray(etj), jnp.asarray(lw),
                              *map(jnp.asarray, args), jnp.asarray(NF), max_dur=max_dur,
                              backoff=bo_j, ring_kernel="xla")
    bo_t = tlat.rescore_backoff(lm, lw) if backoff else None
    rt = tlat.lattice_rescore_ref(torch.from_numpy(ecj), torch.from_numpy(etj), lw,
                                  *map(torch.from_numpy, args), torch.from_numpy(NF),
                                  max_dur=max_dur, backoff=bo_t)
    return (ecj, etj, jg, tg, bo_j, bo_t, rj, rt)


@pytest.mark.parametrize("kind,lm_kind,backoff,max_dur", [
    ("toy", "fit", True, 128),
    ("toy", "fit", False, 128),
    ("toy", "random", False, 128),
    ("random50", "fit", True, 8),   # truncating: arcs of more than 8 frames drop
    ("random50", "fit", False, 12),
    ("toy_unigram", "fit", True, 5),
])
def test_rescore_matches_reference(kind, lm_kind, backoff, max_dur):
    jg = graphs(kind)[0]
    lm = lm_for(lm_kind, len(jg.words), seed=len(kind))
    ecj, etj, jg, tg, bo_j, bo_t, rj, rt = _rescore_both(kind, lm, max_dur, backoff)
    if backoff:
        assert bo_t is not None
        for a, b in zip(bo_t, bo_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert rt.pred_w.dtype == torch.int32 and rt.best_leaf.dtype == torch.int32
    np.testing.assert_array_equal(rt.cost.numpy(), np.asarray(rj.cost))
    np.testing.assert_array_equal(rt.best_leaf.numpy(), np.asarray(rj.best_leaf))
    np.testing.assert_array_equal(rt.pred_w.numpy(), np.asarray(rj.pred_w))
    if max_dur < T:
        n = int(tlat._lattice_truncation_count(torch.from_numpy(ecj), torch.from_numpy(etj),
                                               torch.from_numpy(NF), max_dur))
        assert n > 0
        assert n == int(jlat._lattice_truncation_count(jnp.asarray(ecj), jnp.asarray(etj),
                                                       jnp.asarray(NF), max_dur=max_dur))
    nf = torch.from_numpy(NF)
    words = tlat.lattice_words(rt, tg.leaf_word, nf)
    assert words == jlat.lattice_words(rj, tg.leaf_word, NF)
    lr, nw = tlat.lattice_words_device(rt.pred_w, rt.ends_tau, rt.best_leaf, nf, max_words=T)
    lrj, nwj = jlat.lattice_words_device(rj.pred_w, rj.ends_tau, rj.best_leaf,
                                         jnp.asarray(NF), max_words=T)
    np.testing.assert_array_equal(lr.numpy(), np.asarray(lrj))
    np.testing.assert_array_equal(nw.numpy(), np.asarray(nwj))
    lw = tg.leaf_word
    dev_words = [lw[lr.numpy()[: nw[i], i][::-1]].tolist() for i in range(len(NF))]
    # the host walk reads a length-0 stream's frame -1; the device walk
    # gives it no words (both as in the reference)
    assert [w for w, n in zip(dev_words, NF) if n] == [w for w, n in zip(words, NF) if n]
    assert all(w == [] for w, n in zip(dev_words, NF) if not n)


@pytest.mark.parametrize("backoff", [False, True])
def test_rescore_costs_match_pallas_ring(backoff):
    """B9 (``_hq_sweep_pallas``) in interpret mode inside the reference
    rescorer gives the port's costs and predecessors."""
    kind = "random50"
    lm = lm_for("fit", len(graphs(kind)[0].words), seed=5)
    ecj, etj, jg, tg, bo_j, _, _, rt = _rescore_both(kind, lm, 16, backoff)
    rp = jlat.lattice_rescore(jnp.asarray(ecj), jnp.asarray(etj), jnp.asarray(tg.leaf_word),
                              jnp.asarray(lm.cost), jnp.asarray(lm.start_cost),
                              jnp.asarray(lm.end_cost), jnp.asarray(NF), max_dur=16,
                              backoff=bo_j, ring_kernel="pallas-interpret")
    np.testing.assert_array_equal(rt.cost.numpy(), np.asarray(rp.cost))
    np.testing.assert_array_equal(rt.best_leaf.numpy(), np.asarray(rp.best_leaf))
    np.testing.assert_array_equal(rt.pred_w.numpy(), np.asarray(rp.pred_w))


@pytest.mark.parametrize("backoff", [False, True])
def test_k7_plain_is_the_public_rescorer_in_kernel_layout(backoff):
    kind = "toy"
    lm = lm_for("fit", len(graphs(kind)[0].words), seed=6)
    ecj, etj, _, tg, _, bo_t, _, rt = _rescore_both(kind, lm, 10, backoff)
    lw = torch.from_numpy(tg.leaf_word.astype(np.int64))
    ec = torch.from_numpy(np.ascontiguousarray(ecj.transpose(0, 2, 1)))
    et = torch.from_numpy(np.ascontiguousarray(etj.transpose(0, 2, 1)))
    big = None if backoff else torch.from_numpy(lm.cost)[lw][:, lw].contiguous()
    before = tlk.rescore_lattice.launches
    cost, best, pred = tlk.rescore_lattice(
        ec, et, ec.amin(2), torch.from_numpy(lm.start_cost)[lw],
        torch.from_numpy(lm.end_cost)[lw], torch.from_numpy(NF), tlat._ring_depth(T, 10),
        big_ll=big, backoff=bo_t)
    assert tlk.rescore_lattice.launches == before  # CPU tensors: the plain version
    assert torch.equal(cost, rt.cost) and torch.equal(best, rt.best_leaf)
    assert torch.equal(pred, rt.pred_w.transpose(1, 2))
    with pytest.raises(ValueError, match="exactly one"):
        tlk.rescore_lattice_ref(ec, et, ec.amin(2), cost, cost, torch.from_numpy(NF), 8)


@pytest.mark.parametrize("t_len,max_dur,dmax", [(25, 128, 32), (25, 8, 8), (25, 5, 8),
                                                (3, 128, 8), (500, 128, 128),
                                                (130, 200, 136)])
def test_ring_depth_is_the_reference_rounding(t_len, max_dur, dmax):
    assert tlat._ring_depth(t_len, max_dur) == dmax


def test_flat_lm_reduces_to_pass1():
    """All-zero LM: the rescored costs and words are the plain pass-1
    decode's (the reference's ``test_flat_lm_reduces_to_pass1``, on the
    port alone)."""
    kind = "toy"
    tg = graphs(kind)[1]
    g = tg.banded
    nf = NF[NF > 0]
    e = emissions(8, T, graphs(kind)[2], len(nf))
    nll_tb = torch.from_numpy(np.ascontiguousarray(e[:, g.bank_state.numpy(), :]))
    nf_t = torch.from_numpy(nf)
    final, ec, et = tlat.viterbi_lattice_tb(nll_tb, g, nf_t)
    lm0 = tbg.uniform_bigram(len(tg.words))
    res = tlat.lattice_rescore_ref(ec, et, tg.leaf_word, *(torch.from_numpy(x) for x in lm0),
                                   nf_t)
    words = tlat.lattice_words(res, tg.leaf_word, nf_t)
    costs = final[g.end_states] + g.end_bonus[:, None]
    best = costs.argmin(0)
    np.testing.assert_allclose(res.cost.numpy(), costs.amin(0).numpy(), rtol=1e-6)
    _, bp8, eps_u = tvb.viterbi_banded_tb(nll_tb, g, nf_t)
    states, flags = tvb.banded_backtrace_tb(bp8, eps_u, g, g.end_states[best], nf_t)
    for i, n in enumerate(nf):
        assert words[i] == tlg.lex_words_from_path(tg, states[:, i].numpy(), int(n),
                                                   flags[:, i].numpy()), i


# ---------------------------------------------------------------------------
# the decode slice
# ---------------------------------------------------------------------------


def _bigram_case(seed):
    jb, tb = both_banks(seed, n_models=3, n_states=3, n_mix=1, dim=6, sep=6.0)
    ids = {ch: i for i, ch in enumerate("abc")}
    trans = [np.asarray(jb.trans_cost[i]) for i in range(3)]
    words = ["aa", "ab", "abb", "ba", "b", "cab", "ca"]
    jg = jlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.2)
    tg = tlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.2)
    return jb, tb, jg, tg, words, ids


@pytest.mark.parametrize("lm_kind", ["fit", "random"])
def test_decode_lextree_bigram_matches_reference(lm_kind):
    """Features that walk planted word sequences (three frames on each
    state's mean) and random streams, through both decoders."""
    jb, tb, jg, tg, words, ids = _bigram_case(31)
    lm = (jbg.fit_bigram([[0, 1, 2], [5, 3, 1], [4, 4, 6]], len(words)) if lm_kind == "fit"
          else lm_for("random", len(words), seed=2))
    rng = np.random.default_rng(32)
    means = np.asarray(jb.means)[:, :, 0, :]  # [U, S, D]
    feats = rng.standard_normal((5, 70, 6)).astype(np.float32)
    nf = np.array([70, 70, 70, 1, 23], np.int32)
    refs = [["ab", "ca"], ["cab", "ba", "ab"], ["abb"]]
    for i, seq in enumerate(refs):
        f = [means[ids[ch], j] for w in seq for ch in w for j in range(3) for _ in range(3)]
        feats[i, : len(f)] = f
        nf[i] = len(f)
    w_j, c_j = jlat.decode_lextree_bigram(jb, jg, lm, feats, nf, backend="xla")
    w_t, c_t = tlat.decode_lextree_bigram(tb, tg, lm, torch.from_numpy(feats),
                                          torch.from_numpy(nf))
    assert w_t == w_j
    if lm_kind == "fit":
        assert w_t[:3] == [[words.index(w) for w in seq] for seq in refs]
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)


def test_truncation_warning_fires_where_the_reference_warns():
    """Constant features on one unit's mean keep the best token inside one
    word for all 40 frames: a live arc longer than max_dur = 16."""
    jb, tb, jg, tg, words, ids = _bigram_case(7)
    lm = jbg.uniform_bigram(len(words))
    t_len = 40
    mu = np.asarray(jb.means)[ids["b"], 0, 0]
    feats = np.broadcast_to(mu, (2, t_len, 6)).astype(np.float32).copy()
    nfs = np.array([t_len, t_len], np.int32)
    ft, nt = torch.from_numpy(feats), torch.from_numpy(nfs)
    with pytest.warns(RuntimeWarning, match="max_dur=16") as rec_t:
        w_t, _ = tlat.decode_lextree_bigram(tb, tg, lm, ft, nt, max_dur=16)
    with pytest.warns(RuntimeWarning, match="max_dur=16") as rec_j:
        w_j, _ = jlat.decode_lextree_bigram(jb, jg, lm, feats, nfs, backend="xla", max_dur=16)
    assert str(rec_t[0].message) == str(rec_j[0].message)
    assert w_t == w_j
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tlat.decode_lextree_bigram(tb, tg, lm, ft, nt, max_dur=t_len + 1)


def test_wrappers_take_plain_versions_on_cpu():
    e, fj, ecj, etj = j_lattice("toy")
    g = graphs("toy")[1].banded
    nll = torch.from_numpy(np.ascontiguousarray(e.transpose(1, 0, 2)))
    before = (tlk.viterbi_lattice.launches, tlk.rescore_lattice.launches)
    got = tlk.viterbi_lattice(nll, g, lex_topology(g), torch.from_numpy(NF))
    want = tlk.viterbi_lattice_ref(nll, g, lex_topology(g), torch.from_numpy(NF))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tlk.viterbi_lattice.launches, tlk.rescore_lattice.launches) == before
    with pytest.raises(ValueError, match="at least one frame"):
        tlk.viterbi_lattice(nll[:, :0], g, lex_topology(g), torch.from_numpy(NF))


# K7's plan (host-side, no card needed) at the 227 KB limit per CTA:
# (L, K, dense) -> (leaves per thread, threads, tables on chip, D in device
# memory)
RESCORE_PLAN_CASES = {
    "1k_trie": ((1000, 9, False), (1, 1024, True, False)),
    "1k_dense": ((1000, 0, True), (1, 1024, False, False)),
    "dict1_trie": ((6250, 8, False), (8, 800, False, False)),
    "l203_off_32": ((203, 5, False), (1, 224, True, False)),
    "l1025_two_leaves": ((1025, 9, False), (2, 544, True, False)),
    "tables_too_big": ((3000, 40, False), (4, 768, False, False)),
    "l7000_rows_fit": ((7000, 9, False), (8, 896, False, False)),
    "l7300_rows_do_not_fit": ((7300, 9, False), (0, 1024, False, False)),
    "l8000_direct": ((8000, 9, False), (0, 1024, False, False)),
    # the direct CTA's 256 B of static argmin partials count against the
    # limit beside its 8 L bytes of D rows
    "l29024_direct_full": ((29024, 9, False), (0, 1024, False, False)),
    "l29056_direct_full": ((29056, 9, False), (0, 1024, False, True)),
    "l29057_past_old_limit": ((29057, 9, False), (0, 1024, False, True)),
    "l100000_scratch": ((100000, 3, False), (0, 1024, False, True)),
}


@pytest.mark.parametrize("name", sorted(RESCORE_PLAN_CASES))
def test_rescore_plan_tiers(name):
    """K7's launch plan: the staged mode with the fewest leaves per thread
    (LM tables on chip for the 1k trie, through L1 for the
    dictionary-shaped trie), the direct mode where its three row frames
    do not fit (past ~7,260 leaves), its D rows in device memory past the
    parent's ~29,000-leaf shared-memory limit: every size has a plan, and
    the plan's byte count is its shared memory."""
    (l, k, dense), want = RESCORE_PLAN_CASES[name]
    limit = 227 * 1024
    plan = tlk.rescore_plan(l, k, dense, limit)
    assert (plan.leaves, plan.threads, plan.tables, plan.scratch) == want
    assert plan.smem <= limit
    if plan.leaves:
        assert plan.threads % 32 == 0 and plan.threads <= 1024
        assert plan.leaves * plan.threads >= l > (plan.leaves // 2) * 1024
        assert plan.smem == tlk.rescore_smem_bytes(l, k, plan.tables)
        # two D rows, three ends_cost / ends_tau row frames, (pidx, pcost) pairs
        lp = -(-l // 4) * 4
        assert plan.smem == 4 * lp * 2 + 8 * lp * 3 + (8 * lp * k if plan.tables else 0)
    else:
        assert plan.smem == (0 if plan.scratch else 8 * l)


def test_rescore_wrapper_ignores_plan_and_trace_on_cpu():
    """A CPU tensor takes the plain version whatever plan is passed."""
    rng = np.random.default_rng(4)
    t, b, l, k = 9, 3, 37, 3
    ec = torch.from_numpy(rng.uniform(0, 9, (t, b, l)).astype(np.float32))
    et = torch.from_numpy(rng.integers(-1, 3, (t, b, l)).astype(np.int32))
    et = torch.minimum(et, torch.arange(t, dtype=torch.int32)[:, None, None])
    bo = (torch.from_numpy(rng.uniform(1, 3, l).astype(np.float32)),
          torch.from_numpy(rng.integers(0, l, (l, k)).astype(np.int32)),
          torch.from_numpy(rng.uniform(0, 2, (l, k)).astype(np.float32)))
    args = (ec, et, ec.amin(2), torch.zeros(l), torch.zeros(l),
            torch.tensor([t, 0, 4], dtype=torch.int32), 4)
    before = tlk.rescore_lattice.launches
    plan = tlk.rescore_plan(l, k, False, 227 * 1024)._replace(leaves=0)
    got = tlk.rescore_lattice(*args, backoff=bo, plan=plan,
                              trace=torch.zeros((b, 4), dtype=torch.int64))
    want = tlk.rescore_lattice_ref(*args, backoff=bo)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tlk.rescore_lattice.launches == before

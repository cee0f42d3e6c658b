"""Port vs reference: the lexical-tree decode slice (wav -> word ids over
a trie) and the plain versions of kernels K4 (forward) and K5 (value
backtrace).

* ``lextree_from_words`` / ``build_lex_graph``: every array equal;
* the plain banded DP with cross edges against the reference XLA scan:
  final costs, planes, states and flags bit-identical;
* ``viterbi_lex_ref`` against ``viterbi_lex_pallas(emit_eps_prev=True)``
  and ``viterbi_lex_pallas_wide`` in interpret mode, after the static
  SoA renumbering (``plan.state_of_soa``): final costs, codes, eps
  origins and eps_prev targets bit-identical on valid frames;
* ``lex_backtrace_val_ref`` against all three reference walks (SoA
  with and without eps_prev, wide): states and flags identical;
* ``decode_lextree`` against the reference XLA path: words identical,
  costs at rtol 1e-5 (the emission GEMMs sum in different orders);
* ``connected_test --graph lextree --device cpu`` against the reference
  CLI, and against the port's own ``--graph loop``.

Emissions are made with numpy seeds and handed to both sides as f32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import lextree as jdec
from speech_recognition_tpu.langmodel.bigram import fit_bigram
from speech_recognition_tpu.langmodel.lextree import lextree_from_words as j_lextree
from speech_recognition_tpu.models import lexgraph as jlg
from speech_recognition_tpu.ops.viterbi_lex_pallas import (
    lex_backtrace_soa_pallas,
    lex_backtrace_wide,
    lex_pallas_plan,
    viterbi_lex_pallas,
    viterbi_lex_pallas_wide,
)
from speech_recognition_tpu_torch.data.lexicon import (
    bench_lexicon,
    dict1_shaped_lexicon,
    flat_lm_lexicon,
    random_words,
)
from speech_recognition_tpu_torch.decode import lextree as tdec
from speech_recognition_tpu_torch.langmodel import lextree_from_words as t_lextree
from speech_recognition_tpu_torch.models import lexgraph as tlg
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as tlk
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
    _check_fused,
    banded_topology,
)
from tests.test_lex_pallas import ltr
from tests.test_torch_banded import jvb
from tests.test_torch_gmm_hmm import both_banks

LEXICONS = ["toy", "toy_unigram", "random50", "flat_bigram", "unused_units"]


def lexicon(kind):
    """``(words, unit_trans, unit_ids, n_bank_rows, build kwargs)`` from
    numpy seeds; the same inputs go to both packages."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    kw = dict(word_insertion_cost=0.4)
    if kind in ("toy", "toy_unigram"):
        words = ["aa", "ab", "abb", "ba", "b", "cab", "ca"]
        units = sorted(set("".join(words)))
        trans = [ltr(3, rng, skip=(i % 2 == 0)) for i in range(len(units))]
        if kind == "toy_unigram":
            kw["unigram_cost"] = rng.uniform(0.5, 3.0, len(words)).astype(np.float32)
    elif kind == "random50":
        units = list("abcde")
        trans = [ltr(3, rng, skip=(i % 2 == 1)) for i in range(len(units))]
        words = random_words(rng, units, 50, 1, 6)
    elif kind == "flat_bigram":
        words = units = list("12345")
        trans = [ltr(4, rng) for _ in units]
        kw = dict(lm=fit_bigram([[0, 1, 2], [4, 3], [2, 2, 0]], len(words)),
                  word_insertion_cost=0.2)
    elif kind == "unused_units":  # bank rows past the last unit the words use
        units = list("abcd")
        trans = [ltr(3, rng, skip=False) for _ in units]
        words = ["ab", "ba", "a", "bb"]
    else:
        raise ValueError(kind)
    su = max(t.shape[0] for t in trans)
    return words, trans, {ch: i for i, ch in enumerate(units)}, len(units) * su, kw


@functools.lru_cache(maxsize=None)
def graphs(kind):
    words, trans, ids, n_bank, kw = lexicon(kind)
    return (jlg.build_lex_graph(words, trans, ids, **kw),
            tlg.build_lex_graph(words, trans, ids, **kw), n_bank)


def emissions(seed, t, u, b, integer=False, offset=0.0):
    """``[T, U, B]`` f32 emissions (the Pallas layout)."""
    rng = np.random.default_rng(seed)
    if integer:
        return (offset + rng.integers(0, 6, (t, u, b))).astype(np.float32)
    return rng.uniform(0, 5, (t, u, b)).astype(np.float32)


NF = np.array([21, 9, 1, 21, 15, 4], np.int32)


def port_forward(tg, e_tub, nf):
    g = tg.banded
    return [x.numpy() for x in tlk.viterbi_lex_ref(
        torch.from_numpy(np.ascontiguousarray(e_tub.transpose(1, 0, 2))), g,
        tlk.lex_topology(g), torch.from_numpy(nf))]


def best_ends(final_bs, g):
    """Leaf slot of the best end per stream (first minimum, end bonus
    added), from port finals ``[B, S]``."""
    ends = g.end_states.numpy()
    return np.argmin(final_bs[:, ends] + g.end_bonus.numpy()[None], axis=1)


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", LEXICONS)
def test_lextree_and_lex_graph_match_reference(kind):
    words = lexicon(kind)[0]
    jt, tt = j_lextree(words), t_lextree(words)
    for f in ("val", "parent", "prop", "depth"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f), err_msg=f)
    jg, tg, _ = graphs(kind)
    for f in tvb.BandedGraph._fields:
        np.testing.assert_array_equal(getattr(tg.banded, f).numpy(),
                                      np.asarray(getattr(jg.banded, f)), err_msg=f)
    for f in ("leaf_word", "arc_of_state", "arc_leaf_word", "arc_unit"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
    assert tg.words == jg.words and tg.eps_depth == jg.eps_depth
    row_const = bool((tg.banded.eps_block == tg.banded.eps_block[:, :1]).all())
    assert row_const == (kind != "flat_bigram")


@pytest.mark.parametrize("case", ["not_banded", "duplicate", "lm_deep"])
def test_build_lex_graph_raises_like_reference(case):
    words, trans, ids, _, _ = lexicon("toy")
    kw = {}
    if case == "not_banded":
        trans = [t.copy() for t in trans]
        trans[0][0, 2] = 0.5  # a backward arc 2 -> 0
    elif case == "duplicate":
        words = words + ["ab"]
    else:
        kw["lm"] = fit_bigram([[0, 1]], len(words))
    for mod in (jlg, tlg):
        with pytest.raises(ValueError):
            mod.build_lex_graph(words, trans, ids, **kw)


def test_bench_lexicons_have_the_reference_sizes():
    """The 1,000-word benchmark trie (``bench.py`` ``bench_lextree``'s
    recipe; the JAX package's ``build_lex_graph`` gives 9,588 states,
    3,196 arcs, 8 roots, 1,000 leaves) and the dictionary-shaped one
    (~87k states, 31 roots, 6,250 leaves)."""
    for fn, s, a, r, l in ((bench_lexicon, 9588, 3196, 8, 1000),
                           (dict1_shaped_lexicon, 86520, 28840, 31, 6250)):
        words, trans, ids, _ = fn()
        tg = tlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
        topo = tlk.lex_topology(tg.banded)
        assert (tg.n_states, tg.n_arcs, topo.n_roots, topo.n_leaves) == (s, a, r, l)
        assert topo.disjoint
    jg = jlg.build_lex_graph(*bench_lexicon()[:3], word_insertion_cost=0.5)
    assert jg.n_states == 9588


def test_lex_graph_is_refused_by_the_connected_kernels():
    """K1/K2 do not implement cross edges: a lex graph's topology is not
    fused_ok, and the fused path raises instead of dropping the edges."""
    tg = graphs("toy")[1]
    topo = banded_topology(tg.banded)
    assert topo.cross and not topo.fused_ok
    with pytest.raises(ValueError, match="cross edges"):
        _check_fused(tg.banded, topo)
    for kind in ("loop", "sausage"):  # composed word graphs stay fused
        from tests.test_torch_banded import build_graphs

        trans = [ltr(3, np.random.default_rng(0)) for _ in range(3)]
        bt = tvb.banded_arrays(build_graphs(kind, trans)[1])
        assert bt.cross_src is None and banded_topology(bt).fused_ok
        assert bt.to("cpu").cross_cost is None


# ---------------------------------------------------------------------------
# the plain banded DP with cross edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["toy", "toy_unigram", "random50", "flat_bigram"])
def test_plain_banded_with_cross_matches_reference_scan(kind):
    jg, tg, n_bank = graphs(kind)
    e = emissions(3, 21, n_bank, len(NF))
    bs = tg.banded.bank_state.numpy()
    nll_tsb = np.ascontiguousarray(e[:, bs, :])
    fj, pj, uj = jvb.viterbi_banded_tb(jnp.asarray(nll_tsb), jg.banded, jnp.asarray(NF))
    ft, pt, ut = tvb.viterbi_banded_tb(torch.from_numpy(nll_tsb), tg.banded,
                                       torch.from_numpy(NF))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert (pt.numpy() == tvb._CROSS).any() or kind == "flat_bigram"
    ends = tg.banded.end_states.numpy()
    end = ends[np.argmin(np.asarray(fj)[ends] + tg.banded.end_bonus.numpy()[:, None], 0)]
    sj, ej = jvb.banded_backtrace_tb(pj, uj, jg.banded, jnp.asarray(end), jnp.asarray(NF))
    st, et = tvb.banded_backtrace_tb(pt, ut, tg.banded, torch.from_numpy(end),
                                     torch.from_numpy(NF))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


# ---------------------------------------------------------------------------
# K4 / K5 plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def pallas_case(kind, wide=False):
    """Reference Pallas outputs (interpret mode) and the port's plain K4
    outputs on the same emissions."""
    jg, tg, n_bank = graphs(kind)
    e = emissions(5, 21, n_bank, len(NF))
    plan = lex_pallas_plan(jg, layout="wide" if wide else "soa")
    if wide:
        ref = viterbi_lex_pallas_wide(jnp.asarray(e), plan, jnp.asarray(NF), plan.topo,
                                      interpret=True)
    else:
        ref = viterbi_lex_pallas(jnp.asarray(e), plan, jnp.asarray(NF), plan.topo,
                                 interpret=True, emit_eps_prev=True)
    return dict(jg=jg, tg=tg, plan=plan, ref=[np.asarray(x) for x in ref],
                port=port_forward(tg, e, NF))


@pytest.mark.parametrize("kind,wide", [(k, False) for k in LEXICONS] + [("random50", True)])
def test_k4_plain_matches_pallas_reference(kind, wide):
    c = pallas_case(kind, wide)
    plan, tg = c["plan"], c["tg"]
    final, bp8, eps_u, eps_prev = c["port"]
    r_final, r_bp8, r_eps_u, r_eps_prev = c["ref"]
    if not wide:  # state-major SoA planes -> the wide twin's [.., B, S_soa]
        r_final, r_bp8 = r_final.T, r_bp8.transpose(0, 2, 1)
        r_eps_u, r_eps_prev = r_eps_u.transpose(0, 2, 1), r_eps_prev.transpose(0, 2, 1)
    live = np.nonzero(plan.state_of_soa >= 0)[0]
    orig = plan.state_of_soa[live]
    r = tg.banded.n_words
    assert bp8.dtype == np.int8 and eps_prev.dtype == np.int32
    assert eps_u.dtype == (np.int8 if tg.banded.n_ends <= 127 else np.int32)
    np.testing.assert_array_equal(final[:, orig], r_final[:, live])
    starts = tg.banded.word_starts.numpy()
    for i, n in enumerate(NF):
        np.testing.assert_array_equal(bp8[:n, i][:, orig], r_bp8[:n, i][:, live])
        took = bp8[:n, i][:, starts] == tvb._EPS  # [n, R]
        np.testing.assert_array_equal(eps_u[:n, i], np.where(took, r_eps_u[:n, i, :r], 0))
        # eps_prev: SoA rows on the reference side, renumbered
        target = plan.state_of_soa[r_eps_prev[:n, i, :r]]
        np.testing.assert_array_equal(eps_prev[:n, i], np.where(took, target, 0))
    assert (bp8 == tvb._EPS).any() and ((bp8 == tvb._CROSS).any() or kind == "flat_bigram")


@pytest.mark.parametrize("kind,wide", [("toy_unigram", False), ("random50", False),
                                       ("flat_bigram", False), ("random50", True)])
def test_k5_plain_matches_pallas_backtraces(kind, wide):
    """One plain walk against every reference walk it replaces: B7a (SoA
    without eps_prev), B7b (SoA with eps_prev), B7c (wide)."""
    c = pallas_case(kind, wide)
    plan, tg = c["plan"], c["tg"]
    g = tg.banded
    final, bp8, _, eps_prev = c["port"]
    best = best_ends(final, g)
    s_t, f_t = tlk.lex_backtrace_val_ref(
        torch.from_numpy(bp8), torch.from_numpy(eps_prev), g,
        g.end_states[torch.from_numpy(best)], torch.from_numpy(NF))
    end_soa = jnp.asarray(np.asarray(plan.ends_soa)[best])
    _, r_bp8, r_eps_u, r_eps_prev = (jnp.asarray(x) for x in c["ref"])
    if wide:
        walks = [lex_backtrace_wide(r_bp8, r_eps_u, r_eps_prev, plan, end_soa,
                                    jnp.asarray(NF), plan.topo, interpret=True)]
    else:
        walks = [lex_backtrace_soa_pallas(r_bp8, r_eps_u, plan, end_soa, jnp.asarray(NF),
                                          plan.topo, interpret=True, eps_prev=ep)
                 for ep in (None, r_eps_prev)]
    assert s_t.dtype == torch.int32 and f_t.dtype == torch.bool
    for s_j, f_j in walks:
        s_j = plan.state_of_soa[np.asarray(s_j)]
        for i, n in enumerate(NF):
            np.testing.assert_array_equal(s_t.numpy()[:n, i], s_j[:n, i])
            np.testing.assert_array_equal(f_t.numpy()[:n, i], np.asarray(f_j)[:n, i])
    words = tlg.lex_words_from_path_batch(tg, s_t.numpy().T, NF, f_t.numpy().T)
    assert all(len(w) >= 1 for w in words)


@pytest.mark.parametrize("offset", [0.0, 3.0e6])
def test_integer_emissions_follow_the_xla_scan(offset):
    """Integer-valued emissions on a row-constant graph make exact ties,
    and at a 3e6 offset the f32 sums eps + end lose their low bits.  The
    port takes the per-root first minimum over the rounded sums, as the
    XLA scan does, and equals it bit for bit.  The Pallas row-constant
    shortcut (one argmin over the raw end values) can pick another
    origin when rounding makes a tie the raw values do not have
    (``viterbi_lex_pallas.py`` ``LexTopo.eps_rowconst``), so the port
    does not take it."""
    jg, tg, n_bank = graphs("random50")
    e = emissions(7, 21, n_bank, len(NF), integer=True, offset=offset)
    final, bp8, eps_u, eps_prev = port_forward(tg, e, NF)
    bs = tg.banded.bank_state.numpy()
    fj, pj, uj = jvb.viterbi_banded_tb(jnp.asarray(e[:, bs, :]), jg.banded, jnp.asarray(NF))
    np.testing.assert_array_equal(final, np.asarray(fj).T)
    for i, n in enumerate(NF):
        np.testing.assert_array_equal(bp8[:n, i], np.asarray(pj)[:n, :, i])
        np.testing.assert_array_equal(eps_u[:n, i], np.asarray(uj)[:n, :, i])
    best = best_ends(final, tg.banded)
    g = tg.banded
    s_t, f_t = tlk.lex_backtrace_val_ref(torch.from_numpy(bp8), torch.from_numpy(eps_prev),
                                         g, g.end_states[torch.from_numpy(best)],
                                         torch.from_numpy(NF))
    sj, ej = jvb.banded_backtrace_tb(pj, uj, jg.banded,
                                     jnp.asarray(g.end_states.numpy()[best]), jnp.asarray(NF))
    for i, n in enumerate(NF):
        np.testing.assert_array_equal(s_t.numpy()[:n, i], np.asarray(sj)[:n, i])
        np.testing.assert_array_equal(f_t.numpy()[:n, i], np.asarray(ej)[:n, i])


def test_wrappers_take_plain_versions_on_cpu():
    c = pallas_case("toy")
    g = c["tg"].banded
    topo = tlk.lex_topology(g)
    e = emissions(5, 21, graphs("toy")[2], len(NF))
    nll = torch.from_numpy(np.ascontiguousarray(e.transpose(1, 0, 2)))
    nf = torch.from_numpy(NF)
    before = (tlk.viterbi_lex.launches, tlk.lex_backtrace_val.launches)
    got = tlk.viterbi_lex(nll, g, topo, nf)
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(got, c["port"]))
    ends = g.end_states[torch.from_numpy(best_ends(c["port"][0], g))]
    s_w, f_w = tlk.lex_backtrace_val(got[1], got[3], g, ends, nf)
    s_p, f_p = tlk.lex_backtrace_val_ref(got[1], got[3], g, ends, nf)
    assert torch.equal(s_w, s_p) and torch.equal(f_w, f_p)
    assert (tlk.viterbi_lex.launches, tlk.lex_backtrace_val.launches) == before


def test_flat_lm_vocabulary_over_64_roots_matches_reference_scan():
    """The graph that takes K4 through more than one 64-root re-entry
    pass per frame (100 one-unit words, a bigram-weighted eps block):
    graph arrays equal, and the plain K4 / K5 equal the reference XLA
    scan and backtrace bit for bit."""
    words, trans, ids, lm, rng = flat_lm_lexicon(100)
    jg = jlg.build_lex_graph(words, trans, ids, lm=lm, word_insertion_cost=0.3)
    tg = tlg.build_lex_graph(words, trans, ids, lm=lm, word_insertion_cost=0.3)
    g = tg.banded
    for f in tvb.BandedGraph._fields:
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg.banded, f)),
                                      err_msg=f)
    assert g.n_words == 100 and not bool((g.eps_block == g.eps_block[:, :1]).all())
    e = rng.uniform(0, 5, (21, 200, len(NF))).astype(np.float32)
    final, bp8, eps_u, eps_prev = port_forward(tg, e, NF)
    bs = g.bank_state.numpy()
    fj, pj, uj = jvb.viterbi_banded_tb(jnp.asarray(e[:, bs, :]), jg.banded, jnp.asarray(NF))
    np.testing.assert_array_equal(final, np.asarray(fj).T)
    np.testing.assert_array_equal(bp8, np.asarray(pj).transpose(0, 2, 1))
    np.testing.assert_array_equal(eps_u, np.asarray(uj).transpose(0, 2, 1))
    assert (bp8[:, :, g.word_starts.numpy()[64:]] == tvb._EPS).any()  # roots past one pass
    best = best_ends(final, g)
    s_t, f_t = tlk.lex_backtrace_val_ref(torch.from_numpy(bp8), torch.from_numpy(eps_prev),
                                         g, g.end_states[torch.from_numpy(best)],
                                         torch.from_numpy(NF))
    sj, ej = jvb.banded_backtrace_tb(pj, uj, jg.banded,
                                     jnp.asarray(g.end_states.numpy()[best]), jnp.asarray(NF))
    for i, n in enumerate(NF):
        np.testing.assert_array_equal(s_t.numpy()[:n, i], np.asarray(sj)[:n, i])
        np.testing.assert_array_equal(f_t.numpy()[:n, i], np.asarray(ej)[:n, i])


# ---------------------------------------------------------------------------
# the decode slice
# ---------------------------------------------------------------------------


def test_decode_lextree_matches_reference():
    """A 4-unit GMM bank in both packages, a trie over its units with
    unigram costs, and features that walk known word sequences (three
    frames on each state's first-mixture mean), plus random streams."""
    jb, tb = both_banks(21, n_models=4, n_states=3, n_mix=2, dim=6, sep=6.0)
    ids = {ch: i for i, ch in enumerate("abcd")}
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    words = ["ab", "abc", "ba", "d", "ca", "cab", "dd"]
    kw = dict(word_insertion_cost=0.5,
              unigram_cost=np.random.default_rng(21).uniform(0.1, 1.0, len(words)))
    jg = jlg.build_lex_graph(words, trans, ids, **kw)
    tg = tlg.build_lex_graph(words, trans, ids, **kw)
    rng = np.random.default_rng(22)
    means = np.asarray(jb.means)[:, :, 0, :]  # [U, S, D]
    feats = rng.standard_normal((5, 40, 6)).astype(np.float32)
    nf = np.array([40, 40, 40, 1, 17], np.int32)
    refs = [["ab", "d"], ["ca", "ba"], ["abc"]]
    for i, seq in enumerate(refs):
        f = [means[ids[ch], j] for w in seq for ch in w for j in range(3) for _ in range(3)]
        feats[i, : len(f)] = f
        nf[i] = len(f)
    w_j, c_j = jdec.decode_lextree(jb, jg, feats, nf, backend="xla")
    w_t, c_t = tdec.decode_lextree(tb, tg, torch.from_numpy(feats), torch.from_numpy(nf))
    assert w_t == w_j
    assert w_t[:3] == [[words.index(w) for w in seq] for seq in refs]
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)
    # the beam route (pruned plain forward, K9's plain version over the
    # cross edges) against the reference's XLA beam route
    w_jb, c_jb = jdec.decode_lextree(jb, jg, feats, nf, beam_width=8)
    w_tb, c_tb = tdec.decode_lextree(tb, tg, torch.from_numpy(feats), torch.from_numpy(nf),
                                     beam_width=8)
    assert w_tb == w_jb
    assert w_tb[:3] == w_t[:3]
    np.testing.assert_allclose(c_tb, np.asarray(c_jb), rtol=1e-5)


def test_cli_connected_test_lextree_matches_reference(tmp_path, capsys, monkeypatch):
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    monkeypatch.chdir(tmp_path)
    jmain(["synth", "-o", "data", "--n-train", "3", "--n-test", "1",
           "--n-continuous", "8"])
    jmain(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
           "--n-gaussians", "2"])
    capsys.readouterr()

    def lines(out, prefixes=("Correct:", "Incorrect:", "WER:")):
        return [l for l in out.splitlines() if l.startswith(prefixes)]

    jmain(["connected_test", "-i", "models/bank.npz", "-d", "data/test",
           "--graph", "lextree"])
    ref = lines(capsys.readouterr().out)
    out = {}
    for graph in ("lextree", "loop"):
        tmain(["connected_test", "-i", "models/bank.npz", "-d", "data/test",
               "--graph", graph, "--device", "cpu"])
        out[graph] = capsys.readouterr().out
    assert lines(out["lextree"]) == ref and len(ref) > 10
    # flat digit vocabulary: the trie decodes the loop graph's words
    words = ("Correct:", "Incorrect:")
    assert lines(out["lextree"], words) == lines(out["loop"], words)
    # the bigram on the trie: composed (K4 + K5 on the card) and lattice
    # rescored (K6 + K7); the reference's auto picks compose on one-unit words
    for decoder in ("auto", "compose", "lattice"):
        cmd = ["connected_test", "-i", "models/bank.npz", "-d", "data/test",
               "--graph", "lextree", "--lm", "bigram", "--decoder", decoder]
        jmain(cmd)
        ref = lines(capsys.readouterr().out, words + ("WER:", "WARNING:"))
        tmain(cmd + ["--device", "cpu"])
        out[decoder] = capsys.readouterr().out
        assert lines(out[decoder], words + ("WER:", "WARNING:")) == ref and len(ref) > 10
    assert lines(out["auto"]) == lines(out["compose"])
    for main, dev in ((jmain, []), (tmain, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="needs --lm bigram"):
            main(["connected_test", "-i", "models/bank.npz", "-d", "data/test",
                  "--graph", "lextree", "--decoder", "lattice", *dev])


def test_lex_words_from_path_matches_reference():
    jg, tg, _ = graphs("random50")
    rng = np.random.default_rng(31)
    states = rng.integers(0, tg.n_states, (4, 12)).astype(np.int32)
    flags = rng.uniform(size=(4, 12)) < 0.3
    nf = np.array([12, 1, 7, 12], np.int32)
    assert tlg.lex_words_from_path_batch(tg, states, nf, flags) == \
        jlg.lex_words_from_path_batch(jg, states, nf, flags)
    assert tlg.lex_words_from_path(tg, states[2], 7, flags[2]) == \
        jlg.lex_words_from_path(jg, states[2], 7, flags[2])


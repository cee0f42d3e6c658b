"""Port vs reference: the beams.

* the dense rank-threshold beam (``ops.viterbi.viterbi(beam_width=)``
  and the batched ``viterbi_batch``) against the reference's
  ``viterbi(beam_width=)``: final costs and both planes bit-identical,
  with ties at the k-th best, columns with fewer than k finite costs,
  eps passes and widths past S;
* the banded beam (``viterbi_banded_tb(beam_width=)``) against the
  reference's per-utterance ``viterbi_banded(beam_width=)``: final,
  bp8 and eps_u bit-identical on loop graphs, 1-state sausages at eps
  depth > 1, words of mixed lengths and tries with cross edges (the
  lexicon-built trie and a hand-built one whose arcs have 1, 2 and 3
  states); the plain backtrace and the emulation of kernel K9's walk
  (``tests/k9_walk.py``, cross steps included) against the reference's
  ``banded_backtrace`` on exact and beam planes;
* the token beam (``ops.beam``): ``beam_tables``, every output of
  ``beam_search`` (token planes, garbage slots included) and
  ``beam_backtrace`` bit-identical to the reference's per-utterance
  functions on the same emissions, with and without a bigram, wide and
  narrow; the reference's own beam tests mirrored (exactness at full
  width, the planted path at k = 12 on the 1,000-word trie, the batched
  API);
* the decode routes: ``decode_connected(beam_width=)`` (banded; with
  ``backend="wordtrace"`` the same banded beam route; with
  ``backend="dense"`` the beam ignored, as the reference ignores it),
  ``decode_lextree(beam_width=)`` and ``beam_decode_lextree`` against the
  reference's: words identical, costs at rtol 1e-5 (the emission GEMMs
  sum in other orders).

Inputs come from numpy seeds and go to both sides as f32.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import connected as jconn
from speech_recognition_tpu.decode import lextree as jdec
from speech_recognition_tpu.langmodel.bigram import fit_bigram as j_fit_bigram
from speech_recognition_tpu.models import lexgraph as jlg
from speech_recognition_tpu_torch.data.lexicon import random_words
from speech_recognition_tpu_torch.decode import connected as tconn
from speech_recognition_tpu_torch.decode import lextree as tdec
from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram as t_fit_bigram
from speech_recognition_tpu_torch.models import lexgraph as tlg
from speech_recognition_tpu_torch.models.graph import build_loop_graph
from speech_recognition_tpu_torch.ops import beam as tbeam
from speech_recognition_tpu_torch.ops import viterbi as tv
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.utils.numerics import POS_INF
from tests import k9_walk
from tests.hand_trie import port_graph, trie_arrays
from tests.test_lex_pallas import ltr
from tests.test_torch_banded import build_graphs, jvb
from tests.test_torch_gmm_hmm import both_banks

jbeam = importlib.import_module("speech_recognition_tpu.ops.beam")
jv = importlib.import_module("speech_recognition_tpu.ops.viterbi")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


# ---------------------------------------------------------------------------
# the dense rank-threshold beam
# ---------------------------------------------------------------------------


def dense_case(seed, b, t, s, ties=False, eps=False):
    """A dense problem: left-to-right-with-skips transitions (so early
    columns hold fewer finite costs than the beam), optional eps block,
    integer costs for ties."""
    rng = np.random.default_rng(seed)
    draw = (lambda *sh: rng.integers(0, 4, sh).astype(np.float32)) if ties else \
        (lambda *sh: rng.uniform(0, 3, sh).astype(np.float32))
    nll = draw(b, t, s)
    trans = np.full((s, s), POS_INF, np.float32)
    for d in range(3):
        idx = np.arange(d, s)
        trans[idx, idx - d] = draw(s - d)
    init = np.full(s, POS_INF, np.float32)
    init[:2] = draw(2)
    eps_t = None
    if eps:
        eps_t = np.full((s, s), POS_INF, np.float32)
        eps_t[0, s - 1] = 0.5
        eps_t[s // 2, s // 2 - 1] = 0.25
    nf = rng.integers(1, t + 1, b).astype(np.int32)
    nf[0] = t
    return nll, trans, init, nf, eps_t


@pytest.mark.parametrize("ties,eps,k", [(False, False, 3), (True, False, 2),
                                        (True, True, 4), (False, True, 9),
                                        (False, False, 14)])
def test_dense_beam_matches_reference(ties, eps, k):
    """k = 2-4 prune (ties at the k-th best survive; the first columns
    hold fewer than k finite costs), k = 9 = S keeps everything, k = 14
    is past S (the reference's sort index clamps to the last entry)."""
    nll, trans, init, nf, eps_t = dense_case(7 + k, 4, 18, 9, ties=ties, eps=eps)
    depth = 2 if eps else 1
    kw_t = dict(eps_trans=None if eps_t is None else _t(eps_t), eps_depth=depth)
    kw_j = dict(eps_trans=None if eps_t is None else _j(eps_t), eps_depth=depth)
    fin_b, bp_b, ebp_b = tv.viterbi_batch(_t(nll), _t(trans), _t(init), _t(nf),
                                          beam_width=k, **kw_t)
    n_pruned = 0
    for i in range(nll.shape[0]):
        ref = jv.viterbi(_j(nll[i]), _j(trans), _j(init), jnp.int32(nf[i]), beam_width=k,
                         **kw_j)
        got = tv.viterbi(_t(nll[i]), _t(trans), _t(init), int(nf[i]), beam_width=k, **kw_t)
        for name, g_, r_ in zip(("final", "bp", "eps_bp"), got, ref):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(r_), err_msg=name)
        for g_, b_ in zip(got, (fin_b, bp_b, ebp_b)):
            np.testing.assert_array_equal(g_.numpy(), b_[i].numpy())
        exact = jv.viterbi(_j(nll[i]), _j(trans), _j(init), jnp.int32(nf[i]), **kw_j)
        n_pruned += int((np.asarray(ref.final_cost) != np.asarray(exact.final_cost)).sum())
    if k >= 9:
        assert n_pruned == 0
    elif not eps:
        assert n_pruned > 0  # the beam did prune


# ---------------------------------------------------------------------------
# the banded rank-threshold beam, and K9's walk over cross edges
# ---------------------------------------------------------------------------


def hand_trie(seed):
    """The hand-built trie of ``tests/hand_trie.py`` (arcs of 1, 2 and 3
    states; eps depth 2) in both packages: ``(port graph, reference
    graph, eps_depth, n_bank_rows)``."""
    arrs, depth, n_bank = trie_arrays(seed)
    jg = jvb.BandedGraph(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                            for k, v in arrs.items()})
    return port_graph(arrs), jg, depth, n_bank


@functools.lru_cache(maxsize=None)
def banded_case(kind):
    """``(port graph, reference graph, eps_depth)`` of each banded kind."""
    rng = np.random.default_rng(3)
    if kind == "hand trie":
        return hand_trie(5)[:3]
    if kind == "lex trie":
        units = list("abc")
        trans = [ltr(3, rng, skip=i != 1) for i in range(3)]
        words = random_words(np.random.default_rng(4), units, 30, 1, 5)
        ids = {ch: i for i, ch in enumerate(units)}
        jg = jlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.4)
        tg = tlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.4)
        return tg.banded, jg.banded, 1
    trans = [ltr(n, rng) for n in (3, 2, 4, 3, 5)]
    if kind == "1-state sausage":
        trans = [t[:1, :1] for t in trans]
    jgr, tgr = build_graphs("sausage" if "sausage" in kind else "loop", trans)
    return tvb.banded_arrays(tgr), jvb.banded_arrays(jgr), tgr.eps_depth


BANDED = ["mixed loop", "1-state sausage", "lex trie", "hand trie"]


def banded_emissions(seed, t, s, b, ties):
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(0, 4, (t, s, b)).astype(np.float32)
    return rng.uniform(0, 4, (t, s, b)).astype(np.float32)


@pytest.mark.parametrize("kind", BANDED)
@pytest.mark.parametrize("ties", [False, True])
def test_banded_beam_and_cross_backtrace_match_reference(kind, ties):
    """Beam planes bit-identical to the reference's per utterance at k =
    3, 7 and S (no pruning); the plain backtrace and K9's walk emulation
    equal the reference's backtrace on the beam planes and the exact
    ones."""
    tg, jg, depth = banded_case(kind)
    s = tg.n_states
    nll = banded_emissions(11 + s, 19, s, 5, ties)
    nf = np.array([19, 7, 1, 19, 12], np.int32)
    if kind == "1-state sausage":
        assert depth > 1
    for k in (3, 7, s, 0):
        fin, bp8, eps_u = tvb.viterbi_banded_tb(_t(nll), tg, _t(nf), depth, beam_width=k)
        ends = tg.end_states.numpy()
        best = ends[np.argmin(fin.numpy()[ends] + tg.end_bonus.numpy()[:, None], axis=0)]
        st, fl = tvb.banded_backtrace_tb(bp8, eps_u, tg, _t(best), _t(nf), depth)
        cross = None if tg.cross_src is None else tg.cross_src.numpy()
        sw, fw, *_ = k9_walk.walk(bp8.numpy(), eps_u.numpy(), *k9_walk.graph_tables(tg),
                                  best, nf, depth, cross_src=cross)
        np.testing.assert_array_equal(sw, st.numpy())
        np.testing.assert_array_equal(fw, fl.numpy())
        for i in range(len(nf)):
            r_fin, r_bp, r_eu = jvb.viterbi_banded(_j(nll[:, :, i]), jg, jnp.int32(nf[i]),
                                                   eps_depth=depth, beam_width=k)
            np.testing.assert_array_equal(fin[:, i].numpy(), np.asarray(r_fin))
            np.testing.assert_array_equal(bp8[:, :, i].numpy(), np.asarray(r_bp))
            np.testing.assert_array_equal(eps_u[:, :, i].numpy(), np.asarray(r_eu))
            r_st, r_fl = jvb.banded_backtrace(r_bp, r_eu, jg, jnp.int32(best[i]),
                                              jnp.int32(nf[i]), eps_depth=depth)
            np.testing.assert_array_equal(st[:, i].numpy(), np.asarray(r_st))
            np.testing.assert_array_equal(fl[:, i].numpy(), np.asarray(r_fl))
        if k == 3:
            exact = tvb.viterbi_banded_tb(_t(nll), tg, _t(nf), depth)[0]
            assert not torch.equal(exact, fin)  # the beam pruned
        if k == s:
            assert torch.equal(tvb.viterbi_banded_tb(_t(nll), tg, _t(nf), depth)[0], fin)


def test_k9_walk_takes_cross_steps_out_of_every_arc_length():
    """On the hand-built trie the best paths cross from arcs of 1, 2 and
    3 states, and every cross step leaves the walk's window."""
    tg, _, depth, _ = hand_trie(5)
    s = tg.n_states
    nll = banded_emissions(1, 40, s, 16, False)
    nf = np.full(16, 40, np.int32)
    fin, bp8, eps_u = tvb.viterbi_banded_tb(_t(nll), tg, _t(nf), depth)
    ends = tg.end_states.numpy()
    best = ends[np.argmin(fin.numpy()[ends] + tg.end_bonus.numpy()[:, None], axis=0)]
    st, _ = tvb.banded_backtrace_tb(bp8, eps_u, tg, _t(best), _t(nf), depth)
    st = st.numpy()
    cs = tg.cross_src.numpy()
    codes = bp8.numpy()[np.arange(1, 40)[:, None], st[1:], np.arange(16)[None]]
    crossed = codes == tvb._CROSS
    assert crossed.any()
    arc_len = np.zeros(s, np.int64)  # length of the arc each cross source ends
    starts = np.flatnonzero(k9_walk.graph_tables(tg)[2])
    lens = np.diff(np.r_[starts, s])
    for a, n in zip(starts, lens):
        arc_len[a + n - 1] = n
    src_lens = set(arc_len[cs[st[1:][crossed]]].tolist())
    assert {1, 2, 3} <= src_lens, src_lens
    sw, *_ = k9_walk.walk(bp8.numpy(), eps_u.numpy(), *k9_walk.graph_tables(tg), best, nf,
                          depth, cross_src=cs)
    np.testing.assert_array_equal(sw, st)


# ---------------------------------------------------------------------------
# the token beam
# ---------------------------------------------------------------------------


def toy_lex(kind):
    rng = np.random.default_rng(9)
    if kind == "toy":
        words = ["ab", "abc", "ad", "ba", "c", "da", "dab"]
    else:
        words = random_words(np.random.default_rng(2), list("abcd"), 40, 1, 5)
    units = sorted(set("".join(words)))
    ids = {ch: i for i, ch in enumerate(units)}
    trans = [ltr(3, rng, skip=i % 2 == 0) for i in range(len(units))]
    return (jlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.3),
            tlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.3), len(units) * 3)


def test_beam_tables_match_reference():
    jg, tg, _ = toy_lex("random")
    jt = jbeam.beam_tables(jg.banded, leaf_word=jg.leaf_word)
    tt = tbeam.beam_tables(tg.banded, leaf_word=tg.leaf_word)
    for f in ("band", "child_starts", "child_costs", "end_slot", "end_word", "word_starts",
              "eps_block", "init_states", "init_costs", "bank_state", "end_bonus"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    assert tt.n_states == jt.n_states
    assert tt.n_children == int((np.asarray(jt.child_starts) >= 0).sum())


def _bigram(n_words, seed):
    seqs = [list(np.random.default_rng(seed + i).integers(0, n_words, 4)) for i in range(6)]
    return j_fit_bigram(seqs, n_words), t_fit_bigram(seqs, n_words)


TOKEN_CASES = [("toy", 4, False, False), ("toy", 64, False, True), ("random", 9, True, False),
               ("random", 12, True, True), ("loop", 5, True, False)]


@pytest.mark.parametrize("kind,k,lm,ties", TOKEN_CASES)
def test_token_beam_matches_reference(kind, k, lm, ties):
    """Every output of ``beam_search`` (the token planes with their
    garbage slots) and ``beam_backtrace`` bit-identical to the reference's
    per utterance, narrow and wide, with and without the carried bigram,
    on random and tie-forcing integer emissions."""
    rng = np.random.default_rng(k)
    if kind == "loop":
        trans = [ltr(n, rng) for n in (3, 4, 2, 3)]
        jgr, tgr = build_graphs("loop", trans)
        jg, tg = jvb.banded_arrays(jgr), tvb.banded_arrays(tgr)
        jt, tt = jbeam.beam_tables(jg), tbeam.beam_tables(tg)
        n_rows, n_words = int(tg.bank_state.max()) + 1, 4
    else:
        jl, tl, n_rows = toy_lex(kind)
        jt = jbeam.beam_tables(jl.banded, leaf_word=jl.leaf_word)
        tt = tbeam.beam_tables(tl.banded, leaf_word=tl.leaf_word)
        n_words = tl.n_words
    has_cross = tt.n_children > 0
    assert has_cross == (kind != "loop")
    t_len, b = 23, 5
    e = (rng.integers(0, 3, (b, t_len, n_rows)) if ties
         else rng.uniform(0, 4, (b, t_len, n_rows))).astype(np.float32)
    nf = np.array([23, 11, 1, 23, 6], np.int32)
    big = big_end = None
    if lm:
        jlm, tlm = _bigram(n_words, k)
        big_np = np.concatenate([tlm.cost, tlm.start_cost[None]]).astype(np.float32)
        big, big_end = _t(big_np), _t(tlm.end_cost.astype(np.float32))
    got = tbeam.beam_search(_t(e), tt, _t(nf), k, has_cross=has_cross, bigram_cost=big)
    cost, words_rev = tbeam.beam_backtrace(got[0], got[1], got[4], got[5], tt, _t(nf),
                                           final_pred=got[2], bigram_cost=big,
                                           bigram_end=big_end)
    names = ("final_state", "final_cost", "final_pred", "tok_state", "tok_prev", "tok_word")
    for i in range(b):
        ref = jbeam.beam_search(_j(e[i]), jt, jnp.int32(nf[i]), k=k, has_cross=has_cross,
                                bigram_cost=None if big is None else _j(big))
        for name, g_, r_ in zip(names, got, ref):
            np.testing.assert_array_equal(g_[i].numpy(), np.asarray(r_), err_msg=name)
        r_cost, r_words = jbeam.beam_backtrace(
            ref[0], ref[1], ref[4], ref[5], jt, jnp.int32(nf[i]), final_pred=ref[2],
            bigram_cost=None if big is None else _j(big),
            bigram_end=None if big_end is None else _j(big_end))
        assert float(cost[i]) == float(r_cost)
        np.testing.assert_array_equal(words_rev[i].numpy(), np.asarray(r_words))
    assert (cost.numpy()[nf >= 11] < POS_INF / 2).all()  # long streams end in a word


def test_token_beam_refuses_a_width_below_the_init_states():
    jl, tl, n_rows = toy_lex("toy")
    tt = tbeam.beam_tables(tl.banded, leaf_word=tl.leaf_word)
    with pytest.raises(ValueError, match="init states"):
        tbeam.beam_search(torch.zeros((1, 3, n_rows)), tt, torch.tensor([3]), 2)


def beam_words(words_rev):
    w = words_rev.numpy()
    return [int(x) for x in w[:0:-1] if x >= 0] + [int(w[0])]


def exact_port(g, nll_tb, nf, depth=1):
    """The exact plain decode of ``nll_tb [T, S, 1]``: ``(cost, states,
    flags)`` of its best end."""
    fin, bp8, eps_u = tvb.viterbi_banded_tb(_t(nll_tb), g, _t(nf), depth)
    costs = fin[g.end_states, 0] + g.end_bonus
    best = int(torch.argmin(costs))
    st, fl = tvb.banded_backtrace_tb(bp8, eps_u, g, g.end_states[best:best + 1], _t(nf),
                                     depth)
    return float(costs[best]), st[:, 0].numpy(), fl[:, 0].numpy()


def test_full_width_token_beam_is_exact_lexgraph(rng):
    """Mirror of the reference's exactness test on a trie: k = S gives
    the exact decode's cost and words, bit for bit."""
    words = ["ab", "abc", "ad", "ba", "c"]
    units = sorted(set("".join(words)))
    ids = {ch: i for i, ch in enumerate(units)}
    lexg = tlg.build_lex_graph(words, [ltr(3, rng) for _ in units], ids,
                               word_insertion_cost=0.3)
    tables = tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word)
    e = rng.uniform(0, 5, (29, len(units) * 3)).astype(np.float32)
    nll = e[:, lexg.banded.bank_state.numpy()]
    for nf in (29, 14):
        c_ref, st, fl = exact_port(lexg.banded, nll[..., None], np.array([nf], np.int32))
        w_ref = tlg.lex_words_from_path(lexg, st, nf, fl)
        out = tbeam.beam_search(_t(e[None]), tables, torch.tensor([nf]), lexg.n_states)
        cost, words_rev = tbeam.beam_backtrace(out[0], out[1], out[4], out[5], tables,
                                               torch.tensor([nf]))
        assert float(cost[0]) == c_ref
        assert beam_words(words_rev[0]) == w_ref


def test_full_width_token_beam_is_exact_loop_graph(rng):
    """No cross edges (a flat loop graph with a bigram composed in)."""
    trans = [ltr(4, rng) for _ in range(6)]
    lm = t_fit_bigram([[0, 1, 2], [5, 4, 3, 0]], 6)
    g = build_loop_graph(trans, lm=lm, word_insertion_cost=0.2)
    bg = tvb.banded_arrays(g)
    tables = tbeam.beam_tables(bg)._replace(bank_state=torch.arange(g.n_states))
    nll = rng.uniform(0, 5, (33, g.n_states)).astype(np.float32)
    c_ref, st, fl = exact_port(bg, nll[..., None], np.array([33], np.int32))
    w_ref = tconn.states_to_words(g, st, 33, fl)
    out = tbeam.beam_search(_t(nll[None]), tables, torch.tensor([33]), g.n_states,
                            has_cross=False)
    cost, words_rev = tbeam.beam_backtrace(out[0], out[1], out[4], out[5], tables,
                                           torch.tensor([33]))
    assert float(cost[0]) == c_ref
    assert beam_words(words_rev[0]) == w_ref


def test_narrow_token_beam_decodes_the_planted_path(rng):
    """k = 12 tokens on a 1,000-word trie: the planted two-word path, at
    the exact decode's cost (rtol 1e-6), as the reference's test."""
    units = list("abcdefgh")
    ids = {ch: i for i, ch in enumerate(units)}
    nprng = np.random.default_rng(7)
    vocab = set()
    while len(vocab) < 1000:
        vocab.add("".join(nprng.choice(units, int(nprng.integers(3, 9)))))
    words = sorted(vocab)
    lexg = tlg.build_lex_graph(words, [ltr(3, rng, skip=False) for _ in units], ids,
                               word_insertion_cost=0.5)
    tables = tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word)
    target = [words[42], words[777]]
    cols = [ids[ch] * 3 + j for w in target for ch in w for j in range(3) for _ in range(2)]
    t_len = len(cols)
    e = np.full((t_len, len(units) * 3), 8.0, np.float32)
    e[np.arange(t_len), cols] = 0.1
    out = tbeam.beam_search(_t(e[None]), tables, torch.tensor([t_len]), 12)
    cost, words_rev = tbeam.beam_backtrace(out[0], out[1], out[4], out[5], tables,
                                           torch.tensor([t_len]))
    got = beam_words(words_rev[0])
    assert [words[i] for i in got] == target
    nll = e[:, lexg.banded.bank_state.numpy()]
    c_ref, st, fl = exact_port(lexg.banded, nll[..., None], np.array([t_len], np.int32))
    assert tlg.lex_words_from_path(lexg, st, t_len, fl) == got
    np.testing.assert_allclose(float(cost[0]), c_ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# the decode routes against the reference's
# ---------------------------------------------------------------------------


def gmm_lex_case():
    """The reference's API test setup: 4 units of 3 states over 6 dims,
    features tracing the unit means of 3 planted word sequences (and one
    stream of noise), the same bank and trie in both packages."""
    units = list("abcd")
    ids = {ch: i for i, ch in enumerate(units)}
    jb, tb = both_banks(31, n_models=4, n_states=3, n_mix=1, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    words = ["ab", "abc", "ba", "d", "ca"]
    jg = jlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    tg = tlg.build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    means = np.asarray(jb.means)[:, :, 0, :]
    paths = [["ab", "d"], ["ca", "ba"], ["abc"]]
    rng = np.random.default_rng(8)
    seqs = [[means[ids[ch], j] for w in p for ch in w for j in range(3) for _ in range(3)]
            for p in paths]
    t_len = max(map(len, seqs))
    x = rng.standard_normal((4, t_len, 6)).astype(np.float32)
    nf = np.array([len(s) for s in seqs] + [t_len - 3], np.int32)
    for i, s in enumerate(seqs):
        x[i, : len(s)] = s
    refs = [[words.index(w) for w in p] for p in paths]
    return jb, tb, jg, tg, x, nf, refs


def test_decode_lextree_beam_matches_reference():
    """``decode_lextree(beam_width=)`` (pruned plain forward + K9's plain
    version over the trie's cross edges) against the reference's XLA
    beam route, narrow and at k = S (which equals the exact decode)."""
    jb, tb, jg, tg, x, nf, refs = gmm_lex_case()
    w_exact, c_exact = tdec.decode_lextree(tb, tg, _t(x), _t(nf))
    for k in (4, 9, tg.n_states):
        w_j, c_j = jdec.decode_lextree(jb, jg, x, nf, beam_width=k)
        w_t, c_t = tdec.decode_lextree(tb, tg, _t(x), _t(nf), beam_width=k)
        assert w_t == w_j
        np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)
    assert w_t == w_exact and w_t[:3] == refs
    np.testing.assert_array_equal(c_t, c_exact)


def test_beam_decode_lextree_matches_reference():
    """The batched token-beam API against the reference's, wide, narrow
    and with the carried bigram: words identical, costs at rtol 1e-5; at
    full width the words and costs equal the exact decode's."""
    jb, tb, jg, tg, x, nf, refs = gmm_lex_case()
    w_exact, c_exact = tdec.decode_lextree(tb, tg, _t(x), _t(nf))
    jlm = j_fit_bigram([[0, 3], [4, 2], [1]], 5)
    tlm = t_fit_bigram([[0, 3], [4, 2], [1]], 5)
    for k, lms in ((tg.n_states, (None, None)), (16, (None, None)), (tg.n_states, (jlm, tlm)),
                   (6, (jlm, tlm))):
        w_j, c_j = jdec.beam_decode_lextree(jb, jg, x, nf, k=k, lm=lms[0])
        w_t, c_t = tdec.beam_decode_lextree(tb, tg, _t(x), _t(nf), k, lm=lms[1])
        assert w_t == w_j, (k, lms[0] is not None)
        np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)
        if k == tg.n_states:
            assert w_t[:3] == refs
        if k == tg.n_states and lms[1] is None:
            assert w_t == w_exact
            np.testing.assert_allclose(c_t, c_exact, rtol=1e-6)


def _feats(seed, b, t, nf):
    x = np.random.default_rng(seed).standard_normal((b, t, 6)).astype(np.float32)
    return x, np.asarray(nf, np.int32)


@pytest.mark.parametrize("kind", ["loop", "sausage", "1-state sausage"])
def test_decode_connected_beam_matches_reference(kind):
    """The banded beam route against the reference's vmapped beam path;
    ``backend="wordtrace"`` with a beam takes the same route (ROADMAP
    C4, closed by following the reference); at k = S the words and costs
    equal the exact route's."""
    jb, tb = both_banks(41, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    if kind == "1-state sausage":
        trans = [t[:1, :1] for t in trans]
    jgr, tgr = build_graphs("sausage" if "sausage" in kind else "loop", trans)
    x, nf = _feats(5, 4, 20, [20, 13, 1, 17])
    for k in (3, 8, tgr.n_states):
        w_j, c_j = jconn.decode_connected(jb, jgr, x, nf, beam_width=k)
        w_t, c_t = tconn.decode_connected(tb, tgr, _t(x), _t(nf), beam_width=k)
        assert w_t == w_j
        np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)
        w_w, c_w = tconn.decode_connected(tb, tgr, _t(x), _t(nf), backend="wordtrace",
                                          beam_width=k)
        assert w_w == w_t
        np.testing.assert_array_equal(c_w, c_t)
    w_e, c_e = tconn.decode_connected(tb, tgr, _t(x), _t(nf))
    assert w_t == w_e
    np.testing.assert_allclose(c_t, c_e, rtol=1e-6)


def test_dense_backend_ignores_the_beam_as_the_reference_does():
    """ROADMAP C13: the reference's ``decode_connected(backend="dense")``
    passes no beam to its decoder; the port's ignores it too."""
    jb, tb = both_banks(43, n_models=3, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(3)]
    jgr, tgr = build_graphs("loop", trans)
    x, nf = _feats(6, 3, 15, [15, 9, 4])
    w_j, c_j = jconn.decode_connected(jb, jgr, x, nf, backend="dense", beam_width=2)
    w_t, c_t = tconn.decode_connected(tb, tgr, _t(x), _t(nf), backend="dense", beam_width=2)
    w_0, c_0 = tconn.decode_connected(tb, tgr, _t(x), _t(nf), backend="dense")
    assert w_t == w_j == w_0
    np.testing.assert_array_equal(c_t, c_0)
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)

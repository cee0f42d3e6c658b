"""The lexical-tree backtrace K5's window walk, on the CPU.

K5 (``csrc/lex_backtrace.cu``) reads each state's chain (the states its
walk can reach backwards without an eps step) from the table
``ops.viterbi_lex_kernels.lex_chains`` packs once per graph, and walks
windows of frames x chain states.  Here the table is checked against the
graph it comes from, and the emulation of the kernel's walk
(``tests/k5_walk.py``) is held state for state and flag for flag against
the plain version ``lex_backtrace_val_ref`` on K4's plain planes: the
1,000-word trie with uniform and planted-word emissions (eps re-entries,
lengths below T), a trie whose words are longer than a chain row (the
walk leaves a cut chain at its bottom), the flat 100-word bigram
vocabulary (one arc per word, an eps step every word) and the
dictionary-shaped trie, each at the kernel's window size and at a small
one that takes many windows per word.
"""

import numpy as np
import pytest
import torch

from k5_walk import graph_tables, walk
from speech_recognition_tpu_torch.data.lexicon import (
    bench_lexicon,
    dict1_shaped_lexicon,
    flat_lm_lexicon,
    planted_emissions,
    random_words,
    unit_transitions,
)
from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
from speech_recognition_tpu_torch.utils.numerics import POS_INF


def _case(kind):
    """``(graph, nll [U, T, B], n_frames [B])`` with lengths below T."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "flat_lm_100":
        words, trans, ids, lm, frng = flat_lm_lexicon(100)
        g = build_lex_graph(words, trans, ids, lm=lm, word_insertion_cost=0.3).banded
        t, b = 60, 4
        nll = frng.uniform(0, 5, (200, t, b)).astype(np.float32)
        return g, nll, np.r_[t, 1, rng.integers(2, t, b - 2)]
    if kind == "deep":  # words of 12-16 3-state units: chains past one row
        units = list("abcde")
        words = random_words(rng, units, 30, 12, 16)
        ids = {c: i for i, c in enumerate(units)}
        g = build_lex_graph(words, unit_transitions(rng, 5), ids, word_insertion_cost=0.5).banded
        nll, nf = planted_emissions(rng, words, ids, 3, 15, 4, 200)[:2]
        return g, nll, nf
    if kind == "dict1":
        words, trans, ids, drng = dict1_shaped_lexicon()
        g = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded
        t, b = 40, 3
        nll = drng.uniform(0, 5, (93, t, b)).astype(np.float32)
        return g, nll, np.r_[t, 1, 27]
    words, trans, ids, lrng = bench_lexicon()
    g = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded
    t, b = 160, 6
    if kind == "1k_planted":
        return (g, *planted_emissions(rng, words, ids, 3, 24, b, t)[:2])
    nll = lrng.uniform(0, 5, (24, t, b)).astype(np.float32)
    return g, nll, np.r_[t, 1, rng.integers(2, t, b - 2)]


@pytest.mark.parametrize("kind", ["1k", "dict1", "deep", "flat_lm_100"])
def test_chain_rows_follow_the_graph(kind):
    """Each row ends at its state; each step down the row is a band step
    inside an arc (s - 1, no arc start at s) or the cross edge of an arc
    start; a row that stops short of 32 states starts at a word start or
    an arc without a parent; the head holds the length and the first
    state's eps_prev slot."""
    g = _case(kind)[0]
    chains, heads = lk.lex_chains(g)
    s_n = g.n_states
    length = heads[:, 0]
    assert chains.shape == (s_n, lk.CHAIN) and chains.dtype == np.int32
    assert ((length >= 1) & (length <= lk.CHAIN)).all()
    v = np.arange(s_n)
    assert (chains[v, length - 1] == v).all()
    np.testing.assert_array_equal(heads[:, 1], g.start_pos.numpy()[chains[:, 0]])
    src, cost = g.cross_src.numpy(), g.cross_cost.numpy()
    starts = g.is_start.numpy()
    linked = (cost < POS_INF) & (src < v)
    arc_start = linked | starts
    arc_start[0] = True
    for q in range(1, lk.CHAIN):
        rows = length > q
        hi, lo = chains[rows, q], chains[rows, q - 1]
        band = ~arc_start[hi] & (lo == hi - 1)
        cross = linked[hi] & (lo == src[hi])
        assert (band | cross).all()
    short = length < lk.CHAIN
    assert (arc_start[chains[short, 0]] & ~linked[chains[short, 0]]).all()
    if kind == "deep":
        assert (length == lk.CHAIN).any()


@pytest.mark.parametrize("k_win", [256, 48])
@pytest.mark.parametrize("kind", ["1k", "1k_planted", "deep", "flat_lm_100", "dict1"])
def test_window_walk_matches_plain(kind, k_win):
    g, nll, nf = _case(kind)
    topo = lk.lex_topology(g)
    nf = torch.from_numpy(np.asarray(nf, np.int32))
    final, bp8, _, eps_prev = lk.viterbi_lex_ref(torch.from_numpy(nll), g, topo, nf)
    ends = g.end_states[torch.argmin(final[:, g.end_states] + g.end_bonus, 1)]
    sp, fp = lk.lex_backtrace_val_ref(bp8, eps_prev, g, ends, nf)
    chains, heads = lk.lex_chains(g)
    s, f, waited, ahead, left = walk(bp8.numpy(), eps_prev.numpy(), *graph_tables(g), chains,
                                     heads, ends.numpy(), nf.numpy(), k_win)
    t_len = bp8.shape[0]
    valid = np.arange(t_len)[:, None] < nf.numpy()[None, :]
    np.testing.assert_array_equal(np.where(valid, s, 0), np.where(valid, sp.numpy(), 0))
    np.testing.assert_array_equal(f & valid, fp.numpy() & valid)
    assert (fp.numpy() & valid).any()  # eps re-entries on the path
    assert int(nf.min()) < t_len and waited >= len(nf) - 1
    if k_win == 48 and kind != "flat_lm_100":  # (one 2-state arc a word there)
        assert ahead > 0  # windows of the same chain, loaded during the walk
    if kind == "deep":
        assert left > 0  # the walk left a cut chain at its bottom


def test_k5_wrapper_takes_plain_version_on_cpu():
    g, nll, nf = _case("1k")
    topo = lk.lex_topology(g)
    nf = torch.from_numpy(np.asarray(nf, np.int32))
    _, bp8, _, eps_prev = lk.viterbi_lex_ref(torch.from_numpy(nll), g, topo, nf)
    ends = g.end_states[: len(nf)]
    before = lk.lex_backtrace_val.launches
    got = lk.lex_backtrace_val(bp8, eps_prev, g, ends, nf, topo=topo)
    want = lk.lex_backtrace_val_ref(bp8, eps_prev, g, ends, nf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert lk.lex_backtrace_val.launches == before
    assert not topo.on_device  # the CPU path packs no chain table

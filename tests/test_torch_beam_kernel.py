"""The token beam's kernels on the CPU: K19 (``csrc/token_beam.cu``) and
K26 (``csrc/word_walk.cu``) cannot run here, so their rules are proved on
emulations, packed tables and plans.

* ``beam_pack``'s records unpack to the dense tables; ``beam_widest``;
  ``beam_plan``'s tiers at their boundaries, and its layout against the
  kernel's segment sizes by hand; ``walk_plan``'s forms;
* the kernel's selection rule (dedup by (cost, tie, position), then the
  k of least (cost, state); ``tests/k19_beam.merge_rule``) against
  ``ops.beam._merge_topk`` on live slots, on hypothesis cases with many
  equal costs, POS_INF candidates and eps tie ranks; its ranking (runs
  of 32, rounds merging 8, cut at k) against a sort;
* the emulated kernel (``tests/k19_beam.beam``) over whole tries, flat
  word graphs and the carried bigram, on random and tie-forcing integer
  emissions, with the atomics' orders shuffled, against
  ``beam_search_ref`` on every live slot of every plane and of the final
  frontier (dead slots -1), including a state with more children than
  half the widest fan-out and frames with several merge rounds; the
  plain walk ``beam_backtrace_ref`` gives the same words and costs from
  the emulation's planes as from the plain version's; and the plain
  version against the JAX ``beam_search`` as in ``tests/test_torch_beam.py``;
* K26's window form emulated (``tests/k26_walk.py``) against
  ``beam_backtrace_ref``;
* the gates: CPU tensors take the plain versions and count no launch;
  the tables are built once per graph.

Inputs come from numpy seeds.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from speech_recognition_tpu_torch.ops import beam as tbeam
from speech_recognition_tpu_torch.ops import beam_kernels as bk
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.utils.numerics import POS_INF
from tests import k19_beam, k26_walk
from tests.test_lex_pallas import ltr
from tests.test_torch_banded import build_graphs
from tests.test_torch_beam import _bigram, toy_lex

jbeam = importlib.import_module("speech_recognition_tpu.ops.beam")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def test_layout_matches_the_kernels_segments():
    """S 10, k 4, mmax 10, R 3, L 5: one run of 32, so the sort buffers
    and places hold 32; the winners' keys 3 x 8; every segment rounded to
    8 bytes."""
    got = bk._layout_bytes(10, 4, 10, 3, 5)
    want = (80 + 2 * 256 + 32 + 24) + (40 + 2 * 128 + 40) + 13 * 16 + 16 + 9 * 16
    assert got == want
    assert bk._row_bytes(7) == 2 * 32


@pytest.mark.parametrize("mmax,k,cap", [
    (1, 4, 32), (32, 64, 32), (33, 64, 64), (256, 64, 256), (300, 64, 320),
    (300, 1000, 512),   # 10 runs -> 2 of 256 -> 1 of 512
    (657, 64, 672),     # the 1k trie at k = 64: 21 runs -> 3 of 64 -> 1
    (9405, 9405, 10240)])  # 294 runs -> 37 of 256 -> 5 of 2,048 (10,240) -> 1 of 9,405
def test_sort_capacity(mmax, k, cap):
    """``_sort_cap``: the widest run layout a round writes, by hand."""
    assert bk._sort_cap(mmax, k) == cap


@pytest.mark.parametrize("s,k,mmax,r,l,u,tier,threads", [
    (9405, 64, 657, 8, 1000, 24, "shared", 256),      # the 1k trie at k = 64
    (9405, 64, 192, 8, 1000, 24, "shared", 256),      # ... without cross edges
    (9405, 9405, 9405, 8, 1000, 24, "device", 1024),  # the 1k trie at k = S
    (86520, 64, 1400, 31, 6250, 93, "device", 256),   # the dictionary-shaped trie
    (100, 8, 24, 100, 100, 300, "shared", 256),       # a flat 100-word graph
    (9405, 200, 1500, 8, 1000, 24, "shared", 1024),
])
def test_plan_tiers(s, k, mmax, r, l, u, tier, threads):
    plan = bk.beam_plan(s, k, mmax, r, l, u)
    assert plan.tier == tier and plan.threads == threads and plan.staged
    assert plan.nbytes == bk._layout_bytes(s, k, mmax, r, l)


@pytest.mark.parametrize("s,k,mmax", [(9405, 64, 657), (3000, 200, 1200), (20000, 16, 50)])
def test_plan_boundary(s, k, mmax):
    """Shared memory exactly while the working set and the two rows fit
    the limit; one byte less and the device tier takes the same working
    set, the rows still staged while they fit alone."""
    ws = bk._layout_bytes(s, k, mmax, 8, 1000)
    need = ws + bk._row_bytes(24)
    at = bk.beam_plan(s, k, mmax, 8, 1000, 24, limit=need)
    below = bk.beam_plan(s, k, mmax, 8, 1000, 24, limit=need - 1)
    assert (at.tier, at.nbytes, at.staged) == ("shared", ws, True)
    assert (below.tier, below.nbytes, below.staged) == ("device", ws, True)
    tiny = bk.beam_plan(s, k, mmax, 8, 1000, 24, limit=bk._row_bytes(24) - 1)
    assert (tiny.tier, tiny.staged) == ("device", False)


@pytest.mark.parametrize("k,aligned,form,window", [
    (4, True, "window", 32), (64, True, "window", 32), (224, True, "window", 32),
    (228, True, "window", 31), (896, True, "window", 8), (900, True, "chain", 0),
    (9405, True, "chain", 0), (6, True, "chain", 0), (64, False, "chain", 0)])
def test_walk_plan_forms(k, aligned, form, window):
    """K26's form at 500 frames: windows of 32 frames while the ring of four
    windows of both planes, the 500 rows and the mbarriers fit, fewer
    frames up to the limit, down to 8; past that, with k not a multiple
    of 4 or planes the bulk copies cannot take, the chain form."""
    plan = bk.walk_plan(k, 500, aligned=aligned)
    assert (plan.form, plan.window) == (form, window)
    if form == "window":
        assert plan.nbytes == 4 * (8 * window * k + 500) + 40 <= bk.SMEM_LIMIT
        assert bk._walk_smem(window + 1, k, 500) > bk.SMEM_LIMIT or window == 32


# ---------------------------------------------------------------------------
# the selection rule against _merge_topk
# ---------------------------------------------------------------------------


@st.composite
def candidate_rows(draw):
    n = draw(st.integers(1, 40))
    n_states = draw(st.integers(1, 12))
    k = draw(st.integers(1, 16))
    state = draw(st.lists(st.integers(-1, n_states - 1), min_size=n, max_size=n))
    costs = st.one_of(st.sampled_from([0.0, -0.0, 1.0, 2.0, 2.5, -1.0, float(POS_INF)]),
                      st.floats(-4, 4, width=32))
    cost = draw(st.lists(costs, min_size=n, max_size=n))
    # tie ranks as the beam draws them: origin states, S for dead origins,
    # S + 1 for eps arrivals
    tie = draw(st.lists(st.integers(0, n_states + 1), min_size=n, max_size=n))
    cost = [float(POS_INF) if s < 0 else c for s, c in zip(state, cost)]
    return np.array(state), np.array(cost, np.float32), np.array(tie), k


@settings(max_examples=300, deadline=None, database=None)
@given(candidate_rows())
def test_merge_rule_matches_merge_topk(case):
    """On live slots ``_merge_topk`` keeps, in order, the candidates the
    kernel's rule keeps: each state's least (cost, tie, position), ranked
    by (cost, state), at most k."""
    state, cost, tie, k = case
    n = len(state)
    pos = np.arange(n)
    st_, co, _, (got_pos,) = tbeam._merge_topk(_t(state[None]), _t(cost[None]),
                                               _t(tie[None]), (_t(pos[None]),), k)
    live = (co[0] < POS_INF / 2).numpy()
    want = k19_beam.merge_rule(state, cost, tie, k)
    assert int(live.sum()) == len(want)
    assert live[: len(want)].all()
    np.testing.assert_array_equal(got_pos[0].numpy()[: len(want)], want)
    np.testing.assert_array_equal(st_[0].numpy()[: len(want)], state[want])


def test_cost_keys_order_floats():
    xs = np.array([-3.5, -1e-30, -0.0, 0.0, 1e-30, 1.0, 7.25, 5e29, 1e30], np.float32)
    keys = [k19_beam.cost_key(x) for x in xs]
    assert keys == sorted(keys) and keys[2] == keys[3]
    assert all(k19_beam.key_cost(kk) == x for kk, x in zip(keys, xs))


@pytest.mark.parametrize("kind,has_cross", [("toy", True), ("toy", False), ("random", True),
                                           ("loop", False), ("fan", True)])
def test_beam_pack_unpacks_to_the_tables(kind, has_cross):
    """Each state's run of edge records is its finite band moves (d =
    0..2, below S) then, with cross edges, its child slots, with the
    weights' bits and the targets' bank rows; the state records, init
    states and word starts carry the dense tables' values; ``widest`` is
    the sum of the longest runs."""
    tt = _case(kind, 3)[0]
    pack = bk.beam_pack(tt, has_cross)
    band, cs, cc = tt.band.numpy(), tt.child_starts.numpy(), tt.child_costs.numpy()
    bank = tt.bank_state.numpy()
    s = tt.n_states
    degs = []
    for st in range(s):
        want = [(st + d, band[d, st + d]) for d in range(3)
                if st + d < s and band[d, st + d] < POS_INF / 2]
        if has_cross:
            want += [(int(c), w) for c, w in zip(cs[st], cc[st]) if c >= 0]
        off, cnt, slot, word = pack.rec[st]
        run = pack.edges[off:off + cnt]
        assert [(int(a), np.float32(w)) for a, w in zip(run[:, 0], run[:, 1].view(np.float32))] \
            == want
        np.testing.assert_array_equal(run[:, 2], bank[run[:, 0]])
        assert (slot, word) == (tt.end_slot[st], tt.end_word[st])
        degs.append(cnt)
    r0 = tt.init_states.shape[0]
    np.testing.assert_array_equal(pack.init[:r0, 0], tt.init_states.numpy())
    np.testing.assert_array_equal(pack.init[:r0, 1].view(np.float32), tt.init_costs.numpy())
    ws = tt.word_starts.numpy()
    np.testing.assert_array_equal(pack.starts[:len(ws)],
                                  np.stack([ws, bank[ws], pack.rec[ws, 0], pack.rec[ws, 1]], 1))
    assert pack.dup_starts == (len(set(ws.tolist())) < len(ws))
    np.testing.assert_array_equal(pack.widest, np.r_[0, np.cumsum(sorted(degs)[::-1])])
    for k in (1, 4, 10 ** 6):
        assert bk.beam_widest(pack, k, r0) == min(s, max(r0, int(pack.widest[min(k, s)]), 1))


@pytest.mark.parametrize("m,k,seed", [(0, 4, 0), (1, 4, 1), (31, 64, 2), (32, 8, 3),
                                      (33, 64, 4), (255, 64, 5), (256, 300, 6), (257, 64, 7),
                                      (700, 64, 8), (700, 1000, 9), (2100, 2100, 10)])
def test_ranking_matches_a_sort(m, k, seed):
    """The kernel's ranking (``k19_beam.rank_survivors``: runs of 32,
    rounds merging 8 runs by counts from its binary search, each run cut
    at k) gives the first min(m, k) keys of a sort, within the sort
    buffers ``_sort_cap`` sizes; no merge round up to 32 keys, one up to
    256, two up to 2,048, three past that."""
    rng = np.random.default_rng(seed)
    states = rng.permutation(5 * m + 1)[:m]
    costs = rng.integers(0, 6, m)  # many equal costs: the state decides
    keys = [(k19_beam.cost_key(np.float32(c)) << 32) | int(st) for c, st in zip(costs, states)]
    last, rounds = k19_beam.rank_survivors(keys, k, bk._sort_cap(max(m, 1), k))
    assert list(last[:min(m, k)]) == sorted(keys)[:min(m, k)]
    assert rounds == (0 if m <= 32 else 1 if m <= 256 else 2 if m <= 2048 else 3)


# ---------------------------------------------------------------------------
# the emulated kernel against the plain version
# ---------------------------------------------------------------------------


def _case(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "loop":
        trans = [ltr(n, rng) for n in (3, 4, 2, 3)]
        _, tgr = build_graphs("loop", trans)
        tg = tvb.banded_arrays(tgr)
        return tbeam.beam_tables(tg), int(tg.bank_state.max()) + 1, 4, rng
    if kind in ("fan", "1k"):
        return (*_trie(kind), rng)
    _, tl, n_rows = toy_lex(kind)
    return tbeam.beam_tables(tl.banded, leaf_word=tl.leaf_word), n_rows, tl.n_words, rng


def _trie(kind):
    """``fan``: one arc with a child for each of 8 units, beside short
    words (most states have at most one child); ``1k``: 1,000 random
    words over 8 units, as ``chip_smoke.py``'s trie.  ``(tables, bank
    rows, words)``."""
    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    rng = np.random.default_rng(7)
    units = list("abcdefgh")
    if kind == "fan":
        words = ["a" + u for u in units] + ["b", "cd", "dcb", "e", "fg", "hh"]
    else:
        words = random_words(rng, units, 1000, 3, 8)
    trans = [ltr(3, rng, skip=i % 2 == 0) for i in range(len(units))]
    lexg = build_lex_graph(words, trans, {c: i for i, c in enumerate(units)},
                           word_insertion_cost=0.5)
    return (tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word), 3 * len(units),
            lexg.n_words)


def assert_live_equal(got, want):
    """K19's outputs (dead slots -1) against the plain version's on every
    live slot; the dead slots of the kernel's are -1 / POS_INF."""
    fst, fco, fpd, ts, tp, tw = got
    live_f = want[0].numpy() >= 0
    np.testing.assert_array_equal(fst >= 0, live_f)
    for g_, w_ in zip((fst, fco, fpd), want[:3]):
        np.testing.assert_array_equal(g_[live_f], w_.numpy()[live_f])
    assert (fco[~live_f] == POS_INF).all() and (fpd[~live_f] == -1).all()
    live = want[3].numpy() >= 0
    np.testing.assert_array_equal(ts >= 0, live)
    for g_, w_ in zip((ts, tp, tw), want[3:]):
        np.testing.assert_array_equal(g_[live], w_.numpy()[live])
        assert (g_[~live] == -1).all()


BEAM_CASES = [("toy", 4, False, False), ("toy", 64, False, True), ("toy", 4, True, True),
              ("random", 9, True, False), ("random", 12, True, True), ("random", 8, False, True),
              ("random", 200, False, False), ("loop", 5, True, False), ("loop", 4, False, True),
              ("loop", 40, True, True)]


@pytest.mark.parametrize("kind,k,lm,ties", BEAM_CASES)
def test_emulated_kernel_matches_plain_beam(kind, k, lm, ties):
    """The kernel's rule over whole frames (band, cross, eps with and
    without the bigram, beams narrower and wider than the live states) on
    random and tie-forcing integer emissions; streams of length 0, 1,
    shorter than T and past T.  Then the plain walk on either's planes."""
    tt, n_rows, n_words, rng = _case(kind, k)
    has_cross = tt.n_children > 0
    t_len, b = 17, 6
    e = (rng.integers(0, 3, (b, t_len, n_rows)) if ties
         else rng.uniform(0, 4, (b, t_len, n_rows))).astype(np.float32)
    nf = np.array([17, 9, 1, 0, 23, 4], np.int32)
    big = big_end = None
    if lm:
        _, tlm = _bigram(n_words, k)
        big = np.concatenate([tlm.cost, tlm.start_cost[None]]).astype(np.float32)
        big_end = tlm.end_cost.astype(np.float32)
    want = tbeam.beam_search_ref(_t(e), tt, _t(nf), k, has_cross=has_cross,
                                 bigram_cost=None if big is None else _t(big))
    got = k19_beam.beam(e, tt, nf, k, has_cross=has_cross, bigram_cost=big)
    assert_live_equal(got, want)
    kw = dict(bigram_cost=None if big is None else _t(big),
              bigram_end=None if big_end is None else _t(big_end))
    c_w, w_w = tbeam.beam_backtrace_ref(want[0], want[1], want[4], want[5], tt, _t(nf),
                                        final_pred=want[2], **kw)
    c_g, w_g = tbeam.beam_backtrace_ref(*(_t(x) for x in (got[0], got[1], got[4], got[5])),
                                        tt, _t(nf), final_pred=_t(got[2]), **kw)
    np.testing.assert_array_equal(c_g.numpy(), c_w.numpy())
    found = c_w.numpy() < POS_INF / 2
    assert found[0] and not found[4]  # a stream past T has no final frontier
    np.testing.assert_array_equal(w_g.numpy()[found], w_w.numpy()[found])


def test_emulated_kernel_with_equal_eps_arrivals():
    """Every emission and cross cost 0 on the toy trie: ties everywhere,
    eps candidates tie with the band arrivals at the word starts (the
    arrival keeps the state) and with each other across leaves (the
    least slot wins)."""
    tt, n_rows, n_words, _ = _case("toy", 0)
    tt = tt._replace(child_costs=torch.where(tt.child_costs < POS_INF / 2, 0.0, POS_INF),
                     band=torch.where(tt.band < POS_INF / 2, 0.0, POS_INF),
                     eps_block=torch.where(tt.eps_block < POS_INF / 2, 0.0, POS_INF))
    e = np.zeros((2, 12, n_rows), np.float32)
    nf = np.array([12, 7], np.int32)
    for k in (4, 8, 64):
        for big in (None, np.zeros((n_words + 1, n_words), np.float32)):
            want = tbeam.beam_search_ref(_t(e), tt, _t(nf), k,
                                         bigram_cost=None if big is None else _t(big))
            assert_live_equal(k19_beam.beam(e, tt, nf, k, bigram_cost=big), want)


@pytest.mark.parametrize("kind,k,t_len,lm", [("fan", 8, 17, True), ("fan", 40, 17, False),
                                           ("1k", 300, 7, True)])
def test_emulated_kernel_wide_runs_and_many_survivors(kind, k, t_len, lm):
    """A state with more children than half the widest fan-out, whose
    tokens propose their whole run (the fan trie); frames where the
    survivors outnumber k and, on the 1k trie at k = 300, more than 256
    survivors: several runs and two merge rounds.  Live slots against the
    plain version, with two orders of the atomics."""
    tt, n_rows, n_words, rng = _case(kind, k)
    runs = bk.beam_pack(tt).rec[:, 1]
    children = (tt.child_starts.numpy() >= 0).sum(1)
    assert children.max() > tt.child_starts.shape[1] / 2
    assert (children <= 1).mean() > 0.9
    b = 3
    e = rng.uniform(0, 4, (b, t_len, n_rows)).astype(np.float32)
    nf = np.array([t_len, t_len - 2, 1], np.int32)
    big = None
    if lm:
        _, tlm = _bigram(n_words, k)
        big = np.concatenate([tlm.cost, tlm.start_cost[None]]).astype(np.float32)
    want = tbeam.beam_search_ref(_t(e), tt, _t(nf), k,
                                 bigram_cost=None if big is None else _t(big))
    stats = []
    for seed in (0, 1):
        assert_live_equal(k19_beam.beam(e, tt, nf, k, bigram_cost=big, seed=seed, stats=stats),
                          want)
    m_max, rounds = max(x[0] for x in stats), max(x[1] for x in stats)
    assert m_max > k
    fan = int(np.argmax(children))
    assert runs[fan] > children[fan]  # its self-loop, then every child
    if kind == "1k":
        assert m_max > 256 and rounds == 2
    else:  # the fan state held tokens: their whole runs were proposed
        assert (want[3].numpy() == fan).any()


@pytest.mark.parametrize("k", [8, 30])
def test_plain_beam_still_matches_reference(k):
    """The plain version against the JAX beam per utterance (every plane,
    garbage slots included), on the random trie with the bigram."""
    jl_tt = toy_lex("random")
    jl, tl, n_rows = jl_tt
    jt = jbeam.beam_tables(jl.banded, leaf_word=jl.leaf_word)
    tt = tbeam.beam_tables(tl.banded, leaf_word=tl.leaf_word)
    rng = np.random.default_rng(k)
    e = rng.uniform(0, 4, (3, 15, n_rows)).astype(np.float32)
    nf = np.array([15, 8, 1], np.int32)
    _, tlm = _bigram(tl.n_words, k)
    big = np.concatenate([tlm.cost, tlm.start_cost[None]]).astype(np.float32)
    got = tbeam.beam_search_ref(_t(e), tt, _t(nf), k, bigram_cost=_t(big))
    for i in range(3):
        ref = jbeam.beam_search(jnp.asarray(e[i]), jt, jnp.int32(nf[i]), k=k,
                                bigram_cost=jnp.asarray(big))
        for g_, r_ in zip(got, ref):
            np.testing.assert_array_equal(g_[i].numpy(), np.asarray(r_))


def test_cpu_gates_take_the_plain_versions():
    """CPU tensors: ``beam_search`` / ``beam_backtrace`` return the plain
    versions' outputs and count no launch; k below the init states
    raises before either runs."""
    tt, n_rows, _, rng = _case("toy", 1)
    e = _t(rng.uniform(0, 4, (2, 9, n_rows)).astype(np.float32))
    nf = _t(np.array([9, 5], np.int32))
    before = (tbeam.beam_search.launches, tbeam.beam_backtrace.launches)
    got = tbeam.beam_search(e, tt, nf, 8)
    want = tbeam.beam_search_ref(e, tt, nf, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bt = tbeam.beam_backtrace(got[0], got[1], got[4], got[5], tt, nf)
    bt_ref = tbeam.beam_backtrace_ref(got[0], got[1], got[4], got[5], tt, nf)
    assert all(torch.equal(a, b) for a, b in zip(bt, bt_ref))
    assert (tbeam.beam_search.launches, tbeam.beam_backtrace.launches) == before
    with pytest.raises(ValueError, match="init states"):
        tbeam.beam_search(e, tt, nf, tt.init_states.shape[0] - 1)


def _random_walk_inputs(tt, b, t_len, k, rng):
    """Planes and a final frontier of random values, dead slots among
    them: K26 reads whatever it is given."""
    s = tt.n_states
    fst = rng.integers(-1, s, (b, k)).astype(np.int32)
    fst[:, 0] = np.where(rng.random(b) < 0.5, -1, fst[:, 0])
    ends = tt.word_ends.numpy() if hasattr(tt, "word_ends") else \
        np.nonzero(tt.end_slot.numpy() >= 0)[0]
    fst[:, -1] = rng.choice(ends, b)  # a slot at a word end in every stream
    fco = rng.integers(0, 5, (b, k)).astype(np.float32)  # ties: the first minimum
    fco[fst < 0] = POS_INF
    tp = rng.integers(-1, k, (b, t_len, k)).astype(np.int32)
    tw = rng.integers(-1, 9, (b, t_len, k)).astype(np.int32)
    fpd = rng.integers(-1, 12, (b, k)).astype(np.int32)
    return fst, fco, fpd, tp, tw


@pytest.mark.parametrize("k,t_len,window,lm,end,planes", [
    (8, 17, 5, False, False, "beam"),     # T not a multiple of W
    (8, 17, 32, True, True, "beam"),      # one window
    (4, 40, 8, True, False, "beam"),      # the bigram without its end costs
    (1, 23, 8, False, False, "random"),   # k = 1
    (3, 50, 8, True, True, "random"),     # dead final slots, chains that die
    (33, 64, 16, False, False, "random")])
def test_emulated_walk_matches_plain_walk(k, t_len, window, lm, end, planes):
    """K26's window form (``k26_walk.walk``) against ``beam_backtrace_ref``:
    costs and every row, on the plain beam's and on random planes; streams
    of length T, below T, 1, 0 and past T; the windows a stream copies
    are ceil(frames / W) until the chain dies."""
    tt, n_rows, n_words, rng = _case("toy", k + t_len)
    b = 6
    nf = np.array([t_len, t_len - 3, 1, 0, t_len + 4, 2], np.int32)
    big = big_end = None
    if lm:
        v = 12 if planes == "random" else n_words
        big = rng.uniform(0.1, 3, (v + 1, v)).astype(np.float32)
        big_end = rng.uniform(0.1, 2, v).astype(np.float32) if end else None
    if planes == "beam":
        e = rng.uniform(0, 4, (b, t_len, n_rows)).astype(np.float32)
        fst, fco, fpd, _, tp, tw = (x.numpy() for x in tbeam.beam_search_ref(
            _t(e), tt, _t(nf), k, bigram_cost=None if big is None else _t(big)))
    else:
        fst, fco, fpd, tp, tw = _random_walk_inputs(tt, b, t_len, k, rng)
    kw = dict(bigram_cost=None if big is None else _t(big),
              bigram_end=None if big_end is None else _t(big_end))
    c_w, w_w = tbeam.beam_backtrace_ref(_t(fst), _t(fco), _t(tp), _t(tw), tt, _t(nf),
                                        final_pred=_t(fpd), **kw)
    c_g, w_g, copies = k26_walk.walk(fst, fco, tp, tw, tt, nf, window, final_pred=fpd,
                                     bigram_cost=big, bigram_end=big_end)
    np.testing.assert_array_equal(c_g, c_w.numpy())
    np.testing.assert_array_equal(w_g, w_w.numpy())
    n = np.clip(nf, 0, t_len)
    assert (copies <= -(-n // window)).all() and (copies[n > 0] >= 1).all()
    if planes == "beam":
        np.testing.assert_array_equal(copies, -(-n // window))


def test_beam_tables_built_once_per_graph():
    """``beam_tables`` returns the same tables for the same graph and
    device, and builds them anew once the graph changes in place."""
    _, tl, _ = toy_lex("toy")
    g = tvb.BandedGraph(*(x.clone() if isinstance(x, torch.Tensor) else x for x in tl.banded))
    first = tbeam.beam_tables(g, leaf_word=tl.leaf_word)
    assert tbeam.beam_tables(g, leaf_word=tl.leaf_word) is first
    assert tbeam.beam_tables(g) is not first  # other leaf words
    g.band[0, 0] += 1.0
    again = tbeam.beam_tables(g, leaf_word=tl.leaf_word)
    assert again is not first and torch.equal(again.band, g.band)
    pack = bk.device_pack(again, True, "cpu")
    assert bk.device_pack(again, True, "cpu") is pack
    assert bk.device_pack(again, False, "cpu") is not pack


def test_word_lists_from_the_whole_plane():
    """``decode.lextree._word_lists`` gives, for every stream, the words
    of columns T..1 that are >= 0, then column 0, as a loop a stream does."""
    from speech_recognition_tpu_torch.decode.lextree import _word_lists

    rows = np.random.default_rng(5).integers(-3, 6, (9, 14)).astype(np.int32)
    rows[2, 1:] = -1
    assert _word_lists(rows) == [[int(w) for w in r[:0:-1] if w >= 0] + [int(r[0])]
                                 for r in rows]
    assert _word_lists(rows[:0]) == []


def test_token_beam_work_models_count_by_hand():
    """``utils.roofline``'s K19 and K26 models on a one-stream plane:
    frames 0 and 1 kept 2 and 1 live tokens (one at an end state each),
    frame 2 is past the stream's length."""
    from speech_recognition_tpu_torch.utils.roofline import (
        token_beam_floor,
        token_beam_work,
        token_walk_work,
    )

    ts = torch.tensor([[[3, 5, -1], [4, -1, -1], [-1, -1, -1]]], dtype=torch.int32)
    s, c, r, l = 6, 2, 3, 2
    tb = tbeam.BeamTables(
        band=torch.zeros(3, s), child_starts=torch.zeros(s, c, dtype=torch.int64),
        child_costs=torch.zeros(s, c), end_slot=torch.tensor([-1, -1, -1, -1, 0, 1]),
        end_word=torch.zeros(s, dtype=torch.int64), word_starts=torch.zeros(r, dtype=torch.int64),
        eps_block=torch.zeros(r, l), init_states=torch.zeros(2, dtype=torch.int64),
        init_costs=torch.zeros(2), bank_state=torch.zeros(s, dtype=torch.int64),
        end_bonus=torch.zeros(l), n_states=s, n_children=4)
    big = torch.zeros(3, 2)
    # runs: the band moves (s <= 3: 3, s = 4: 2, s = 5: 1) and 2 children
    # each, 27 edges (15 without the children).  U 4: rows 2 x 16; packed
    # tables 16 x (27 + 6 + 2 + 3) and the eps block 24; the bigram's 2
    # entries; planes 108, final 36.  Operations: frame 0 takes the 2 init
    # states, frame 1 the runs of states 3 and 5 (5 + 3, or 3 + 1); ranks
    # 2 log2 2; eps 2 x 3 pairs at 3 (2); second merge 3 x 3
    assert token_beam_work(ts, tb, torch.tensor([2]), 4, bigram_cost=big) == (
        32 + 16 * 38 + 24 + 8 + 108 + 36, 5.0 * 10 + 2 + 3 * 2 * 3 + 3 * 3)
    assert token_beam_work(ts, tb, torch.tensor([2]), 4, has_cross=False) == (
        32 + 16 * 26 + 24 + 108 + 36, 5.0 * 6 + 2 + 2 * 2 * 3 + 3 * 3)
    assert token_walk_work(torch.tensor([2, 0]), 3, 3) == (
        2 * 3 * 32 + 8 * 2 + 4 * 2 * 4 + 8, float(2 * 3 * 4 + 4))
    # the floor: 500 frames of the frame's chain; a round more adds its
    # search and move (8 shared-memory steps) and two barriers
    one, two = (token_beam_floor(torch.tensor([500, 20]), rounds=x) for x in (1, 2))
    assert one == 500 * (26 * 29 + 3 * 283 + 19 * 44 + 5 * 75) / 1.98e9
    assert two - one == pytest.approx(500 * (8 * 29 + 2 * 75) / 1.98e9)


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    """``check_search`` / ``check_walk`` (run before K19 / K26 launch,
    here on CPU tensors) pass the plain version's own inputs and outputs
    and raise on the wrong dtype, shape or a bigram without its
    predecessors."""
    tt, n_rows, n_words, rng = _case("toy", 2)
    e = _t(rng.uniform(0, 4, (2, 7, n_rows)).astype(np.float32))
    nf = _t(np.array([7, 3], np.int32))
    big = torch.zeros((n_words + 1, n_words))
    bk.check_search(e, tt, nf, big)
    with pytest.raises(ValueError, match="float32 emissions"):
        bk.check_search(e.double(), tt, nf, None)
    with pytest.raises(ValueError, match="n_frames"):
        bk.check_search(e, tt, nf[:1], None)
    with pytest.raises(ValueError, match="bigram_cost"):
        bk.check_search(e, tt, nf, big[:-1])
    with pytest.raises(ValueError, match="end_slot"):
        bk.check_search(e, tt._replace(end_slot=tt.end_slot.int()), nf, None)
    fs, fc, fp, _, tp, tw = tbeam.beam_search_ref(e, tt, nf, 8, bigram_cost=big)
    bk.check_walk(fs, fc, tp, tw, tt, nf, fp, big, torch.zeros(n_words))
    with pytest.raises(ValueError, match="final_pred"):
        bk.check_walk(fs, fc, tp, tw, tt, nf, None, big, None)
    with pytest.raises(ValueError, match="tok_prev"):
        bk.check_walk(fs, fc, tp.long(), tw, tt, nf, fp, None, None)
    with pytest.raises(ValueError, match="bigram_end"):
        bk.check_walk(fs, fc, tp, tw, tt, nf, fp, big, torch.zeros(n_words + 1))

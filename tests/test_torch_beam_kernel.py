"""The token beam's kernels on the CPU: K19 (``csrc/token_beam.cu``) and
K26 (``csrc/word_walk.cu``) cannot run here, so their rules are proved on
emulations and plans.

* ``beam_plan``'s tiers at their boundaries, and its layout against the
  kernel's segment sizes by hand;
* the kernel's selection rule (dedup by (cost, tie, position), then the
  k of least (cost, state); ``tests/k19_beam.merge_rule``) against
  ``ops.beam._merge_topk`` on live slots, on hypothesis cases with many
  equal costs, POS_INF candidates and eps tie ranks;
* the emulated kernel (``tests/k19_beam.beam``) over whole tries, flat
  word graphs and the carried bigram, on random and tie-forcing integer
  emissions, against ``beam_search_ref`` on every live slot of every
  plane and of the final frontier (dead slots -1); the plain walk
  ``beam_backtrace_ref`` gives the same words and costs from the
  emulation's planes as from the plain version's; and the plain version
  against the JAX ``beam_search`` as in ``tests/test_torch_beam.py``;
* the gates: CPU tensors take the plain versions and count no launch.

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
from tests import k19_beam
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
    """S 10, k 4, 3 + 2 proposals a token, R 3, L 5, U 7: mmax = min(10,
    20) = 10, P = 16; every segment rounded to 8 bytes."""
    got = bk._layout_bytes(10, 4, 5, 3, 5, 7, staged=True)
    want = (80 + 128 + 40 + 24 + 40) + 7 * 16 + 16 + 7 * 16 + 32
    assert got == want
    assert bk._layout_bytes(10, 4, 5, 3, 5, 7, staged=False) == want - 32


@pytest.mark.parametrize("s,k,c,r,l,u,tier", [
    (9405, 64, 13, 8, 1000, 24, "shared"),     # the 1k trie at k = 64
    (9405, 64, 0, 8, 1000, 24, "shared"),      # ... without cross edges
    (9405, 9405, 13, 8, 1000, 24, "device"),   # the 1k trie at k = S
    (86520, 64, 31, 31, 6250, 93, "device"),   # the dictionary-shaped trie
    (100, 8, 0, 100, 100, 300, "shared"),      # a flat 100-word graph
])
def test_plan_tiers(s, k, c, r, l, u, tier):
    plan = bk.beam_plan(s, k, c, r, l, u)
    assert plan.tier == tier
    assert plan.threads == (bk.THREADS_SHARED if tier == "shared" else bk.THREADS_DEVICE)
    assert plan.nbytes == bk._layout_bytes(s, k, 3 + c, r, l, u, tier == "shared")


@pytest.mark.parametrize("s,k,c", [(9405, 64, 13), (3000, 200, 5), (20000, 16, 2)])
def test_plan_boundary(s, k, c):
    """Shared memory exactly while the staged working set fits the limit;
    one byte less and the device tier takes it (unstaged, so smaller)."""
    need = bk._layout_bytes(s, k, 3 + c, 8, 1000, 24, staged=True)
    at = bk.beam_plan(s, k, c, 8, 1000, 24, limit=need)
    below = bk.beam_plan(s, k, c, 8, 1000, 24, limit=need - 1)
    assert (at.tier, at.nbytes) == ("shared", need)
    assert below.tier == "device"
    assert below.nbytes == bk._layout_bytes(s, k, 3 + c, 8, 1000, 24, staged=False) < need


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
    _, tl, n_rows = toy_lex(kind)
    return tbeam.beam_tables(tl.banded, leaf_word=tl.leaf_word), n_rows, tl.n_words, rng


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


def test_token_beam_work_models_count_by_hand():
    """``utils.roofline``'s K19 and K26 models on a one-stream plane:
    frames 0 and 1 kept 2 and 1 live tokens (one at an end state each),
    frame 2 is past the stream's length."""
    from speech_recognition_tpu_torch.utils.roofline import token_beam_work, token_walk_work

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
    # U 4: rows 2 x 16; tables: band 72, bank rows / end slots / end words
    # 3 x 48, word starts 24, eps 24, init 16 + 8, children 96 + 48; the
    # bigram's 2 entries; planes 108, final 36.  Operations: frame 0 takes
    # the 2 init states, frame 1 2 x 5 candidates; ranks 2 log2 2; eps 2 x
    # 3 pairs at 3; second merge 3 x 3
    tables = 72 + 3 * 48 + 24 + 24 + 16 + 8 + 96 + 48
    assert token_beam_work(ts, tb, torch.tensor([2]), 4, bigram_cost=big) == (
        32 + tables + 8 + 108 + 36, 5.0 * 12 + 2 + 3 * 2 * 3 + 3 * 3)
    assert token_beam_work(ts, tb, torch.tensor([2]), 4, has_cross=False) == (
        32 + tables - 144 + 108 + 36, 5.0 * 8 + 2 + 2 * 2 * 3 + 3 * 3)
    assert token_walk_work(torch.tensor([2, 0]), 3, 3) == (
        2 * 3 * 32 + 8 * 2 + 4 * 2 * 4 + 8, float(2 * 3 * 4 + 4))


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

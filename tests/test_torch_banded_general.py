"""Port vs reference: the general banded path, the plain versions of
kernels K8 (forward on unit-bank emissions, any banded graph, any eps
depth) and K9 (the general backtrace), and ``decode_connected`` on the
graphs that take them.

Graphs: a sausage of 1-state words (every word start is also a word
end, so eps chains run within one frame: eps depth 3 at 4 slots), a
sausage of words of 1 to 4 states, a transcript graph with an optional
layer over those words, and a loop graph with bigram costs (a
non-row-constant eps block).

* K8 / K9's plain versions against the reference's XLA scan
  (``viterbi_banded_tb`` / ``banded_backtrace_tb``) on identical
  emissions, uniform-random and tie-forced (integer-valued): every plane,
  state and flag bit-identical, frozen frames included;
* the same against the reference's Pallas kernels in interpret mode
  (``bank_input=True``; the one-hot backtrace) on emissions without
  ties: final costs bit-identical, planes, states and flags equal below
  each utterance's length;
* ``_decode_banded_batch`` against the reference's Pallas decode path
  (interpret mode) and ``decode_connected`` against the reference's:
  states and words equal, costs at rtol 1e-5 (the emission GEMMs sum in
  different orders).
"""

import functools
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import connected as jconn
from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.ops.viterbi_banded_pallas import (
    banded_backtrace_tb_pallas,
    banded_topology as j_banded_topology,
    viterbi_banded_tb_pallas,
)
from speech_recognition_tpu_torch.decode import connected as tconn
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
from tests import k9_walk
from tests.test_torch_gmm_hmm import both_banks

jvb = importlib.import_module("speech_recognition_tpu.ops.viterbi_banded")

GRAPHS = ["sausage_1state", "sausage_mixed", "transcript_mixed", "loop_lm"]


@functools.lru_cache(maxsize=None)
def case(kind):
    """``(jax bank, torch bank, jax graph, torch graph)`` of one kind."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "sausage_1state":
        jb, tb = both_banks(21, n_models=4, n_states=1, n_mix=2, dim=6)
    else:
        jb, tb = both_banks(22, n_models=4, n_states=4, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    if kind in ("sausage_mixed", "transcript_mixed"):
        trans = [t[:k, :k] for t, k in zip(trans, (2, 1, 3, 4))]  # 2, 1, 3, 4 states
    if kind.startswith("sausage"):
        args, kw = (trans, [list(range(4))] * 4), dict(word_insertion_cost=0.3)
    elif kind == "transcript_mixed":
        args = (trans, [[2], [0, 1], [3], [1]])
        kw = dict(optional_layers=[1], end_layers=[2, 3])
    else:
        lm = types.SimpleNamespace(cost=rng.uniform(0.1, 3.0, (4, 4)).astype(np.float32),
                                   start_cost=rng.uniform(0.1, 2.0, 4).astype(np.float32),
                                   end_cost=rng.uniform(0.1, 2.0, 4).astype(np.float32))
        return jb, tb, *(m.build_loop_graph(trans, lm=lm, word_insertion_cost=0.4)
                         for m in (jgraph, tgraph))
    return jb, tb, *(m.build_word_graph(*args, **kw) for m in (jgraph, tgraph))


def test_graphs_need_the_general_path():
    """Every graph here but the loop is refused by the fused kernels, and
    the 1-state sausage needs one eps pass per slot boundary."""
    for kind in GRAPHS:
        _, _, gj, gt = case(kind)
        assert gt.eps_depth == gj.eps_depth
        topo = vk.banded_topology(tvb.banded_arrays(gt))
        assert topo.fused_ok == (kind == "loop_lm"), kind
    assert case("sausage_1state")[3].eps_depth == 3
    assert not vk.banded_topology(tvb.banded_arrays(case("sausage_1state")[3])).disjoint


def emissions(gt, seed, t, b, ties):
    """``[U, T, B]`` bank emissions: uniform(0, 6), or integers 0..2
    (every band move and re-entry then meets exact ties)."""
    rng = np.random.default_rng(seed)
    u = int(gt.bank_state.max()) + 1
    if ties:
        return rng.integers(0, 3, (u, t, b)).astype(np.float32)
    return rng.uniform(0.0, 6.0, (u, t, b)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["uniform", "ties"])
@pytest.mark.parametrize("kind", GRAPHS)
def test_k8_k9_plain_match_reference_scan(kind, ties):
    _, _, gj, gt = case(kind)
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    topo = vk.banded_topology(bt)
    t, b = 13, 5
    nll = emissions(gt, 31, t, b, ties)
    nf = np.array([13, 1, 0, 7, 12], np.int32)
    nll_tb = np.ascontiguousarray(nll.transpose(1, 0, 2)[:, gt.bank_state, :])
    fj, pj, uj = jvb.viterbi_banded_tb(jnp.asarray(nll_tb), bj, jnp.asarray(nf),
                                       eps_depth=gj.eps_depth)
    before = vk.viterbi_banded_general.launches
    ft, pt, ut = vk.viterbi_banded_general(torch.from_numpy(nll), bt, topo,
                                           torch.from_numpy(nf), gt.eps_depth)
    assert vk.viterbi_banded_general.launches == before  # CPU tensors: the plain version
    assert pt.dtype == torch.int8 and ut.dtype == torch.int8
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    ends = np.asarray(bj.end_states)[np.argmin(
        np.asarray(fj)[np.asarray(bj.end_states)] + np.asarray(bj.end_bonus)[:, None], 0)]
    sj, ej = jvb.banded_backtrace_tb(pj, uj, bj, jnp.asarray(ends), jnp.asarray(nf),
                                     eps_depth=gj.eps_depth)
    before = vk.banded_backtrace_general.launches
    st, et = vk.banded_backtrace_general(pt, ut, bt, torch.from_numpy(ends),
                                         torch.from_numpy(nf), gt.eps_depth)
    assert vk.banded_backtrace_general.launches == before
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_one_state_sausage_chains_reentries_within_a_frame():
    """On 1-state words a state entered in eps pass k is an origin in
    pass k+1.  With a negative emission for word 2 every extra word in a
    frame lowers the cost, so frame 0 chains all four slots in its three
    eps passes; the backtrace unwinds the chain through eps_u."""
    _, _, gj, gt = case("sausage_1state")
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    topo = vk.banded_topology(bt)
    nll = np.full((4, 3, 2), 5.0, np.float32)
    nll[2] = -1.0
    nf = np.array([3, 1], np.int32)
    final, bp8, eps_u = vk.viterbi_banded_general_ref(torch.from_numpy(nll), bt, topo,
                                                     torch.from_numpy(nf), gt.eps_depth)
    starts = bt.word_starts.numpy()
    assert (bp8.numpy()[0, starts[4:]] == tvb._EPS).all()  # slots 2-4, both streams
    # slot k's word 2 entered from slot k-1's word 2 in the same frame
    np.testing.assert_array_equal(eps_u.numpy()[0, 6::4],
                                  np.repeat(4 * np.arange(3)[:, None] + 2, 2, 1))
    nll_tb = np.ascontiguousarray(nll.transpose(1, 0, 2)[:, gt.bank_state, :])
    fj, pj, uj = jvb.viterbi_banded_tb(jnp.asarray(nll_tb), bj, jnp.asarray(nf),
                                       eps_depth=gj.eps_depth)
    np.testing.assert_array_equal(final.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(bp8.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(eps_u.numpy(), np.asarray(uj))
    ends = np.asarray(bj.end_states)[np.argmin(np.asarray(fj)[np.asarray(bj.end_states)], 0)]
    assert (ends == 14).all()  # slot 4's word 2
    sj, ej = jvb.banded_backtrace_tb(pj, uj, bj, jnp.asarray(ends), jnp.asarray(nf),
                                     eps_depth=gj.eps_depth)
    st, et = vk.banded_backtrace_general_ref(bp8, eps_u, bt, torch.from_numpy(ends),
                                             torch.from_numpy(nf), gt.eps_depth)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert et.numpy()[0].all()  # the frame-0 chain was unwound


@pytest.mark.parametrize("kind", GRAPHS)
def test_k8_k9_plain_match_pallas_reference(kind):
    _, _, gj, gt = case(kind)
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    topo = vk.banded_topology(bt)
    t, b = 12, 4
    nll = emissions(gt, 41, t, b, ties=False)
    nf = np.array([12, 1, 9, 5], np.int32)
    j_topo = j_banded_topology(bj)
    fj, pj, uj = viterbi_banded_tb_pallas(jnp.asarray(nll), bj, jnp.asarray(nf), j_topo,
                                          eps_depth=gj.eps_depth, bank_input=True,
                                          input_ubt=True, interpret=True)
    ft, pt, ut = vk.viterbi_banded_general_ref(torch.from_numpy(nll), bt, topo,
                                               torch.from_numpy(nf), gt.eps_depth)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for i, n in enumerate(nf):
        np.testing.assert_array_equal(pt.numpy()[:n, :, i], np.asarray(pj)[:n, :, i])
        np.testing.assert_array_equal(ut.numpy()[:n, :, i], np.asarray(uj)[:n, :, i])
    ends = np.asarray(bj.end_states)[np.argmin(np.asarray(fj)[np.asarray(bj.end_states)], 0)]
    sj, ej = banded_backtrace_tb_pallas(pj, uj, bj, jnp.asarray(ends), jnp.asarray(nf),
                                        j_topo, eps_depth=gj.eps_depth, interpret=True)
    st, et = vk.banded_backtrace_general_ref(pt, ut, bt, torch.from_numpy(ends),
                                             torch.from_numpy(nf), gt.eps_depth)
    for i, n in enumerate(nf):
        np.testing.assert_array_equal(st.numpy()[:n, i], np.asarray(sj)[:n, i])
        np.testing.assert_array_equal(et.numpy()[:n, i], np.asarray(ej)[:n, i])


@pytest.mark.parametrize("kind", GRAPHS)
def test_decode_general_graphs_match_reference(kind):
    jb, tb, gj, gt = case(kind)
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    rng = np.random.default_rng(51)
    feats = rng.standard_normal((5, 14, 6)).astype(np.float32)
    nf = np.array([14, 1, 8, 13, 11], np.int32)
    s_j, e_j, c_j = jconn._decode_banded_batch(
        jb, jnp.asarray(feats), jnp.asarray(nf), bj, eps_depth=gj.eps_depth,
        pallas_topo=j_banded_topology(bj), pallas_interpret=True)
    s_t, e_t, c_t = tconn._decode_banded_batch(
        tb, torch.from_numpy(feats), torch.from_numpy(nf), bt, eps_depth=gt.eps_depth)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)
    for i, n in enumerate(nf):
        np.testing.assert_array_equal(s_t.numpy()[i, :n], np.asarray(s_j)[i, :n])
        np.testing.assert_array_equal(e_t.numpy()[i, :n], np.asarray(e_j)[i, :n])
    for drop in (None, {1}):
        w_j, cw_j = jconn.decode_connected(jb, gj, feats, nf, drop_labels=drop)
        w_t, cw_t = tconn.decode_connected(tb, gt, torch.from_numpy(feats),
                                           torch.from_numpy(nf), drop_labels=drop)
        assert w_t == w_j
        np.testing.assert_allclose(cw_t, np.asarray(cw_j), rtol=1e-5)


def test_general_wrappers_refuse_cross_edges_only_on_cuda_inputs():
    """A lexical tree (cross edges) runs the plain scan on CPU tensors;
    the plain version of K9 is the plain backtrace itself."""
    assert vk.banded_backtrace_general_ref is tvb.banded_backtrace_tb
    _, _, _, gt = case("sausage_mixed")
    bt = tvb.banded_arrays(gt)
    topo = vk.banded_topology(bt)
    with pytest.raises(ValueError, match="mismatch"):
        vk.viterbi_banded_general_ref(torch.zeros((16, 3, 2)), bt,
                                      topo._replace(n_states=topo.n_states + 1),
                                      torch.ones(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K9's window walk (csrc/banded_backtrace.cu), emulated on the CPU by
# tests/k9_walk.py
# ---------------------------------------------------------------------------

def _lr_trans(n, rng):
    """Left-to-right ``[n, n]`` costs ``T[to, from]``: self loops, next
    states and some skips, POS_INF elsewhere."""
    m = np.full((n, n), 1e30, np.float32)
    for i in range(n):
        m[i, i] = rng.uniform(0.1, 1.0)
        if i + 1 < n:
            m[i + 1, i] = rng.uniform(0.1, 1.0)
        if i + 2 < n and rng.uniform() < 0.5:
            m[i + 2, i] = rng.uniform(0.5, 2.0)
    return m


WALK_GRAPHS = {  # model sizes, slots, frames
    "1-state sausage7": ((1, 1, 1, 1), 7, 70),      # eps depth 6, 64-frame windows
    "3-6-state sausage": ((3, 4, 5, 6), 3, 45),
    "word of 40 states": ((40, 3, 2), 3, 25),       # lo is a hint 31 below st
}


@functools.lru_cache(maxsize=None)
def walk_case(kind):
    sizes, slots, t = WALK_GRAPHS[kind]
    rng = np.random.default_rng(sum(map(ord, kind)))
    trans = [_lr_trans(n, rng) for n in sizes]
    layers = [list(range(len(sizes)))] * slots
    gj = jgraph.build_word_graph(trans, layers, word_insertion_cost=0.2)
    gt = tgraph.build_word_graph(trans, layers, word_insertion_cost=0.2)
    return gj, gt, t


@pytest.mark.parametrize("ties", [False, True], ids=["uniform", "ties"])
@pytest.mark.parametrize("kind", list(WALK_GRAPHS))
def test_k9_window_walk_matches_plain_and_pallas(kind, ties):
    """The emulated walk (span hint, reload on leaving the span, unwind at
    the same frame, the eps code left after eps_depth unwinds) equals the
    plain backtrace state for state and flag for flag over every frame,
    and the reference's Pallas backtrace (interpret mode) below each
    length; lengths 0, 1 and T included."""
    gj, gt, t = walk_case(kind)
    if kind == "1-state sausage7":
        assert gt.eps_depth == 6
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    topo = vk.banded_topology(bt)
    b = 6
    nll = emissions(gt, 61 + ties, t, b, ties)
    nf = np.array([t, 0, 1, t // 2, t - 1, t // 3 + 2], np.int32)
    final, bp8, eps_u = vk.viterbi_banded_general_ref(torch.from_numpy(nll), bt, topo,
                                                     torch.from_numpy(nf), gt.eps_depth)
    ends = bt.end_states[torch.argmin(final[bt.end_states] + bt.end_bonus[:, None], 0)]
    sp, fp = vk.banded_backtrace_general_ref(bp8, eps_u, bt, ends, torch.from_numpy(nf),
                                             gt.eps_depth)
    s, f, waited, ahead, unwinds = k9_walk.walk(bp8.numpy(), eps_u.numpy(),
                                                *k9_walk.graph_tables(bt), ends.numpy(), nf,
                                                gt.eps_depth)
    np.testing.assert_array_equal(s, sp.numpy())
    np.testing.assert_array_equal(f, fp.numpy())
    assert waited >= b - 1 and unwinds >= int(fp.sum())  # stream 1 (nf 0) loads none
    sj, ej = banded_backtrace_tb_pallas(jnp.asarray(bp8.numpy()), jnp.asarray(eps_u.numpy()),
                                        bj, jnp.asarray(ends.numpy()), jnp.asarray(nf),
                                        j_banded_topology(bj), eps_depth=gj.eps_depth,
                                        interpret=True)
    for i, n in enumerate(nf):
        np.testing.assert_array_equal(s[:n, i], np.asarray(sj)[:n, i])
        np.testing.assert_array_equal(f[:n, i], np.asarray(ej)[:n, i])


def test_k9_window_walk_takes_the_eps_code_left_after_eps_depth():
    """A plane whose eps chain is longer than eps_depth: after eps_depth
    unwinds the code is still the eps code and the walk steps to st - 4,
    as the plain version does; the word hint of a state with no word start
    within 31 below is st - 31."""
    _, gt, _ = walk_case("1-state sausage7")
    bt = tvb.banded_arrays(gt)
    t, b, s = 3, 1, gt.n_states
    bp8 = np.zeros((t, s, b), np.int8)
    eps_u = np.zeros((t, bt.n_words, b), np.int8)
    starts = bt.word_starts.numpy()
    bp8[2, starts, 0] = 4  # every word start at frame 2 is an eps arrival
    for r in range(4, len(starts)):  # slot k's word 0 from slot k-1's word 0
        eps_u[2, r, 0] = r - 4
    end = np.array([starts[-4]])  # slot 6's word 0: a chain 24 -> 20 -> ... -> 0
    for depth in (1, 2, 3, 5):  # the code left at the chain's last state steps 4 down
        sp, fp = tvb.banded_backtrace_tb(torch.from_numpy(bp8), torch.from_numpy(eps_u), bt,
                                         torch.from_numpy(end), torch.tensor([t]), depth)
        sw, fw, *_ = k9_walk.walk(bp8, eps_u, *k9_walk.graph_tables(bt), end, [t], depth)
        np.testing.assert_array_equal(sw, sp.numpy())
        np.testing.assert_array_equal(fw, fp.numpy())
    assert k9_walk.word_hint(70, np.zeros(80, bool)) == 39
    assert k9_walk.word_hint(5, np.zeros(80, bool)) == 0

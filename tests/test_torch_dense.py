"""Port vs reference: the dense Viterbi (K11's plain version) and the
dense connected decoder.

* ``viterbi_batch`` / ``viterbi`` / ``viterbi_backtrace`` against the
  reference's XLA scan ``ops/viterbi``, bit for bit (final costs and
  both planes over every frame), at eps depth 1 and 2, with ties forced
  by integer emissions and costs, and n_frames 0, 1, mid and T;
* ``viterbi_batch`` against the reference's Pallas kernel
  ``pallas_viterbi`` in interpret mode, shared and per-utterance graphs,
  at n_frames >= 1 (where the kernel writes ``final``);
* ``decode_connected(backend="dense")`` against the reference's dense
  decoder and the port's banded path, and a graph that is not banded
  under ``auto``: words identical, costs at rtol 1e-5 (emission GEMMs
  sum in different orders).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import connected as jconn
from speech_recognition_tpu.ops.pallas_kernels import pallas_viterbi
from speech_recognition_tpu_torch.decode import connected as tconn
from speech_recognition_tpu_torch.ops import viterbi_kernels as tvk
from tests.test_torch_banded import build_graphs
from tests.test_torch_gmm_hmm import both_banks

jv = importlib.import_module("speech_recognition_tpu.ops.viterbi")
tv = importlib.import_module("speech_recognition_tpu_torch.ops.viterbi")

POS_INF = 1e30


def dense_problem(seed, b, t, s, per_item=False, eps=True, ties=False):
    """Numpy float32 inputs: emissions (uniform, or integers 0..2 forcing
    ties), transition and eps matrices with POS_INF holes, init costs
    finite on the first quarter of the states, and n_frames T, 0, 1 and
    random."""
    rng = np.random.default_rng(seed)
    lead = (b,) if per_item else ()

    def mat(p_hole):
        m = (rng.integers(0, 3, lead + (s, s)) if ties
             else rng.uniform(0, 3, lead + (s, s))).astype(np.float32)
        m[rng.uniform(size=m.shape) < p_hole] = POS_INF
        return m

    nll = (rng.integers(0, 3, (b, t, s)) if ties
           else rng.uniform(0, 5, (b, t, s))).astype(np.float32)
    init = rng.uniform(0, 2, lead + (s,)).astype(np.float32)
    init[..., max(1, s // 4):] = POS_INF
    nf = np.r_[t, 0, 1, rng.integers(2, t, max(b - 3, 0))][:b].astype(np.int32)
    return nll, mat(0.5), init, nf, (mat(0.8) if eps else None)


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("per_item", [False, True])
def test_viterbi_batch_matches_reference_scan(depth, ties, per_item):
    nll, trans, init, nf, eps = dense_problem(depth + 2 * ties + 4 * per_item, 5, 24, 12,
                                              per_item=per_item, ties=ties)
    final, bp, eps_bp = tv.viterbi_batch(_t(nll), _t(trans), _t(init), _t(nf), _t(eps),
                                         depth)
    for b in range(len(nf)):
        pick = (lambda x: x[b]) if per_item else (lambda x: x)
        ref = jv.viterbi(jnp.asarray(nll[b]), jnp.asarray(pick(trans)),
                         jnp.asarray(pick(init)), jnp.int32(nf[b]),
                         eps_trans=jnp.asarray(pick(eps)), eps_depth=depth)
        np.testing.assert_array_equal(final[b].numpy(), np.asarray(ref.final_cost))
        np.testing.assert_array_equal(bp[b].numpy(), np.asarray(ref.bp))
        np.testing.assert_array_equal(eps_bp[b].numpy(), np.asarray(ref.eps_bp))
        end = int(np.argmin(np.asarray(ref.final_cost)))
        s_j, e_j = jv.viterbi_backtrace(ref.bp, ref.eps_bp, jnp.int32(end), jnp.int32(nf[b]),
                                        eps_depth=depth)
        s_t, e_t = tv.viterbi_backtrace(bp[b], eps_bp[b], end, int(nf[b]), eps_depth=depth)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    assert (final[1] == POS_INF).all()  # n_frames 0


def test_single_utterance_forms_and_batched_backtrace():
    nll, trans, init, nf, eps = dense_problem(9, 4, 20, 10, eps=False)
    for b in range(4):
        ref = jv.viterbi(jnp.asarray(nll[b]), jnp.asarray(trans), jnp.asarray(init),
                         jnp.int32(nf[b]))
        got = tv.viterbi(_t(nll[b]), _t(trans), _t(init), int(nf[b]))
        for g_, r_ in zip(got, ref[:3]):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
        np.testing.assert_array_equal(
            tv.viterbi_path_cost(_t(nll[b]), _t(trans), _t(init), int(nf[b])).numpy(),
            np.asarray(jv.viterbi_path_cost(jnp.asarray(nll[b]), jnp.asarray(trans),
                                            jnp.asarray(init), jnp.int32(nf[b]))))
    # the batched backtrace equals the per-utterance one
    final, bp, eps_bp = tv.viterbi_batch(_t(nll), _t(trans), _t(init), _t(nf))
    ends = torch.argmin(final, 1)
    states, flags = tv.viterbi_backtrace(bp, eps_bp, ends, _t(nf))
    for b in range(4):
        s1, f1 = tv.viterbi_backtrace(bp[b], eps_bp[b], int(ends[b]), int(nf[b]))
        assert torch.equal(states[b], s1) and torch.equal(flags[b], f1)
    # the rank-threshold beam: the reference's beam_width=3, bit for bit
    for b in range(4):
        ref = jv.viterbi(jnp.asarray(nll[b]), jnp.asarray(trans), jnp.asarray(init),
                         jnp.int32(nf[b]), beam_width=3)
        got = tv.viterbi(_t(nll[b]), _t(trans), _t(init), int(nf[b]), beam_width=3)
        for g_, r_ in zip(got, ref[:3]):
            np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))


def test_planes_off_gives_the_same_final():
    nll, trans, init, nf, eps = dense_problem(10, 6, 30, 5, per_item=True, eps=False)
    full = tv.viterbi_batch(_t(nll), _t(trans), _t(init), _t(nf))
    final, bp, eps_bp = tvk.viterbi_dense(_t(nll), _t(trans), _t(init), _t(nf), planes=False)
    assert bp is None and eps_bp is None
    assert torch.equal(final, full[0])


@pytest.mark.parametrize("per_item", [False, True])
def test_viterbi_batch_matches_pallas_viterbi(per_item):
    """The reference's Pallas kernel in interpret mode (S = one lane tile),
    as its own test runs it; n_frames >= 1."""
    nll, trans, init, _, eps = dense_problem(11 + per_item, 2, 16, 128, per_item=per_item)
    nf = np.asarray([16, 9], np.int32)
    fin, bp, eps_bp = pallas_viterbi(
        jnp.asarray(nll), jnp.asarray(trans), jnp.asarray(init), jnp.asarray(nf),
        eps_trans=jnp.asarray(eps), per_utterance_graph=per_item, interpret=True)
    final, bp_t, eps_bp_t = tv.viterbi_batch(_t(nll), _t(trans), _t(init), _t(nf), _t(eps))
    np.testing.assert_array_equal(final.numpy(), np.asarray(fin))
    np.testing.assert_array_equal(bp_t.numpy(), np.asarray(bp))
    np.testing.assert_array_equal(eps_bp_t.numpy(), np.asarray(eps_bp))


def _feats(seed, b, t, nf):
    f = np.random.default_rng(seed).standard_normal((b, t, 6)).astype(np.float32)
    return f, np.asarray(nf, np.int32)


@pytest.mark.parametrize("kind", ["loop", "sausage", "loop_lm"])
def test_decode_connected_dense_matches_reference_and_banded(kind):
    jb, tb = both_banks(21, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs(kind, trans)
    feats, nf = _feats(22, 5, 18, [18, 1, 9, 17, 12])
    for drop in (None, {1}):
        w_j, c_j = jconn.decode_connected(jb, gj, feats, nf, backend="dense",
                                          drop_labels=drop)
        ft, nt = torch.from_numpy(feats), torch.from_numpy(nf)
        w_d, c_d = tconn.decode_connected(tb, gt, ft, nt, backend="dense", drop_labels=drop)
        w_b, c_b = tconn.decode_connected(tb, gt, ft, nt, backend="banded", drop_labels=drop)
        assert w_d == w_j == w_b
        np.testing.assert_allclose(c_d, np.asarray(c_j), rtol=1e-5)
        np.testing.assert_allclose(c_d, c_b, rtol=1e-5)


def test_graph_that_is_not_banded_decodes_dense_under_auto():
    """A model with a backward arc (state 1 -> 0) has no banded form:
    ``auto`` takes the dense decoder as the reference does, ``banded``
    raises."""
    jb, tb = both_banks(23, n_models=3, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]).copy() for i in range(3)]
    trans[1][0, 1] = 1.5
    gj, gt = build_graphs("loop", trans)
    feats, nf = _feats(24, 4, 16, [16, 3, 11, 8])
    w_j, c_j = jconn.decode_connected(jb, gj, feats, nf)
    w_t, c_t = tconn.decode_connected(tb, gt, torch.from_numpy(feats), torch.from_numpy(nf))
    assert w_t == w_j
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)
    with pytest.raises(ValueError):
        tconn.decode_connected(tb, gt, torch.from_numpy(feats), torch.from_numpy(nf),
                               backend="banded")
    # a beam on a graph that is not banded: the dense decoder ignores it, as
    # the reference's does (ROADMAP C13), under "dense" and under "auto"
    for backend in ("dense", "auto"):
        w_jb, c_jb = jconn.decode_connected(jb, gj, feats, nf, backend=backend, beam_width=4)
        w_tb, c_tb = tconn.decode_connected(tb, gt, torch.from_numpy(feats),
                                            torch.from_numpy(nf), backend=backend,
                                            beam_width=4)
        assert w_tb == w_jb == w_t
        np.testing.assert_array_equal(c_tb, c_t)
        np.testing.assert_allclose(c_tb, np.asarray(c_jb), rtol=1e-5)


# K11's plan: the form and sizes ``dense_plan`` picks (no card needed)
SMEM_LIMIT, N_SM = 227 * 1024, 132  # the H100's, as the kernel library reports them


def occupancy_slots(c, threads, smem, items):
    """A fake of the card's count of co-resident clusters of ``c`` CTAs
    (``viterbi_dense_cluster_slots``): the CTAs one SM holds by shared
    memory and threads, times the SMs, over ``c``."""
    per_sm = max(1, min(SMEM_LIMIT // max(smem, 1), 2048 // threads, 32))
    return N_SM * per_sm // c


def gpc_slots(c, threads, smem, items):
    """The count an H100 gives for clusters of one CTA an SM: 15 of 7 or 8
    CTAs, since a cluster's CTAs share one GPC."""
    return 15 if c >= 7 else occupancy_slots(c, threads, smem, items)


@pytest.mark.parametrize("use_eps", [False, True])
@pytest.mark.parametrize("per_item", [False, True])
def test_dense_plan_every_small_graph(per_item, use_eps):
    """S = 1..64 at several batch sizes: packed below 33 states with
    floor(32 / S) items per warp, a row form above; every form's shared
    memory within the limit, enough CTAs for the batch, nothing refused."""
    for s in range(1, 65):
        for b in (1, 5, 37, 64, 5632):
            p = tvk.dense_plan(b, s, per_item, use_eps, SMEM_LIMIT, N_SM, occupancy_slots)
            assert p.smem == tvk.dense_smem_bytes(p.form, s, per_item, use_eps, *p.params)
            assert p.smem <= SMEM_LIMIT
            if s <= 32:
                assert p.form == "packed" and p.items_per_warp == 32 // s
                assert p.grid * p.warps * p.items_per_warp >= b
            else:
                assert p.form == ("item" if per_item else "cluster")
                assert p.cluster * p.rows >= s and p.grid % p.cluster == 0
                assert p.grid // p.cluster * p.items >= b
                assert p.items in ((1,) if per_item else (1, tvk.CLUSTER_ITEMS))
                if not per_item:  # one item a cluster only where every cluster is resident
                    assert p.items == tvk.CLUSTER_ITEMS or (p.grid <= N_SM and b * p.cluster
                                                             <= N_SM)
                assert p.warps * 32 <= tvk.ROWS_MAX_THREADS
                assert p.warps * 32 // p.lanes >= p.rows  # a lane group per row


def test_dense_plan_main_path_shapes():
    """The isolated shape (5 states, 6 items per warp), the 385-state
    sausage at 64 items (16 clusters of 4 items; an H100 holds 15 clusters
    of 7 or 8 CTAs at once, so the cluster stays the smallest whose matrix
    rows fit, 6 CTAs of 65 rows), the transcript graphs (CTAs sized to S:
    a warp per 8 rows)."""
    iso = tvk.dense_plan(5632, 5, True, False, SMEM_LIMIT, N_SM, occupancy_slots)
    assert (iso.form, iso.items_per_warp, iso.grid) == ("packed", 6, 235)
    saus = tvk.dense_plan(64, 385, False, True, SMEM_LIMIT, N_SM, gpc_slots)
    assert (saus.form, saus.items) == ("cluster", 4)
    assert (saus.cluster, saus.rows, saus.lanes, saus.warps, saus.grid) == (6, 65, 8, 17, 96)
    assert saus.smem >= 2 * 65 * 385 * 4
    tr = tvk.dense_plan(256, 75, True, True, SMEM_LIMIT, N_SM, occupancy_slots)
    assert (tr.form, tr.cluster, tr.lanes, tr.warps, tr.grid) == ("item", 1, 4, 10, 256)


@pytest.mark.parametrize("per_item", [False, True])
def test_dense_plan_boundaries(per_item):
    """Past the largest row form the wide form takes over, past the
    shared-memory frontier the scratch form; one state either side of
    each boundary, and no size is refused."""
    def plan(b, s, use_eps):
        return tvk.dense_plan(b, s, per_item, use_eps, SMEM_LIMIT, N_SM, occupancy_slots)

    forms = []
    for use_eps in (False, True):
        prev = None
        for s in list(range(33, 1200, 7)) + [11622, 11623, 11624, 20000]:
            p = plan(64, s, use_eps)
            assert p.smem <= SMEM_LIMIT
            if prev is not None and p.form != prev.form:  # a boundary: check both sides
                for s2 in (s - 7, s - 1, s, s + 1):
                    q = plan(64, s2, use_eps)
                    assert q.smem <= SMEM_LIMIT
                    assert q.smem == tvk.dense_smem_bytes(q.form, s2, per_item, use_eps,
                                                          *q.params)
            forms.append(p.form)
            prev = p
        assert plan(64, 11622, use_eps).form == "wide"
        assert plan(64, 11623, use_eps).form == "scratch"
        assert plan(64, 700 if per_item else 1100, use_eps).form == "wide"
    assert {"wide", "scratch", "item" if per_item else "cluster"} <= set(forms)
    with pytest.raises(ValueError):
        plan(0, 5, False)

"""Port vs reference: the bigram pipeline's one K7 launch,
``ops.lattice_kernels.rescore_and_walk`` (the per-frame minimum q, the
truncation count, the rescoring DP and the word walk), through its plain
version ``rescore_and_walk_ref`` on CPU tensors.

* q against the reference's ``jnp.min`` over the leaves, each stream's
  truncation count against the reference's ``_lattice_truncation_count``
  on that stream (and their sum on the batch), cost, best leaf and every
  ``pred_w`` entry against the reference's ``lattice_rescore``, the
  walk's leaves and word counts against its ``lattice_words_device``: all
  exact;
* on random planes (dead arcs, entry times at or below 0 on arcs longer
  than ``max_dur``, frames past a stream's length frozen as K6 writes
  them, a stream of length 0) and on the lattice pass's planes of the
  test graphs, with ``max_dur`` below T and off a multiple of 8 (so it
  differs from the ring depth), the dense and the backoff LM;
* ``_decode_lattice_batch`` against the reference's
  ``decode_lextree_bigram``: words equal, costs at rtol 1e-5 (the
  emission GEMMs sum in different orders), the truncation counts summing
  to the reference's warning.

The reference runs as its own tests run it on the CPU (the XLA ring
lookup).  Inputs are made with numpy seeds and handed to both sides.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.langmodel import bigram as jbg
from speech_recognition_tpu.ops import lattice as jlat
from speech_recognition_tpu_torch.ops import lattice as tlat
from speech_recognition_tpu_torch.ops import lattice_kernels as tlk
from speech_recognition_tpu_torch.utils import roofline
from speech_recognition_tpu_torch.utils.numerics import POS_INF
from tests.test_torch_lattice import NF, T, _bigram_case, graphs, j_lattice, lm_for


def random_planes(seed, t, l, nf, max_dur):
    """``[T, L, B]`` reference-layout planes: 15% dead arcs, entry times
    at or below 0 (so arcs from the start longer than ``max_dur``; their
    costs raised, so the best paths hold several words), the frame
    before, inside and beyond the ``max_dur`` window; frames past each
    stream's length repeat its last frame."""
    rng = np.random.default_rng(seed)
    b = len(nf)
    ec = rng.uniform(0, 50, (t, l, b)).astype(np.float32)
    ec[rng.random((t, l, b)) < 0.15] = POS_INF
    tt = np.arange(t)[:, None, None]
    pick = rng.integers(0, 4, (t, l, b))
    tau = np.select([pick == 0, pick == 1, pick == 2],
                    [rng.integers(-2, 1, (t, l, b)), tt - 1,
                     tt - rng.integers(1, max_dur + 1, (t, l, b))],
                    tt - rng.integers(max_dur + 1, max_dur + 6, (t, l, b)))
    tau = np.minimum(tau, tt).astype(np.int32)
    ec[(tau <= 0) & (ec < POS_INF)] += 60.0  # dearer starts: chains of several words
    for j, n in enumerate(nf):
        n = max(int(n), 1)
        ec[n:, :, j], tau[n:, :, j] = ec[n - 1, :, j], tau[n - 1, :, j]
    return ec, tau


def _both(ecj, etj, leaf_word, lm, nf, max_dur, backoff, max_words):
    """The reference's pieces and the port's ``rescore_and_walk_ref`` on
    the same ``[T, L, B]`` planes."""
    t_len = ecj.shape[0]
    lw = np.asarray(leaf_word)
    args = (lm.cost, lm.start_cost, lm.end_cost)
    bo_j = jlat.rescore_backoff(lm, lw) if backoff else None
    rj = jlat.lattice_rescore(jnp.asarray(ecj), jnp.asarray(etj), jnp.asarray(lw),
                              *map(jnp.asarray, args), jnp.asarray(nf), max_dur=max_dur,
                              backoff=bo_j, ring_kernel="xla")
    walk_j = jlat.lattice_words_device(rj.pred_w, rj.ends_tau, rj.best_leaf, jnp.asarray(nf),
                                       max_words=max_words)
    ref = dict(q=np.asarray(jnp.min(jnp.asarray(ecj.transpose(0, 2, 1)), axis=2)),
               count=int(jlat._lattice_truncation_count(jnp.asarray(ecj), jnp.asarray(etj),
                                                        jnp.asarray(nf), max_dur=max_dur)),
               per_stream=[int(jlat._lattice_truncation_count(
                   jnp.asarray(ecj[..., i:i + 1]), jnp.asarray(etj[..., i:i + 1]),
                   jnp.asarray(nf[i:i + 1]), max_dur=max_dur)) for i in range(len(nf))],
               cost=np.asarray(rj.cost), best=np.asarray(rj.best_leaf),
               pred=np.asarray(rj.pred_w).transpose(0, 2, 1),
               leaves=np.asarray(walk_j[0]), n_words=np.asarray(walk_j[1]))
    start_l, end_l, big_ll, bo_t = tlat.lattice_lm(lm, lw, torch.device("cpu"))
    if backoff:
        assert bo_t is not None
    else:
        # the dense recombination on an LM that has the backoff structure
        big_ll, bo_t = torch.from_numpy(np.asarray(lm.cost, np.float32))[lw][:, lw], None
    ec = torch.from_numpy(np.ascontiguousarray(ecj.transpose(0, 2, 1)))
    et = torch.from_numpy(np.ascontiguousarray(etj.transpose(0, 2, 1)))
    q_out = torch.full((t_len, len(nf)), -1.0)
    got = tlk.rescore_and_walk_ref(ec, et, start_l, end_l, torch.from_numpy(nf),
                                   tlat._ring_depth(t_len, max_dur), max_dur, max_words,
                                   big_ll=big_ll, backoff=bo_t, q_out=q_out)
    return ref, got, q_out


def _assert_equal(ref, got, q_out):
    cost, best, pred, n_trunc, leaves, n_words = got
    assert n_trunc.dtype == leaves.dtype == n_words.dtype == best.dtype == torch.int32
    np.testing.assert_array_equal(q_out.numpy().view(np.int32), ref["q"].view(np.int32))
    np.testing.assert_array_equal(n_trunc.numpy(), ref["per_stream"])
    assert int(n_trunc.sum()) == ref["count"]
    np.testing.assert_array_equal(cost.numpy(), ref["cost"])
    np.testing.assert_array_equal(best.numpy(), ref["best"])
    np.testing.assert_array_equal(pred.numpy(), ref["pred"])
    np.testing.assert_array_equal(leaves.numpy(), ref["leaves"])
    np.testing.assert_array_equal(n_words.numpy(), ref["n_words"])


@pytest.mark.parametrize("t_len,l,max_dur,backoff,seed", [
    (40, 30, 5, True, 1),     # max_dur off a multiple of 8: dmax = 8
    (40, 30, 11, False, 2),   # the dense recombination, dmax = 16
    (40, 30, 128, True, 3),   # nothing truncated
    (33, 17, 13, True, 4),
    (25, 64, 9, False, 5),
    (60, 9, 3, True, 6),      # chains of many short words
])
def test_rescore_and_walk_ref_matches_reference_on_random_planes(t_len, l, max_dur, backoff,
                                                                 seed):
    nf = np.array([t_len, 0, 1, t_len // 2, t_len - 1, 7], np.int32)
    ecj, etj = random_planes(seed, t_len, l, nf, max_dur)
    lm = jbg.fit_bigram([[int(x) for x in np.random.default_rng(seed).integers(0, l, 6)]
                         for _ in range(12)], l)
    ref, got, q_out = _both(ecj, etj, np.arange(l), lm, nf, max_dur, backoff, t_len)
    _assert_equal(ref, got, q_out)
    if max_dur < t_len:
        assert ref["count"] > 0 and ref["per_stream"][1] == 0  # nf = 0 counts nothing
        # arcs from the start (tau <= 0) longer than max_dur are counted
        ts = np.arange(t_len)[:, None, None]
        from_start = (etj <= 0) & (ts - etj > max_dur) & (ecj < POS_INF / 2) & (ts < nf)
        assert from_start.any()
    assert int(got[5].max()) > 1  # chains of more than one word


@pytest.mark.parametrize("kind,lm_kind,backoff,max_dur", [
    ("toy", "fit", True, 5),
    ("toy", "random", False, 11),
    ("random50", "fit", True, 13),
    ("toy_unigram", "fit", False, 128),
])
def test_rescore_and_walk_ref_matches_reference_on_lattices(kind, lm_kind, backoff, max_dur):
    """The lattice pass's planes of the test graphs (frozen frames past
    each length, a stream of length 0, NF's lengths), cut to the
    decode's ``max_words`` and at one word short of the longest chain."""
    _, _, ecj, etj = j_lattice(kind)
    jg, tg, _ = graphs(kind)
    lm = lm_for(lm_kind, len(jg.words), seed=len(kind) + max_dur)
    for max_words in (T, 3):
        ref, got, q_out = _both(ecj, etj, tg.leaf_word, lm, NF, max_dur, backoff, max_words)
        _assert_equal(ref, got, q_out)
    if max_dur < T:
        assert ref["count"] > 0


def test_rescore_and_walk_takes_the_plain_version_on_cpu():
    """CPU tensors take ``rescore_and_walk_ref`` whatever plan is passed,
    count no launch, and give the pieces the parent composed: the amin,
    ``rescore_lattice`` and ``lattice_words_device``."""
    nf = np.array([30, 0, 12, 29], np.int32)
    ecj, etj = random_planes(8, 30, 21, nf, 6)
    ec = torch.from_numpy(np.ascontiguousarray(ecj.transpose(0, 2, 1)))
    et = torch.from_numpy(np.ascontiguousarray(etj.transpose(0, 2, 1)))
    lm = jbg.fit_bigram([[1, 2, 3], [4, 5, 1, 2]], 21)
    start_l, end_l, big_ll, bo = tlat.lattice_lm(lm, np.arange(21), torch.device("cpu"))
    nf_t = torch.from_numpy(nf)
    before = (tlk.rescore_and_walk.launches, tlk.rescore_lattice.launches,
              tlk.lattice_walk.launches)
    plan = tlk.rescore_plan(21, bo[1].shape[1], False, 227 * 1024)._replace(leaves=0)
    got = tlk.rescore_and_walk(ec, et, start_l, end_l, nf_t, 8, 6, 30, backoff=bo, plan=plan,
                               trace=torch.zeros((4, 4), dtype=torch.int64))
    assert (tlk.rescore_and_walk.launches, tlk.rescore_lattice.launches,
            tlk.lattice_walk.launches) == before
    cost, best, pred = tlk.rescore_lattice(ec, et, ec.amin(2), start_l, end_l, nf_t, 8,
                                           backoff=bo)
    walk = tlat.lattice_words_device(pred.transpose(1, 2), et.transpose(1, 2), best, nf_t, 30)
    count = tlat._lattice_truncation_count(ec.transpose(1, 2), et.transpose(1, 2), nf_t, 6)
    for a, b in zip(got, (cost, best, pred, None, *walk)):
        assert b is None or torch.equal(a, b)
    assert got[3].shape == (4,) and int(got[3].sum()) == int(count) > 0
    assert got[4].shape == (30, 4) and int(got[5][1]) == 0 and bool((got[4][:, 1] == -1).all())


@pytest.mark.parametrize("lm_kind,max_dur", [("fit", 128), ("random", 16)])
def test_decode_lattice_batch_matches_reference(lm_kind, max_dur):
    """``_decode_lattice_batch`` (one ``rescore_and_walk`` after K6's
    plain version) gives the reference decoder's words and costs, and its
    truncation counts sum to the count the reference warns of."""
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology

    jb, tb, jg, tg, words, ids = _bigram_case(31)
    lm = (jbg.fit_bigram([[0, 1, 2], [5, 3, 1], [4, 4, 6]], len(words)) if lm_kind == "fit"
          else lm_for("random", len(words), seed=3))
    rng = np.random.default_rng(33)
    means = np.asarray(jb.means)[:, :, 0, :]  # [U, S, D]
    feats = rng.standard_normal((6, 70, 6)).astype(np.float32)
    nf = np.array([70, 70, 0, 1, 23, 70], np.int32)
    for i, seq in enumerate([["ab", "ca"], ["cab", "ba", "ab"]]):
        f = [means[ids[ch], j] for w in seq for ch in w for j in range(3) for _ in range(3)]
        feats[i, : len(f)] = f
        nf[i] = len(f)
    feats[5] = means[ids["b"], 0]  # one word held for 70 frames: a long arc
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        w_j, c_j = jlat.decode_lextree_bigram(jb, jg, lm, feats, nf, backend="xla",
                                              max_dur=max_dur)
    g = tg.banded
    lr, nw, cost, n_trunc = tlat._decode_lattice_batch(
        tb, torch.from_numpy(feats), torch.from_numpy(nf), g, lex_topology(g),
        tlat.lattice_lm(lm, tg.leaf_word, torch.device("cpu")), tg.n_states // tg.n_arcs,
        max_dur)
    assert n_trunc.shape == (6,) and n_trunc.dtype == torch.int32
    lw = np.asarray(tg.leaf_word)
    lr, nw = lr.numpy(), nw.numpy()
    assert [lw[lr[: nw[i], i][::-1]].tolist() for i in range(6)] == w_j
    np.testing.assert_allclose(cost.numpy(), np.asarray(c_j), rtol=1e-5)
    warned = [r for r in rec if issubclass(r.category, RuntimeWarning)]
    if max_dur < 70:
        assert int(n_trunc.sum()) > 0 and len(warned) == 1
        assert f"{int(n_trunc.sum())} live lattice arc(s)" in str(warned[0].message)
    else:
        assert int(n_trunc.sum()) == 0 and not warned


def test_rescore_walk_work_model():
    """The fused launch's bound model: inputs once (no q plane), pred_w,
    cost, best leaf and the counts written, the walk's rows and word
    counts written; rescore_ops plus 5 operations a leaf and frame and 4
    a word."""
    n_words = torch.tensor([3, 0, 1], dtype=torch.int32)
    n_b, n_ops = roofline.rescore_walk_work(1000, 10, 3, 7, 2, False, n_words, 5)
    assert n_b == 1000 + 10 * 3 * 7 * 4 + 3 * 4 * 3 + 4 * 3 * 6
    assert n_ops == roofline.rescore_ops(10, 3, 7, 2, False) + 5.0 * 10 * 3 * 7 + 4.0 * 4

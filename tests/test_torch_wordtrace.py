"""Port vs reference: the word-trace backend, the plain version of kernel
K10 (fused emission + forward with entry-time side planes) and
``wordtrace_words_device``.

* K10's DP on given bank emissions against the reference's
  ``viterbi_banded_wordtrace_pallas`` (interpret mode, compact bank
  input): final costs bit-identical; eps_u / eps_tau equal below each
  utterance's length; final_tau equal at every state a path reaches;
* the whole plain K10 (K13's plain GEMM emission, then the DP) against
  the reference's fused-emission form at rtol 1e-5 (different summation
  orders), and its final costs equal to the plain K1's on the same
  inputs (one emission, one band and eps rule);
* ``wordtrace_words_device`` against the reference's walk on the same
  planes: identical words;
* ``decode_connected(backend="wordtrace")`` against the reference's
  ``_decode_banded_words`` (interpret mode) and against the port's own
  states path, on loop and sausage graphs with repeated words: words
  identical, costs at rtol 1e-5;
* graphs the word trace does not take raise ``ValueError``.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import connected as jconn
from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.ops.gmm import augment_dtb, gmm_emission_weights
from speech_recognition_tpu.ops.viterbi_banded_pallas import (
    banded_topology as j_banded_topology,
    viterbi_banded_wordtrace_pallas,
    wordtrace_words_device as j_walk,
)
from speech_recognition_tpu_torch.decode import connected as tconn
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.ops import gmm as tgmm
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
from tests.test_torch_banded import build_graphs
from tests.test_torch_gmm_hmm import bank_params, both_banks

jvb = importlib.import_module("speech_recognition_tpu.ops.viterbi_banded")

KINDS = ["loop", "loop_lm", "sausage", "sausage_lm"]


@functools.lru_cache(maxsize=None)
def graphs(kind):
    jb, tb = both_banks(61, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs(kind, trans)
    return jb, tb, gj, gt, jvb.banded_arrays(gj), tvb.banded_arrays(gt)


@functools.lru_cache(maxsize=None)
def reference_trace(kind):
    """Shared emissions and the reference kernel's planes of one kind."""
    _, _, gj, gt, bj, bt = graphs(kind)
    rng = np.random.default_rng(sum(map(ord, kind)))
    t, b = 15, 5
    nll = rng.uniform(0.0, 6.0, (int(gt.bank_state.max()) + 1, t, b)).astype(np.float32)
    nf = np.array([15, 1, 9, 14, 6], np.int32)
    ref = viterbi_banded_wordtrace_pallas(jnp.asarray(nll), bj, jnp.asarray(nf),
                                          j_banded_topology(bj), input_ubt=True,
                                          interpret=True)
    return nll, nf, [np.array(x) for x in ref]


@pytest.mark.parametrize("kind", KINDS)
def test_k10_dp_matches_pallas_reference(kind):
    _, _, _, gt, _, bt = graphs(kind)
    nll, nf, (r_final, r_eu, r_et, r_ftau) = reference_trace(kind)
    final, eps_u, eps_tau, ftau = vk._wordtrace_dp(torch.from_numpy(nll), bt,
                                                   torch.from_numpy(nf))
    assert eps_u.dtype == torch.int8 and eps_tau.dtype == torch.int32
    assert ftau.dtype == torch.int32
    np.testing.assert_array_equal(final.numpy(), r_final)
    live = r_final < 1e29
    np.testing.assert_array_equal(ftau.numpy()[live], r_ftau[live])
    for i, n in enumerate(nf):
        np.testing.assert_array_equal(eps_u.numpy()[:n, :, i], r_eu[:n, :, i])
        np.testing.assert_array_equal(eps_tau.numpy()[:n, :, i], r_et[:n, :, i])
    # re-entries happened, and every recorded entry time precedes its frame
    assert (eps_tau.numpy() > 0).any()
    t_idx = np.arange(nll.shape[1])[:, None, None]
    assert (eps_tau.numpy() < np.maximum(t_idx, 1)).all()


@pytest.mark.parametrize("kind", KINDS)
def test_wordtrace_walk_matches_reference(kind):
    _, _, _, gt, bj, bt = graphs(kind)
    nll, nf, (r_final, r_eu, r_et, r_ftau) = reference_trace(kind)
    ends = np.asarray(bj.end_states)
    best = ends[np.argmin(r_final[ends] + np.asarray(bj.end_bonus)[:, None], 0)]
    w = j_banded_topology(bj).uniform_w
    entry = r_ftau[best, np.arange(len(nf))]
    max_words = nll.shape[1] // w + 1
    wj, nj = j_walk(jnp.asarray(r_eu), jnp.asarray(r_et), jnp.asarray(best // w),
                    jnp.asarray(entry), jnp.asarray(nf), max_words=max_words)
    wt, nt = vk.wordtrace_words_device(
        *[torch.from_numpy(x) for x in (r_eu, r_et, best // w, entry, nf)])
    # the port writes T + 1 rows, which hold every chain; the reference
    # stops after max_words steps, which hold every word here
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    k = min(wt.shape[0], max_words)
    np.testing.assert_array_equal(wt.numpy()[:k], np.asarray(wj)[:k])
    assert (wt.numpy()[k:] == -1).all() and (np.asarray(wj)[k:] == -1).all()
    assert wt.shape[0] == nll.shape[1] + 1 and nt.numpy().max() <= wt.shape[0]


@pytest.mark.parametrize("kind", ["loop_lm", "sausage"])
def test_k10_plain_matches_fused_pallas_reference(kind):
    jb, tb, _, gt, bj, bt = graphs(kind)
    feats = np.random.default_rng(64).standard_normal((4, 12, 6)).astype(np.float32)
    nf = np.array([12, 1, 7, 10], np.int32)
    w_j, lw_j = gmm_emission_weights(*jb.flat_states())
    ref = viterbi_banded_wordtrace_pallas(
        augment_dtb(jnp.asarray(feats)), bj, jnp.asarray(nf), j_banded_topology(bj),
        input_ubt=True, fuse_emission=True, bank_gemm=(w_j, lw_j), interpret=True)
    w, lw = tgmm.gmm_emission_weights(*tb.flat_states())
    xa = tgmm.augment_dtb(torch.from_numpy(feats))
    topo = vk.banded_topology(bt)
    before = vk.viterbi_banded_wordtrace.launches
    got = vk.viterbi_banded_wordtrace(xa, w, lw, bt, topo, torch.from_numpy(nf))
    assert vk.viterbi_banded_wordtrace.launches == before  # CPU: the plain version
    want = vk.viterbi_banded_wordtrace_ref(xa, w, lw, bt, topo, torch.from_numpy(nf))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5)
    for i, n in enumerate(nf):
        for k in (1, 2):
            np.testing.assert_array_equal(got[k].numpy()[:n, :, i], np.asarray(ref[k])[:n, :, i])


@pytest.mark.parametrize("kind", KINDS)
def test_k10_plain_final_equals_k1_plain(kind):
    """The plain K10 and the plain K1 share K13's plain emission, the
    min-chain band and the eps rule, so their final costs are equal bit
    for bit; K10's entry times at word starts are entry frames."""
    _, tb, _, _, _, bt = graphs(kind)
    rng = np.random.default_rng(68)
    feats = torch.from_numpy(rng.standard_normal((5, 14, 6)).astype(np.float32))
    nf = torch.tensor([14, 0, 1, 9, 13], dtype=torch.int32)
    w, lw = tgmm.gmm_emission_weights(*tb.flat_states())
    xa = tgmm.augment_dtb(feats)
    topo = vk.banded_topology(bt)
    k10 = vk.viterbi_banded_wordtrace_ref(xa, w, lw, bt, topo, nf)
    k1 = vk.viterbi_banded_fused_ref(xa, w, lw, bt, topo, nf)
    assert torch.equal(k10[0], k1[0])
    assert bool((k10[0][:, 1] == 1e30).all()) and bool((k10[3][:, 1] == 0).all())
    assert bool(((k10[3] >= 0) & (k10[3] < 14)).all())


def planted(bank_means, seqs, rng):
    """Features that plant word strings (3 frames per state, state means
    plus noise), as the reference's word-trace test builds them."""
    fs = []
    for seq in seqs:
        rows = []
        for w in seq:
            for s in range(bank_means.shape[1]):
                rows += [bank_means[w, s, 0] + 0.1 * rng.standard_normal(6)] * 3
        fs.append(np.asarray(rows, np.float32))
    nf = np.array([len(x) for x in fs], np.int32)
    feats = np.zeros((len(seqs), nf.max(), 6), np.float32)
    for i, x in enumerate(fs):
        feats[i, : len(x)] = x
    return feats, nf


@pytest.mark.parametrize("kind", ["loop", "sausage4"])
def test_wordtrace_backend_matches_reference_and_states_path(kind):
    """Repeated words (a re-entry into the same slot) and variable lengths."""
    jb, tb = both_banks(65, n_models=4, n_states=3, n_mix=1, dim=6, sep=6.0)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    rng = np.random.default_rng(66)
    seqs = [[0, 1, 1, 2], [3, 0], [2, 2, 2], [1]]
    feats, nf = planted(np.asarray(jb.means), seqs, rng)
    if kind == "loop":
        gj = jgraph.build_loop_graph(trans, word_insertion_cost=0.2)
        gt = tgraph.build_loop_graph(trans, word_insertion_cost=0.2)
    else:
        gj, gt = jconn.connected_graph_arrays(jb, 4), tconn.connected_graph_arrays(tb, 4)
    bj = jvb.banded_arrays(gj)
    w_j, c_j = jconn._decode_banded_words(jb, gj, bj, feats, nf, j_banded_topology(bj),
                                          interpret=True)
    before = vk.viterbi_banded_wordtrace.launches
    w_t, c_t = tconn.decode_connected(tb, gt, torch.from_numpy(feats), torch.from_numpy(nf),
                                      backend="wordtrace")
    assert vk.viterbi_banded_wordtrace.launches == before
    assert w_t == w_j
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)
    w_a, c_a = tconn.decode_connected(tb, gt, torch.from_numpy(feats), torch.from_numpy(nf))
    assert w_t == w_a
    np.testing.assert_allclose(c_t, c_a, rtol=1e-5)
    # a word repeated back to back: two re-entries into the same slot
    assert any(a == b for s in w_t for a, b in zip(s, s[1:]))
    w_d, _ = tconn.decode_connected(tb, gt, torch.from_numpy(feats), torch.from_numpy(nf),
                                    backend="wordtrace", drop_labels={2})
    assert w_d == [[x for x in s if x != 2] for s in w_t]


def test_wordtrace_refuses_other_graphs():
    jb, tb = both_banks(67, n_models=4, n_states=3, n_mix=1, dim=6)
    trans = [tb.trans_cost[i].numpy() for i in range(4)]
    feats = torch.zeros((2, 5, 6))
    nf = torch.tensor([5, 3], dtype=torch.int32)
    mixed = [trans[0][:2, :2]] + trans[1:]  # words of 2 and 3 states
    one_state = [t[:1, :1] for t in trans]  # every start is also an end
    for model_trans in (mixed, one_state):
        graph = tgraph.build_word_graph(model_trans, [[0, 1, 2, 3]] * 2)
        with pytest.raises(ValueError, match="uniform word graph"):
            tconn.decode_connected(tb, graph, feats, nf, backend="wordtrace")
        bg = tvb.banded_arrays(graph)
        w, lw = tgmm.gmm_emission_weights(*tb.flat_states())
        with pytest.raises(ValueError, match="word-trace"):
            vk.viterbi_banded_wordtrace_ref(tgmm.augment_dtb(feats), w, lw, bg,
                                            vk.banded_topology(bg), nf)
    # with a beam, "wordtrace" runs the banded beam route, as the reference's
    # does (ROADMAP C4), on any banded graph
    for model_trans in (trans, mixed):
        jw, jc = jconn.decode_connected(jb, jgraph.build_loop_graph(model_trans),
                                        feats.numpy(), nf.numpy(), backend="wordtrace",
                                        beam_width=4)
        tg_ = tgraph.build_loop_graph(model_trans)
        tw, tc = tconn.decode_connected(tb, tg_, feats, nf, backend="wordtrace", beam_width=4)
        bw, bc = tconn.decode_connected(tb, tg_, feats, nf, backend="banded", beam_width=4)
        assert tw == jw == bw
        np.testing.assert_array_equal(tc, bc)
        np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-5)


def test_wordtrace_keeps_every_word_on_skip_arcs():
    """Skip arcs let a 5-state word pass in 3 frames, so a 12-frame
    utterance holds more than the reference walk's 12 // 5 + 1 = 3 words;
    the port's walk runs until every chain ends and agrees with the
    states path."""
    _, tb = both_banks(17, n_models=3, n_states=5, n_mix=2, dim=6)
    trans = [tb.trans_cost[i].numpy().copy() for i in range(3)]
    for tr in trans:
        for i in range(3):
            tr[i + 2, i] = 0.05  # cheap skip arcs
    tb.trans_cost.copy_(torch.from_numpy(np.stack(trans)))
    graph = tgraph.build_loop_graph(trans, word_insertion_cost=-1000.0)
    feats = torch.from_numpy(np.random.default_rng(18).standard_normal((3, 12, 6))
                             .astype(np.float32))
    nf = torch.tensor([12, 12, 9], dtype=torch.int32)
    w_t, c_t = tconn.decode_connected(tb, graph, feats, nf, backend="wordtrace")
    w_a, c_a = tconn.decode_connected(tb, graph, feats, nf)
    assert w_t == w_a and max(len(w) for w in w_t) > 12 // 5 + 1
    np.testing.assert_allclose(c_t, c_a, rtol=1e-5)

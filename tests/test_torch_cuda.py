"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small shapes and the edge cases the main-path shapes miss.

Marked ``cuda``: without a CUDA device these tests skip (decided in a
fixture, at run time).  The GPU host has no jax, so this file imports
none, and it is run there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K1 final costs rtol 1e-5 (emission GEMM summation order),
K1 planes / K2 / words exact, K3 rtol 2e-3 / atol 5e-4, K14 (the MFCC-39
tail) exact for raw features and rtol 1e-4 / atol 1e-4 standardized (the
mean and variance summed in another order).  K4 (the
lexical-tree forward), K5 (its backtrace), K6 (the lattice pass), K7
(the lattice rescorer), K8 (the banded forward on bank emissions) and K9
(the general backtrace) are fed the plain version's own inputs, so every
output is compared exactly; K10 (the word-trace forward = K13 + the DP's
word-trace mode) is compared exactly with its plain DP on K13's own
plane, and its final costs at rtol 1e-5 with the whole plain version and
with K1; K13 (the bank emission) at rtol 1e-5 / atol 1e-4.  K11 (the dense Viterbi) is fed its
plain version's own inputs and compared exactly, both planes over every
frame; K12 (the MFCC cepstra) at K3's rtol 2e-3 / atol 5e-4.  K15 / K16 (the
banded and dense forward-backward) against their plain versions: log Z
at rtol 1e-5, gamma at atol 1e-4, xi at rtol 1e-4 / atol 1e-3 (the same
IEEE expf / logf on both sides; only the sums over frames and over a
row's origins run in other orders), past shared memory too (their
device-row tier), and K13's chunked form past ~450 feature dimensions
at K13's tolerance.  K9's cross mode is held exactly
to the plain backtrace on tries' exact and beam planes; the pruned
forward and the spell checker run the same tensor ops on the card as on
the CPU and are compared exactly.  K19 (the token beam's frame loop) and
K26 (its walk) are held to ``beam_search_ref`` / ``beam_backtrace_ref``
on the card's own tensors: every live slot of the token planes and the
final frontier, costs and words exactly (K19 writes -1 on dead slots).  K21-K23 (the dense
backtrace, in each of its forms; the lattice word walk, the word-trace
walk) walk the plain versions' own planes and are compared exactly, K23's
T + 1 rows included; the bigram pipeline's K7 launch (``rescore_and_walk``:
q, the truncation count, the DP and K22's walk as its last step) is held
to ``rescore_and_walk_ref`` bit for bit in every K7 plan.  Decodes
on the card against the CPU
(emission GEMMs on two devices) compare words exactly and costs at rtol
1e-5.
"""

import importlib
import os
import types

import numpy as np
import pytest
import torch

from speech_recognition_tpu_torch.data.synthetic import random_gmm_hmm
from speech_recognition_tpu_torch.ops.frontend import FrontendConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda", 0)


def _bank(n_models, n_states, n_mix, dim, seed=0):
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

    rng = np.random.default_rng(seed)
    ps = [random_gmm_hmm(rng, n_states=n_states, n_mix=n_mix, dim=dim, sep=3.0)
          for _ in range(n_models)]
    return HMMBank.from_numpy(
        np.stack([p["means"] for p in ps]), np.log(np.stack([p["variances"] for p in ps])),
        np.log(np.stack([p["weights"] for p in ps])),
        np.stack([to_cost_matrix(p["trans"]) for p in ps]))


@pytest.mark.parametrize("rate,lens,norm", [
    (16000, [16000, 7321, 400, 123, 16000, 561], "utterance"),
    (16000, [9000, 16000], "none"),
    (16000, [16000, 300, 500, 700, 9000], "utterance"),  # nf 1, 2, 3: one-sided rows
    (16000, [16000, 300, 500, 700], "none"),
    (8000, [8000, 3000, 5555], "utterance"),
    (48000, [48000, 20000, 1000], "utterance"),  # 1200-sample frames fold onto the FFT
    (44100, [30000, 44100], "none"),
])
def test_k3_matches_plain(dev, rate, lens, norm):
    from speech_recognition_tpu_torch.ops.frontend import padded_length
    from speech_recognition_tpu_torch.ops.frontend_kernel import (
        mfcc39_fused,
        mfcc39_fused_ref,
        mfcc_tail,
    )

    cfg = FrontendConfig(sample_rate=rate)
    rng = np.random.default_rng(1)
    sig = (rng.standard_normal((len(lens), padded_length(cfg, max(lens)))) * 3000)
    sig = torch.from_numpy(sig.astype(np.float32)).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = (mfcc39_fused.launches, mfcc_tail.launches)
    got, nf_k = mfcc39_fused(sig, ln, cfg, norm=norm)
    want, nf_p = mfcc39_fused_ref(sig, ln, cfg, norm=norm)
    torch.cuda.synchronize()
    assert (mfcc39_fused.launches, mfcc_tail.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(nf_k, nf_p)
    scale = 1.0 if norm == "utterance" else want.abs().amax((0, 1)).clamp(min=1.0)
    torch.testing.assert_close(got / scale, want / scale, rtol=2e-3, atol=5e-4)
    for i, n in enumerate(nf_k.tolist()):
        assert bool((got[i, n:] == 0).all())


def test_k3_through_mfcc39_auto_past_shared_memory(dev):
    """A 25 s cap (2,499 frames, past the 1,967 whose cepstra and deltas
    once had to fit in shared memory): mfcc39_auto runs K3's two launches,
    the frame-parallel cepstra kernel and K14, neither with a frame limit;
    equal to the plain version within rtol 2e-3 / atol 5e-4."""
    from speech_recognition_tpu_torch.ops.frontend import mfcc39_auto, padded_length
    from speech_recognition_tpu_torch.ops.frontend_kernel import (
        mfcc39_fused,
        mfcc39_fused_ref,
        mfcc_fused,
        mfcc_tail,
    )

    cfg = FrontendConfig()
    lens = [400000, 31000, 16000, 561]
    rng = np.random.default_rng(4)
    sig = rng.standard_normal((len(lens), padded_length(cfg, 400000))) * 3000
    sig = torch.from_numpy(sig.astype(np.float32)).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = (mfcc39_fused.launches, mfcc_tail.launches, mfcc_fused.launches)
    got, nf_k = mfcc39_auto(sig, ln, cfg)
    want, nf_p = mfcc39_fused_ref(sig, ln, cfg)
    torch.cuda.synchronize()
    assert (mfcc39_fused.launches, mfcc_tail.launches, mfcc_fused.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    assert got.shape[1] == 2499
    assert torch.equal(nf_k, nf_p)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=5e-4)
    for i, n in enumerate(nf_k.tolist()):
        assert bool((got[i, n:] == 0).all())


@pytest.mark.parametrize("norm", ["utterance", "none"])
def test_k14_matches_plain(dev, norm):
    """K14 alone on given cepstra with nf 0, 1, 2, 3, F and others against
    its plain version ``_stack39``: deltas bit-identical (the same single
    subtractions), standardized features at rtol 1e-4 / atol 1e-4 (sums
    in another order); rows >= nf zeros."""
    from speech_recognition_tpu_torch.ops.frontend import _stack39
    from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc_tail

    rng = np.random.default_rng(9)
    f = 57
    ceps = rng.standard_normal((7, f, 13)).astype(np.float32) * 5
    nf = np.array([0, 1, 2, 3, f, 20, 41], np.int32)
    ceps[np.arange(f)[None, :] >= nf[:, None]] = 0.0
    ceps, nf = torch.from_numpy(ceps).to(dev), torch.from_numpy(nf).to(dev)
    before = mfcc_tail.launches
    got = mfcc_tail(ceps, nf, norm)
    want = _stack39(ceps, nf, norm)
    torch.cuda.synchronize()
    assert mfcc_tail.launches == before + 1
    if norm == "none":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for i, n in enumerate(nf.tolist()):
        assert bool((got[i, n:] == 0).all())


@pytest.mark.parametrize("kind,b,t,n_models", [
    ("loop", 3, 17, 4),       # B < the smallest tile
    ("sausage", 11, 15, 4),   # B not a multiple of the tile
    ("loop_lm", 37, 20, 4),   # non-row-constant eps block
    ("loop", 5, 9, 130),      # > 127 word ends: int32 eps_u side plane
])
def test_k1_k2_match_plain(dev, kind, b, t, n_models):
    _check_k1_k2(dev, kind, b, t, _bank(n_models, 3, 2, 6).to(dev))


@pytest.mark.parametrize("n_states,n_mix,staged", [
    (3, 11, True),    # two mixture chunks, weights staged in shared memory
    (10, 8, False),   # 11 x 10 x 8 x 79 weights (278 KB) read from device memory
])
def test_k1_large_banks(dev, n_states, n_mix, staged):
    """The emission kernel stages the padded weights in shared memory when
    they fit, else reads them through L1; K1 equal to its plain version
    either way (the Python and CUDA byte counts agree)."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    a, u = 2 * 39 + 1, 11 * n_states
    for st in (0, 1):
        assert lib.bank_emission_smem_bytes(a, u, n_mix, st) == vk._emission_smem(
            a, u, n_mix, bool(st))
    assert (vk._emission_smem(a, u, n_mix, True) <= lib.srt_smem_limit()) == staged
    _check_k1_k2(dev, "sausage", 7, 12, _bank(11, n_states, n_mix, 39, seed=4).to(dev))


def _check_k1_k2(dev, kind, b, t, bank):
    from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    n_models, dim = bank.n_models, bank.means.shape[-1]
    trans = [bank.trans_cost[i].cpu().numpy() for i in range(n_models)]
    rng = np.random.default_rng(2)
    if kind == "sausage":
        graph = build_word_graph(trans, [list(range(n_models))] * 3)
    else:
        lm = None
        if kind == "loop_lm":  # bigram-shaped costs: a non-row-constant eps block
            lm = types.SimpleNamespace(cost=rng.uniform(0.1, 3.0, (n_models, n_models)),
                                       start_cost=rng.uniform(0.1, 2.0, n_models),
                                       end_cost=rng.uniform(0.1, 2.0, n_models))
        graph = build_loop_graph(trans, lm=lm, word_insertion_cost=0.5)
    bg = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(bg)
    feats = torch.from_numpy(rng.standard_normal((b, t, dim)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 1, rng.integers(1, t + 1, b - 2)].astype(np.int32)).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    xa = augment_dtb(feats)
    got = vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)
    want = vk.viterbi_banded_fused_ref(xa, w, lw, bg, topo, nf)
    torch.cuda.synchronize()
    assert got[2].dtype == (torch.int32 if n_models > 127 else torch.int8)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    valid = (torch.arange(t, device=dev)[:, None] < nf[None, :])[:, None, :]
    for k in (1, 2, 3):
        assert bool(((got[k] == want[k]) | ~valid).all()), k
    ends = bg.end_states[torch.argmin(want[0][bg.end_states], 0)]
    sk, fk = vk.banded_backtrace_val(want[1], want[3], ends, nf, topo.uniform_w)
    sp, fp = vk.banded_backtrace_val_ref(want[1], want[3], ends, nf, topo.uniform_w)
    torch.cuda.synchronize()
    assert bool(((sk == sp) & (fk == fp) | ~valid[:, 0]).all())


def _plan_agrees_with_kernel(lib, mode, g, u, b, dev):
    """The wrapper's plan and shared-memory sum equal the kernel's."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk

    s, r, l = g.n_states, g.n_words, g.n_ends
    plan = vk.banded_plan(b, torch.cuda.get_device_properties(dev).multi_processor_count,
                          s, r, l, u, mode, lib.srt_smem_limit())
    if plan.form == "warp":
        assert plan.smem == lib.banded_warp_smem_bytes(vk.MODES[mode], u, plan.tile)
        return plan
    assert plan.smem == lib.banded_forward_smem_bytes(
        vk.MODES[mode], u, s, r, l, plan.tile, int(plan.work_smem), int(plan.tables),
        int(plan.ring), plan.kf)
    assert plan.work == lib.banded_forward_work_bytes(vk.MODES[mode], s, r, l)
    return plan


def _big_loop(n_words, sizes, u_bank):
    """A loop graph of ``n_words`` words cycling through ``sizes`` states
    (bank rows reused modulo ``u_bank``): past the old 6,400-state limit."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    base = _bank(5, max(sizes), 2, 6).trans_cost.numpy()
    trans = [base[i % 5][:k, :k] for i, k in zip(range(n_words), sizes * n_words)]
    graph = build_loop_graph(trans, word_insertion_cost=0.5)
    g = banded_arrays(graph)
    return graph, g._replace(bank_state=g.bank_state % u_bank)


@pytest.mark.parametrize("b,ties,big", [
    (1, False, False), (5, True, False), (130, False, False), (512, True, False),
    (3, False, True),   # a 1,500-word loop graph, 7,500 states
])
def test_k1_dp_matches_plain(dev, b, ties, big):
    """K1's DP kernel on given emissions (uniform or integer 0..2, which
    force ties) against ``fused_dp_ref``, with lengths 0, 1, T and T + 3:
    every output over every frame, frozen ones included; K2 on its planes;
    K1 end to end (emission kernel + DP) at rtol 1e-5."""
    from speech_recognition_tpu_torch.models.graph import build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.utils.build import load_library

    bank = _bank(11, 5, 4, 39).to(dev)
    u = 55
    if big:
        graph, g = _big_loop(1500, (5,), u)
        t = 8
    else:
        graph = build_word_graph([bank.trans_cost[i].cpu().numpy() for i in range(11)],
                                 [list(range(11))] * 7)
        g = banded_arrays(graph)
        t = 30
    g = g.to(dev)
    topo = vk.banded_topology(g)
    assert topo.fused_ok
    plan = _plan_agrees_with_kernel(load_library(), "fused", g, u, b, dev)
    assert plan.frontier == "shared"
    rng = np.random.default_rng(b)
    e = rng.integers(0, 3, (u, t, b)) if ties else rng.uniform(0, 6, (u, t, b))
    nll = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[0, t + 3, 1, t, rng.integers(1, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)
    got = vk._banded_forward(nll, g, nf, 1, "fused", vk.viterbi_banded_fused)
    want = vk.fused_dp_ref(nll, g, nf)
    torch.cuda.synchronize()
    for k in range(4):
        assert torch.equal(got[k], want[k]), k
    ends = g.end_states[torch.argmin(want[0][g.end_states], 0)]
    sk, fk = vk.banded_backtrace_val(got[1], got[3], ends, nf, topo.uniform_w)
    sp, fp = vk.banded_backtrace_val_ref(want[1], want[3], ends, nf, topo.uniform_w)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(fk, fp)
    feats = torch.from_numpy(rng.standard_normal((b, t, 39)).astype(np.float32)).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    xa = augment_dtb(feats)
    before = (vk.bank_emission.launches, vk.viterbi_banded_fused.launches)
    got = vk.viterbi_banded_fused(xa, w, lw, g, topo, nf)
    want = vk.viterbi_banded_fused_ref(xa, w, lw, g, topo, nf)
    torch.cuda.synchronize()
    assert (vk.bank_emission.launches, vk.viterbi_banded_fused.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    torch.testing.assert_close(vk.bank_emission(xa, w, lw), vk.bank_emission_ref(xa, w, lw),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b,ties,big", [
    (1, True, False), (5, False, False), (130, True, False), (512, False, False),
    (2, True, True),    # a 2,000-word loop graph of 2-5-state words, 7,000 states
])
def test_k8_at_batch_sizes_and_large_graphs(dev, b, ties, big):
    """K8 / K9 against the plain scan at B = 1, 5, 130 and 512 on the
    4-slot sausage of 1-state words (eps depth 3), and past the old
    6,400-state limit, with lengths 0, 1, T and T + 3 and tie-forcing
    integer emissions: every plane over every frame."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.utils.build import load_library

    if big:
        graph, g = _big_loop(2000, (2, 3, 4, 5), 20)
        u, t = 20, 6
    else:
        bank, graph = _general_graph("sausage_1state")
        g, u, t = banded_arrays(graph), bank.n_models * bank.n_states, 25
    g = g.to(dev)
    topo = vk.banded_topology(g)
    assert not topo.fused_ok
    plan = _plan_agrees_with_kernel(load_library(), "general", g, u, b, dev)
    assert plan.frontier == ("shared" if big else "registers")  # the sausage: warp form
    rng = np.random.default_rng(b + 7)
    e = rng.integers(0, 3, (u, t, b)) if ties else rng.uniform(0, 6, (u, t, b))
    nll = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[0, t + 3, 1, t, rng.integers(1, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)
    got = vk.viterbi_banded_general(nll, g, topo, nf, graph.eps_depth)
    want = vk.viterbi_banded_general_ref(nll, g, topo, nf, graph.eps_depth)
    torch.cuda.synchronize()
    for k in range(3):
        assert torch.equal(got[k], want[k]), k
    ends = g.end_states[torch.argmin(want[0][g.end_states] + g.end_bonus[:, None], 0)]
    sk, fk = vk.banded_backtrace_general(got[1], got[2], g, ends, nf, graph.eps_depth)
    sp, fp = vk.banded_backtrace_general_ref(want[1], want[2], g, ends, nf, graph.eps_depth)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(fk, fp)


def _long_word_graph(n_slots, n_words, width, u, seed):
    """A uniform sausage of ``n_slots`` x ``n_words`` words of ``width``
    states, built as banded arrays directly (the graph constructors' dense
    [S, S] matrices would not fit at these sizes): random band costs,
    random eps costs from each slot's ends to the next slot's starts,
    entry into the first slot, bank rows drawn from ``u``."""
    from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
    from speech_recognition_tpu_torch.utils.numerics import POS_INF

    rng = np.random.default_rng(seed)
    s, r = n_slots * n_words * width, n_slots * n_words
    pos = np.arange(s) % width
    band = np.full((3, s), POS_INF, np.float32)
    band[0] = rng.uniform(0.1, 2.0, s)
    band[1, pos >= 1] = rng.uniform(0.1, 2.0, int((pos >= 1).sum()))
    band[2, pos >= 2] = rng.uniform(1.0, 3.0, int((pos >= 2).sum()))
    starts = np.arange(r) * width
    ends = starts + width - 1
    eps = np.full((r, r), POS_INF, np.float32)
    for k in range(1, n_slots):
        eps[k * n_words:(k + 1) * n_words, (k - 1) * n_words:k * n_words] = rng.uniform(
            0.1, 3.0, (n_words, n_words))
    init = np.full(s, POS_INF, np.float32)
    init[starts[:n_words]] = 0.0
    start_pos = np.zeros(s, np.int64)
    start_pos[starts] = np.arange(r)
    t = torch.from_numpy
    return BandedGraph(band=t(band), init_cost=t(init), word_starts=t(starts),
                       word_ends=t(ends), eps_block=t(eps), start_pos=t(start_pos),
                       is_start=t(np.isin(np.arange(s), starts)),
                       end_states=t(ends[-n_words:]), end_bonus=torch.zeros(n_words),
                       bank_state=t(rng.integers(0, u, s)))


@pytest.mark.parametrize("mode", ["fused", "general", "wordtrace"])
@pytest.mark.parametrize("case", ["device_frontier", "no_staging", "no_ring"])
def test_dp_fallback_plans_match_plain(dev, case, mode):
    """The DP's fallbacks, chosen by size: the work area in device memory
    (26,400 states), each warp writing its plane rows itself (33,000
    states at 4 streams per CTA), and emissions read without the ring (a
    20,000-row bank); K1's DP (uniform mode), K8 and K10's DP (word-trace
    mode) each equal to their plain versions over every frame,
    tie-forcing emissions, lengths 0, 1, T and T + 3.  K10 stages no bp8
    rows, so its planes fit the staging at 33,000 states: there the
    unstaged plan is given to the launch explicitly."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.utils.build import load_library

    width, b, u = {"device_frontier": (800, 2, 55), "no_staging": (1000, 265, 55),
                   "no_ring": (7, 5, 20000)}[case]
    g = _long_word_graph(3, 11, width, u, seed=width + b).to(dev)
    topo = vk.banded_topology(g)
    assert topo.fused_ok
    plan = _plan_agrees_with_kernel(load_library(), mode, g, u, b, dev)
    if mode == "wordtrace" and case == "no_staging":
        assert plan.kf > 0
        plan = plan._replace(kf=0, smem=vk.banded_smem_bytes(
            mode, u, g.n_states, g.n_words, g.n_ends, plan.tile, plan.work_smem, plan.tables,
            plan.ring, 0))
    assert (plan.frontier, plan.kf > 0, plan.ring) == {
        "device_frontier": ("device", True, True), "no_staging": ("device", False, True),
        "no_ring": ("shared", True, False)}[case]
    t = 4
    rng = np.random.default_rng(b)
    nll = torch.from_numpy(rng.integers(0, 3, (u, t, b)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[0, t + 3, 1, t, rng.integers(1, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)
    wrapper, want = {
        "fused": (vk.viterbi_banded_fused, lambda: vk.fused_dp_ref(nll, g, nf)),
        "general": (vk.viterbi_banded_general,
                    lambda: vk.viterbi_banded_general_ref(nll, g, topo, nf, 1)),
        "wordtrace": (vk.viterbi_banded_wordtrace, lambda: vk._wordtrace_dp(nll, g, nf)),
    }[mode]
    got = vk._banded_forward(nll, g, nf, 1, mode, wrapper, plan=plan)
    want = want()
    torch.cuda.synchronize()
    for k in range(len(want)):
        assert torch.equal(got[k], want[k]), k


def test_decode_connected_cuda_matches_cpu(dev):
    from speech_recognition_tpu_torch.decode.connected import (
        connected_graph_arrays,
        decode_connected,
    )
    from speech_recognition_tpu_torch.models.graph import build_loop_graph

    bank, bank_g = _bank(11, 5, 4, 39), _bank(11, 5, 4, 39).to(dev)
    trans = [bank.trans_cost[i].numpy() for i in range(11)]
    rng = np.random.default_rng(3)
    feats = torch.from_numpy(rng.standard_normal((9, 60, 39)).astype(np.float32))
    nf = torch.from_numpy(rng.integers(1, 61, 9).astype(np.int32))
    for graph in (connected_graph_arrays(bank, 4), build_loop_graph(trans, word_insertion_cost=1.0)):
        w_c, c_c = decode_connected(bank, graph, feats, nf)
        w_g, c_g = decode_connected(bank_g, graph, feats.to(dev), nf.to(dev))
        assert w_g == w_c
        np.testing.assert_allclose(c_g, c_c, rtol=1e-5)


def test_wrappers_raise_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops.frontend import mfcc39_auto
    from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc39_fused
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import banded_backtrace_val

    sig = torch.zeros((2, 16000), dtype=torch.float64, device=dev)
    lens = torch.tensor([16000, 100], device=dev)
    with pytest.raises(ValueError, match="float32"):
        mfcc39_fused(sig, lens)
    # a config K3 does not implement raises on the card, never runs the
    # plain pipeline there
    before = mfcc39_fused.launches
    for cfg, norm in ((FrontendConfig(variant="scratch"), "utterance"),
                      (FrontendConfig(n_fft=1024), "utterance"),
                      (FrontendConfig(), "cmvn")):
        with pytest.raises(ValueError, match="does not implement"):
            mfcc39_auto(sig.float(), lens, cfg, norm=norm)
    assert mfcc39_fused.launches == before
    with pytest.raises(ValueError, match="contiguous"):
        banded_backtrace_val(torch.zeros((4, 6, 2), dtype=torch.int8, device=dev),
                             torch.zeros((4, 2, 2), dtype=torch.int64, device=dev),
                             torch.zeros(2, dtype=torch.int32, device=dev),
                             torch.ones(2, dtype=torch.int32, device=dev), 3)


def _k2_planes(seed, t, w, r, b, dev, eps_at_1=True):
    """Random K2 planes over a uniform graph of ``r`` words of ``w``
    states whose walks stay on the graph: band codes 0..3 (3 is clamped to
    MAX_BAND) no deeper than the state's place in its word, codes 0 or 4
    (eps) at word starts, eps_prev any state; with ``eps_at_1`` every word
    start takes the eps code at t = 1."""
    rng = np.random.default_rng(seed)
    s = r * w
    pos = np.arange(s) % w
    band = np.minimum(rng.integers(0, 4, (t, s, b)), pos[None, :, None] + (pos >= 2)[None, :, None])
    band = np.where((band == 3) & (pos[None, :, None] < 2), 0, band)
    eps = np.where(rng.random((t, s, b)) < 0.5, 4, 0)
    bp8 = np.where(pos[None, :, None] == 0, eps, band)
    if eps_at_1 and t > 1:
        bp8[1, pos == 0] = 4
    eps_prev = rng.integers(0, s, (t, r, b))
    return (torch.from_numpy(bp8.astype(np.int8)).to(dev),
            torch.from_numpy(eps_prev.astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, s, b).astype(np.int32)).to(dev))


# (B, T, words, W): B a multiple of 16, of 4, of neither, B = 1; words
# longer than the window's 32 states; the 7,500-state loop
K2_CASES = {
    "b48": (48, 40, 11, 5),
    "b37": (37, 40, 11, 5),
    "b36_w3": (36, 33, 20, 3),
    "b1": (1, 25, 11, 5),
    "b9_w40": (9, 60, 6, 40),
    "b5_loop7500": (5, 9, 1500, 5),
}


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_windows_match_plain(dev, name):
    """K2 against ``banded_backtrace_val_ref`` on random planes (walks
    that change words often and leave long words' windows): states and
    flags equal for t < nf, with nf = T, 0, 1 and T + 2 side by side and an
    eps code at t = 1; the launch is counted."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk

    b, t, r, w = K2_CASES[name]
    bp8, eps_prev, end = _k2_planes(b + t, t, w, r, b, dev)
    rng = np.random.default_rng(b)
    nf = torch.from_numpy(np.r_[t, 0, 1, t + 2, rng.integers(0, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)
    before = vk.banded_backtrace_val.launches
    sk, fk = vk.banded_backtrace_val(bp8, eps_prev, end, nf, w)
    sp, fp = vk.banded_backtrace_val_ref(bp8, eps_prev, end, nf, w)
    torch.cuda.synchronize()
    assert vk.banded_backtrace_val.launches == before + 1
    valid = torch.arange(t, device=dev)[:, None] < nf[None, :]
    assert bool(((sk == sp) & (fk == fp) | ~valid).all())
    assert bool(fp[1][nf > 1].any())  # eps codes at t = 1 were taken


def _k7_lattice(seed, t, b, l, k, dmax, dev, dense=False):
    """Random K7 inputs: ends_cost with dead (POS_INF) entries, ends_tau
    mixing tau <= 0, tau = t - 1, taus inside the window and beyond it;
    the backoff LM (K predecessors per target) or a dense ``[L, L]`` one."""
    from speech_recognition_tpu_torch.utils.numerics import POS_INF

    rng = np.random.default_rng(seed)
    ec = rng.uniform(0, 50, (t, b, l)).astype(np.float32)
    ec[rng.random((t, b, l)) < 0.2] = POS_INF
    tt = np.arange(t)[:, None, None]
    pick = rng.integers(0, 4, (t, b, l))
    tau = np.select([pick == 0, pick == 1, pick == 2],
                    [rng.integers(-2, 1, (t, b, l)), tt - 1,
                     tt - rng.integers(1, dmax + 1, (t, b, l))],
                    tt - rng.integers(dmax + 1, dmax + 4, (t, b, l)))
    tau = np.minimum(tau, tt)
    ec_t = torch.from_numpy(ec).to(dev)
    lm = dict(big_ll=None, backoff=None)
    if dense:
        lm["big_ll"] = torch.from_numpy(rng.uniform(0.1, 3.0, (l, l)).astype(np.float32)).to(dev)
    else:
        lm["backoff"] = tuple(torch.from_numpy(x).to(dev) for x in (
            rng.uniform(1.0, 4.0, l).astype(np.float32),
            rng.integers(0, l, (l, k)).astype(np.int32),
            rng.uniform(0.0, 2.0, (l, k)).astype(np.float32)))
    nf = np.r_[t, 0, 1, rng.integers(2, t + 1, b)][:b]
    args = (ec_t, torch.from_numpy(tau.astype(np.int32)).to(dev), ec_t.amin(2),
            torch.from_numpy(rng.uniform(0, 2, l).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0, 2, l).astype(np.float32)).to(dev),
            torch.from_numpy(nf.astype(np.int32)).to(dev), dmax)
    return args, lm


# (T, B, L, K, dmax, dense, plan): L off a multiple of 32 and of 4; small
# dmax with taus beyond the window; the dense LM; the dictionary-shaped
# trie's L (no tables on chip); each staged variant forced; the direct
# mode in shared memory and, past the parent's ~29,000 leaves, in a
# device-memory scratch
K7_CASES = {
    "l1000_auto": (40, 5, 1000, 9, 32, False, None),
    "l203_dmax3": (30, 4, 203, 5, 3, False, None),
    "l203_dmax1": (12, 3, 203, 2, 1, False, None),
    "l203_dense": (20, 3, 203, 0, 6, True, None),
    "l1000_no_tables": (30, 3, 1000, 9, 8, False, (1, 1024, False)),
    "l1500_leaves2": (25, 2, 1500, 4, 8, False, None),
    "l3001_leaves4": (20, 2, 3001, 3, 8, False, None),
    "l6250_dict": (20, 2, 6250, 9, 16, False, None),
    "l1000_direct": (30, 3, 1000, 9, 8, False, (0, 1024, False)),
    "l203_direct_dense": (20, 2, 203, 0, 6, True, (0, 1024, False)),
    "l29100_direct_scratch": (6, 2, 29100, 3, 4, False, None),
}


@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_k7_plans_match_plain(dev, name):
    """K7 in every plan against ``rescore_lattice_ref``: cost and best
    leaf bit-identical, pred_w for t < nf, with tau = t - 1 (read from
    the newest row), taus outside the window, nf = T, 0, 1; the plan's and
    the kernel's shared-memory sums agree, and the staged trace fills."""
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.utils.build import load_library

    t, b, l, k, dmax, dense, forced = K7_CASES[name]
    lib = load_library()
    args, lm = _k7_lattice(l + t, t, b, l, k, dmax, dev, dense)
    auto = lk.rescore_plan(l, k, dense, lib.srt_smem_limit())
    plan = auto
    if forced is not None:
        leaves, threads, tables = forced
        plan = lk.RescorePlan(leaves, threads, tables, False,
                              lk.rescore_smem_bytes(l, k, tables) if leaves else 8 * l)
    if name == "l6250_dict":
        assert plan.leaves == 8 and not plan.tables
    if name == "l29100_direct_scratch":
        assert plan.leaves == 0 and plan.scratch
    if name == "l1000_auto":
        assert plan.leaves == 1 and plan.tables
    if plan.leaves:
        assert lib.lattice_rescore_staged_smem_bytes(l, k, int(plan.tables)) == plan.smem
    elif not plan.scratch:
        assert lib.lattice_rescore_smem_bytes(l) == plan.smem
    trace = torch.zeros((b, 4), dtype=torch.int64, device=dev)
    before = lk.rescore_lattice.launches
    r_k = lk.rescore_lattice(*args, **lm, plan=plan, trace=trace)
    r_p = lk.rescore_lattice_ref(*args, **lm)
    torch.cuda.synchronize()
    assert lk.rescore_lattice.launches == before + 1
    assert torch.equal(r_k[0], r_p[0]) and torch.equal(r_k[1], r_p[1])
    valid = torch.arange(t, device=dev)[:, None, None] < args[5][None, :, None]
    assert bool(((r_k[2] == r_p[2]) | ~valid).all())
    assert bool((trace > 0).all()) == bool(plan.leaves)


@pytest.mark.parametrize("name", sorted(K7_CASES))
def test_rescore_and_walk_plans_match_plain(dev, name):
    """The pipeline's K7 launch in every plan (staged with 1, 2, 4 and 8
    leaves a thread, LM tables on chip and through L1, dense; direct, and
    direct with its D rows in device memory) against
    ``rescore_and_walk_ref``: the q it computed (``q_out``) against
    ``ends_cost.amin(2)``, each stream's truncation count, cost, best
    leaf, pred_w for t < nf, the walk's leaves and word counts, bit for
    bit, at a ``max_words`` that holds every chain and at one that cuts
    the longest; one launch each, and no standalone K7 or K22."""
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.utils.build import load_library

    t, b, l, k, dmax, dense, forced = K7_CASES[name]
    lib = load_library()
    args, lm = _k7_lattice(l + t + 1, t, b, l, k, dmax, dev, dense)
    args = (*args[:2], *args[3:])
    plan = lk.rescore_plan(l, k, dense, lib.srt_smem_limit())
    if forced is not None:
        leaves, threads, tables = forced
        plan = lk.RescorePlan(leaves, threads, tables, False,
                              lk.rescore_smem_bytes(l, k, tables) if leaves else 8 * l)
    max_dur = max(dmax - 1, 1)  # the raw max_dur below the ring depth
    full = lk.rescore_and_walk_ref(*args, max_dur, t, **lm)
    valid = torch.arange(t, device=dev)[:, None, None] < args[4][None, :, None]
    for mw in (t, max(int(full[5].max()) - 1, 0)):
        want = lk.rescore_and_walk_ref(*args, max_dur, mw, **lm)
        q_k = torch.full((t, b), -1.0, device=dev)
        trace = torch.zeros((b, 4), dtype=torch.int64, device=dev)
        before = (lk.rescore_and_walk.launches, lk.rescore_lattice.launches,
                  lk.lattice_walk.launches)
        got = lk.rescore_and_walk(*args, max_dur, mw, **lm, plan=plan, trace=trace, q_out=q_k)
        torch.cuda.synchronize()
        assert (lk.rescore_and_walk.launches, lk.rescore_lattice.launches,
                lk.lattice_walk.launches) == (before[0] + 1, *before[1:])
        assert torch.equal(q_k.view(torch.int32), args[0].amin(2).view(torch.int32))
        for i in (0, 1, 3, 4, 5):
            assert torch.equal(got[i], want[i]), (i, mw)
        assert bool(((got[2] == want[2]) | ~valid).all())
        assert bool((trace > 0).all()) == bool(plan.leaves)
    assert int(full[3].sum()) > 0  # arcs past max_dur were counted


def test_decode_lattice_batch_launches_one_k7(dev):
    """On CUDA the bigram decode runs ``bank_nll_ubt``, K6 and one
    ``rescore_and_walk``: no standalone K7, no K22; its words equal the
    same call's on the CPU, its costs at rtol 1e-5 (the emission GEMMs
    sum in other orders), its truncation counts the tensor-op count's on
    its own planes."""
    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import lattice as lat
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology

    bank = _bank(6, 3, 4, 39, seed=5)
    units = list("abcdef")
    rng = np.random.default_rng(9)
    words = random_words(rng, units, 200, 2, 6)
    lexg = build_lex_graph(words, [bank.trans_cost[i].numpy() for i in range(6)],
                           {c: i for i, c in enumerate(units)}, word_insertion_cost=1.0)
    lm = fit_bigram([[int(x) for x in rng.integers(0, 200, 10)] for _ in range(40)], 200)
    feats = torch.from_numpy(rng.standard_normal((7, 50, 39)).astype(np.float32))
    nf = torch.from_numpy(np.r_[50, 1, 0, rng.integers(12, 51, 4)].astype(np.int32))
    out = {}
    for d in (torch.device("cpu"), dev):
        before = (lk.viterbi_lattice.launches, lk.rescore_and_walk.launches,
                  lk.rescore_lattice.launches, lk.lattice_walk.launches)
        out[d.type] = lat._decode_lattice_batch(
            bank.to(d), feats.to(d), nf.to(d), lexg.banded.to(d), lex_topology(lexg.banded),
            lat.lattice_lm(lm, lexg.leaf_word, d), lexg.n_states // lexg.n_arcs, 8)
        torch.cuda.synchronize()
        after = (lk.viterbi_lattice.launches, lk.rescore_and_walk.launches,
                 lk.rescore_lattice.launches, lk.lattice_walk.launches)
        launched = int(d.type == "cuda")
        assert after == (before[0] + launched, before[1] + launched, *before[2:])
    (lr_c, nw_c, c_c, nt_c), (lr_g, nw_g, c_g, nt_g) = out["cpu"], out["cuda"]
    assert torch.equal(lr_g.cpu(), lr_c) and torch.equal(nw_g.cpu(), nw_c)
    np.testing.assert_allclose(c_g.cpu().numpy(), c_c.numpy(), rtol=1e-5)
    # the counts against the tensor-op count on the card's own planes
    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt

    g_nf = nf.to(dev)
    _, ec, et = lk.viterbi_lattice(bank_nll_ubt(bank.to(dev), feats.to(dev), g_nf),
                                   lexg.banded.to(dev), lex_topology(lexg.banded), g_nf)
    want = lat._lattice_truncation_counts(ec.transpose(1, 2), et.transpose(1, 2), g_nf, 8)
    assert torch.equal(nt_g, want) and int(want.sum()) > 0 and int(nt_c.sum()) > 0


def test_rescore_and_walk_raises_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk

    t, b, l = 6, 2, 40
    ec = torch.zeros((t, b, l), device=dev)
    et = torch.zeros((t, b, l), dtype=torch.int32, device=dev)
    vec = torch.zeros(l, device=dev)
    big = torch.zeros((l, l), device=dev)
    nf = torch.full((b,), t, dtype=torch.int32, device=dev)
    before = lk.rescore_and_walk.launches
    with pytest.raises(ValueError, match="exactly one"):
        lk.rescore_and_walk(ec, et, vec, vec, nf, 8, 8, 6)
    with pytest.raises(ValueError, match="ends_tau"):
        lk.rescore_and_walk(ec, et.long(), vec, vec, nf, 8, 8, 6, big_ll=big)
    with pytest.raises(ValueError, match="q_out"):
        lk.rescore_and_walk(ec, et, vec, vec, nf, 8, 8, 6, big_ll=big,
                            q_out=torch.zeros((t, b + 1), device=dev))
    with pytest.raises(ValueError, match="max_dur >= 1"):
        lk.rescore_and_walk(ec, et, vec, vec, nf, 8, 0, 6, big_ll=big)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        lk.rescore_and_walk(ec, et, vec, vec, nf.cpu(), 8, 8, 6, big_ll=big)
    with pytest.raises(ValueError, match="trace"):
        lk.rescore_and_walk(ec, et, vec, vec, nf, 8, 8, 6, big_ll=big,
                            trace=torch.zeros((b, 5), dtype=torch.int64, device=dev))
    assert lk.rescore_and_walk.launches == before
    # rescore_lattice launches the same kernel: its q is checked, not read
    before = lk.rescore_lattice.launches
    with pytest.raises(ValueError, match="q must be"):
        lk.rescore_lattice(ec, et, ec.amin(2)[:, :1], vec, vec, nf, 8, big_ll=big)
    assert lk.rescore_lattice.launches == before


def _units(rng, n_units, n_states=3, skip=True):
    """Banded left-to-right unit costs (self, step and, on every other
    unit, skip arcs)."""
    trans = []
    for k in range(n_units):
        t = np.full((n_states, n_states), np.inf)
        for i in range(n_states):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < n_states:
                t[i + 1, i] = rng.uniform(0.1, 1)
            if skip and k % 2 == 0 and i + 2 < n_states:
                t[i + 2, i] = rng.uniform(0.5, 2)
        trans.append(t)
    return trans


def _lex_graph(kind):
    from speech_recognition_tpu_torch.data.lexicon import flat_lm_lexicon, random_words
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    if kind.startswith("flat_lm_"):  # R > 64 roots: several re-entry passes per frame
        words, trans, ids, lm, _ = flat_lm_lexicon(int(kind[8:]))
        return build_lex_graph(words, trans, ids, lm=lm, word_insertion_cost=0.3), 2 * len(words)
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "flat_lm":  # digit-shaped flat vocabulary, bigram-weighted eps block
        syms = list("0123456789A")
        lm = types.SimpleNamespace(cost=rng.uniform(0.1, 3.0, (11, 11)),
                                   start_cost=rng.uniform(0.1, 2.0, 11),
                                   end_cost=rng.uniform(0.1, 2.0, 11))
        return build_lex_graph(syms, _units(rng, 11, 5), {c: i for i, c in enumerate(syms)},
                               lm=lm, word_insertion_cost=0.3), 11 * 5
    units = list("abcde")
    n_words = {"deep": 60, "deep_int32": 150}[kind]  # 150 leaves: int32 eps_u plane
    words = random_words(rng, units, n_words, 1, 7)
    uni = rng.uniform(0.1, 2.0, n_words) if kind == "deep" else None
    return build_lex_graph(words, _units(rng, 5), {c: i for i, c in enumerate(units)},
                           unigram_cost=uni, word_insertion_cost=0.5), 5 * 3


def _check_k4_k5(dev, lexg, n_bank, b, t):
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    g = lexg.banded.to(dev)
    topo = lk.lex_topology(lexg.banded)
    rng = np.random.default_rng(b + t)
    nll = torch.from_numpy(rng.uniform(0, 5, (n_bank, t, b)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 1, rng.integers(1, t + 1, b)][:b].astype(np.int32)).to(dev)
    before = lk.viterbi_lex.launches
    got = lk.viterbi_lex(nll, g, topo, nf)
    want = lk.viterbi_lex_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    assert lk.viterbi_lex.launches == before + 1
    assert got[2].dtype == topo.eps_u_dtype
    assert torch.equal(got[0], want[0])
    valid = torch.arange(t, device=dev)[:, None] < nf[None, :]  # [T, B]
    for k in (1, 2, 3):
        assert bool(((got[k] == want[k]) | ~valid[:, :, None]).all()), k
    ends = g.end_states[torch.argmin(want[0][:, g.end_states] + g.end_bonus, 1)]
    sk, fk = lk.lex_backtrace_val(want[1], want[3], g, ends, nf)
    sp, fp = lk.lex_backtrace_val_ref(want[1], want[3], g, ends, nf)
    torch.cuda.synchronize()
    assert bool(((sk == sp) & (fk == fp) | ~valid).all())
    return sk, fk, nf


@pytest.mark.parametrize("b", [1, 5, 130])
def test_k4_k5_match_plain(dev, b):
    lexg, n_bank = _lex_graph("deep")
    _check_k4_k5(dev, lexg, n_bank, b, 23)


@pytest.mark.parametrize("kind", ["flat_lm", "deep_int32", "flat_lm_100", "flat_lm_130"])
def test_k4_k5_match_plain_other_graphs(dev, kind):
    from speech_recognition_tpu_torch.models.lexgraph import lex_words_from_path_batch

    lexg, n_bank = _lex_graph(kind)
    s, f, nf = _check_k4_k5(dev, lexg, n_bank, 9, 31)
    words = lex_words_from_path_batch(lexg, s.T.cpu().numpy(), nf.cpu().numpy(),
                                      f.T.cpu().numpy())
    assert len(words) == 9


def test_decode_lextree_cuda_matches_cpu(dev):
    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.decode.lextree import decode_lextree
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    bank = _bank(6, 3, 4, 39, seed=5)
    units = list("abcdef")
    trans = [bank.trans_cost[i].numpy() for i in range(6)]
    rng = np.random.default_rng(6)
    lexg = build_lex_graph(random_words(rng, units, 200, 2, 6), trans,
                           {c: i for i, c in enumerate(units)}, word_insertion_cost=1.0)
    feats = torch.from_numpy(rng.standard_normal((7, 50, 39)).astype(np.float32))
    nf = torch.from_numpy(np.r_[50, 1, rng.integers(12, 51, 5)].astype(np.int32))
    w_c, c_c = decode_lextree(bank, lexg, feats, nf)
    w_g, c_g = decode_lextree(bank.to(dev), lexg, feats.to(dev), nf.to(dev))
    assert w_g == w_c
    np.testing.assert_allclose(c_g, c_c, rtol=1e-5)


def test_lex_wrappers_raise_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    lexg, n_bank = _lex_graph("deep")
    g, topo = lexg.banded.to(dev), lk.lex_topology(lexg.banded)
    nll = torch.zeros((n_bank, 6, 2), device=dev)
    nf = torch.full((2,), 6, dtype=torch.int32, device=dev)
    before = (lk.viterbi_lex.launches, lk.lex_backtrace_val.launches)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        lk.viterbi_lex(nll, g, topo, nf.cpu())
    with pytest.raises(ValueError, match="float32"):
        lk.viterbi_lex(nll.double(), g, topo, nf)
    with pytest.raises(ValueError, match="contiguous"):
        lk.viterbi_lex(nll.transpose(1, 2).contiguous().transpose(1, 2), g, topo, nf)
    bp8 = torch.zeros((6, 2, g.n_states), dtype=torch.int8, device=dev)
    eps_prev = torch.zeros((6, 2, g.n_words), dtype=torch.int32, device=dev)
    end = g.end_states[:2]
    with pytest.raises(ValueError, match="contiguous"):
        lk.lex_backtrace_val(bp8.transpose(0, 1).contiguous().transpose(0, 1),
                             eps_prev, g, end, nf)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        lk.lex_backtrace_val(bp8, eps_prev, g, end, nf.cpu())
    assert (lk.viterbi_lex.launches, lk.lex_backtrace_val.launches) == before


def _check_k6_k7(dev, lexg, n_bank, b, t, nf, lm_kind, max_dur):
    """K6 against its plain version on every plane entry (frozen frames
    included), then K7 on the plain planes against its plain version:
    cost, best leaf and every predecessor."""
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.ops import lattice as lat
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology

    g = lexg.banded.to(dev)
    topo = lex_topology(lexg.banded)
    rng = np.random.default_rng(b + t)
    nll = torch.from_numpy(rng.uniform(0, 5, (n_bank, t, b)).astype(np.float32)).to(dev)
    nf = torch.as_tensor(nf, dtype=torch.int32, device=dev)
    before = (lk.viterbi_lattice.launches, lk.rescore_lattice.launches)
    got = lk.viterbi_lattice(nll, g, topo, nf)
    want = lk.viterbi_lattice_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    for k in range(3):
        assert torch.equal(got[k], want[k]), k
    v = len(lexg.words)
    if lm_kind == "dense":
        cost = torch.from_numpy(rng.uniform(0.1, 3.0, (v, v)).astype(np.float32))
        backoff = None
    else:
        lm = fit_bigram([[int(x) for x in rng.integers(0, v, 8)] for _ in range(30)], v)
        cost = torch.from_numpy(lm.cost)
        backoff = tuple(x.to(dev) for x in lat.rescore_backoff(lm, lexg.leaf_word))
    lw = torch.as_tensor(lexg.leaf_word, dtype=torch.int64)
    big = None if backoff is not None else cost[lw][:, lw].contiguous().to(dev)
    ec, et = want[1], want[2]
    args = (ec, et, ec.amin(2), torch.from_numpy(rng.uniform(0, 2, len(lw)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.uniform(0, 2, len(lw)).astype(np.float32)).to(dev), nf,
            lat._ring_depth(t, max_dur))
    r_k = lk.rescore_lattice(*args, big_ll=big, backoff=backoff)
    r_p = lk.rescore_lattice_ref(*args, big_ll=big, backoff=backoff)
    torch.cuda.synchronize()
    assert (lk.viterbi_lattice.launches, lk.rescore_lattice.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    for k in range(3):
        assert torch.equal(r_k[k], r_p[k]), k
    if max_dur < t:
        assert int(lat._lattice_truncation_count(ec.transpose(1, 2), et.transpose(1, 2),
                                                 nf, max_dur)) > 0


@pytest.mark.parametrize("kind,b,lm_kind,max_dur", [
    ("deep", 5, "backoff", 128),
    ("deep", 1, "backoff", 128),       # B = 1
    ("deep", 6, "dense", 128),          # the dense [L, L] recombination
    ("deep", 7, "backoff", 8),          # arcs longer than 8 frames drop
    ("deep_int32", 9, "backoff", 12),   # 150 leaves
    ("deep_int32", 4, "dense", 16),
])
def test_k6_k7_match_plain(dev, kind, b, lm_kind, max_dur):
    lexg, n_bank = _lex_graph(kind)
    t = 29
    nf = np.r_[t, 0, 1, np.random.default_rng(b).integers(2, t, 8)][:b]  # nf = T, 0, 1, ...
    _check_k6_k7(dev, lexg, n_bank, b, t, nf, lm_kind, max_dur)


def test_decode_lextree_bigram_cuda_matches_cpu(dev):
    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops.lattice import decode_lextree_bigram

    bank = _bank(6, 3, 4, 39, seed=5)
    units = list("abcdef")
    trans = [bank.trans_cost[i].numpy() for i in range(6)]
    rng = np.random.default_rng(7)
    words = random_words(rng, units, 200, 2, 6)
    lexg = build_lex_graph(words, trans, {c: i for i, c in enumerate(units)},
                           word_insertion_cost=1.0)
    lm = fit_bigram([[int(x) for x in rng.integers(0, 200, 10)] for _ in range(40)], 200)
    feats = torch.from_numpy(rng.standard_normal((7, 50, 39)).astype(np.float32))
    nf = torch.from_numpy(np.r_[50, 1, rng.integers(12, 51, 5)].astype(np.int32))
    w_c, c_c = decode_lextree_bigram(bank, lexg, lm, feats, nf)
    w_g, c_g = decode_lextree_bigram(bank.to(dev), lexg, lm, feats.to(dev), nf.to(dev))
    assert w_g == w_c
    np.testing.assert_allclose(c_g, c_c, rtol=1e-5)


def test_lattice_wrappers_raise_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology

    lexg, n_bank = _lex_graph("deep")
    g, topo = lexg.banded.to(dev), lex_topology(lexg.banded)
    nll = torch.zeros((n_bank, 6, 2), device=dev)
    nf = torch.full((2,), 6, dtype=torch.int32, device=dev)
    before = (lk.viterbi_lattice.launches, lk.rescore_lattice.launches)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        lk.viterbi_lattice(nll, g, topo, nf.cpu())
    with pytest.raises(ValueError, match="float32"):
        lk.viterbi_lattice(nll.double(), g, topo, nf)
    with pytest.raises(ValueError, match="at least one frame"):
        lk.viterbi_lattice(nll[:, :0].contiguous(), g, topo, nf)
    l = g.n_ends
    ec = torch.zeros((6, 2, l), device=dev)
    et = torch.zeros((6, 2, l), dtype=torch.int32, device=dev)
    vec = torch.zeros(l, device=dev)
    big = torch.zeros((l, l), device=dev)
    with pytest.raises(ValueError, match="exactly one"):
        lk.rescore_lattice(ec, et, ec.amin(2), vec, vec, nf, 8)
    with pytest.raises(ValueError, match="ends_tau"):
        lk.rescore_lattice(ec, et.long(), ec.amin(2), vec, vec, nf, 8, big_ll=big)
    with pytest.raises(ValueError, match="big_ll"):
        lk.rescore_lattice(ec, et, ec.amin(2), vec, vec, nf, 8, big_ll=big.T)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        lk.rescore_lattice(ec, et, ec.amin(2), vec, vec, nf.cpu(), 8, big_ll=big)
    assert (lk.viterbi_lattice.launches, lk.rescore_lattice.launches) == before


def _lex_case(kind):
    """``(graph, n_bank)`` for the K4 / K6 plan tests: the 1,000-word
    benchmark trie, the dictionary-shaped trie, the 1k trie with one
    state's band perturbed (it no longer factorises: the general mode)
    and the 60-word trie with a repeated word end (the gather mode)."""
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon, dict1_shaped_lexicon
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    if kind == "dup_end":
        lexg, n_bank = _lex_graph("deep")
        g = lexg.banded
        return g._replace(word_ends=torch.cat([g.word_ends, g.word_ends[:1]]),
                          eps_block=torch.cat([g.eps_block, g.eps_block[:, :1] + 0.25], 1)
                          ), n_bank
    words, trans, ids, _ = dict1_shaped_lexicon() if kind == "dict1" else bench_lexicon()
    g = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded
    if kind == "1k_general":
        band = g.band.clone()
        v = int(torch.nonzero(band[1] < 1e29)[50])
        band[1, v] += 0.125
        g = g._replace(band=band)
    return g, int(g.bank_state.max()) + 1


@pytest.mark.parametrize("kind,variant,lattice", [
    ("1k", "plan", False), ("1k", "plan", True),
    ("1k", "device frontier", False), ("1k", "device frontier", True),
    ("1k", "tables via L1", False), ("1k", "tables via L1", True),
    ("1k", "eps via L1", False), ("1k", "gather", False), ("1k", "gather", True),
    ("1k", "rows once", False), ("1k", "rows once", True),
    ("1k", "tau in scratch", True),
    ("dict1", "plan", False), ("dict1", "plan", True),
    ("1k_general", "plan", False), ("1k_general", "plan", True),
    ("dup_end", "plan", False), ("dup_end", "plan", True),
    ("1k", "rows in device memory", False), ("1k", "rows in device memory", True),
    ("1k_general", "rows in device memory", False),
    ("1k_general", "rows in device memory", True),
])
def test_k4_k6_plans_match_plain(dev, kind, variant, lattice):
    """K4 and K6 under every placement of their frontier, tables and eps
    block: the plans ``lex_plan`` picks for the 1k trie (on chip) and the
    dictionary-shaped trie (device scratch), each field moved off chip in
    turn, the leaf ends gathered per root, one copy of each bank row in
    the row tables instead of eight, no row tables (the bank rows and
    emissions read through L1, the tier past ~7,000 bank rows), the
    general mode (per-state
    band rows) and a repeated word end; integer (tie-forcing) or uniform
    emissions, lengths 0, 1 and T: every output bit-identical to the
    plain version (K4's planes on frames below nf), the plan's shared
    memory equal to the kernel's, and the cycle trace filled."""
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.utils.build import load_library

    g, n_bank = _lex_case(kind)
    topo = lk.lex_topology(g)
    g = g.to(dev)
    lib = load_library()
    plan = lk.lex_plan(lattice, topo, lib.srt_smem_limit())
    assert plan.frontier == ("device" if kind == "dict1" else "shared")
    assert topo.pack.factorised == (kind != "1k_general")
    assert plan.gather == topo.pack.gather == (kind == "dup_end")
    plan = plan._replace(**{"plan": {}, "device frontier": dict(front=False),
                            "tables via L1": dict(tables=False), "eps via L1": dict(eps=False),
                            "gather": dict(gather=True), "rows once": dict(rep=1),
                            "tau in scratch": dict(tau=False, eps=True),
                            "rows in device memory": dict(front=False, tables=False, rep=0),
                            }[variant])
    dims = topo.dims
    plan = plan._replace(smem=lk.lex_smem_bytes(lattice, *dims, plan.front, plan.tau,
                                                plan.tables, plan.eps, plan.gather, plan.rep))
    assert plan.smem == lib.viterbi_lex_smem_bytes(
        int(lattice), *dims, int(plan.front), int(plan.tau), int(plan.tables), int(plan.eps),
        int(plan.gather), plan.rep)
    b, t = (3, 30) if kind == "dict1" else (5, 40)
    rng = np.random.default_rng(len(variant) + t)
    e = rng.uniform(0, 5, (n_bank, t, b)) if variant == "plan" else rng.integers(
        0, 3, (n_bank, t, b))
    nll = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 0, 1, rng.integers(2, t + 1, b)][:b].astype(np.int32)).to(dev)
    trace = torch.zeros((b, 6), dtype=torch.int64, device=dev)
    wrapper = lt.viterbi_lattice if lattice else lk.viterbi_lex
    before = wrapper.launches
    got = lk.lex_forward(nll, g, topo, nf, lattice, wrapper, plan=plan, trace=trace)
    want = (lt.viterbi_lattice_ref if lattice else lk.viterbi_lex_ref)(nll, g, topo, nf)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got[0], want[0])
    valid = torch.arange(t, device=dev)[:, None, None] < nf[None, :, None]
    for k in range(1, len(want)):
        assert bool(((got[k] == want[k]) | ~valid).all() if not lattice
                    else torch.equal(got[k], want[k])), k
    ran = (nf > 0) | lattice
    assert bool((trace[ran].sum(1) > 0).all())


@pytest.mark.parametrize("kind,b", [("1k", 1), ("1k", 7), ("1k", 128), ("1k_planted", 7),
                                    ("dict1", 1), ("dict1", 7), ("dict1", 128),
                                    ("deep", 9), ("flat_lm_100", 7)])
def test_k5_windows_match_plain(dev, kind, b):
    """K5's window walk against its plain version on K4's planes: the 1k
    trie and the dictionary-shaped trie at B = 1, 7 and 128 (lengths 0, 1,
    T and between), planted words, a trie whose words pass a chain row
    (32 states) and the flat bigram vocabulary; states and flags
    bit-identical, the chain table cached on the topology, and the trace
    counting one waited window at least per stream that runs."""
    from speech_recognition_tpu_torch.data.lexicon import (
        bench_lexicon,
        dict1_shaped_lexicon,
        planted_emissions,
        random_words,
        unit_transitions,
    )
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    rng = np.random.default_rng(b + len(kind))
    t = 200
    if kind == "deep":
        units = list("abcde")
        words = random_words(rng, units, 30, 12, 16)
        ids = {c: i for i, c in enumerate(units)}
        lexg = build_lex_graph(words, unit_transitions(rng, 5), ids, word_insertion_cost=0.5)
        e, nf, _ = planted_emissions(rng, words, ids, 3, 15, b, t)
    elif kind == "flat_lm_100":
        lexg, n_bank = _lex_graph(kind)
        e = rng.uniform(0, 5, (n_bank, t, b))
        nf = np.r_[t, 0, 1, rng.integers(2, t + 1, b)][:b]
    else:
        words, trans, ids, _ = dict1_shaped_lexicon() if kind == "dict1" else bench_lexicon()
        lexg = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
        n_bank = int(lexg.banded.bank_state.max()) + 1
        if kind == "1k_planted":
            e, nf, _ = planted_emissions(rng, words, ids, 3, n_bank, b, t)
        else:
            e = rng.uniform(0, 5, (n_bank, t, b))
            nf = np.r_[t, 0, 1, rng.integers(2, t + 1, b)][:b]
    g = lexg.banded.to(dev)
    topo = lk.lex_topology(lexg.banded)
    nll = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.asarray(nf, np.int32)).to(dev)
    final, bp8, _, eps_prev = lk.viterbi_lex(nll, g, topo, nf)
    ends = g.end_states[torch.argmin(final[:, g.end_states] + g.end_bonus, 1)]
    trace = torch.zeros((b, 9), dtype=torch.int64, device=dev)
    before = lk.lex_backtrace_val.launches
    sk, fk = lk.lex_backtrace_val(bp8, eps_prev, g, ends, nf, topo=topo, trace=trace)
    sp, fp = lk.lex_backtrace_val_ref(bp8, eps_prev, g, ends, nf)
    torch.cuda.synchronize()
    assert lk.lex_backtrace_val.launches == before + 1
    assert ("chains", str(dev)) in topo.on_device
    assert torch.equal(sk, sp) and torch.equal(fk, fp)
    ran = nf > 0
    assert bool((trace[ran, 6] >= 1).all()) and torch.equal(trace[:, 8], nf.long())
    if kind in ("1k", "1k_planted") and b > 1:
        assert bool(fp.any())  # eps re-entries on the paths


def _large_bank_case(dev, b, t):
    """The 8,000-bank-row trie (``large_bank_lexicon``), its topology and
    uniform(0, 5) emissions with lengths T, 1 and between."""
    from speech_recognition_tpu_torch.data.lexicon import large_bank_lexicon
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    words, trans, ids, rng = large_bank_lexicon()
    lexg = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    topo = lk.lex_topology(lexg.banded)
    nll = torch.from_numpy(rng.uniform(0, 5, (8000, t, b)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 1, rng.integers(2, t + 1, b)][:b].astype(np.int32)).to(dev)
    return lexg, topo, nll, nf


def test_k4_k5_k6_on_a_bank_past_the_row_tables(dev):
    """8,000 bank rows (the two row tables alone pass 227 KB): the plan
    keeps none, and K4's planes, K5's walk and K6's lattice planes equal
    their plain versions bit for bit."""
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.utils.build import load_library

    lexg, topo, nll, nf = _large_bank_case(dev, 6, 40)
    for lattice in (False, True):
        plan = lk.lex_plan(lattice, topo, load_library().srt_smem_limit())
        assert plan.rep == 0 and not plan.front
    g = lexg.banded.to(dev)
    got = lk.viterbi_lex(nll, g, topo, nf)
    want = lk.viterbi_lex_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    valid = torch.arange(nll.shape[1], device=dev)[:, None] < nf[None, :]
    for k in (1, 2, 3):
        assert bool(((got[k] == want[k]) | ~valid[:, :, None]).all()), k
    ends = g.end_states[torch.argmin(want[0][:, g.end_states] + g.end_bonus, 1)]
    sk, fk = lk.lex_backtrace_val(got[1], got[3], g, ends, nf, topo=topo)
    sp, fp = lk.lex_backtrace_val_ref(want[1], want[3], g, ends, nf)
    torch.cuda.synchronize()
    assert bool(((sk == sp) & (fk == fp) | ~valid).all())
    got = lt.viterbi_lattice(nll, g, topo, nf)
    want = lt.viterbi_lattice_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_k4_k6_with_wide_records(dev):
    """~1M bank rows and ~3,200 cross links: the wide records (two words
    per state) through K4 and K6, bit-identical to the plain versions."""
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    words, trans, ids, rng = bench_lexicon()
    g = build_lex_graph(words, trans, ids, unigram_cost=rng.uniform(0.1, 2.0, len(words)),
                        word_insertion_cost=0.5).banded
    g = g._replace(bank_state=g.bank_state * 45000)
    topo = lk.lex_topology(g)
    assert topo.pack.wide
    b, t = 3, 12
    gen = torch.Generator(device=dev).manual_seed(5)
    nll = torch.rand((topo.max_bank_state + 1, t, b), generator=gen, device=dev) * 5
    nf = torch.tensor([t, 1, 7], dtype=torch.int32, device=dev)
    g = g.to(dev)
    got = lk.viterbi_lex(nll, g, topo, nf)
    want = lk.viterbi_lex_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    valid = torch.arange(t, device=dev)[:, None] < nf[None, :]
    for k in (1, 2, 3):
        assert bool(((got[k] == want[k]) | ~valid[:, :, None]).all()), k
    got = lt.viterbi_lattice(nll, g, topo, nf)
    want = lt.viterbi_lattice_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    assert all(torch.equal(a, w) for a, w in zip(got, want))


def test_decode_lextree_on_a_large_bank_cuda_matches_cpu(dev):
    """``decode_lextree`` over a 2,000-unit bank (8,000 bank rows, the
    device-row plan) prints the same words on the card as on the CPU."""
    from speech_recognition_tpu_torch.data.lexicon import large_bank_lexicon
    from speech_recognition_tpu_torch.decode.lextree import decode_lextree
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    bank = _bank(2000, 4, 2, 6, seed=9)
    words, _, ids, rng = large_bank_lexicon()
    lexg = build_lex_graph(words, [bank.trans_cost[i].numpy() for i in range(2000)], ids,
                           word_insertion_cost=1.0)
    feats = torch.from_numpy(rng.standard_normal((5, 40, 6)).astype(np.float32))
    nf = torch.from_numpy(np.r_[40, 1, rng.integers(12, 41, 3)].astype(np.int32))
    w_c, c_c = decode_lextree(bank, lexg, feats, nf)
    w_g, c_g = decode_lextree(bank.to(dev), lexg, feats.to(dev), nf.to(dev))
    assert w_g == w_c
    np.testing.assert_allclose(c_g, c_c, rtol=1e-5)


def _general_graph(kind):
    """``(bank, graph)`` for the general banded path (K8 + K9) or, for
    ``loop_lm`` / ``loop_int32``, a graph the fused kernels also take."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph

    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "sausage_1state":  # starts == ends: eps depth 3 at 4 slots
        bank = _bank(5, 1, 2, 6)
        trans = [bank.trans_cost[i].numpy() for i in range(5)]
        return bank, build_word_graph(trans, [list(range(5))] * 4, word_insertion_cost=0.3)
    if kind == "loop_int32":  # 130 word ends: int32 eps_u
        bank = _bank(130, 3, 2, 6)
        return bank, build_loop_graph([bank.trans_cost[i].numpy() for i in range(130)],
                                      word_insertion_cost=0.5)
    bank = _bank(5, 4, 2, 6)
    trans = [t[:k, :k] for t, k in zip(bank.trans_cost.numpy(), (2, 1, 3, 2, 4))]
    if kind == "sausage_mixed":
        return bank, build_word_graph(trans, [list(range(5))] * 3, word_insertion_cost=0.3)
    if kind == "transcript":
        return bank, build_word_graph(trans, [[2], [0, 1], [3], [4]], optional_layers=[1],
                                      end_layers=[2, 3])
    lm = types.SimpleNamespace(cost=rng.uniform(0.1, 3.0, (5, 5)),
                               start_cost=rng.uniform(0.1, 2.0, 5),
                               end_cost=rng.uniform(0.1, 2.0, 5))
    full = [bank.trans_cost[i].numpy() for i in range(5)]
    return bank, build_loop_graph(full, lm=lm, word_insertion_cost=0.4)


@pytest.mark.parametrize("kind,b,t,ties", [
    ("sausage_1state", 5, 17, False),
    ("sausage_1state", 37, 12, True),   # integer emissions: ties everywhere
    ("sausage_mixed", 3, 20, False),
    ("sausage_mixed", 9, 15, True),
    ("transcript", 11, 14, False),
    ("loop_lm", 6, 13, True),
    ("loop_int32", 4, 9, False),
])
def test_k8_k9_match_plain(dev, kind, b, t, ties):
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    bank, graph = _general_graph(kind)
    g = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(g)
    rng = np.random.default_rng(b * t)
    u = bank.n_models * bank.n_states
    nll = (rng.integers(0, 3, (u, t, b)) if ties else rng.uniform(0, 6, (u, t, b)))
    nll = torch.from_numpy(nll.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 1, 0, rng.integers(1, t + 1, b)][:b].astype(np.int32)).to(dev)
    before = (vk.viterbi_banded_general.launches, vk.banded_backtrace_general.launches)
    got = vk.viterbi_banded_general(nll, g, topo, nf, graph.eps_depth)
    want = vk.viterbi_banded_general_ref(nll, g, topo, nf, graph.eps_depth)
    torch.cuda.synchronize()
    assert got[2].dtype == (torch.int32 if g.n_ends > 127 else torch.int8)
    for k in range(3):  # every frame, frozen ones included
        assert torch.equal(got[k], want[k]), k
    ends = g.end_states[torch.argmin(want[0][g.end_states] + g.end_bonus[:, None], 0)]
    sk, fk = vk.banded_backtrace_general(got[1], got[2], g, ends, nf, graph.eps_depth)
    sp, fp = vk.banded_backtrace_general_ref(want[1], want[2], g, ends, nf, graph.eps_depth)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(fk, fp)
    assert (vk.viterbi_banded_general.launches,
            vk.banded_backtrace_general.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("kind,b,t", [
    ("sausage7_1state", 500, 120),   # int8 eps_u, eps depth 6, B = 500
    ("loop_int32", 500, 60),         # int32 eps_u (130 word ends)
    ("loop_2000", 32, 100),          # 2,000 words of 2-5 states: tables through L1
])
def test_k9_at_scale_matches_plain(dev, kind, b, t):
    """K9 on K8's planes, states and flags bit-identical to the plain
    version, with lengths 0, 1, T and T + 3."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    if kind == "sausage7_1state":
        bank = _bank(11, 1, 2, 6)
        graph = build_word_graph([bank.trans_cost[i].numpy() for i in range(11)],
                                 [list(range(11))] * 7)
        assert graph.eps_depth == 6
    elif kind == "loop_int32":
        bank, graph = _general_graph(kind)
    else:
        bank = _bank(11, 5, 2, 6)
        graph = build_loop_graph([bank.trans_cost[i % 11].numpy()[:k, :k] for i, k in
                                  zip(range(2000), (3, 4, 5, 2) * 500)],
                                 word_insertion_cost=0.5)
    g = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(g)
    rng = np.random.default_rng(b + t)
    u = int(graph.bank_state.max()) + 1
    nll = torch.from_numpy(rng.uniform(0, 5, (u, t, b)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 0, 1, t + 3, rng.integers(2, t + 1, b - 4)]
                          .astype(np.int32)).to(dev)
    fin, bp8, eps_u = vk.viterbi_banded_general(nll, g, topo, nf, graph.eps_depth)
    assert eps_u.dtype == (torch.int32 if g.n_ends > 127 else torch.int8)
    ends = g.end_states[torch.argmin(fin[g.end_states] + g.end_bonus[:, None], 0)]
    before = vk.banded_backtrace_general.launches
    sk, fk = vk.banded_backtrace_general(bp8, eps_u, g, ends, nf, graph.eps_depth)
    sp, fp = vk.banded_backtrace_general_ref(bp8, eps_u, g, ends, nf, graph.eps_depth)
    torch.cuda.synchronize()
    assert vk.banded_backtrace_general.launches == before + 1
    assert torch.equal(sk, sp) and torch.equal(fk, fp)
    assert int(fp.sum()) > 0  # the walks unwound eps arrivals


@pytest.mark.parametrize("kind,b,t,n_mix", [
    ("loop", 3, 17, 2),
    ("sausage", 11, 15, 2),
    ("loop_lm", 37, 20, 11),    # three mixture blocks of K13's logsumexp
    ("loop_int32", 5, 9, 2),    # 130 word ends: int32 eps_u
])
def test_k10_matches_plain(dev, kind, b, t, n_mix):
    from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    n_models = 130 if kind == "loop_int32" else 4
    bank = _bank(n_models, 3, n_mix, 6).to(dev)
    trans = [bank.trans_cost[i].cpu().numpy() for i in range(n_models)]
    rng = np.random.default_rng(5)
    if kind == "sausage":
        graph = build_word_graph(trans, [list(range(n_models))] * 3)
    else:
        lm = None
        if kind == "loop_lm":
            lm = types.SimpleNamespace(cost=rng.uniform(0.1, 3.0, (n_models, n_models)),
                                       start_cost=rng.uniform(0.1, 2.0, n_models),
                                       end_cost=rng.uniform(0.1, 2.0, n_models))
        graph = build_loop_graph(trans, lm=lm, word_insertion_cost=0.5)
    g = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(g)
    feats = torch.from_numpy(rng.standard_normal((b, t, 6)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 1, 0, rng.integers(1, t + 1, b)][:b].astype(np.int32)).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    xa = augment_dtb(feats)
    _check_k10(xa, w, lw, g, topo, nf)


def _check_k10(xa, w, lw, g, topo, nf):
    """K10 = one K13 launch + one word-trace DP launch; the DP's outputs
    bit-identical to the plain DP on K13's own plane (every frame), final
    costs within rtol 1e-5 of the whole plain version and equal to K1's
    (the same K13 plane, the same band and eps rule)."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk

    before = (vk.bank_emission.launches, vk.viterbi_banded_wordtrace.launches)
    got = vk.viterbi_banded_wordtrace(xa, w, lw, g, topo, nf)
    torch.cuda.synchronize()
    assert (vk.bank_emission.launches, vk.viterbi_banded_wordtrace.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got[1].dtype == (torch.int32 if g.n_ends > 127 else torch.int8)
    dp = vk._wordtrace_dp(vk.bank_emission(xa, w, lw), g, nf)
    want = vk.viterbi_banded_wordtrace_ref(xa, w, lw, g, topo, nf)
    k1 = vk.viterbi_banded_fused(xa, w, lw, g, topo, nf)
    torch.cuda.synchronize()
    for k in range(4):
        assert torch.equal(got[k], dp[k]), k
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    assert torch.equal(got[0], k1[0])


@pytest.mark.parametrize("b,t", [(3, 8), (200, 5)])
def test_k10_on_a_7500_state_loop(dev, b, t):
    """K10 past its old ~6,400-state limit: a 1,500-word loop of 5-state
    words (7,500 states), the work area in shared memory at B = 3 and in
    the device scratch at B = 200; lengths 0, 1, T and T + 3."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.utils.build import load_library

    bank = _bank(11, 5, 4, 39).to(dev)
    _, g = _big_loop(1500, (5,), 55)
    g = g.to(dev)
    topo = vk.banded_topology(g)
    assert topo.fused_ok and g.n_states == 7500
    plan = _plan_agrees_with_kernel(load_library(), "wordtrace", g, 55, b, dev)
    assert plan.frontier == ("shared" if b == 3 else "device")
    rng = np.random.default_rng(b)
    feats = torch.from_numpy(rng.standard_normal((b, t, 39)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[0, t + 3, 1, t, rng.integers(1, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    _check_k10(augment_dtb(feats), w, lw, g, topo, nf)


@pytest.mark.parametrize("n_models,n_states,n_mix,dim,t,b,staged", [
    (7, 3, 3, 6, 7, 9, True),        # U = 21, M = 3, N = 63: 4-byte feature copies
    (5, 5, 6, 39, 13, 8, True),      # U = 25, M = 6: two mixture blocks, N = 104
    (11, 10, 8, 39, 9, 37, False),   # U = 110, weights from device memory, N = 333
    (13, 10, 5, 39, 11, 16, False),  # U = 130, M = 5 unstaged, N = 176
])
def test_k13_edge_shapes(dev, n_models, n_states, n_mix, dim, t, b, staged):
    """K13 where the main path's shape hides the edges: U not a multiple of
    32 (the items wrap across warps), M not a multiple of 4 (padded
    mixtures, more than one block), N not a multiple of the 64-column tile
    (and not of 4), the weights unstaged; within rtol 1e-5 / atol 1e-4 of
    its plain version, its Python and CUDA byte counts equal."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    bank = _bank(n_models, n_states, n_mix, dim, seed=n_mix).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    u, a = w.shape[0], w.shape[2]
    for st in (0, 1):
        assert lib.bank_emission_smem_bytes(a, u, n_mix, st) == vk._emission_smem(
            a, u, n_mix, bool(st))
    assert (vk._emission_smem(a, u, n_mix, True) <= lib.srt_smem_limit()) == staged
    rng = np.random.default_rng(t * b)
    xa = augment_dtb(torch.from_numpy(rng.standard_normal((b, t, dim))
                                      .astype(np.float32)).to(dev))
    before = vk.bank_emission.launches
    got = vk.bank_emission(xa, w, lw)
    want = vk.bank_emission_ref(xa, w, lw)
    torch.cuda.synchronize()
    assert vk.bank_emission.launches == before + 1
    assert got.shape == (u, t, b) and got.stride() == (1, b * u, u)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_decode_general_and_wordtrace_cuda_match_cpu(dev):
    from speech_recognition_tpu_torch.decode.connected import decode_connected
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk

    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.standard_normal((9, 60, 6)).astype(np.float32))
    nf = torch.from_numpy(np.r_[60, 1, rng.integers(2, 61, 7)].astype(np.int32))
    for kind in ("sausage_1state", "sausage_mixed", "transcript"):
        bank, graph = _general_graph(kind)
        bank_g = _general_graph(kind)[0].to(dev)  # Module.to moves in place
        before = (vk.viterbi_banded_general.launches, vk.viterbi_banded_fused.launches)
        w_g, c_g = decode_connected(bank_g, graph, feats.to(dev), nf.to(dev))
        assert (vk.viterbi_banded_general.launches,
                vk.viterbi_banded_fused.launches) == (before[0] + 1, before[1])
        w_c, c_c = decode_connected(bank, graph, feats, nf)
        assert w_g == w_c, kind
        np.testing.assert_allclose(c_g, c_c, rtol=1e-5)
    bank, bank_g = _bank(4, 3, 2, 6), _bank(4, 3, 2, 6).to(dev)
    graph = build_loop_graph([bank.trans_cost[i].numpy() for i in range(4)],
                             word_insertion_cost=0.5)
    before = vk.viterbi_banded_wordtrace.launches
    w_g, c_g = decode_connected(bank_g, graph, feats.to(dev), nf.to(dev),
                                backend="wordtrace")
    assert vk.viterbi_banded_wordtrace.launches == before + 1
    w_c, c_c = decode_connected(bank, graph, feats, nf, backend="wordtrace")
    w_a, c_a = decode_connected(bank_g, graph, feats.to(dev), nf.to(dev))
    assert w_g == w_c == w_a
    np.testing.assert_allclose(c_g, c_c, rtol=1e-5)
    np.testing.assert_allclose(c_g, c_a, rtol=1e-5)


def test_general_and_wordtrace_wrappers_raise_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    bank, graph = _general_graph("sausage_mixed")
    g = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(g)
    nll = torch.zeros((bank.n_models * bank.n_states, 6, 2), device=dev)
    nf = torch.full((2,), 6, dtype=torch.int32, device=dev)
    counts = (vk.viterbi_banded_general.launches, vk.banded_backtrace_general.launches,
              vk.viterbi_banded_wordtrace.launches)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        vk.viterbi_banded_general(nll, g, topo, nf.cpu(), graph.eps_depth)
    with pytest.raises(ValueError, match="float32"):
        vk.viterbi_banded_general(nll.double(), g, topo, nf, graph.eps_depth)
    lexg, n_bank = _lex_graph("deep")
    gl = lexg.banded.to(dev)
    with pytest.raises(ValueError, match="cross edges"):
        vk.viterbi_banded_general(torch.zeros((n_bank, 6, 2), device=dev), gl,
                                  vk.banded_topology(gl), nf)
    bp8 = torch.zeros((6, g.n_states, 2), dtype=torch.int8, device=dev)
    eps_u = torch.zeros((6, g.n_words, 2), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="eps_u"):
        vk.banded_backtrace_general(bp8, eps_u.long(), g, g.end_states[:2], nf)
    with pytest.raises(ValueError, match="end_state is on cpu"):
        vk.banded_backtrace_general(bp8, eps_u, g, g.end_states[:2].cpu(), nf)
    w, lw = gmm_emission_weights(*bank.to(dev).flat_states())
    xa = augment_dtb(torch.zeros((2, 6, 6), device=dev))
    with pytest.raises(ValueError, match="word-trace"):
        vk.viterbi_banded_wordtrace(xa, w, lw, g, topo, nf)
    assert (vk.viterbi_banded_general.launches, vk.banded_backtrace_general.launches,
            vk.viterbi_banded_wordtrace.launches) == counts


# ---------------------------------------------------------------------------
# K11 (dense Viterbi) and K12 (MFCC cepstra)
# ---------------------------------------------------------------------------


def _dense_problem(seed, b, t, s, per_item=False, eps=False, ties=False, nf=None):
    """Random dense graphs: emissions (uniform, or integers 0..2 that force
    ties), transition / eps matrices with POS_INF holes (integers too with
    ``ties``), init costs finite on the first few states."""
    from speech_recognition_tpu_torch.utils.numerics import POS_INF

    rng = np.random.default_rng(seed)
    lead = (b,) if per_item else ()

    def mat(p_hole):
        m = (rng.integers(0, 3, lead + (s, s)) if ties
             else rng.uniform(0, 3, lead + (s, s))).astype(np.float32)
        m[rng.uniform(size=m.shape) < p_hole] = POS_INF
        return torch.from_numpy(m)

    e = rng.integers(0, 3, (b, t, s)) if ties else rng.uniform(0, 5, (b, t, s))
    init = rng.uniform(0, 2, s).astype(np.float32)
    init[max(1, s // 4):] = POS_INF
    if nf is None:
        nf = np.r_[t, 0, 1, rng.integers(2, t + 1, max(b - 3, 0))][:b]
    return (torch.from_numpy(e.astype(np.float32)), mat(0.5), torch.from_numpy(init),
            torch.from_numpy(np.asarray(nf, np.int32)), mat(0.8) if eps else None)


@pytest.mark.parametrize("b,t,s,per_item,eps,depth,ties", [
    (37, 40, 5, True, False, 1, False),     # isolated shape: 8 items per CTA, 5 CTAs
    (37, 40, 5, True, False, 1, True),
    (11, 30, 32, False, True, 2, True),     # the largest warp-per-item graph
    (9, 50, 75, True, True, 2, False),      # transcript-graph size, matrices staged
    (9, 50, 75, True, True, 1, True),
    (6, 40, 385, False, True, 1, False),    # the sausage size, matrices in L2
    (5, 24, 200, False, True, 2, True),     # above the staging size
])
@pytest.mark.parametrize("planes", [True, False])
def test_k11_matches_plain(dev, b, t, s, per_item, eps, depth, ties, planes):
    from speech_recognition_tpu_torch.ops.viterbi_kernels import (
        viterbi_dense,
        viterbi_dense_ref,
    )

    nll, trans, init, nf, eps_m = _dense_problem(b * s + t, b, t, s, per_item, eps, ties)
    want = viterbi_dense_ref(nll, trans, init, nf, eps_m, depth, planes=planes)
    before = viterbi_dense.launches
    got = viterbi_dense(nll.to(dev), trans.to(dev), init.to(dev), nf.to(dev),
                        eps_m.to(dev) if eps_m is not None else None, depth, planes=planes)
    torch.cuda.synchronize()
    assert viterbi_dense.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    if planes:  # every frame of both planes, frozen ones included
        assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
    else:
        assert got[1] is None and got[2] is None
    assert bool((want[0][1] == 1e30).all())  # nf = 0: POS_INF


# K11 in each of its forms: (S, B, per item, eps, depth, ties).  B is not a
# multiple of the items per warp (floor(32 / S), 4 warps) or per cluster (4
# items a cluster where the batch outnumbers the SMs, as at B = 150);
# S steps over the plan's boundaries: packed -> rows at 33, the cluster
# size at B = 5 (1 -> 2 CTAs at 63 states, 7 -> 8 at 249), rows -> wide at
# 465 (shared, eps) and 477 (per item, eps).
K11_FORMS = [
    (1, 37, True, False, 1, True), (5, 37, True, False, 1, False),
    (5, 29, False, True, 3, True), (6, 11, True, True, 2, True),
    (16, 9, False, True, 1, False), (31, 7, True, True, 3, True),
    (32, 5, True, True, 2, False), (33, 9, False, True, 2, True),
    (33, 5, True, True, 1, True), (62, 5, False, True, 1, False),
    (63, 5, False, True, 3, True), (64, 6, True, False, 1, True),
    (248, 5, False, False, 1, False), (249, 5, False, True, 2, True),
    (385, 6, False, True, 1, False), (385, 3, True, True, 2, True),
    (464, 5, False, True, 1, True), (465, 5, False, True, 1, False),
    (476, 3, True, True, 1, False), (477, 3, True, True, 1, True),
    (40, 150, False, True, 2, True),
]


@pytest.mark.parametrize("s,b,per_item,eps,depth,ties", K11_FORMS)
@pytest.mark.parametrize("planes", [True, False])
def test_k11_forms_match_plain(dev, s, b, per_item, eps, depth, ties, planes):
    """Every frame of final, bp and eps_bp bit-identical to the plain
    version in the form ``dense_plan`` picks; final with planes off equals
    final with planes on."""
    from speech_recognition_tpu_torch.ops.viterbi_kernels import (
        viterbi_dense,
        viterbi_dense_ref,
    )

    t = 24 if s > 100 else 40
    nll, trans, init, nf, eps_m = _dense_problem(s * 7 + b, b, t, s, per_item, eps, ties)
    want = viterbi_dense_ref(nll, trans, init, nf, eps_m, depth)
    before = viterbi_dense.launches
    got = viterbi_dense(*(x.to(dev) if x is not None else None
                          for x in (nll, trans, init, nf, eps_m)), depth, planes=planes)
    torch.cuda.synchronize()
    assert viterbi_dense.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    if planes:
        assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])
    else:
        assert got[1] is None and got[2] is None


def _forced_dense_plans(lib, dev, b, s, per_item, use_eps):
    """Every plan K11 can run at this shape: the row forms at each cluster
    size whose rows fit, the wide form, the scratch frontier, and the
    packed form where S <= 32."""
    from speech_recognition_tpu_torch.ops import viterbi_kernels as tvk

    limit, plans = lib.srt_smem_limit(), []
    if s <= 32:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        return [tvk.dense_plan(b, s, per_item, use_eps, limit, n_sm, tvk._cluster_slots(dev))]
    lanes = tvk.ITEM_LANES if per_item else tvk.CLUSTER_LANES
    for ki in (1,) if per_item else (1, tvk.CLUSTER_ITEMS):
        for c in range(1, tvk.MAX_CLUSTER + 1):
            for k in lanes:
                r = -(-s // c)
                smem = tvk.dense_smem_bytes("item", s, per_item, use_eps, r, k, ki)
                warps = tvk._rows_layout(s, r, k, ki)[0]
                if smem <= limit and warps * 32 <= tvk.ROWS_MAX_THREADS:
                    plans.append(tvk.DensePlan("item" if per_item else "cluster", 0, warps,
                                               c, ki, r, k, -(-b // ki) * c, smem))
    smem = tvk.dense_smem_bytes("wide", s, per_item, use_eps)
    if smem <= limit:
        plans.append(tvk.DensePlan("wide", 0, 32, 1, 0, s, 0, b, smem))
    plans.append(tvk.DensePlan("scratch", 0, 32, 1, 0, s, 0, b, 0))
    return plans


@pytest.mark.parametrize("s,b,per_item,eps,depth", [
    (48, 7, False, True, 2), (48, 5, True, True, 3), (100, 6, False, False, 1),
    (5, 9, True, False, 1),
])
def test_k11_every_plan_matches_plain(dev, s, b, per_item, eps, depth):
    """The integer tie batch (every minimum ties; POS_INF holes) in every
    plan K11 can run: the kernel's layout agrees with ``dense_smem_bytes``
    (the launcher refuses a plan whose bytes differ) and every output is
    bit-identical."""
    from speech_recognition_tpu_torch.ops import viterbi_kernels as tvk
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    nll, trans, init, nf, eps_m = _dense_problem(s + b, b, 30, s, per_item, eps, True)
    want = tvk.viterbi_dense_ref(nll, trans, init, nf, eps_m, depth)
    args = [x.to(dev) if x is not None else None for x in (nll, trans, init, nf, eps_m)]
    plans = _forced_dense_plans(lib, dev, b, s, per_item, eps)
    assert len({p.form for p in plans}) >= (1 if s <= 32 else 3)
    for plan in plans:
        assert lib.viterbi_dense_smem_bytes(tvk.FORMS[plan.form], s, int(per_item), int(eps),
                                            *plan.params) == plan.smem
        got = tvk._launch(*args, depth, plan=plan)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu(), w_), plan


def test_k11_plan_agrees_with_kernel(dev):
    """``dense_smem_bytes`` equals the kernel's layout for every plan of
    S = 1..64 and the main path's shapes."""
    from speech_recognition_tpu_torch.ops import viterbi_kernels as tvk
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for s in list(range(1, 65)) + [75, 385, 500, 11623]:
        for per_item in (False, True):
            for eps in (False, True):
                p = tvk.dense_plan(64, s, per_item, eps, lib.srt_smem_limit(), n_sm,
                                   tvk._cluster_slots(dev))
                assert lib.viterbi_dense_smem_bytes(tvk.FORMS[p.form], s, int(per_item),
                                                    int(eps), *p.params) == p.smem


def test_k11_edge_lengths_and_per_item_init(dev):
    """nf past T (final stays POS_INF, as the scan never reaches nf - 1),
    T = 1, and a per-item init row."""
    from speech_recognition_tpu_torch.ops.viterbi_kernels import (
        viterbi_dense,
        viterbi_dense_ref,
    )

    for t, s, nf in ((12, 40, [12, 15, 0, 1, 7]), (1, 6, [1, 0, 3, 1, 1])):
        nll, trans, _, nf_t, eps_m = _dense_problem(3, 5, t, s, eps=True, nf=nf)
        init = torch.from_numpy(np.random.default_rng(4).uniform(0, 2, (5, s))
                                .astype(np.float32))
        want = viterbi_dense_ref(nll, trans, init, nf_t, eps_m, 1)
        got = viterbi_dense(*(x.to(dev) for x in (nll, trans, init, nf_t, eps_m)), 1)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_.cpu(), w_)


def test_k11_through_the_slice(dev):
    """classify_batch, dtw_classify_batch, the dense connected decode and
    align_batch on the card against the CPU: predictions, words and ids
    equal, costs at rtol 1e-5 (emission GEMMs on two devices)."""
    from speech_recognition_tpu_torch.decode.connected import decode_connected
    from speech_recognition_tpu_torch.decode.dtw import TemplateBank, dtw_classify_batch
    from speech_recognition_tpu_torch.decode.isolated import classify_batch
    from speech_recognition_tpu_torch.models.graph import (
        build_word_graph,
        pad_graphs,
        transcript_graph,
    )
    from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense
    from speech_recognition_tpu_torch.train.continuous import align_batch

    bank, bank_g = _bank(5, 4, 2, 6), _bank(5, 4, 2, 6).to(dev)
    feats = torch.from_numpy(np.random.default_rng(5).standard_normal((7, 30, 6))
                             .astype(np.float32))
    nf = torch.tensor([30, 1, 0, 12, 29, 5, 17], dtype=torch.int32)
    before = viterbi_dense.launches
    p_g, c_g = classify_batch(bank_g, feats.to(dev), nf.to(dev))
    p_c, c_c = classify_batch(bank, feats, nf)
    assert torch.equal(p_g.cpu(), p_c)
    np.testing.assert_allclose(c_g.cpu().numpy(), c_c.numpy(), rtol=1e-5)
    tb = TemplateBank(bank.means[:, :, 0], torch.exp(bank.log_vars[:, :, 0]), bank.trans_cost)
    p_g, c_g = dtw_classify_batch(tb.to(dev), feats.to(dev), nf.to(dev))
    p_c, c_c = dtw_classify_batch(tb, feats, nf)
    assert torch.equal(p_g.cpu(), p_c)
    np.testing.assert_allclose(c_g.cpu().numpy(), c_c.numpy(), rtol=1e-5)
    trans = [bank.trans_cost[i].numpy() for i in range(5)]
    graph = build_word_graph(trans, [[0, 1, 2, 3, 4]] * 3)
    nf3 = torch.clamp(nf, min=12)
    w_g, k_g = decode_connected(bank_g, graph, feats.to(dev), nf3.to(dev),
                                backend="dense")
    w_c, k_c = decode_connected(bank, graph, feats, nf3, backend="dense")
    assert w_g == w_c
    np.testing.assert_allclose(k_g, k_c, rtol=1e-5)
    gb, depth = pad_graphs([transcript_graph(trans, [i % 4, (i + 1) % 4], sil=4)
                            for i in range(7)])
    arrs = [torch.as_tensor(gb[k]) for k in ("trans", "eps_trans", "init_cost",
                                             "end_states", "bank_state")]
    i_g, a_g = align_batch(bank_g, feats.to(dev), nf3.to(dev),
                           *(x.to(dev) for x in arrs), eps_depth=depth)
    i_c, a_c = align_batch(bank, feats, nf3, *arrs, eps_depth=depth)
    assert torch.equal(i_g.cpu(), i_c)
    np.testing.assert_allclose(a_g.cpu().numpy(), a_c.numpy(), rtol=1e-5)
    assert viterbi_dense.launches == before + 4


def test_k11_raises_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops.viterbi_kernels import (
        max_dense_states,
        viterbi_dense,
        viterbi_dense_ref,
    )
    from speech_recognition_tpu_torch.utils.build import load_library

    nll, trans, init, nf, eps_m = _dense_problem(6, 3, 8, 40, eps=True)
    nll, trans, init, nf, eps_m = (x.to(dev) for x in (nll, trans, init, nf, eps_m))
    before = viterbi_dense.launches
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        viterbi_dense(nll, trans, init, nf.cpu())
    with pytest.raises(ValueError, match="float32"):
        viterbi_dense(nll.double(), trans, init, nf)
    with pytest.raises(ValueError, match="both be shared or both per item"):
        viterbi_dense(nll, trans, init, nf, eps_m[None].expand(3, 40, 40))
    assert viterbi_dense.launches == before
    # one state past the shared-memory frontier: the device-memory scratch,
    # equal to the plain version (random costs with POS_INF holes)
    s = max_dense_states(load_library()) + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    trans = torch.rand((s, s), generator=gen, device=dev) * 3
    trans[torch.rand((s, s), generator=gen, device=dev) < 0.5] = 1e30
    args = (torch.rand((2, 3, s), generator=gen, device=dev) * 5, trans,
            torch.rand(s, generator=gen, device=dev), nf[:2].clamp(min=1))
    got = viterbi_dense(*args)
    want = viterbi_dense_ref(*args)
    torch.cuda.synchronize()
    assert viterbi_dense.launches == before + 1
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("rate,lens", [
    (16000, [16000, 7321, 400, 123, 16000, 561]),
    (8000, [8000, 3000, 5555, 200]),
    (16000, [400000, 31000]),   # 2,499 frames
    (8000, [200000, 8000]),
    (16000, [16000, 300, 500, 700]),  # nf 1, 2, 3
    (48000, [48000, 20000, 1000]),    # 1200-sample frames fold onto the FFT
    (44100, [30000, 44100]),          # 1102-sample frames
])
def test_k12_matches_plain(dev, rate, lens):
    from speech_recognition_tpu_torch.ops.frontend import mfcc, padded_length
    from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc_fused, mfcc_fused_ref

    cfg = FrontendConfig(sample_rate=rate)
    rng = np.random.default_rng(2)
    sig = (rng.standard_normal((len(lens), padded_length(cfg, max(lens)))) * 3000)
    sig = torch.from_numpy(sig.astype(np.float32))
    ln = torch.tensor(lens, dtype=torch.int32)
    before = mfcc_fused.launches
    got, nf_k = mfcc_fused(sig.to(dev), ln.to(dev), cfg)
    want, nf_p = mfcc_fused_ref(sig.to(dev), ln.to(dev), cfg)
    torch.cuda.synchronize()
    assert mfcc_fused.launches == before + 1
    assert torch.equal(nf_k, nf_p)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=5e-4)
    one, n1 = mfcc(sig[1].to(dev), lens[1], cfg)  # ops.frontend.mfcc on CUDA runs K12
    assert mfcc_fused.launches == before + 2 and int(n1) == int(nf_p[1])
    torch.testing.assert_close(one, want[1], rtol=2e-3, atol=5e-4)


def test_k12_raises_for_configs_it_does_not_implement(dev):
    from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc_fused

    sig = torch.zeros((2, 4000), device=dev)
    ln = torch.full((2,), 4000, dtype=torch.int32, device=dev)
    before = mfcc_fused.launches
    with pytest.raises(ValueError, match="does not implement"):
        mfcc_fused(sig, ln, FrontendConfig(variant="scratch"))
    with pytest.raises(ValueError, match="float32"):
        mfcc_fused(sig.double(), ln)
    assert mfcc_fused.launches == before


def _templates(seed, n=12, d=39, n_states=5):
    """``n`` [T_i, d] feature sequences sampled from one random GMM-HMM
    (separated states, so no alignment sits near a tie)."""
    rng = np.random.default_rng(seed)
    p = random_gmm_hmm(rng, n_states=n_states, n_mix=2, dim=d, sep=3.0)
    out = []
    for _ in range(n):
        frames = []
        for s in range(n_states):
            for _ in range(int(rng.integers(4, 30))):
                m = rng.choice(2, p=p["weights"][s])
                frames.append(p["means"][s, m]
                              + np.sqrt(p["variances"][s, m]) * rng.standard_normal(d))
        out.append(torch.from_numpy(np.asarray(frames, np.float32)))
    return out


def test_k11_matches_plain_at_the_training_shapes(dev):
    """K11 as segmental K-means calls it (one word's templates, a shared
    5-state chain, Euclidean distances) and as the embedded step calls it
    (per-utterance transcript graphs with optional silence): every plane
    bit-identical."""
    import importlib

    from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
    from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense, viterbi_dense_ref

    skm = importlib.import_module("speech_recognition_tpu_torch.train.skmeans")
    cont = importlib.import_module("speech_recognition_tpu_torch.train.continuous")
    temps = [t.to(dev) for t in _templates(1)]
    calls = []
    orig = skm.viterbi_dense
    skm.viterbi_dense = lambda *a, **k: calls.append((a, k)) or orig(*a, **k)
    try:
        skm.skmeans(temps, 5, pad_to=160)
    finally:
        skm.viterbi_dense = orig
    assert calls and calls[0][0][0].shape == (12, 160, 5) and calls[0][0][1].shape == (5, 5)
    bank = _bank(12, 5, 4, 39, seed=3).to(dev)
    trans = [bank.trans_cost[i].cpu().numpy() for i in range(12)]
    rng = np.random.default_rng(4)
    gb, depth = pad_graphs([transcript_graph(trans, [int(x) for x in rng.integers(
        0, 11, rng.integers(1, 8))], sil=11) for _ in range(40)])
    g = {k: torch.as_tensor(gb[k], device=dev)
         for k in ("trans", "eps_trans", "init_cost", "end_states", "bank_state")}
    feats = torch.from_numpy(rng.standard_normal((40, 300, 39)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(rng.integers(1, 301, 40).astype(np.int32)).to(dev)
    orig = cont.viterbi_dense
    cont.viterbi_dense = lambda *a, **k: calls.append((a, k)) or orig(*a, **k)
    try:
        cont.align_batch(bank, feats, nf, *g.values(), eps_depth=depth)
    finally:
        cont.viterbi_dense = orig
    for a, k in (calls[0], calls[-1]):
        got, want = viterbi_dense(*a, **k), viterbi_dense_ref(*a, **k)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            assert torch.equal(g_, w_)


def test_isolated_train_cuda_matches_cpu(dev):
    """``fit_hmm`` on the card and on the CPU from the same draws: the same
    segmental K-means states and transitions, parameters at rtol 1e-4 /
    atol 1e-4 (f32 GEMMs and sums in other orders)."""
    import importlib

    from speech_recognition_tpu_torch.config import HMMConfig
    from speech_recognition_tpu_torch.train.isolated import fit_hmm
    from speech_recognition_tpu_torch.train.kmeans import random_assign

    skm = importlib.import_module("speech_recognition_tpu_torch.train.skmeans")
    temps = _templates(5)
    out = []
    for d in ("cpu", dev):
        ts = [t.to(d) for t in temps]
        sk = skm.skmeans(ts, 5, pad_to=160)
        model = fit_hmm(ts, hmm_cfg=HMMConfig(n_mix=4), pad_to=160,
                        draw_assign=random_assign(torch.Generator().manual_seed(0)))
        out.append((sk[3].cpu(), sk[2], model))
    (s_c, t_c, m_c), (s_g, t_g, m_g) = out
    assert torch.equal(s_c, s_g)
    np.testing.assert_array_equal(t_c, t_g)
    for f in ("means", "log_vars", "log_weights", "trans_cost"):
        torch.testing.assert_close(getattr(m_g, f).cpu(), getattr(m_c, f), rtol=1e-4, atol=1e-4)


def _fb_close(got, want):
    torch.testing.assert_close(got.log_z, want.log_z, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.gamma, want.gamma, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.xi_sum, want.xi_sum, rtol=1e-4, atol=1e-3)
    assert (got.xi_cross is None) == (want.xi_cross is None)
    if got.xi_cross is not None:
        torch.testing.assert_close(got.xi_cross, want.xi_cross, rtol=1e-4, atol=1e-3)


def _fb_transcripts(rng, b, dev):
    from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
    from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans

    trans = [uniform_left_to_right_trans(5) for _ in range(12)]
    graphs = [transcript_graph(trans, [int(x) for x in rng.integers(0, 11, rng.integers(1, 5))],
                               sil=11) for _ in range(b)]
    return graphs, pad_graphs(graphs)


def _fb_twice(fn):
    """Two calls on the same inputs: the second must repeat the first bit
    for bit (no atomics, one order per sum)."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    return got


@pytest.mark.parametrize("xi_mode", ["band", "dense"])
@pytest.mark.parametrize("graph", ["transcripts", "past the shared-memory tier", "ergodic",
                                   "unreachable item", "lists in device memory"])
def test_fb_dense_kernel_edge_cases(dev, xi_mode, graph):
    """K16 on per-item transcript graphs with lengths T, 0, 1 and mixed
    (padded graph rows), on a 170-state loop, on an ergodic HMM (every
    entry finite: the lists are the whole matrices), on transcripts with
    one item whose every state is unreachable, and on a 3,500-state loop
    whose lists the plan puts in device memory (eps rows past their
    capacity run the dense loop); every call twice, bit for bit."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from speech_recognition_tpu_torch.utils.build import load_library

    rng = np.random.default_rng(5)
    b, t_len = 12, 40
    if graph in ("transcripts", "unreachable item"):
        _, (gb, depth) = _fb_transcripts(rng, b, dev)
        args = [torch.as_tensor(gb[k], device=dev) for k in ("trans", "init_cost")]
        eps, end = (torch.as_tensor(gb[k], device=dev) for k in ("eps_trans", "end_scores"))
        if graph == "unreachable item":
            args[1][4] = 1e30
    elif graph == "ergodic":
        args = [torch.from_numpy(rng.uniform(0.5, 4, (b, 48, 48)).astype(np.float32)).to(dev),
                torch.from_numpy(rng.uniform(0, 2, 48).astype(np.float32)).to(dev)]
        eps = torch.from_numpy(rng.uniform(3, 8, (b, 48, 48)).astype(np.float32)).to(dev)
        end, depth = None, 1
    else:
        n_words = 34 if graph == "past the shared-memory tier" else 700
        if graph == "lists in device memory":
            b, t_len = 3, 8
        lg = build_loop_graph([uniform_left_to_right_trans(5) for _ in range(n_words)])
        args = [torch.as_tensor(x, device=dev) for x in (lg.trans, lg.init_cost)]
        eps, end, depth = torch.as_tensor(lg.eps_trans, device=dev), None, 1
    s = args[0].shape[-1]
    if graph == "lists in device memory":
        lib = load_library()
        plan = fk.dense_plan(s, True, b, torch.cuda.get_device_properties(dev)
                             .multi_processor_count, lib.fb_dense_smem_bytes,
                             lib.srt_smem_limit())
        assert plan.lists == "device"
    nll = torch.from_numpy(rng.uniform(40, 60, (b, t_len, s)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t_len, 0, 1, rng.integers(2, t_len, b - 3)].astype(
        np.int32)).to(dev)
    before = fk.fb_dense.launches
    got = _fb_twice(lambda: fk.fb_dense(nll, *args, nf, eps, depth, end, xi_mode))
    want = fk.fb_dense_ref(nll, *args, nf, eps, depth, end, xi_mode)
    torch.cuda.synchronize()
    assert fk.fb_dense.launches == before + 2
    _fb_close(got, want)
    assert not got.gamma[1].any() and not got.gamma[2, 1:].any() and not got.xi_sum[1:3].any()


@pytest.mark.parametrize("graph", ["loop", "padded transcripts", "eps depth 4", "trie",
                                   "1k trie (wide spans)"])
def test_fb_banded_kernel_edge_cases(dev, graph):
    """K15 on the loop graph, the padded per-item banded dict of
    transcript graphs, a sausage of 1-state words (eps depth 4), a small
    lexical tree and the 1k trie (cross edges, -inf end scores off the word
    ends; the 1k trie's eps rows span 1,000 ends, a warp each), with
    lengths T, 0, 1 and mixed; every call twice, bit for bit."""
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon
    from speech_recognition_tpu_torch.models.graph import (
        build_loop_graph,
        build_word_graph,
        pad_graphs_banded,
    )
    from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph, banded_arrays

    rng = np.random.default_rng(6)
    trans = [uniform_left_to_right_trans(5) for _ in range(11)]
    b, t_len, end, depth = 12, 40, None, 1
    if graph == "loop":
        g = banded_arrays(build_loop_graph(trans), dev)
    elif graph == "padded transcripts":
        graphs, _ = _fb_transcripts(rng, b, dev)
        gb, depth = pad_graphs_banded(graphs)
        g = BandedGraph(*[torch.as_tensor(gb[k], device=dev) for k in (
            "band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos",
            "is_start")], end_states=None, end_bonus=None,
            bank_state=torch.as_tensor(gb["bank_state"], device=dev))
        end = torch.as_tensor(gb["end_scores"], device=dev)
    elif graph == "eps depth 4":
        wg = build_word_graph([uniform_left_to_right_trans(1)] + trans[:3], [[0, 1, 2, 3]] * 5)
        g, depth = banded_arrays(wg, dev), wg.eps_depth
        assert depth > 1
    else:
        words, ltrans, ids, _ = bench_lexicon(**({"n_words": 60} if graph == "trie" else {}))
        g = build_lex_graph(words, ltrans, ids, word_insertion_cost=0.5).banded.to(dev)
        end = torch.full((g.n_states,), -float("inf"), device=dev)
        end[g.end_states] = 0.0
        if graph != "trie":
            b, t_len = 6, 30
            assert int((g.eps_block < 0.5e30).sum(-1).max()) > 64
    s = g.band.shape[-1]
    nll = torch.from_numpy(rng.uniform(40, 60, (b, t_len, s)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t_len, 0, 1, rng.integers(2, t_len, b - 3)].astype(
        np.int32)).to(dev)
    before = fk.fb_banded.launches
    got = _fb_twice(lambda: fk.fb_banded(nll, g, nf, depth, end))
    want = fk.fb_banded_ref(nll, g, nf, depth, end)
    torch.cuda.synchronize()
    assert fk.fb_banded.launches == before + 2
    _fb_close(got, want)
    assert not got.gamma[1].any() and not got.gamma[2, 1:].any() and not got.xi_sum[1:3].any()


def _long_loop(n_words, n, dev, dense=False):
    """A loop graph of ``n_words`` left-to-right words of ``n`` states
    (self and step costs -log 0.5, every word end to every word start at
    cost 1), built on the card: as a ``BandedGraph``, or with ``dense`` as
    K16's ``(trans, eps_trans, init_cost)`` (its ``[S, S]`` matrices, too
    large to build on the host)."""
    from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph

    s = n_words * n
    idx = torch.arange(s, device=dev)
    first = idx % n == 0
    band = torch.full((3, s), 1e30, device=dev)
    band[0] = 0.6931472
    band[1] = torch.where(first, 1e30, 0.6931472)
    starts = idx[first]
    ends = starts + n - 1
    init = torch.where(first, 0.0, 1e30)
    eps_block = torch.ones((n_words, n_words), device=dev)
    if not dense:
        return BandedGraph(band, init, starts, ends, eps_block, torch.where(first, idx // n, 0),
                           first, ends, torch.zeros(n_words, device=dev), idx % 55)
    trans = torch.full((s, s), 1e30, device=dev)
    for d in range(2):
        trans[idx[d:], idx[:s - d]] = band[d, d:]
    eps = torch.full((s, s), 1e30, device=dev)
    eps[starts[:, None], ends[None, :]] = eps_block
    return trans, eps, init


@pytest.mark.parametrize("kernel", ["K15", "K16"])
def test_fb_device_row_tier(dev, kernel):
    """Past the rows' room in shared memory: K15 on a 30,000-state loop
    (300 words of 100 states), K16 on a 19,500-state loop (195 words),
    both in the device-row tier (K16's lists prebuilt in device memory),
    lengths T, 0, 1 and mixed; against the plain versions at the usual
    tolerances, every call twice, bit for bit."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    limit = lib.srt_smem_limit()
    rng = np.random.default_rng(8)
    b, t_len = 4, 12
    if kernel == "K15":
        g = _long_loop(300, 100, dev)
        s = g.n_states
        assert fk.banded_plan(s, 300, 300, lib.fb_banded_smem_bytes, limit).rows == "device"
    else:
        trans, eps, init = _long_loop(195, 100, dev, dense=True)
        s = trans.shape[0]
        plan = fk.dense_plan(s, True, b, torch.cuda.get_device_properties(dev)
                             .multi_processor_count, lib.fb_dense_smem_bytes, limit)
        assert (plan.rows, plan.lists) == ("device", "device")
    nll = torch.from_numpy(rng.uniform(40, 60, (b, t_len, s)).astype(np.float32)).to(dev)
    nf = torch.tensor([t_len, 0, 1, 7], dtype=torch.int32, device=dev)
    if kernel == "K15":
        before = fk.fb_banded.launches
        got = _fb_twice(lambda: fk.fb_banded(nll, g, nf))
        want = fk.fb_banded_ref(nll, g, nf)
        launches = fk.fb_banded.launches - before
    else:
        before = fk.fb_dense.launches
        got = _fb_twice(lambda: fk.fb_dense(nll, trans, init, nf, eps, 1, None, "band"))
        want = fk.fb_dense_ref(nll, trans, init, nf, eps, 1, None, "band")
        launches = fk.fb_dense.launches - before
    torch.cuda.synchronize()
    assert launches == 2
    _fb_close(got, want)
    assert not got.gamma[1].any() and not got.gamma[2, 1:].any()


@pytest.mark.parametrize("a", [455, 512, 1024])
def test_k13_chunked_feature_widths(dev, a):
    """K13 past two feature tiles' room in shared memory (A above ~450):
    the chunked form against its plain version at rtol 1e-5 / atol 1e-4
    (K13_TOL), on 40 x 37 columns (not a multiple of 4: 4-byte copies)
    and 32 x 40 (16-byte copies), with one and with three mixture blocks."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    rng = np.random.default_rng(a)
    for u, m in ((55, 4), (7, 11)):
        assert vk.emission_plan(a, u, m, lib.srt_smem_limit()) == "chunked"
        assert lib.bank_emission_smem_bytes(a, u, m, 2) == vk._emission_smem(a, u, m, 2)
        w = torch.from_numpy(rng.standard_normal((u, m, a)).astype(np.float32) * 0.05).to(dev)
        lw = torch.from_numpy(np.log(rng.dirichlet(np.ones(m), u)).astype(np.float32)).to(dev)
        for t, b in ((40, 37), (32, 40)):
            xa = torch.from_numpy(rng.standard_normal((a, t, b)).astype(np.float32)).to(dev)
            before = vk.bank_emission.launches
            got = vk.bank_emission(xa, w, lw)
            want = vk.bank_emission_ref(xa, w, lw)
            torch.cuda.synchronize()
            assert vk.bank_emission.launches == before + 1
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kernel", ["K15", "K16"])
def test_fb_plans_refuse_no_graph_the_earlier_layouts_took(dev, kernel):
    """With the library's own layouts: every state count (and, for K15,
    eps block shape) whose rows fit the layouts before the split gets a
    plan whose shared memory the card grants."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    limit = lib.srt_smem_limit()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for s in list(range(1, 400, 13)) + list(range(18000, 29100, 211)):
        if kernel == "K15":
            for r, l in ((1, 1), (77, 77), (8, 1000), (s, s), (3, s)):
                if 4 * (64 + r + l + 2 * s) <= limit:
                    assert fk.banded_plan(s, r, l, lib.fb_banded_smem_bytes, limit).smem <= limit
        elif 4 * (64 + 3 * s) <= limit:
            for b in (1, 419):
                p = fk.dense_plan(s, True, b, n_sm, lib.fb_dense_smem_bytes, limit)
                assert p.smem <= limit and p.cap >= 1


def test_fb_wrappers_raise(dev):
    """The K15 / K16 wrappers refuse a graph on another device, a wrong
    dtype or shape, and never fall back to the plain version."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    lg = build_loop_graph([uniform_left_to_right_trans(5) for _ in range(3)])
    s = lg.n_states
    nll = torch.zeros((2, 5, s), device=dev)
    nf = torch.tensor([5, 3], dtype=torch.int32, device=dev)
    trans, init = (torch.as_tensor(x, device=dev) for x in (lg.trans, lg.init_cost))
    before = (fk.fb_dense.launches, fk.fb_banded.launches)
    with pytest.raises(ValueError, match="is on"):
        fk.fb_dense(nll, trans.cpu(), init, nf)
    with pytest.raises(ValueError, match="float32"):
        fk.fb_dense(nll.double(), trans, init, nf)
    with pytest.raises(ValueError, match="trans_cost"):
        fk.fb_dense(nll, trans[:-1, :-1], init, nf)
    with pytest.raises(ValueError, match="n_frames"):
        fk.fb_dense(nll, trans, init, nf[:1])
    g = banded_arrays(lg, dev)
    with pytest.raises(ValueError, match="is on"):
        fk.fb_banded(nll, g._replace(band=g.band.cpu()), nf)
    with pytest.raises(ValueError, match="band"):
        fk.fb_banded(nll[:, :, :-1], g, nf)
    with pytest.raises(ValueError, match="end_scores"):
        fk.fb_banded(nll, g, nf, 1, torch.zeros(s + 1, device=dev))
    assert (fk.fb_dense.launches, fk.fb_banded.launches) == before


# ---------------------------------------------------------------------------
# K17 / K18: the streaming chunk steps
# ---------------------------------------------------------------------------


def _chunks(t, chunk):
    return [(t0, min(chunk, t - t0)) for t0 in range(0, t, chunk)]


def _hold_chunk_chain(launch, plain, frontier, nf, t, chunk):
    """Run ``launch(t0, c, frontier, nv, first)`` chunk by chunk from
    ``frontier``; at every chunk the plain version gets the kernel's own
    carry, and every output (carry, planes, org) must be bit-identical;
    a second launch on the same inputs too.  Returns the kernel's
    outputs per chunk."""
    outs = []
    for t0, c in _chunks(t, chunk):
        nv = torch.clamp(nf - t0, 0, c).to(torch.int32)
        got = launch(t0, c, frontier, nv, t0 == 0)
        again = launch(t0, c, frontier, nv, t0 == 0)
        want = plain(t0, c, frontier, nv, t0 == 0)
        torch.cuda.synchronize()
        for k, (a, a2, w) in enumerate(zip(got, again, want)):
            assert (a is None) == (w is None), k
            if w is not None:
                assert torch.equal(a, w) and torch.equal(a, a2), (t0, k)
        frozen = nv == 0
        fr_axis = 1 if got[0].shape[1] == nf.shape[0] else 0
        kept = got[0].index_select(fr_axis, torch.nonzero(frozen)[:, 0])
        assert torch.equal(kept, frontier.index_select(fr_axis, torch.nonzero(frozen)[:, 0]))
        outs.append(got)
        frontier = got[0]
    return outs


K17_CASES = {  # kind: (mode, b, t)
    "loop": ("fused", 6, 70),
    "loop ties": ("fused", 5, 40),
    "7,500-state loop": ("fused", 300, 5),
    "sausage_1state": ("general", 6, 40),
    "sausage_mixed": ("general", 5, 40),
}


@pytest.mark.parametrize("track_org", [False, True])
@pytest.mark.parametrize("chunk", [1, 64, 0])
@pytest.mark.parametrize("kind", sorted(K17_CASES))
def test_k17_matches_plain(dev, kind, chunk, track_org):
    """K17's DP (``csrc/banded_forward.cu``'s chunk modes) on given bank
    emissions against its plain version, chunk by chunk from the carry
    (chunks of 1, 64 and T frames; lengths 0, 1, T and between, so some
    streams are frozen for whole chunks): carry, bp8, eps_u, eps_prev and
    the ancestor map bit-identical, a frozen stream's carry unchanged,
    two launches equal; the planes concatenated give the monolithic
    DP's (K1's or K8's plain version) and the same backtrace; the plan's
    shared memory equals the kernel's, and the 7,500-state loop's work
    area lies in device memory."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.utils.build import load_library

    mode, b, t = K17_CASES[kind]
    if kind.startswith("sausage"):
        _, graph = _general_graph(kind)
        g, depth = banded_arrays(graph), graph.eps_depth
    elif kind == "7,500-state loop":
        graph, g = _big_loop(1500, (5,), 55)
        depth = 1
    else:
        from speech_recognition_tpu_torch.models.graph import build_loop_graph

        bank = _bank(11, 5, 2, 6)
        graph = build_loop_graph([bank.trans_cost[i].numpy() for i in range(11)],
                                 word_insertion_cost=0.5)
        g, depth = banded_arrays(graph), 1
    g = g.to(dev)
    topo = vk.banded_topology(g)
    assert vk.banded_route(topo, depth) == mode
    u = int(g.bank_state.max()) + 1
    full = f"{mode}_chunk" + ("_org" if track_org else "")
    plan = _plan_agrees_with_kernel(load_library(), full, g, u, b, dev)
    if kind == "7,500-state loop":
        assert plan.frontier == "device"
    rng = np.random.default_rng(len(kind) + chunk)
    e = rng.integers(0, 3, (u, t, b)) if "ties" in kind else rng.uniform(0, 6, (u, t, b))
    nll = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[0, t, 1, rng.integers(1, t + 1, b)][:b].astype(np.int32)).to(dev)
    chunk = chunk or t

    def launch(t0, c, fr, nv, first):
        return vk._banded_forward(nll[:, t0:t0 + c], g, nv, depth, full,
                                  vk.viterbi_banded_chunk, frontier=fr, first=first)

    def plain(t0, c, fr, nv, first):
        x = nll[:, t0:t0 + c]
        if mode == "fused":
            return vk._fused_dp(x, g, nv, fr, fr, first, track_org)
        return vk.viterbi_banded_chunk_ref(x.contiguous(), g, topo, fr, nv, first, track_org,
                                           "general", depth)

    init = g.init_cost[:, None].expand(-1, b).contiguous()
    outs = _hold_chunk_chain(launch, plain, init, nf, t, chunk)
    planes = [torch.cat([o[k] for o in outs]) for k in (1, 2)]
    # a stream of length 0 keeps its frontier in the chunk step and is
    # POS_INF (K1) or moved by frame 0 (K8) in the monolithic DP: the
    # planes agree on the other streams
    live = nf > 0
    if mode == "fused":
        want = vk.fused_dp_ref(nll, g, nf)
        eps_prev = torch.cat([o[3] for o in outs])
        assert torch.equal(eps_prev[..., live], want[3][..., live])
    else:
        want = vk.viterbi_banded_general_ref(nll, g, topo, nf, depth)
    assert all(torch.equal(a[..., live], w[..., live]) for a, w in zip(planes, want[1:3]))
    assert torch.equal(outs[-1][0][:, live], want[0][:, live])
    ends = g.end_states[torch.argmin(want[0][g.end_states] + g.end_bonus[:, None], 0)]
    if mode == "fused":
        sk, fk = vk.banded_backtrace_val(planes[0], eps_prev, ends, nf, topo.uniform_w)
        sp, fp = vk.banded_backtrace_val_ref(want[1], want[3], ends, nf, topo.uniform_w)
    else:
        sk, fk = vk.banded_backtrace_general(planes[0], planes[1], g, ends, nf, depth)
        sp, fp = vk.banded_backtrace_general_ref(want[1], want[2], g, ends, nf, depth)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(fk, fp)


WARP_CASES = {  # kind: (route, eps depth or None for the graph's)
    "loop": ("fused", None), "loop ties": ("fused", None), "loop depth 2": ("general", 2),
    "sausage_1state": ("general", None), "sausage_mixed": ("general", None),
    "loop_lm": ("general", None),
}


@pytest.mark.parametrize("form", ["warp", "four"])
@pytest.mark.parametrize("track_org", [False, True])
@pytest.mark.parametrize("chunk", [1, 64])
@pytest.mark.parametrize("kind", sorted(WARP_CASES))
def test_k17_forms_match_plain(dev, kind, chunk, track_org, form):
    """K17's DP with its form forced by ``plan=`` (the warp form of
    ``csrc/banded_warp.cu``, the four-warp form of ``banded_forward.cu``)
    against its plain version, chunk by chunk from its own carry: the
    uniform chunk mode and the general one at eps depth 1, 2 and the
    1-state sausage's 3, with and without the map, 1- and 64-frame chunks,
    ragged lengths with 0, at 37 streams (off every warp tile: padding
    warps); the warp plan's bytes equal the kernel's."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.utils.build import load_library

    route, depth = WARP_CASES[kind]
    if kind.startswith("loop") and kind != "loop_lm":
        bank = _bank(11, 5, 2, 6)
        graph = build_loop_graph([bank.trans_cost[i].numpy() for i in range(11)],
                                 word_insertion_cost=0.5)
    else:
        _, graph = _general_graph(kind)
    depth = depth or graph.eps_depth
    g = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(g)
    b, t = 37, 70
    u = int(g.bank_state.max()) + 1
    mode = f"{route}_chunk" + ("_org" if track_org else "")
    lib = load_library()
    plan = vk.banded_plan(b, torch.cuda.get_device_properties(dev).multi_processor_count,
                          g.n_states, g.n_words, g.n_ends, u, mode, lib.srt_smem_limit(),
                          form=form)
    assert plan.form == form
    if form == "warp":
        assert b % plan.tile
        assert plan.smem == lib.banded_warp_smem_bytes(vk.MODES[mode], u, plan.tile)
    rng = np.random.default_rng(len(kind) + chunk)
    e = rng.integers(0, 3, (u, t, b)) if "ties" in kind else rng.uniform(0, 6, (u, t, b))
    nll = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[0, t, 1, 0, rng.integers(1, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)

    def launch(t0, c, fr, nv, first):
        return vk._banded_forward(nll[:, t0:t0 + c], g, nv, depth, mode,
                                  vk.viterbi_banded_chunk, plan=plan, frontier=fr,
                                  first=first, topo=topo)

    def plain(t0, c, fr, nv, first):
        x = nll[:, t0:t0 + c]
        if route == "fused":
            return vk._fused_dp(x, g, nv, fr, fr, first, track_org)
        return vk.viterbi_banded_chunk_ref(x.contiguous(), g, topo, fr, nv, first, track_org,
                                           "general", depth)

    _hold_chunk_chain(launch, plain, g.init_cost[:, None].expand(-1, b).contiguous(), nf, t,
                      chunk)


def test_k17_wrapper_runs_k13_then_the_dp(dev):
    """``viterbi_banded_chunk(mode="fused")`` is K13 then the DP (one
    launch each, counted), within rtol 1e-5 of its plain version (the
    emission GEMM sums in another order); the general mode on bank
    emissions is bit-identical; a CUDA tensor never runs the plain
    version, and the wrong inputs raise."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    bank = _bank(11, 5, 4, 39).to(dev)
    graph = build_loop_graph([bank.trans_cost[i].cpu().numpy() for i in range(11)],
                             word_insertion_cost=0.5)
    g = banded_arrays(graph, device=dev)
    topo = vk.banded_topology(g)
    b, c = 7, 16
    rng = np.random.default_rng(3)
    xa = augment_dtb(torch.from_numpy(rng.standard_normal((b, c, 39)).astype(np.float32))
                     .to(dev))
    w, lw = gmm_emission_weights(*bank.flat_states())
    fr = g.init_cost[:, None].expand(-1, b).contiguous()
    nv = torch.tensor([c, 0, 3, c, c, 1, 9], dtype=torch.int32, device=dev)
    before = (vk.bank_emission.launches, vk.viterbi_banded_chunk.launches)
    got = vk.viterbi_banded_chunk((xa, w, lw), g, topo, fr, nv, True, True, "fused")
    want = vk.viterbi_banded_chunk_ref((xa, w, lw), g, topo, fr, nv, True, True, "fused")
    torch.cuda.synchronize()
    assert (vk.bank_emission.launches, vk.viterbi_banded_chunk.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
    assert torch.equal(got[0][:, 1], fr[:, 1])
    with pytest.raises(ValueError, match="frontier"):
        vk.viterbi_banded_chunk((xa, w, lw), g, topo, fr.T.contiguous(), nv, True, False,
                                "fused")
    with pytest.raises(ValueError, match="chunk mode"):
        vk.viterbi_banded_chunk((xa, w, lw), g, topo, fr, nv, True, False, "wordtrace")
    nll = vk.bank_emission(xa, w, lw).contiguous()
    got = vk.viterbi_banded_chunk(nll, g, topo, fr, nv, False, True, "general")
    want = vk.viterbi_banded_chunk_ref(nll, g, topo, fr, nv, False, True, "general")
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want) if b_ is not None)


K18_CASES = {  # kind: (b, t)
    "1k": (5, 40), "dict1": (3, 12), "dup_end": (5, 30), "1k_general": (4, 24),
    "8,000 bank rows": (4, 20), "wide records": (3, 10),
}


@pytest.mark.parametrize("track_org", [False, True])
@pytest.mark.parametrize("chunk", [1, 64, 0])
@pytest.mark.parametrize("kind", sorted(K18_CASES))
def test_k18_matches_plain(dev, kind, chunk, track_org):
    """K18 (``csrc/viterbi_lex.cu``'s chunk mode) against its plain
    version in every ``lex_plan`` tier (the 1k trie on chip, the
    dictionary-shaped trie in device memory, the gather mode, the general
    mode, no row tables past 8,000 bank rows, the wide two-word
    records), chunk by chunk from the carry (chunks of 1, 64 and T;
    lengths 0, 1, T and between): carry, bp8, eps_u, eps_prev and the
    ancestor map bit-identical, frozen streams' carries unchanged, two
    launches equal; the planes concatenated give K4's plain version's
    and the same K5 walk; the plan's shared memory equals the kernel's."""
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.utils.build import load_library

    b, t = K18_CASES[kind]
    if kind == "8,000 bank rows":
        lexg, topo, _, _ = _large_bank_case(dev, b, t)
        g = lexg.banded
    elif kind == "wide records":
        from speech_recognition_tpu_torch.data.lexicon import bench_lexicon
        from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

        words, trans, ids, rng_w = bench_lexicon()
        g = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded
        g = g._replace(bank_state=g.bank_state * 45000)
        topo = lk.lex_topology(g)
        assert topo.pack.wide
    else:
        g, _ = _lex_case(kind)
        topo = lk.lex_topology(g)
    mode = lk.LEX_MODES["chunk_org" if track_org else "chunk"]
    lib = load_library()
    plan = lk.lex_plan(mode, topo, lib.srt_smem_limit())
    assert plan.smem == lib.viterbi_lex_smem_bytes(
        mode, *topo.dims, int(plan.front), int(plan.tau), int(plan.tables), int(plan.eps),
        int(plan.gather), plan.rep)
    if kind in ("dict1", "8,000 bank rows", "wide records"):
        assert plan.frontier == "device"
    assert (plan.rep == 0) == (kind in ("8,000 bank rows", "wide records"))
    g = g.to(dev)
    u = topo.max_bank_state + 1
    gen = torch.Generator(device=dev).manual_seed(len(kind) + chunk)
    nll = torch.rand((u, t, b), generator=gen, device=dev) * 5
    nf = torch.tensor(np.r_[t, 0, 1, np.arange(2, b) * t // b][:b].astype(np.int32),
                      device=dev)
    chunk = chunk or t

    def launch(t0, c, fr, nv, first):
        return lk.viterbi_lex_chunk(nll[:, t0:t0 + c].contiguous(), g, topo, fr, nv, first,
                                    track_org)

    def plain(t0, c, fr, nv, first):
        return lk.viterbi_lex_chunk_ref(nll[:, t0:t0 + c].contiguous(), g, topo, fr, nv, first,
                                        track_org)

    init = g.init_cost[None].expand(b, -1).contiguous()
    outs = _hold_chunk_chain(launch, plain, init, nf, t, chunk)
    want = lk.viterbi_lex_ref(nll, g, topo, nf)
    planes = [torch.cat([o[k] for o in outs]) for k in (1, 2, 3)]
    live = nf > 0  # a stream of length 0 keeps its frontier (K4's moves at frame 0)
    assert all(torch.equal(a[:, live], w[:, live]) for a, w in zip(planes, want[1:]))
    assert torch.equal(outs[-1][0][live], want[0][live])
    ends = g.end_states[torch.argmin(want[0][:, g.end_states] + g.end_bonus, 1)]
    sk, fk = lk.lex_backtrace_val(planes[0], planes[2], g, ends, nf, topo=topo)
    sp, fp = lk.lex_backtrace_val_ref(want[1], want[3], g, ends, nf)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(fk, fp)


@pytest.mark.parametrize("kind", ["loop", "loop incremental", "sausage_1state", "lextree",
                                  "lextree incremental"])
def test_streaming_decode_cuda_matches_monolithic(dev, kind):
    """``StreamingDecoder`` on the card (K13 + K17 + K2, K17 + K9, or K18
    + K5, with flushes in incremental mode) gives the monolithic decode's
    states and words on the card (K1 + K2, K8 + K9, K4 + K5) and the CPU
    streaming decode's words, costs at rtol 1e-5."""
    from speech_recognition_tpu_torch.decode.connected import _decode_banded_batch
    from speech_recognition_tpu_torch.decode.lextree import _decode_lex_batch
    from speech_recognition_tpu_torch.decode.streaming import StreamingDecoder
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    incremental = kind.endswith("incremental")
    if kind.startswith("sausage"):
        bank, graph = _general_graph(kind)
    elif kind.startswith("lextree"):
        from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

        bank = _bank(4, 3, 2, 6, seed=2)
        words = ["ab", "abc", "ba", "d", "ca", "cab", "bad", "c"]
        graph = build_lex_graph(words, [bank.trans_cost[i].numpy() for i in range(4)],
                                {c: i for i, c in enumerate("abcd")}, word_insertion_cost=0.5)
    else:
        bank = _bank(6, 3, 2, 6, seed=1)
        graph = build_loop_graph([bank.trans_cost[i].numpy() for i in range(6)],
                                 word_insertion_cost=0.5)
    rng = np.random.default_rng(len(kind))
    means = bank.means.numpy()[:, :, 0, :]
    b = 1 if incremental else 3
    t = 160
    feats = np.zeros((b, t, 6), np.float32)
    for i in range(b):
        f = [means[u, s] + 0.3 * rng.standard_normal(6)
             for u in rng.integers(0, means.shape[0], 40) for s in range(means.shape[1])
             for _ in range(int(rng.integers(2, 4)))][:t]
        feats[i, : len(f)] = f
    nf = np.r_[t, t - 37, t // 3][:b].astype(np.int32)
    bank_d = bank.to(dev)
    res = {}
    for where, bk in (("cuda", bank_d), ("cpu", bank)):
        dec = StreamingDecoder(bk, graph, chunk_frames=32, batch=b,
                               emit_incremental=incremental, window_chunks=2)
        t0 = 0
        while t0 < t:
            x = torch.from_numpy(feats[:, t0:t0 + 32]).to(bk.means.device)
            dec.push(x, n_valid=np.clip(nf - t0, 0, 32).astype(np.int32))
            t0 += 32
        out = dec.finish()
        res[where] = [out] if b == 1 else out
    x, n = torch.from_numpy(feats).to(dev), torch.from_numpy(nf).to(dev)
    if kind.startswith("lextree"):
        g = graph.banded.to(dev)
        st, _, costs = _decode_lex_batch(bank_d, x, n, g, lk.lex_topology(graph.banded))
        st = st.T
    else:
        st, _, costs = _decode_banded_batch(bank_d, x, n, banded_arrays(graph, dev),
                                            eps_depth=graph.eps_depth)
    st, costs = st.cpu().numpy(), costs.cpu().numpy()
    for i in range(b):
        words, states, cost = res["cuda"][i]
        assert words == res["cpu"][i][0]
        np.testing.assert_allclose(cost, res["cpu"][i][2], rtol=1e-5)
        np.testing.assert_allclose(cost, costs[i], rtol=1e-5)
        if not incremental:
            np.testing.assert_array_equal(states, st[i, : nf[i]])
    assert vk.viterbi_banded_chunk.launches + lk.viterbi_lex_chunk.launches > 0


# ---------------------------------------------------------------------------
# the beams: K9's cross mode, the pruned forward, the token beam, the spell
# checker (the plain forms run on the card; K9 backtraces their planes)
# ---------------------------------------------------------------------------


def _trie_case(kind):
    """``(port graph, eps_depth, n_bank_rows)``: the hand-built tries of
    ``tests/hand_trie.py`` (arcs of 1, 2 and 3 states) or a lexicon trie."""
    from hand_trie import port_graph, trie_arrays

    if kind == "hand trie":
        arrs, depth, n_bank = trie_arrays(5)
    elif kind == "big hand trie":  # ~50 roots, arcs down to depth 5
        arrs, depth, n_bank = trie_arrays(8, n_roots=50, depth=5)
    else:
        lexg, n_bank = _lex_graph(kind)
        return lexg.banded, lexg.eps_depth, n_bank
    return port_graph(arrs), depth, n_bank


@pytest.mark.parametrize("kind,b,t,beam", [
    ("hand trie", 7, 30, 0), ("hand trie", 40, 50, 5), ("big hand trie", 64, 80, 0),
    ("big hand trie", 64, 80, 16), ("deep", 33, 60, 0), ("deep", 33, 60, 8),
    ("deep_int32", 20, 40, 12)])
def test_k9_cross_mode_matches_plain(dev, kind, b, t, beam):
    """K9 on a trie's planes (the exact plain forward's and the beam
    forward's): states and flags bit-identical to the plain backtrace,
    with lengths 0, 1, T and T + 3, and cross steps out of arcs of every
    length on the best paths."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import _CROSS, viterbi_banded_tb

    g, depth, n_bank = _trie_case(kind)
    g = g.to(dev)
    rng = np.random.default_rng(b + t + beam)
    nll = torch.from_numpy(rng.uniform(0, 5, (t, n_bank, b)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 0, 1, t + 3, rng.integers(2, t + 1, b)][:b]
                          .astype(np.int32)).to(dev)
    fin, bp8, eps_u = viterbi_banded_tb(nll[:, g.bank_state], g, nf, depth, beam_width=beam)
    ends = g.end_states[torch.argmin(fin[g.end_states] + g.end_bonus[:, None], 0)]
    before = vk.banded_backtrace_general.launches
    sk, fk = vk.banded_backtrace_general(bp8, eps_u, g, ends, nf, depth)
    sp, fp = vk.banded_backtrace_general_ref(bp8, eps_u, g, ends, nf, depth)
    torch.cuda.synchronize()
    assert vk.banded_backtrace_general.launches == before + 1
    assert torch.equal(sk, sp) and torch.equal(fk, fp)
    tt = torch.arange(1, t, device=dev)[:, None]
    codes = bp8[tt, sp[1:].long(), torch.arange(b, device=dev)[None]]
    assert int(((codes == _CROSS) & (tt < nf[None])).sum()) > 0  # the walks crossed arcs


@pytest.mark.parametrize("kind,beam", [("hand trie", 4), ("deep", 9), ("loop_lm", 3),
                                       ("sausage_1state", 6)])
def test_beam_forward_cuda_matches_cpu(dev, kind, beam):
    """The pruned plain forward on the card: final, bp8 and eps_u
    bit-identical to the CPU's (``torch.kthvalue`` on both)."""
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays, viterbi_banded_tb

    if kind in ("hand trie", "deep"):
        g, depth, n_bank = _trie_case(kind)
    else:
        bank, graph = _general_graph(kind)
        g, depth, n_bank = banded_arrays(graph), graph.eps_depth, bank.n_models * bank.n_states
    rng = np.random.default_rng(beam)
    nll = torch.from_numpy(rng.integers(0, 4, (40, n_bank, 9)).astype(np.float32))
    nf = torch.from_numpy(np.r_[40, 1, rng.integers(2, 41, 7)].astype(np.int32))
    want = viterbi_banded_tb(nll[:, g.bank_state], g, nf, depth, beam_width=beam)
    gd = g.to(dev)
    got = viterbi_banded_tb(nll.to(dev)[:, gd.bank_state], gd, nf.to(dev), depth,
                            beam_width=beam)
    for a, w in zip(got, want):
        assert torch.equal(a.cpu(), w)


def _live_equal(got, want):
    """K19's outputs (dead slots -1, final cost POS_INF) against the plain
    version's on every live slot (state >= 0) of the final frontier and
    the token planes."""
    fst, fco, fpd, ts, tp, tw = [x.cpu() for x in got]
    want = [x.cpu() for x in want]
    live_f = want[0] >= 0
    assert torch.equal(fst >= 0, live_f)
    for g_, w_ in zip((fst, fco, fpd), want[:3]):
        assert torch.equal(g_[live_f], w_[live_f])
    assert bool((fco[~live_f] == 1e30).all())
    live = want[3] >= 0
    assert torch.equal(ts >= 0, live)
    for g_, w_ in zip((ts, tp, tw), want[3:]):
        assert torch.equal(g_[live], w_[live]) and bool((g_[~live] == -1).all())


def _walk_equal(got, want):
    """K26's costs equal the plain walk's; its words on every stream whose
    best token ends a word (a stream with none walks dead slots, which
    K19 writes as -1 and the plain version in its sort order)."""
    (c_g, w_g), (c_w, w_w) = [(c.cpu(), w.cpu()) for c, w in (got, want)]
    assert torch.equal(c_g, c_w)
    found = c_w < 5e29
    assert torch.equal(w_g[found], w_w[found])


@pytest.mark.parametrize("k,lm", [(12, False), (24, True), (200, False)])
def test_token_beam_cuda_matches_cpu(dev, k, lm):
    """``beam_search`` (K19) and ``beam_backtrace`` (K26) on the card:
    every live slot of the token planes and the final frontier
    bit-identical to the CPU's on the same emissions, costs and words
    too, with and without the carried bigram."""
    from speech_recognition_tpu_torch.ops.beam import beam_backtrace, beam_search, beam_tables

    lexg, n_bank = _lex_graph("deep")
    rng = np.random.default_rng(k)
    e = torch.from_numpy(rng.uniform(0, 5, (6, 50, n_bank)).astype(np.float32))
    nf = torch.from_numpy(np.r_[50, 1, 17, 50, 33, 8].astype(np.int32))
    big = big_end = None
    if lm:
        v = lexg.n_words
        big = torch.from_numpy(rng.uniform(0.1, 3, (v + 1, v)).astype(np.float32))
        big_end = torch.from_numpy(rng.uniform(0.1, 2, v).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        tb = beam_tables(lexg.banded, leaf_word=lexg.leaf_word, device=where)
        mv = (lambda x: None if x is None else x.to(where))
        res = beam_search(e.to(where), tb, nf.to(where), k, bigram_cost=mv(big))
        out[str(where)] = (res, beam_backtrace(
            res[0], res[1], res[4], res[5], tb, nf.to(where), final_pred=res[2],
            bigram_cost=mv(big), bigram_end=mv(big_end)))
    _live_equal(out[str(dev)][0], out["cpu"][0])
    _walk_equal(out[str(dev)][1], out["cpu"][1])


def _trie_1k():
    """A 1,000-word trie over 8 units of 3 states (24 emission rows), as
    ``chip_smoke.py``'s ``make_lex_pipeline`` builds its own."""
    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    rng = np.random.default_rng(7)
    units = list("abcdefgh")
    words = random_words(rng, units, 1000, 3, 8)
    return build_lex_graph(words, _units(rng, 8, skip=False),
                           {c: i for i, c in enumerate(units)}, word_insertion_cost=0.5), 24


@pytest.mark.parametrize("kind,k,lm,tier,ties", [
    ("flat_lm", 12, True, "shared", False),    # a flat tree: no cross edges
    ("flat_lm", 40, False, "shared", True),
    ("1k", 8, False, "shared", False), ("1k", 8, True, "shared", False),
    ("1k", 64, False, "shared", False), ("1k", 64, True, "shared", False),
    ("1k", 64, True, "shared", True),
    ("1k", 0, True, "device", False),          # k = S: the device-scratch tier
])
def test_token_beam_kernels_match_plain(dev, kind, k, lm, tier, ties):
    """K19 and K26 against ``beam_search_ref`` / ``beam_backtrace_ref``
    on the card's own tensors: live slots, final frontiers, costs and
    words bit for bit, on uniform and tie-forcing integer emissions, with
    streams of length T, 1, 0 and past T; one launch of each a call, in
    the plan's tier; the kernel's layout is the plan's."""
    from speech_recognition_tpu_torch.ops import beam as tbeam
    from speech_recognition_tpu_torch.ops import beam_kernels as bk
    from speech_recognition_tpu_torch.utils.build import load_library

    lexg, n_bank = _trie_1k() if kind == "1k" else _lex_graph(kind)
    tb = tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word, device=dev)
    has_cross = tb.n_children > 0
    assert has_cross == (kind == "1k")
    k = k or tb.n_states
    r, l = tb.eps_block.shape
    mmax = bk.beam_widest(bk.beam_pack(tb, has_cross), k, tb.init_states.shape[0])
    plan = bk.beam_plan(tb.n_states, k, mmax, r, l, n_bank)
    assert plan.tier == tier
    assert load_library().token_beam_bytes(tb.n_states, k, mmax, r, l) == plan.nbytes
    rng = np.random.default_rng(k)
    b, t_len = (3, 24) if tier == "device" else (5, 60)
    e = rng.integers(0, 3, (b, t_len, n_bank)) if ties else rng.uniform(0, 5, (b, t_len, n_bank))
    e = torch.from_numpy(e.astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[t_len, 1, 0, t_len + 3, rng.integers(2, t_len)][:b]
                          .astype(np.int32)).to(dev)
    big = big_end = None
    if lm:
        v = lexg.n_words
        big = torch.from_numpy(rng.uniform(0.1, 3, (v + 1, v)).astype(np.float32)).to(dev)
        big_end = torch.from_numpy(rng.uniform(0.1, 2, v).astype(np.float32)).to(dev)
    before = (tbeam.beam_search.launches, tbeam.beam_backtrace.launches)
    got = tbeam.beam_search(e, tb, nf, k, has_cross=has_cross, bigram_cost=big)
    walk = tbeam.beam_backtrace(got[0], got[1], got[4], got[5], tb, nf, final_pred=got[2],
                                bigram_cost=big, bigram_end=big_end)
    torch.cuda.synchronize()
    assert (tbeam.beam_search.launches, tbeam.beam_backtrace.launches) == (
        before[0] + 1, before[1] + 1)
    want = tbeam.beam_search_ref(e, tb, nf, k, has_cross=has_cross, bigram_cost=big)
    _live_equal(got, want)
    want_walk = tbeam.beam_backtrace_ref(want[0], want[1], want[4], want[5], tb, nf,
                                         final_pred=want[2], bigram_cost=big,
                                         bigram_end=big_end)
    _walk_equal(walk, want_walk)
    # K26 on the plain version's own planes (dead slots in sort order), in
    # both its forms
    wplans = [bk.walk_plan(k, t_len), bk.WalkPlan("chain", 0, 0)]
    if k % 4 == 0 and bk._walk_smem(8, k, t_len) <= bk.SMEM_LIMIT:
        wplans.append(bk.WalkPlan("window", 8, 0))
    for wplan in wplans:
        _walk_equal(bk.launch_walk(want[0], want[1], want[4], want[5], tb, nf, want[2], big,
                                   big_end, plan=wplan), want_walk)
    # the survivor counter: frames, survivors summed and the most a frame
    stats = torch.zeros((b, bk.STATS), dtype=torch.int64, device=dev)
    again = bk.launch_search(e, tb, nf, k, has_cross, big, stats=stats)
    assert all(torch.equal(x, y) for x, y in zip(again, got))
    st = stats.cpu()
    assert torch.equal(st[:, 0], nf.cpu().clamp(1, t_len).long())
    assert bool((st[:, 2] <= mmax).all()) and bool((st[:, 1] >= st[:, 2]).all())
    assert bool((st[:, 3:] >= 0).all()) and bool((st[:, 3:].sum(1) > 0).all())


def test_token_beam_never_runs_the_plain_loop_on_the_card(dev, monkeypatch):
    """``beam_decode_lextree`` on CUDA tensors: one K19 and one K26 launch
    a call and no call of the plain versions; k below the init states
    raises before a launch."""
    from speech_recognition_tpu_torch.decode.lextree import beam_decode_lextree
    from speech_recognition_tpu_torch.ops import beam as tbeam

    def refuse(*a, **kw):
        raise AssertionError("the plain token beam ran on CUDA tensors")

    monkeypatch.setattr(tbeam, "beam_search_ref", refuse)
    monkeypatch.setattr(tbeam, "beam_backtrace_ref", refuse)
    lexg, _ = _lex_graph("deep")
    bank = _bank(5, 3, 2, 6, seed=3).to(dev)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 30, 6)).astype(np.float32)).to(dev)
    nf = torch.tensor([30, 12, 1, 0], dtype=torch.int32, device=dev)
    before = (tbeam.beam_search.launches, tbeam.beam_backtrace.launches)
    words, costs = beam_decode_lextree(bank, lexg, x, nf, 16)
    assert (tbeam.beam_search.launches, tbeam.beam_backtrace.launches) == (
        before[0] + 1, before[1] + 1)
    assert len(words) == 4 and costs[0] < 5e29
    tb = tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word, device=dev)
    with pytest.raises(ValueError, match="init states"):
        tbeam.beam_search(x[:, :, :1].repeat(1, 1, 15), tb, nf, 1)
    assert tbeam.beam_search.launches == before[0] + 1


def test_beam_decodes_cuda_match_cpu(dev):
    """``decode_connected(beam_width=)`` and ``decode_lextree(beam_width=)``
    on the card run the pruned forward and K9 (counted): words equal to
    the CPU's, costs at rtol 1e-5; ``beam_decode_lextree`` likewise."""
    import copy

    from speech_recognition_tpu_torch.decode.connected import decode_connected
    from speech_recognition_tpu_torch.decode.lextree import beam_decode_lextree, decode_lextree
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk

    bank, graph = _general_graph("sausage_mixed")
    lexg, _ = _lex_graph("deep")
    lbank = _bank(5, 3, 2, 6, seed=3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 40, 6)).astype(np.float32)
    nf = np.r_[40, 1, rng.integers(2, 41, 6)].astype(np.int32)
    banks = {"cpu": (bank, lbank), "cuda": (copy.deepcopy(bank).to(dev),
                                           copy.deepcopy(lbank).to(dev))}
    runs = {"connected": lambda bk, f, n: decode_connected(bk[0], graph, f, n, beam_width=20),
            "lextree": lambda bk, f, n: decode_lextree(bk[1], lexg, f, n, beam_width=7),
            "token": lambda bk, f, n: beam_decode_lextree(bk[1], lexg, f, n, 16)}
    for name, run in runs.items():
        before = vk.banded_backtrace_general.launches
        w_g, c_g = run(banks["cuda"], torch.from_numpy(x).to(dev),
                       torch.from_numpy(nf).to(dev))
        torch.cuda.synchronize()
        k9 = vk.banded_backtrace_general.launches - before
        w_c, c_c = run(banks["cpu"], torch.from_numpy(x), torch.from_numpy(nf))
        assert w_g == w_c, name
        np.testing.assert_allclose(c_g, c_c, rtol=1e-5)
        assert k9 == (0 if name == "token" else 1), name


def test_spell_checker_cuda_matches_cpu(dev):
    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.langmodel.lextree import lextree_from_words
    from speech_recognition_tpu_torch.langmodel.spellcheck import (
        SpellChecker,
        text_viterbi,
        text_viterbi_batch,
    )

    words = random_words(np.random.default_rng(1), list("abcdefgh"), 300, 2, 8)
    tree = lextree_from_words(words)
    rng = np.random.default_rng(2)
    texts = ["".join(rng.choice(list("abcdefghij "), int(rng.integers(1, 14))))
             for _ in range(40)]
    texts = [t.strip() or "a" for t in texts]
    assert text_viterbi_batch(texts, tree, device=dev) == text_viterbi_batch(texts, tree,
                                                                             device="cpu")
    sc_g, sc_c = SpellChecker(device=dev).fit(words), SpellChecker(device="cpu").fit(words)
    for t in texts[:12]:
        assert text_viterbi(t, tree, device=dev) == text_viterbi(t, tree, device="cpu")
        assert sc_g.spell_check(t) == sc_c.spell_check(t)


# ---------------------------------------------------------------------------
# K21 (dense backtrace), K22 (lattice word walk), K23 (word-trace walk)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,b,t,s,per_item,eps,depth,ties", [
    ("sausage size", 8, 120, 385, False, True, 1, False),
    ("isolated / skmeans shape", 300, 200, 5, True, False, 1, False),
    ("eps depth 2, ties", 20, 60, 40, False, True, 2, True),
    ("transcript graphs", 12, 80, 75, True, True, 2, False),
])
def test_k21_matches_plain(dev, name, b, t, s, per_item, eps, depth, ties):
    """K21 on K11's own planes (lengths T, 0, 1 and mid-length in every
    batch) against ``viterbi_backtrace_ref`` on the same CUDA planes: states
    and flags bit for bit, batched, single-stream and on strided views."""
    from speech_recognition_tpu_torch.ops import viterbi as tv
    from speech_recognition_tpu_torch.ops import viterbi_kernels as vk_dense
    from speech_recognition_tpu_torch.ops.viterbi_kernels import dense_backtrace, viterbi_dense

    nll, trans, init, nf, eps_t = _dense_problem(40 + s, b, t, s, per_item, eps, ties)
    nf = nf.to(dev)
    final, bp, eps_bp = viterbi_dense(nll.to(dev), trans.to(dev), init.to(dev), nf,
                                      None if eps_t is None else eps_t.to(dev), depth)
    end = torch.argmin(final, 1) if eps else torch.full((b,), s - 1, device=dev)
    before = dense_backtrace.launches
    got = tv.viterbi_backtrace(bp, eps_bp, end, nf, depth)
    want = tv.viterbi_backtrace_ref(bp, eps_bp, end, nf, depth)
    torch.cuda.synchronize()
    assert dense_backtrace.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    if eps:
        assert bool(want[1].any())
    # a strided view of the planes ([B, S, T] storage: the chain form) and
    # the single form
    bp_v = bp.transpose(1, 2).contiguous().transpose(1, 2)
    ebp_v = eps_bp.transpose(1, 2).contiguous().transpose(1, 2)
    got_v = dense_backtrace(bp_v, ebp_v, end, nf, depth)
    one = dense_backtrace(bp[0], eps_bp[0], int(end[0]), int(nf[0]), depth)
    torch.cuda.synchronize()
    assert torch.equal(got_v[0], want[0]) and torch.equal(got_v[1], want[1])
    assert torch.equal(one[0], want[0][0]) and torch.equal(one[1], want[1][0])
    # each form forced on the same planes: the plan's window, small windows
    # (many reloads), and the chain
    for plan in _k21_plans(bp, depth):
        got_f = vk_dense._backtrace(bp, eps_bp, end, nf, depth, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got_f[0], want[0]) and torch.equal(got_f[1], want[1]), plan


def _k21_plans(bp, depth):
    """K21's plan for ``bp`` [B, T, S], the window form at 8 frames x 8
    states (or S) and at 32 x 128 in the row layout, and the chain form."""
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk
    from speech_recognition_tpu_torch.utils.build import load_library

    b, t, s = bp.shape
    lim, n_sm = load_library().srt_smem_limit(), torch.cuda.get_device_properties(
        bp.device).multi_processor_count
    plan = dk.dense_backtrace_plan(b, t, s, [bp.stride()] * 2, lim, n_sm, depth)
    assert plan.form == "window"
    return (plan, dk.window_plan(b, t, s, depth, 8, 8, lim, n_sm),
            dk.window_plan(b, t, s, depth, 32, 128, lim, n_sm),
            dk.BacktracePlan("chain", 0, 0, 1, 4, -(-b // 128), 0))


@pytest.mark.parametrize("case", ["large S", "left to right, wraps", "eps depth 0"])
def test_k21_forms_edge_cases(dev, case):
    """K21's forms on planes the main paths do not give: S past K11's
    shared-memory frontier (the plan's chain tier; the window form forced
    too), a left-to-right walk through small windows with indices that wrap
    or clamp (held to the chain form: the plain version's gathers take
    neither), eps depth 0."""
    from speech_recognition_tpu_torch.ops import viterbi as tv
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk
    from speech_recognition_tpu_torch.utils.build import load_library

    rng = np.random.default_rng(21)
    lim = load_library().srt_smem_limit()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    if case == "large S":
        b, t, s, depth = 3, 6, lim // 20 + 1, 2
    else:
        b, t, s, depth = 37, 90, 300, 0 if case == "eps depth 0" else 3
    here = np.arange(s)[None, None, :]
    bp = np.maximum(here - rng.integers(0, 4, (b, t, s)), 0).astype(np.int32)
    bp[:, 0] = -1
    eps_bp = (here - rng.integers(1, 60, (b, t, s))).astype(np.int32)
    eps_bp[(rng.uniform(size=eps_bp.shape) > 0.2) | (eps_bp < 0)] = -1
    if case == "left to right, wraps":
        hit = rng.uniform(size=bp.shape) < 0.03
        bp[hit] = rng.integers(-3, 0, int(hit.sum()))
        bp[rng.uniform(size=bp.shape) < 0.01] = s + 5
    end = torch.from_numpy((s - 1 - rng.integers(0, 4, b)).astype(np.int32)).to(dev)
    nf = torch.from_numpy(np.r_[t, 0, 1, rng.integers(2, t, b - 3)].astype(np.int32)).to(dev)
    bp, eps_bp = torch.from_numpy(bp).to(dev), torch.from_numpy(eps_bp).to(dev)
    plan = dk.dense_backtrace_plan(b, t, s, [bp.stride()] * 2, lim, n_sm, depth)
    assert plan.form == ("chain" if case == "large S" else "window")
    chain = dk.BacktracePlan("chain", 0, 0, 1, 4, 1, 0)
    want = dk._backtrace(bp, eps_bp, end, nf, depth, plan=chain)
    if case != "left to right, wraps":
        ref = tv.viterbi_backtrace_ref(bp, eps_bp, end, nf, depth)
        assert torch.equal(want[0], ref[0]) and torch.equal(want[1], ref[1])
    stats = torch.zeros((b, 7), dtype=torch.int64, device=dev)
    for p in (plan, dk.window_plan(b, t, s, depth, 8, 8, lim, n_sm),
              dk.window_plan(b, t, s, depth, 32, 128, lim, n_sm)):
        got = dk._backtrace(bp, eps_bp, end, nf, depth, plan=p,
                            stats=stats if p.form == "window" else None)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), p
    assert int(stats[:, 0].sum()) > 0 and int(stats[:, 3].sum()) > 0


def _random_lattice(seed, t, b, l, dev):
    """Random ``[T, B, L]`` int32 planes (entry times below the frame, some
    0; predecessors in [0, L)), best leaves and lengths T, 0, 1, mid."""
    rng = np.random.default_rng(seed)
    back = (rng.uniform(size=(t, b, l)) * np.arange(t)[:, None, None] ** 0.5).astype(np.int32)
    tau = np.maximum(np.arange(t)[:, None, None] - 1 - back, 0).astype(np.int32)
    tau[rng.uniform(size=tau.shape) < 0.02] = 0
    pred = rng.integers(0, l, (t, b, l)).astype(np.int32)
    nf = np.r_[t, 0, 1, rng.integers(2, t + 1, b - 3)].astype(np.int32)
    return [torch.from_numpy(x).to(dev) for x in (pred, tau, rng.integers(0, l, b)
                                                  .astype(np.int32), nf)]


@pytest.mark.parametrize("t,b,l", [(500, 128, 1000), (40, 37, 3), (60, 5, 200)])
def test_k22_matches_plain(dev, t, b, l):
    """K22 on the ``[T, L, B]`` views of ``[T, B, L]`` planes against
    ``lattice_words_ref`` bit for bit, at a ``max_words`` that holds every
    chain and at one that cuts the longest."""
    from speech_recognition_tpu_torch.ops import lattice as lat
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk

    pred, tau, best, nf = _random_lattice(t + l, t, b, l, dev)
    p_v, t_v = pred.transpose(1, 2), tau.transpose(1, 2)
    full = lat.lattice_words_ref(p_v, t_v, best, nf, t)
    longest = int(full[1].max())
    assert longest > 2
    for mw in (t, longest - 1, 1, 0):
        before = lk.lattice_walk.launches
        got = lat.lattice_words_device(p_v, t_v, best, nf, max_words=mw)
        want = lat.lattice_words_ref(p_v, t_v, best, nf, max_words=mw)
        torch.cuda.synchronize()
        assert lk.lattice_walk.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), mw


def _skip_arc_case(b, t):
    """The skip-arc loop graph (3 words of 5 states, cheap skips, word
    insertion -1000: up to T / 3 words) and features."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    bank = _bank(3, 5, 2, 6, seed=17)
    trans = [bank.trans_cost[i].numpy().copy() for i in range(3)]
    for tr in trans:
        for i in range(3):
            tr[i + 2, i] = 0.05
    bank.trans_cost.copy_(torch.from_numpy(np.stack(trans)))
    graph = build_loop_graph(trans, word_insertion_cost=-1000.0)
    rng = np.random.default_rng(18)
    feats = torch.from_numpy(rng.standard_normal((b, t, 6)).astype(np.float32))
    nf = torch.from_numpy(np.r_[t, 0, 1, rng.integers(2, t + 1, b - 3)].astype(np.int32))
    return bank, banded_arrays(graph), feats, nf


def _wordtrace_planes(dev, bank, g, feats, nf):
    """K10's side planes on the card and each stream's final slot and
    entry time, as ``decode.connected`` gives them to the walk."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights

    g = g.to(dev)
    topo = vk.banded_topology(g)
    w, lw = gmm_emission_weights(*bank.to(dev).flat_states())
    final, eps_u, eps_tau, ftau = vk.viterbi_banded_wordtrace(
        augment_dtb(feats.to(dev)), w, lw, g, topo, nf.to(dev))
    end = g.end_states[torch.argmin(final[g.end_states] + g.end_bonus[:, None], 0)]
    return eps_u, eps_tau, end // topo.uniform_w, ftau.gather(0, end[None])[0], nf.to(dev)


@pytest.mark.parametrize("case", ["skip arcs 3x12", "skip arcs 64x300", "random int32"])
def test_k23_matches_plain(dev, case):
    """K23 against ``wordtrace_words_ref`` on the same CUDA planes, the
    plane's T + 1 rows included, with no read back to the host: K10's int8
    planes of the skip-arc loop graph (more words than T / W + 1) and
    random int32 planes."""
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk

    if case.startswith("skip"):
        b, t = (3, 12) if case.endswith("3x12") else (64, 300)
        args = _wordtrace_planes(dev, *_skip_arc_case(b, t))
        assert args[0].dtype == torch.int8
    else:
        rng = np.random.default_rng(23)
        t, r, b = 200, 300, 40
        et = (rng.uniform(size=(t, r, b)) * np.arange(t)[:, None, None]).astype(np.int32)
        args = [torch.from_numpy(x).to(dev) for x in (
            rng.integers(0, r, (t, r, b)).astype(np.int32), et,
            rng.integers(0, r, b).astype(np.int32), np.full(b, t - 1, np.int32),
            np.r_[t, 0, 1, rng.integers(2, t, b - 3)].astype(np.int32))]
    before = vk.wordtrace_words_device.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the wrapper reads nothing back
    try:
        got = vk.wordtrace_words_device(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = vk.wordtrace_words_ref(*args)
    torch.cuda.synchronize()
    assert vk.wordtrace_words_device.launches == before + 1
    assert got[0].shape == want[0].shape == (args[0].shape[0] + 1, args[0].shape[2])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    host = vk.wordtrace_words_host(*got)
    assert (host[0] == want[0].cpu().numpy()).all() and (host[1] == want[1].cpu().numpy()).all()
    if case.startswith("skip"):
        assert int(want[1].max()) > t // 5 + 1


def test_walk_wrappers_raise_instead_of_falling_back(dev):
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_kernels import dense_backtrace

    bp = torch.zeros((2, 6, 4), dtype=torch.int32, device=dev)
    nf = torch.full((2,), 6, dtype=torch.int32, device=dev)
    counts = (dense_backtrace.launches, lk.lattice_walk.launches,
              vk.wordtrace_words_device.launches)
    with pytest.raises(ValueError, match="n_frames is on cpu"):
        dense_backtrace(bp, bp, nf, nf.cpu())
    with pytest.raises(ValueError, match="int32"):
        dense_backtrace(bp.long(), bp, nf, nf)
    with pytest.raises(ValueError, match="int32"):
        lk.lattice_walk(bp.permute(1, 2, 0), bp.permute(1, 2, 0).long(), nf, nf)
    with pytest.raises(ValueError, match="best_leaf is on cpu"):
        lk.lattice_walk(bp.permute(1, 2, 0), bp.permute(1, 2, 0), nf.cpu(), nf)
    planes = bp.permute(1, 2, 0)  # [T, R, B]
    with pytest.raises(ValueError, match="int8 or int32"):
        vk.wordtrace_words_device(planes.short(), planes, nf, nf, nf)
    with pytest.raises(ValueError, match="entry_t is on cpu"):
        vk.wordtrace_words_device(planes, planes, nf, nf.cpu(), nf)
    assert (dense_backtrace.launches, lk.lattice_walk.launches,
            vk.wordtrace_words_device.launches) == counts


@pytest.fixture(scope="module")
def walk_corpus(tmp_path_factory):
    """A small corpus from the port's ``synth`` and a bank trained on it
    on the CPU."""
    import contextlib
    import io

    from speech_recognition_tpu_torch.cli import main

    root = str(tmp_path_factory.mktemp("walks"))
    with contextlib.redirect_stdout(io.StringIO()):
        main(["synth", "-o", root, "--n-train", "2", "--n-test", "1", "--n-continuous", "8",
              "--seed", "5"])
        main(["isolated_train", "-i", os.path.join(root, "train"), "-o",
              os.path.join(root, "bank.npz"), "--n-gaussians", "2", "--device", "cpu"])
    return root


@pytest.mark.parametrize("action", ["isolated_train", "align", "connected_test bigram"])
def test_walk_clis_cuda_match_cpu(dev, walk_corpus, tmp_path, action):
    """``align``, ``isolated_train`` and ``connected_test --graph lextree
    --lm bigram --decoder lattice`` on the card launch K21 / K22 (the
    bigram path's K22 as the last step of its K7 launch,
    ``rescore_and_walk``) and print what ``--device cpu`` prints (align:
    its segments too, costs at rtol 1e-5)."""
    import contextlib
    import io
    import json

    from speech_recognition_tpu_torch.cli import main
    from speech_recognition_tpu_torch.ops import lattice_kernels as lk
    from speech_recognition_tpu_torch.ops.viterbi_kernels import dense_backtrace

    bank = os.path.join(walk_corpus, "bank.npz")
    argv = {"isolated_train": ["isolated_train", "-i", os.path.join(walk_corpus, "train"),
                               "-o", str(tmp_path / "out.npz"), "--n-gaussians", "2"],
            "align": ["align", "-i", bank, "-d", os.path.join(walk_corpus, "train"), "-o",
                      str(tmp_path / "out.jsonl")],
            "connected_test bigram": ["connected_test", "-i", bank, "-d",
                                      os.path.join(walk_corpus, "test"), "--graph",
                                      "lextree", "--lm", "bigram", "--decoder", "lattice"]}
    counter = lk.rescore_and_walk if action.startswith("connected") else dense_backtrace
    out = {}
    for d in ("cuda", "cpu"):
        before = counter.launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv[action] + ["--device", d])
        torch.cuda.synchronize()
        assert (counter.launches > before) == (d == "cuda"), (action, d)
        out[d] = buf.getvalue()
        if action == "align":
            with open(tmp_path / "out.jsonl") as f:
                out[d + " segments"] = [json.loads(x) for x in f]
    assert out["cuda"] == out["cpu"] and out["cuda"]
    if action == "align":
        segs = {d: [(r["file"], r["segments"]) for r in out[d + " segments"]]
                for d in ("cuda", "cpu")}
        assert segs["cuda"] == segs["cpu"]
        np.testing.assert_allclose([r["cost"] for r in out["cuda segments"]],
                                   [r["cost"] for r in out["cpu segments"]], rtol=1e-5)


# ---- K24 / K25: the k-means and EM fits of mixture training ------------------


# planted mixtures, and K24 / K25's tolerances against their plain versions
# (whole fits at GMM_TOL, rtol 1e-4 / atol 1e-4; one iteration at
# GMM_STEP_TOL, rtol 1e-5 / atol 2e-5), as chip_smoke.py holds them
from chip_smoke import (  # noqa: E402
    GMM_AS_ACCURATE,
    GMM_STEP_TOL,
    GMM_TOL,
    gmm_f64_errors,
    planted_fits,
)
# the modules (the package's ``kmeans`` name is the function)
tem = importlib.import_module("speech_recognition_tpu_torch.train.em")
tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")


# the fits of fit_hmm's shape (a word's 5 states, ~240 frames each), and
# one of ~8,000 frames (past the ~1,300 frames a CTA stages: read from
# device memory) beside two small ones
GMM_SIZES = {"staged": (260, 240, 300, 180, 220), "device memory": (8000, 300, 40)}


@pytest.mark.parametrize("tier", list(GMM_SIZES))
@pytest.mark.parametrize("quirk", [False, True])
def test_k24_kmeans_matches_plain(dev, tier, quirk):
    """One iteration tightly, then whole fits on planted mixtures: the same
    assignment (every frame, in a fit or not) and iteration counts, the
    parameters at GMM_TOL; two launches give the same bits."""
    from speech_recognition_tpu_torch.ops import gmm_fit_kernels as gfk

    x, masks, c0, init = planted_fits(40, GMM_SIZES[tier], dev)
    plan = gfk.gmm_fit_plan(x.shape[0], 39, 4, em=False)
    assert plan.frames == ("device" if tier == "device memory" else "shared")
    for iters, tol in ((1, GMM_STEP_TOL), (100, GMM_TOL)):
        before = tkm.kmeans_batch.launches
        n_it = torch.zeros(masks.shape[0], dtype=torch.int32, device=dev)
        got = tkm.kmeans_batch(x, masks, c0, 4, init, max_iters=iters, shared_cov_quirk=quirk,
                             iters=n_it)
        again = tkm.kmeans_batch(x, masks, c0, 4, init, max_iters=iters, shared_cov_quirk=quirk)
        want = tkm.kmeans_batch_ref(x, masks, c0, 4, init, max_iters=iters,
                                  shared_cov_quirk=quirk)
        torch.cuda.synchronize()
        assert tkm.kmeans_batch.launches == before + 2
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
        for a, b in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(a, b, **tol)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        assert int(n_it.min()) >= 1 and int(n_it.max()) <= iters
    assert int(n_it.max()) < 100  # the planted fits converge


@pytest.mark.parametrize("tier", list(GMM_SIZES))
def test_k25_em_matches_plain(dev, tier):
    """K25 from k-means' result: one iteration tightly, then whole fits with
    the same iteration counts; two launches give the same bits."""

    x, masks, c0, init = planted_fits(41, GMM_SIZES[tier], dev)
    _, m0, v0, counts = tkm.kmeans_batch_ref(x, masks, c0, 4, init)
    w0 = counts / masks.sum(1, keepdim=True).clamp(min=1).float()
    for iters, tol in ((1, GMM_STEP_TOL), (100, GMM_TOL)):
        before = tem.em_fit_batch.launches
        got = tem.em_fit_batch(x, masks, m0, v0, w0, max_iters=iters)
        again = tem.em_fit_batch(x, masks, m0, v0, w0, max_iters=iters)
        want = tem.em_fit_batch_ref(x, masks, m0, v0, w0, max_iters=iters)
        torch.cuda.synchronize()
        assert tem.em_fit_batch.launches == before + 2
        assert torch.equal(got[3], want[3].to(dev))
        for a, b in zip(got[:3], want[:3]):
            torch.testing.assert_close(a, b, **tol)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
    assert int(got[3].max()) < 100


def test_k24_k25_parameters_in_device_memory(dev):
    """Features too wide for a fit's parameter area in shared memory (D =
    3,000, M = 4: ~300 KB), so the parameters and partial sums live in a
    device scratch a CTA; of the two fits one is staged in the shared
    memory left (its frames at the start of it) and one read from device
    memory.  One iteration of K24 (with and without the quirk) and K25 as
    accurate as their plain versions: the largest difference from the
    plain version run in float64 on the same inputs at most
    GMM_AS_ACCURATE (2) times the float32 plain version's (which is itself
    up to ~2.3e-5 off float64 in a variance here, so that over 24,000
    parameters kernel and plain differ by more than GMM_STEP_TOL's atol);
    whole fits against the float32 plain versions (GMM_TOL; the same
    assignments, counts and iteration counts)."""
    from speech_recognition_tpu_torch.ops import gmm_fit_kernels as gfk

    x, masks, c0, init = planted_fits(47, (12, 300), dev, d=3000)
    for em in (False, True):
        plan = gfk.gmm_fit_plan(x.shape[0], 3000, 4, em=em)
        assert (plan.params, plan.frames) == ("device", "device") and 12 <= plan.cap < 300

    def held(got, want, close, tol):
        for j, (a, b) in enumerate(zip(got, want)):
            if j in close:
                torch.testing.assert_close(a, b.to(dev, a.dtype), **tol)
            else:
                assert torch.equal(a, b.to(dev))

    def as_accurate(kernel, plain, args, kw, close):
        errs, exact = gmm_f64_errors(kernel, plain, args, dict(kw, max_iters=1), close)
        assert exact and all(k <= GMM_AS_ACCURATE * max(p, 1e-7) for k, p in errs), errs

    for quirk in (False, True):
        kw = dict(shared_cov_quirk=quirk, disjoint=True)
        as_accurate(tkm.kmeans_batch, tkm.kmeans_batch_ref, (x, masks, c0, 4, init), kw, (1, 2))
        held(tkm.kmeans_batch(x, masks, c0, 4, init, **kw),
             tkm.kmeans_batch_ref(x, masks, c0, 4, init, **kw), (1, 2), GMM_TOL)
    _, m0, v0, counts = tkm.kmeans_batch_ref(x, masks, c0, 4, init)
    w0 = counts / masks.sum(1, keepdim=True).float()
    as_accurate(tem.em_fit_batch, tem.em_fit_batch_ref, (x, masks, m0, v0, w0),
                dict(disjoint=True), (0, 1, 2))
    got = tem.em_fit_batch(x, masks, m0, v0, w0, disjoint=True)
    held(got, tem.em_fit_batch_ref(x, masks, m0, v0, w0), (0, 1, 2), GMM_TOL)
    assert int(got[3].max()) < 100


def test_k24_k25_scratch_overrun_gives_nan(dev):
    """Fits that share frames launched as ``disjoint``: each fit's rows of
    the launch's N-row scratch start at the frames of the mask rows before
    its own, so the third fit (the first again: 100 + 80 frames before
    it, 100 of its own, in 244 rows) overruns.  Its outputs are NaN (K24's
    assignments -1), its iteration count -1, and nothing is written past
    the scratch; the two fits before it equal their plain versions, as
    every fit does launched without the promise (F N rows)."""
    from speech_recognition_tpu_torch.ops import gmm_fit_kernels as gfk

    x, masks, c0, init = planted_fits(48, (100, 80), dev, d=6)
    shared = torch.cat([masks, masks[:1]])
    c0, init = torch.cat([c0, c0[:1]]), torch.cat([init, init[:1]])
    want = tkm.kmeans_batch_ref(x, shared, c0, 4, init)
    it = torch.zeros(3, dtype=torch.int32, device=dev)
    got = gfk.launch_kmeans(x, shared, c0, 4, init, 100, False, 1e-6, it, True)
    assert bool(torch.all(got[0][2] == -1)) and bool(torch.isnan(got[1][2]).all())
    assert bool(torch.isnan(got[3][2]).all()) and it.tolist()[2] == -1
    assert torch.equal(got[0][:2], want[0][:2]) and torch.equal(got[3][:2], want[3][:2])
    w0 = torch.full((3, 4), 0.25, device=dev)
    em = gfk.launch_em(x, shared, c0, torch.ones_like(c0), w0, 100, 1e-5, 1e-8, 1e-6, True)
    assert all(bool(torch.isnan(t[2]).all()) for t in em[:3]) and em[3].tolist()[2] == -1
    assert bool(torch.isfinite(em[0][:2]).all()) and min(em[3].tolist()[:2]) >= 1
    ok = tkm.kmeans_batch(x, shared, c0, 4, init)  # not disjoint: F N rows
    assert torch.equal(ok[0], want[0]) and torch.equal(ok[3], want[3])


@pytest.mark.parametrize("quirk", [False, True])
def test_k24_k25_edge_fits(dev, quirk):
    """An empty cluster (it keeps its centroid), fits of one frame and of
    none, and no iteration at all (K24 returns the draws and their
    statistics, K25 its start)."""

    x, masks, c0, init = planted_fits(42, (200, 1, 0), dev, d=8)
    c0[0, 3] = 50.0
    for iters in (0, 100):
        got = tkm.kmeans_batch(x, masks, c0, 4, init, max_iters=iters, shared_cov_quirk=quirk)
        want = tkm.kmeans_batch_ref(x, masks, c0, 4, init, max_iters=iters,
                                  shared_cov_quirk=quirk)
        assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
        for a, b in zip(got[1:3], want[1:3]):
            torch.testing.assert_close(a, b, **GMM_TOL)
    assert float(got[3][0, 3]) == 0.0 and bool(torch.all(got[1][0, 3] == 50.0))
    w0 = torch.full((3, 4), 0.25, device=dev)
    v0 = torch.ones_like(c0)
    for iters in (0, 100):
        got = tem.em_fit_batch(x, masks, c0, v0, w0, max_iters=iters, var_floor=1e-2)
        want = tem.em_fit_batch_ref(x, masks, c0, v0, w0, max_iters=iters, var_floor=1e-2)
        assert torch.equal(got[3], want[3].to(dev))
        for a, b in zip(got[:3], want[:3]):
            torch.testing.assert_close(a, b, **GMM_TOL)
    assert got[3].tolist()[2] == 2


def test_fit_gmm_states_reads_nothing_back(dev):
    """A word's five states through ``fit_gmm_states`` under CUDA's sync
    debug mode: one K24 and one K25 launch a split level and no wait on
    the card (the draws go over from pinned memory)."""
    from speech_recognition_tpu_torch.config import HMMConfig
    from speech_recognition_tpu_torch.train.isolated import fit_gmm_states
    from speech_recognition_tpu_torch.train.kmeans import random_assign

    x, masks, c0, _ = planted_fits(43, GMM_SIZES["staged"], dev)
    mu0 = c0.mean(1)
    counts = (tkm.kmeans_batch.launches, tem.em_fit_batch.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fit_gmm_states(x, masks, mu0, 4, hmm_cfg=HMMConfig(n_mix=4),
                             draw_assign=random_assign(torch.Generator().manual_seed(0)))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (tkm.kmeans_batch.launches - counts[0], tem.em_fit_batch.launches - counts[1]) == (2, 2)
    assert all(bool(torch.isfinite(t).all()) for t in out)


def test_gmm_fit_wrappers_raise_instead_of_falling_back(dev, monkeypatch):
    """CUDA tensors never reach the plain versions: a library that does not
    load raises, and so does a mask on another device."""
    from speech_recognition_tpu_torch.utils import build

    x, masks, c0, init = planted_fits(44, (50, 20), dev, d=6)

    def fell_back(*a, **kw):
        raise AssertionError("a CUDA tensor ran the plain version")

    def no_library():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(tkm, "kmeans_batch_ref", fell_back)
    monkeypatch.setattr(tem, "em_fit_batch_ref", fell_back)
    monkeypatch.setattr(build, "load_library", no_library)
    with pytest.raises(RuntimeError, match="no kernel library"):
        tkm.kmeans_batch(x, masks, c0, 4, init)
    with pytest.raises(RuntimeError, match="no kernel library"):
        tem.em_fit_batch(x, masks, c0, torch.ones_like(c0), torch.full((2, 4), 0.25, device=dev))
    with pytest.raises(ValueError, match="masks is on cpu"):
        tkm.kmeans_batch(x, masks.cpu(), c0, 4, init)


def test_isolated_train_cuda_launches_k24_k25(dev, tmp_path):
    """``isolated_train --device cuda`` runs the mixture fits on K24 and K25
    (two launches of each a digit: two split levels) and its bank scores
    the accuracy the ``--device cpu`` bank scores, within one file."""
    import contextlib
    import io

    from speech_recognition_tpu_torch.cli import main

    root = str(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        main(["synth", "-o", root, "--n-train", "4", "--n-test", "3", "--n-continuous", "4",
              "--seed", "7"])
    acc = {}
    for d in ("cuda", "cpu"):
        before = (tkm.kmeans_batch.launches, tem.em_fit_batch.launches)
        bank = os.path.join(root, f"bank_{d}.npz")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["isolated_train", "-i", os.path.join(root, "train"), "-o", bank, "--device", d])
            torch.cuda.synchronize()
            launched = (tkm.kmeans_batch.launches - before[0],
                        tem.em_fit_batch.launches - before[1])
            main(["isolated_test", "-i", bank, "-d", os.path.join(root, "test"), "--device", d])
        assert launched == ((22, 22) if d == "cuda" else (0, 0))
        acc[d] = float(buf.getvalue().splitlines()[-1])
    n_test = sum(1 for f in os.listdir(os.path.join(root, "test")) if len(f.split("_")[1]) == 6)
    assert abs(acc["cuda"] - acc["cpu"]) <= 1.0 / n_test + 1e-9 and acc["cpu"] > 0.5


def test_continuous_train_cuda_launches_k24_k25(dev):
    """``continuous_train`` refits the states that got frames with one K24
    and one K25 launch a split level and iteration, and trains what the
    CPU trains from the same draws (rtol 1e-4 / atol 1e-4, as
    ``test_isolated_train_cuda_matches_cpu``)."""
    from speech_recognition_tpu_torch.config import HMMConfig, TrainConfig
    from speech_recognition_tpu_torch.train.continuous import continuous_train
    from speech_recognition_tpu_torch.train.kmeans import random_assign

    rng = np.random.default_rng(45)
    ps = [random_gmm_hmm(rng, n_states=3, n_mix=2, dim=8, sep=4.0) for _ in range(4)]
    bank = _bank(4, 3, 2, 8, seed=46)
    labels, feats, n_frames = [], np.zeros((12, 90, 8), np.float32), np.zeros(12, np.int32)
    for b in range(12):
        seq = [int(w) for w in rng.integers(0, 4, 3)]
        frames = [ps[w]["means"][s_, 0] + np.sqrt(ps[w]["variances"][s_, 0])
                  * rng.standard_normal(8) for w in seq for s_ in range(3)
                  for _ in range(int(rng.integers(3, 9)))][:90]
        labels.append(seq)
        feats[b, : len(frames)] = frames
        n_frames[b] = len(frames)
    out = {}
    for d in ("cpu", dev):
        before = (tkm.kmeans_batch.launches, tem.em_fit_batch.launches)
        out[str(d)] = continuous_train(
            bank.to(d), torch.from_numpy(feats).to(d), torch.from_numpy(n_frames).to(d), labels,
            hmm_cfg=HMMConfig(n_states=3, n_mix=2), train_cfg=TrainConfig(continuous_max_iters=2),
            draw_assign=random_assign(torch.Generator().manual_seed(3)))
        torch.cuda.synchronize()
        launched = (tkm.kmeans_batch.launches - before[0], tem.em_fit_batch.launches - before[1])
        assert launched == ((0, 0) if d == "cpu" else (2, 2))
    for f in ("means", "log_vars", "log_weights", "trans_cost"):
        torch.testing.assert_close(getattr(out[str(dev)], f).cpu(), getattr(out["cpu"], f),
                                   rtol=1e-4, atol=1e-4)

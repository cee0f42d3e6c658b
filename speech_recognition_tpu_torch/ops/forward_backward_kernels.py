"""The log-space forward-backward: kernels K15 (banded) and K16 (dense)
in ``csrc/forward_backward.cu``, and their plain versions.

Neither has a TPU kernel: each replaces a pass the JAX package leaves to
XLA as ``lax.scan``s (``speech_recognition_tpu/ops/forward_backward.py``
``forward_backward_banded`` and ``forward_backward``).  ``fb_banded`` and
``fb_dense`` run the plain versions of ``ops.forward_backward`` for CPU
tensors and launch the kernels for CUDA tensors, or raise: there is no
fallback.  A call launches twice, the scan (each item's forward and
backward side by side, into alpha and beta planes) and the combine pass
(gamma and the xi sums); ``fb_banded.launches`` / ``fb_dense.launches``
count calls.

``banded_plan`` / ``dense_plan`` size a scan CTA: its threads (a thread a
state or row, states past the block strided), its shared memory, whether
the emission rows are staged ahead in a shared-memory ring (where it
fits), and (K16) where the lists of finite matrix entries live: in shared
memory with the capacity the plan leaves room for (so that the 2B scan
CTAs of a call fit on the card at once where they can), else in device
memory.  Rows past a list's capacity run the dense loop, which gives the
same answer.  A graph whose alpha / beta rows do not fit in shared memory
(K15 past ~29,000 states, K16 past ~19,000) takes the device-row tier:
each scan CTA's rows live in a device-memory scratch, no ring, and K16's
lists are built before the scan by grid-wide launches, one list per
matrix and direction.  No size is refused.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.ops.forward_backward import (
    FBResult,
    cross_inverse,
    forward_backward_banded_plain,
    forward_backward_plain,
)
from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND, BandedGraph

__all__ = ["fb_banded", "fb_dense", "fb_banded_ref", "fb_dense_ref", "FBPlan", "banded_plan",
           "dense_plan", "fb_threads"]

# the plain versions
fb_banded_ref = forward_backward_banded_plain
fb_dense_ref = forward_backward_plain

# An H100 SM's shared memory (228 KB), handed out in 128-byte units, of
# which each resident CTA also takes 1 KB for the system
SM_SMEM_BYTES = 228 * 1024
SMEM_UNIT = 128
CTA_SMEM_RESERVED = 1024


class FBPlan(NamedTuple):
    """A scan CTA's threads and dynamic shared memory, whether it stages
    the emission rows in a shared-memory ring, (K16) where its
    finite-entry lists live and how many entries each holds, and where its
    alpha / beta rows live."""

    threads: int
    smem: int   # bytes
    lists: str  # K16: "shared" or "device"; K15: "none"
    cap: int    # K16: entries a list holds (rows past it run the dense loop)
    ring: bool = True
    rows: str = "shared"  # "device": the device-row tier


def fb_threads(s: int) -> int:
    """Threads per scan CTA: a thread a state (K15) or row (K16), states
    past the block strided as evenly as a multiple of 32 allows, at most
    224 (the kernels' register cap, 72, leaves room for 4 such CTAs an
    SM): the 385-state sausage gets 224, two states a thread."""
    per = -(-s // 224)
    return -(-(-(-s // per)) // 32) * 32


def banded_plan(s: int, r: int, l: int, smem_bytes, limit: int) -> FBPlan:
    """K15's plan: ``smem_bytes(S, R, L, ring, rows_in_smem)`` is the
    kernel's own layout (``fb_banded_smem_bytes``: the two rows, the eps
    pass's [max(R, L)] vector and, where they fit, the 3-row emission
    ring and the band's scores; with the rows in device memory, the block
    scratch alone).  Rows that do not fit in shared memory take the
    device-row tier."""
    if smem_bytes(s, r, l, 0, 1) > limit:
        return FBPlan(fb_threads(s), smem_bytes(s, r, l, 0, 0), "none", 0, False, "device")
    ring = smem_bytes(s, r, l, 1, 1) <= limit
    return FBPlan(fb_threads(s), smem_bytes(s, r, l, int(ring), 1), "none", 0, ring)


def dense_plan(s: int, use_eps: bool, b: int, n_sm: int, smem_bytes, limit: int) -> FBPlan:
    """K16's plan: ``smem_bytes(S, eps, cap, lists_in_smem, ring,
    rows_in_smem)`` is the kernel's own layout (``fb_dense_smem_bytes``).
    The emission ring goes in where it fits; the lists take the shared
    memory left once the 2B scan CTAs share the card's SMs (``n_sm``) as
    evenly as threads allow, up to S^2 entries; where that leaves fewer
    than min(S^2, 4 S), they go to device memory with min(S^2, 16 S)
    entries each.  Rows that do not fit in shared memory take the
    device-row tier (lists prebuilt in device memory, min(S^2, 16 S)
    entries)."""
    e = int(use_eps)
    threads = fb_threads(s)
    full = s * s
    if smem_bytes(s, e, 0, 0, 0, 1) > limit:
        return FBPlan(threads, smem_bytes(s, e, 0, 0, 0, 0), "device", min(full, 16 * s),
                      False, "device")
    ring = int(smem_bytes(s, e, 0, 0, 1, 1) <= limit)
    ctas = max(1, min(-(-2 * b // n_sm), 2048 // threads, 32))
    budget = min(limit, SM_SMEM_BYTES // ctas // SMEM_UNIT * SMEM_UNIT - CTA_SMEM_RESERVED)
    fixed = smem_bytes(s, e, 0, 1, ring, 1)
    per_entry = smem_bytes(s, e, 1, 1, ring, 1) - fixed
    cap = min(full, (budget - fixed) // per_entry) if budget >= fixed else 0
    if cap >= min(full, 4 * s):
        return FBPlan(threads, smem_bytes(s, e, cap, 1, ring, 1), "shared", cap, bool(ring))
    return FBPlan(threads, smem_bytes(s, e, 0, 0, ring, 1), "device", min(full, 16 * s),
                  bool(ring))


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, x, shapes, dtype, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, emissions on {dev}")
    if tuple(x.shape) not in shapes or x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} of shape {' or '.join(map(str, shapes))}, "
                         f"got {x.dtype} {tuple(x.shape)}")


def _nll_checks(nll, n_frames):
    if not nll.is_cuda:
        raise ValueError(f"the forward-backward kernels run on CUDA tensors, got {nll.device}")
    if nll.dtype != torch.float32 or nll.dim() != 3:
        raise ValueError(f"the forward-backward kernels take float32 nll [B, T, S], got "
                         f"{nll.dtype} {tuple(nll.shape)}")
    b, t_len, s = nll.shape
    if t_len < 1 or s < 1:
        raise ValueError(f"the forward-backward needs T >= 1 and S >= 1, got {tuple(nll.shape)}")
    if n_frames.shape != (b,) or n_frames.device != nll.device:
        raise ValueError(f"n_frames must be [B] = ({b},) on {nll.device}, got "
                         f"{tuple(n_frames.shape)} on {n_frames.device}")
    return b, t_len, s


def _end_scores(end_scores, b, s, dev):
    """``end_scores`` checked, or None (the kernels read 0 everywhere)."""
    if end_scores is None:
        return None
    _check("end_scores", end_scores, ((s,), (b, s)), torch.float32, dev)
    return end_scores.contiguous()


def _frames(n_frames):
    """``(n_frames, is_int64)`` as the kernels read it: int32 or int64 as
    given (other types cast to int32)."""
    if n_frames.dtype in (torch.int32, torch.int64):
        return n_frames.contiguous(), int(n_frames.dtype == torch.int64)
    return n_frames.to(torch.int32).contiguous(), 0


def _i32(x):
    return x.to(torch.int32).contiguous()


def _ptrs(xs):
    return [x.data_ptr() if x is not None else None for x in xs]


def fb_banded(nll, g: BandedGraph, n_frames, eps_depth: int = 1, end_scores=None) -> FBResult:
    """K15 for CUDA tensors, the plain version for CPU tensors (see
    ``ops.forward_backward.forward_backward_banded``).  A call is two
    launches, the scan and the combine pass; ``fb_banded.launches`` counts
    calls."""
    if not nll.is_cuda:
        return forward_backward_banded_plain(nll, g, n_frames, eps_depth, end_scores)
    return _banded(nll, g, n_frames, eps_depth, end_scores)


def _banded(nll, g, n_frames, eps_depth, end_scores, trace=None):
    """K15's launch; ``trace`` (int64 ``[2B, 8]``, zeroed) takes each scan
    CTA's clock64 cycles by phase (``csrc/forward_backward.cu`` Trace)."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    b, t_len, s = _nll_checks(nll, n_frames)
    dev = nll.device
    per_item = g.band.dim() == 3
    lead = (b,) if per_item else ()
    r, l = g.word_starts.shape[-1], g.word_ends.shape[-1]
    if r < 1 or l < 1:
        raise ValueError(f"the banded forward-backward needs an eps block, got R={r}, L={l}")
    f32 = torch.float32
    _check("band", g.band, (lead + (MAX_BAND + 1, s),), f32, dev)
    _check("init_cost", g.init_cost, (lead + (s,),), f32, dev)
    _check("eps_block", g.eps_block, (lead + (r, l),), f32, dev)
    _check("is_start", g.is_start, (lead + (s,),), torch.bool, dev)
    for name in ("word_starts", "word_ends", "start_pos"):
        x = getattr(g, name)
        if x.device != dev or x.dtype not in (torch.int32, torch.int64) or \
                x.shape[:-1] != lead:
            raise ValueError(f"{name} must be int32 / int64 with leading {lead} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if g.start_pos.shape[-1] != s:
        raise ValueError(f"start_pos has {g.start_pos.shape[-1]} states, nll {s}")
    if eps_depth < 1:
        raise ValueError(f"eps_depth must be >= 1, got {eps_depth}")
    has_cross = g.cross_src is not None
    if has_cross:
        _check("cross_cost", g.cross_cost, (lead + (s,),), f32, dev)
        if g.cross_src.shape != g.cross_cost.shape or g.cross_src.device != dev:
            raise ValueError("cross_src must match cross_cost's shape and device")
    ends_sc = _end_scores(end_scores, b, s, dev)
    nf, nf64 = _frames(n_frames)
    lib = load_library()
    plan = banded_plan(s, r, l, lib.fb_banded_smem_bytes, lib.srt_smem_limit())
    if has_cross:
        inv_off, inv_dst = cross_inverse(g.cross_src, g.cross_cost)
        cross = (_i32(g.cross_src), g.cross_cost.contiguous(), inv_off, inv_dst)
    else:
        cross = (None,) * 4
    alpha = torch.empty((b, t_len, s), dtype=f32, device=dev)
    beta = torch.empty_like(alpha)
    gamma = torch.empty_like(alpha)
    aux = torch.empty((2 * b, lib.fb_banded_aux_ints(s, r, l)), dtype=torch.int32, device=dev)
    rows = torch.empty((2 * b, lib.fb_banded_rows_floats(s, r, l)), dtype=f32, device=dev) \
        if plan.rows == "device" else None
    xi = torch.empty((b, MAX_BAND + 1, s), dtype=f32, device=dev)
    xi_cross = torch.empty((b, s), dtype=f32, device=dev) if has_cross else None
    log_z = torch.empty((b,), dtype=f32, device=dev)
    args = [nll.contiguous(), g.band.contiguous(), g.init_cost.contiguous(),
            g.eps_block.contiguous(), _i32(g.word_starts), _i32(g.word_ends),
            _i32(g.start_pos), g.is_start.contiguous(), *cross, ends_sc, nf, aux, alpha, beta,
            gamma, xi, xi_cross, log_z, trace, rows]
    with torch.cuda.device(dev):
        rc = lib.fb_banded_launch(
            *_ptrs(args), b, t_len, s, r, l, int(per_item),
            int(ends_sc is not None and ends_sc.dim() == 2), eps_depth, nf64, int(plan.ring),
            plan.threads, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "banded forward-backward kernel")
    fb_banded.launches += 1
    return FBResult(gamma, xi, log_z, xi_cross)


fb_banded.launches = 0


def fb_dense(nll, trans_cost, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
             end_scores=None, xi_mode: str = "dense") -> FBResult:
    """K16 for CUDA tensors, the plain version for CPU tensors (see
    ``ops.forward_backward.forward_backward``).  A call is two launches,
    the scan and the combine pass; ``fb_dense.launches`` counts calls."""
    if not nll.is_cuda:
        return forward_backward_plain(nll, trans_cost, init_cost, n_frames, eps_trans,
                                      eps_depth, end_scores, xi_mode)
    return _dense(nll, trans_cost, init_cost, n_frames, eps_trans, eps_depth, end_scores,
                  xi_mode)


def _dense(nll, trans_cost, init_cost, n_frames, eps_trans, eps_depth, end_scores, xi_mode,
           trace=None):
    """K16's launch; ``trace`` as for :func:`_banded`."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if xi_mode not in ("dense", "band"):
        raise ValueError(f"unknown xi_mode {xi_mode!r}")
    b, t_len, s = _nll_checks(nll, n_frames)
    dev = nll.device
    f32 = torch.float32
    _check("trans_cost", trans_cost, ((s, s), (b, s, s)), f32, dev)
    if eps_trans is not None:
        _check("eps_trans", eps_trans, (tuple(trans_cost.shape),), f32, dev)
    _check("init_cost", init_cost, ((s,), (b, s)), f32, dev)
    if eps_depth < 1:
        raise ValueError(f"eps_depth must be >= 1, got {eps_depth}")
    ends_sc = _end_scores(end_scores, b, s, dev)
    nf, nf64 = _frames(n_frames)
    lib = load_library()
    xi_dense = xi_mode == "dense"
    use_eps = eps_trans is not None
    plan = dense_plan(s, use_eps, b, _n_sm(dev.index if dev.index is not None else
                                           torch.cuda.current_device()),
                      lib.fb_dense_smem_bytes, lib.srt_smem_limit())
    lists = rows = None
    n_kinds = 1 + int(use_eps)
    if plan.rows == "device":  # a list per matrix and direction, built before the scan
        n_mats = b if trans_cost.dim() == 3 else 1
        lists = torch.empty((n_mats * 2 * n_kinds, lib.fb_dense_list_ints(s, plan.cap)),
                            dtype=torch.int32, device=dev)
        rows = torch.empty((2 * b, 3 * s), dtype=f32, device=dev)
    elif plan.lists == "device":
        lists = torch.empty((2 * b, n_kinds * lib.fb_dense_list_ints(s, plan.cap)),
                            dtype=torch.int32, device=dev)
    alpha = torch.empty((b, t_len, s), dtype=f32, device=dev)
    beta = torch.empty_like(alpha)
    gamma = torch.empty_like(alpha)
    xi = torch.empty((b, s, s) if xi_dense else (b, MAX_BAND + 1, s), dtype=f32, device=dev)
    log_z = torch.empty((b,), dtype=f32, device=dev)
    args = [nll.contiguous(), trans_cost.contiguous(),
            eps_trans.contiguous() if use_eps else None, init_cost.contiguous(), ends_sc, nf,
            lists, alpha, beta, gamma, xi, log_z, trace, rows]
    with torch.cuda.device(dev):
        rc = lib.fb_dense_launch(
            *_ptrs(args), b, t_len, s, int(trans_cost.dim() == 3), int(init_cost.dim() == 2),
            int(ends_sc is not None and ends_sc.dim() == 2), eps_depth, int(xi_dense), nf64,
            plan.cap, int(plan.lists == "shared"), int(plan.ring), plan.threads,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "dense forward-backward kernel")
    fb_dense.launches += 1
    return FBResult(gamma, xi, log_z)


fb_dense.launches = 0

"""The log-space forward-backward: kernels K15 (banded) and K16 (dense)
in ``csrc/forward_backward.cu``, and their plain versions.

Neither has a TPU kernel: each replaces a pass the JAX package leaves to
XLA as ``lax.scan``s (``speech_recognition_tpu/ops/forward_backward.py``
``forward_backward_banded`` and ``forward_backward``).  ``fb_banded`` and
``fb_dense`` run the plain versions of ``ops.forward_backward`` for CPU
tensors and launch the kernels for CUDA tensors, or raise: there is no
fallback.  ``fb_banded.launches`` / ``fb_dense.launches`` count launches.

``banded_plan`` / ``dense_plan`` pick where each kernel keeps its state:
everything in shared memory where it fits; else the xi sums go to the
outputs themselves, then (K16) the matrices are read through L1 as costs.
The alpha / beta rows always stay in shared memory, so a graph whose rows
do not fit (K15 past ~29,000 states, K16 past ~19,000) is refused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.ops.forward_backward import (
    FBResult,
    cross_inverse,
    end_positions,
    forward_backward_banded_plain,
    forward_backward_plain,
)
from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND, BandedGraph
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["fb_banded", "fb_dense", "fb_banded_ref", "fb_dense_ref", "FBPlan", "banded_plan",
           "dense_plan", "fb_threads"]

# the plain versions
fb_banded_ref = forward_backward_banded_plain
fb_dense_ref = forward_backward_plain


class FBPlan(NamedTuple):
    """Where a forward-backward kernel keeps its state (True: shared
    memory), and its threads per CTA."""

    acc: bool   # the xi sums (else the outputs)
    mats: bool  # K16: the score matrices (else costs through L1)
    threads: int
    smem: int   # dynamic shared memory per CTA, bytes


def fb_threads(s: int) -> int:
    """Threads per CTA: a thread a state (K15) or row (K16), a multiple of
    32, at most 512 (states past it are strided; both kernels take 80-92
    registers a thread, so 1,024 would not launch)."""
    return min(512, -(-s // 32) * 32)


def _first_fit(candidates, size, limit, what):
    for flags in candidates:
        n = size(*flags)
        if n <= limit:
            return flags, n
    raise ValueError(f"too many states for the {what}: its rows alone need {n} bytes of "
                     f"shared memory, the card has {limit}")


def banded_plan(s: int, r: int, l: int, has_cross: bool, smem_bytes, limit: int) -> FBPlan:
    """K15's plan: ``smem_bytes(S, R, L, has_cross, acc)`` is the kernel's
    own layout (``fb_banded_smem_bytes``)."""
    (acc,), n = _first_fit(((1,), (0,)), lambda ac: smem_bytes(s, r, l, int(has_cross), ac),
                           limit, f"banded forward-backward (S={s}, R={r}, L={l})")
    return FBPlan(bool(acc), False, fb_threads(s), n)


def dense_plan(s: int, use_eps: bool, xi_dense: bool, smem_bytes, limit: int) -> FBPlan:
    """K16's plan: ``smem_bytes(S, eps, xi_dense, mats, acc)`` is the
    kernel's own layout (``fb_dense_smem_bytes``)."""
    (mats, acc), n = _first_fit(((1, 1), (1, 0), (0, 0)),
                                lambda m, a: smem_bytes(s, int(use_eps), int(xi_dense), m, a),
                                limit, f"dense forward-backward (S={s})")
    return FBPlan(bool(acc), bool(mats), fb_threads(s), n)


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
    if end_scores is None:
        return torch.zeros((s,), dtype=torch.float32, device=dev)
    _check("end_scores", end_scores, ((s,), (b, s)), torch.float32, dev)
    return end_scores.contiguous()


def _i32(x):
    return x.to(torch.int32).contiguous()


def _spans(finite, dim):
    """``(lo, hi)`` int32 of the first and one past the last True along
    ``dim`` of ``finite``; (0, 0) where there is none."""
    n = finite.shape[dim]
    f = finite.to(torch.int32)
    any_ = finite.any(dim)
    lo = torch.argmax(f, dim)
    hi = n - torch.argmax(f.flip(dim), dim)
    return _i32(torch.where(any_, lo, 0)), _i32(torch.where(any_, hi, 0))


def fb_banded(nll, g: BandedGraph, n_frames, eps_depth: int = 1, end_scores=None) -> FBResult:
    """K15 for CUDA tensors, the plain version for CPU tensors (see
    ``ops.forward_backward.forward_backward_banded``)."""
    if not nll.is_cuda:
        return forward_backward_banded_plain(nll, g, n_frames, eps_depth, end_scores)
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
    lib = load_library()
    plan = banded_plan(s, r, l, has_cross, lib.fb_banded_smem_bytes, lib.srt_smem_limit())
    finite = g.eps_block < POS_INF / 2
    row_lo, row_hi = _spans(finite, -1)
    col_lo, col_hi = _spans(finite, -2)
    if has_cross:
        inv_off, inv_dst = cross_inverse(g.cross_src, g.cross_cost)
        cross = (_i32(g.cross_src), g.cross_cost.contiguous(), inv_off, inv_dst)
    else:
        cross = (None,) * 4
    alpha = torch.empty((b, t_len, s), dtype=f32, device=dev)
    gamma = torch.empty_like(alpha)
    xi = torch.empty((b, MAX_BAND + 1, s), dtype=f32, device=dev)
    xi_cross = torch.empty((b, s), dtype=f32, device=dev) if has_cross else None
    log_z = torch.empty((b,), dtype=f32, device=dev)
    args = [nll.contiguous(), g.band.contiguous(), g.init_cost.contiguous(),
            g.eps_block.contiguous(), _i32(g.word_starts), _i32(g.word_ends),
            _i32(g.start_pos), g.is_start.contiguous(), _i32(end_positions(g.word_ends, s)),
            row_lo, row_hi, col_lo, col_hi, *cross, ends_sc, _i32(n_frames), alpha, gamma, xi,
            xi_cross, log_z]
    with torch.cuda.device(dev):
        rc = lib.fb_banded_launch(
            *[x.data_ptr() if x is not None else None for x in args], b, t_len, s, r, l,
            int(per_item), int(ends_sc.dim() == 2), eps_depth, int(plan.acc), plan.threads,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "banded forward-backward kernel")
    fb_banded.launches += 1
    return FBResult(gamma, xi, log_z, xi_cross)


fb_banded.launches = 0


def fb_dense(nll, trans_cost, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
             end_scores=None, xi_mode: str = "dense") -> FBResult:
    """K16 for CUDA tensors, the plain version for CPU tensors (see
    ``ops.forward_backward.forward_backward``)."""
    if not nll.is_cuda:
        return forward_backward_plain(nll, trans_cost, init_cost, n_frames, eps_trans,
                                      eps_depth, end_scores, xi_mode)
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
    lib = load_library()
    xi_dense = xi_mode == "dense"
    plan = dense_plan(s, eps_trans is not None, xi_dense, lib.fb_dense_smem_bytes,
                      lib.srt_smem_limit())
    alpha = torch.empty((b, t_len, s), dtype=f32, device=dev)
    gamma = torch.empty_like(alpha)
    xi = torch.empty((b, s, s) if xi_dense else (b, MAX_BAND + 1, s), dtype=f32, device=dev)
    log_z = torch.empty((b,), dtype=f32, device=dev)
    args = [nll.contiguous(), trans_cost.contiguous(),
            eps_trans.contiguous() if eps_trans is not None else None,
            init_cost.contiguous(), ends_sc, _i32(n_frames), alpha, gamma, xi, log_z]
    with torch.cuda.device(dev):
        rc = lib.fb_dense_launch(
            *[x.data_ptr() if x is not None else None for x in args], b, t_len, s,
            int(trans_cost.dim() == 3), int(init_cost.dim() == 2), int(ends_sc.dim() == 2),
            eps_depth, int(xi_dense), int(plan.mats), int(plan.acc), plan.threads,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "dense forward-backward kernel")
    fb_dense.launches += 1
    return FBResult(gamma, xi, log_z)


fb_dense.launches = 0

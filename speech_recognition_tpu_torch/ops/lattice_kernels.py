"""Lattice kernels K6 (pass-1 lattice planes) and K7 (bigram rescoring),
with their plain PyTorch versions.

K6 (``csrc/viterbi_lex.cu``, the lattice mode of K4) replaces the TPU
kernel ``_lex_kernel(emit_lattice=True)`` behind
``viterbi_lex_pallas_lattice`` and its lane-major twin
``_lex_kernel_wide(emit_lattice=True)``; its plain version is
``ops.lattice.viterbi_lattice_tb``.  K7 (``csrc/lattice_rescore.cu``)
replaces ``ops/lattice.py``'s ``_hq_sweep_pallas``, the VMEM-resident
ring lookup of the rescorer; the ring exists because XLA would not keep
it resident across the scan, and on the card the lookup is one indexed
load, so K7 is the whole rescoring DP (plain version
``ops.lattice.rescore_tbl``).

Layouts: emissions ``nll [U, T, B]`` as K4 takes them; the lattice
planes ``ends_cost / ends_tau [T, B, L]`` and the predecessor plane
``pred_w [T, B, L]``, so one stream's row is contiguous.  The public
functions of ``ops.lattice`` keep the reference's ``[T, L, B]`` and
transpose around the plain versions.

Each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors (or raises), counting launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops.lattice import rescore_tbl, viterbi_lattice_tb
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import use_kernels
from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import (
    LexTopo,
    lex_forward,
)

__all__ = ["viterbi_lattice", "viterbi_lattice_ref", "rescore_lattice",
           "rescore_lattice_ref"]


# ---------------------------------------------------------------------------
# K6: lattice pass 1
# ---------------------------------------------------------------------------


def viterbi_lattice_ref(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """Plain version of K6: ``nll [U, T, B]``, ``n_frames [B]`` ->
    ``(final [B, S], ends_cost [T, B, L], ends_tau [T, B, L] int32)``,
    ``viterbi_lattice_tb`` in K6's layouts."""
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    final, ec, et = viterbi_lattice_tb(nll.permute(1, 0, 2)[:, g.bank_state, :], g, n_frames)
    return (final.T.contiguous(), ec.transpose(1, 2).contiguous(),
            et.transpose(1, 2).contiguous())


def viterbi_lattice(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """K6 for CUDA tensors, the plain version for CPU tensors; arguments
    and results as ``viterbi_lattice_ref``.  Every frame ``t < T`` of
    the planes is written: frames past a stream's length repeat its last
    frame, and a stream of length 0 still runs frame 0.  The same
    kernel and plan as K4 (``viterbi_lex_kernels.lex_forward``), with an
    entry-time frontier beside the costs."""
    if not use_kernels(nll):
        return viterbi_lattice_ref(nll, g, topo, n_frames)
    return lex_forward(nll, g, topo, n_frames, True, viterbi_lattice)


viterbi_lattice.launches = 0


# ---------------------------------------------------------------------------
# K7: bigram rescoring over the lattice
# ---------------------------------------------------------------------------


# Plain version of K7: the rescoring DP in the kernel's layouts
rescore_lattice_ref = rescore_tbl


def rescore_lattice(ends_cost, ends_tau, q, start_l, end_l, n_frames, dmax: int,
                    big_ll=None, backoff=None):
    """K7 for CUDA tensors, the plain version for CPU tensors; arguments
    and results as ``rescore_lattice_ref``.  One CTA per stream keeps
    the frame's D row in shared memory and the ``H - q`` rows in a
    ``[B, dmax, L]`` device-memory ring."""
    if not use_kernels(ends_cost):
        return rescore_lattice_ref(ends_cost, ends_tau, q, start_l, end_l, n_frames, dmax,
                                   big_ll=big_ll, backoff=backoff)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if (big_ll is None) == (backoff is None):
        raise ValueError("pass exactly one of big_ll and backoff")
    if ends_cost.dim() != 3:
        raise ValueError("ends_cost must be a [T, B, L] tensor")
    t_len, b, l = ends_cost.shape
    dev = ends_cost.device
    lm = (("big_ll", big_ll, torch.float32, (l, l)),) if backoff is None else (
        ("base_l", backoff[0], torch.float32, (l,)),
        ("pred_idx", backoff[1], torch.int32, (l, backoff[1].shape[-1])),
        ("pred_cost", backoff[2], torch.float32, (l, backoff[1].shape[-1])))
    for name, x, dtype, shape in (("ends_cost", ends_cost, torch.float32, (t_len, b, l)),
                                  ("ends_tau", ends_tau, torch.int32, (t_len, b, l)),
                                  ("q", q, torch.float32, (t_len, b)),
                                  ("start_l", start_l, torch.float32, (l,)),
                                  ("end_l", end_l, torch.float32, (l,)),
                                  ("n_frames", n_frames, None, (b,)), *lm):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the lattice on {dev}")
        if (dtype is not None and x.dtype != dtype) or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if t_len == 0 or l == 0 or dmax < 1:
        raise ValueError(f"rescoring needs T, L, dmax >= 1 (got {t_len}, {l}, {dmax})")
    cost = torch.empty((b,), dtype=torch.float32, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    pred = torch.empty((t_len, b, l), dtype=torch.int32, device=dev)
    if b == 0:
        return cost, best, pred
    lib = load_library()
    need, limit = lib.lattice_rescore_smem_bytes(l), lib.srt_smem_limit()
    if need > limit:
        raise ValueError(f"rescoring kernel: {need} B of shared memory for {l} leaves, "
                         f"over the {limit} B limit per CTA")
    nf = n_frames.to(torch.int32).contiguous()
    # every ring row is written before it is read (a lookup needs
    # tau < t), so the ring starts uninitialized
    ring = torch.empty((b, dmax, l), dtype=torch.float32, device=dev)
    k = 0 if backoff is None else backoff[1].shape[1]
    lm_ptrs = ([big_ll.data_ptr(), None, None, None] if backoff is None
               else [None] + [x.data_ptr() for x in backoff])
    with torch.cuda.device(dev):
        rc = lib.lattice_rescore_launch(
            ends_cost.data_ptr(), ends_tau.data_ptr(), q.data_ptr(), start_l.data_ptr(),
            end_l.data_ptr(), nf.data_ptr(), *lm_ptrs, ring.data_ptr(), cost.data_ptr(),
            best.data_ptr(), pred.data_ptr(), t_len, b, l, k, dmax,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "lattice rescoring kernel")
    rescore_lattice.launches += 1
    return cost, best, pred


rescore_lattice.launches = 0

"""Dense Viterbi: kernel K11 (``csrc/viterbi_dense.cu``) and its plain
version ``ops.viterbi.viterbi_batch``.

Counterpart of ``speech_recognition_tpu/ops/pallas_kernels.py``
``pallas_viterbi`` (shared or per-utterance graphs), with the semantics
of ``ops/viterbi.viterbi``, including ``final = POS_INF`` at
``n_frames`` 0, where the Pallas kernel leaves it unwritten.  The TPU
layout is not carried over: no padding of S to 128 lanes, no padding of
the frames to 8, no VMEM tiles.

``viterbi_dense`` runs the plain version for CPU tensors and launches
K11 for CUDA tensors (or raises); ``viterbi_dense.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops.viterbi import viterbi_batch
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["viterbi_dense", "viterbi_dense_ref", "max_dense_states"]

# K11's plain version
viterbi_dense_ref = viterbi_batch


def max_dense_states(lib) -> int:
    """The most states whose K11 frontier (five ``[S]`` rows of 4 bytes)
    fits in shared memory; above, it lives in a device-memory scratch."""
    return lib.srt_smem_limit() // 20


def viterbi_dense(nll, trans, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
                  planes: bool = True):
    """K11 for CUDA tensors, the plain version for CPU tensors.

    ``nll [B, T, S]`` f32; ``trans`` / ``eps_trans`` ``[S, S]`` (shared)
    or ``[B, S, S]`` (per item, as ``per_utterance_graph``); ``init_cost
    [S]`` or ``[B, S]``; ``n_frames [B]``.  Returns ``(final [B, S], bp
    [B, T, S] int32, eps_bp [B, T, S] int32)``; ``planes=False`` writes
    neither plane (``None``), as the isolated scorers need only
    ``final``.  Any S: above ``max_dense_states`` the frontier lives in a
    device-memory scratch."""
    if not nll.is_cuda:
        return viterbi_batch(nll, trans, init_cost, n_frames, eps_trans, eps_depth, planes)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    dev = nll.device
    if nll.dtype != torch.float32 or nll.dim() != 3:
        raise ValueError(f"dense Viterbi kernel takes float32 nll [B, T, S], got "
                         f"{nll.dtype} {tuple(nll.shape)}")
    b, t_len, s = nll.shape
    mats = [("trans", trans)] + ([("eps_trans", eps_trans)] if eps_trans is not None else [])
    for name, m in mats:
        if m.shape not in ((s, s), (b, s, s)) or m.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [S, S] or [B, S, S] with S={s}, "
                             f"B={b}; got {m.dtype} {tuple(m.shape)}")
    if eps_trans is not None and eps_trans.shape != trans.shape:
        raise ValueError("trans and eps_trans must both be shared or both per item")
    if init_cost.shape not in ((s,), (b, s)) or init_cost.dtype != torch.float32:
        raise ValueError(f"init_cost must be float32 [S] or [B, S], got "
                         f"{init_cost.dtype} {tuple(init_cost.shape)}")
    if n_frames.shape != (b,):
        raise ValueError(f"n_frames has shape {tuple(n_frames.shape)}, batch is {b}")
    for name, x in [("init_cost", init_cost), ("n_frames", n_frames), *mats]:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, emissions on {dev}")
    if eps_depth < 1:
        raise ValueError(f"eps_depth must be >= 1, got {eps_depth}")
    lib = load_library()
    limit, use_eps = lib.srt_smem_limit(), int(eps_trans is not None)
    final = torch.empty((b, s), dtype=torch.float32, device=dev)
    bp = torch.empty((b, t_len, s), dtype=torch.int32, device=dev) if planes else None
    eps_bp = torch.empty_like(bp) if planes else None
    if b == 0 or t_len == 0 or s == 0:
        return final.fill_(POS_INF), bp, eps_bp
    stage = int(lib.viterbi_dense_smem_bytes(s, use_eps, 1) <= limit)
    # a frontier too wide for shared memory lives in a [B, 5, S] scratch
    scratch = None
    if lib.viterbi_dense_smem_bytes(s, use_eps, 0) > limit:
        scratch = torch.empty((b, 5, s), dtype=torch.float32, device=dev)
    args = [nll.contiguous(), trans.contiguous(),
            eps_trans.contiguous() if eps_trans is not None else None,
            init_cost.contiguous(), n_frames.to(torch.int32).contiguous()]
    ptr = [x.data_ptr() if x is not None else None for x in args]
    with torch.cuda.device(dev):
        rc = lib.viterbi_dense_launch(
            *ptr, final.data_ptr(), bp.data_ptr() if planes else None,
            eps_bp.data_ptr() if planes else None,
            scratch.data_ptr() if scratch is not None else None, b, t_len, s,
            int(trans.dim() == 3),
            int(init_cost.dim() == 2), eps_depth, stage,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "dense Viterbi kernel")
    viterbi_dense.launches += 1
    return final, bp, eps_bp


viterbi_dense.launches = 0

"""The launches of mixture training's two loop kernels, K24 (k-means) and
K25 (EM) in ``csrc/gmm_fit.cu``: their plan, their scratch and their
calls into the kernel library.

Neither has a TPU kernel: each replaces a jitted ``lax.while_loop`` of the
JAX package (``speech_recognition_tpu/train/kmeans.py:91`` in ``kmeans``,
``speech_recognition_tpu/train/em.py:95`` in ``em_fit``).  A launch fits
a batch of F mixtures, each over the frames of one shared buffer ``x [N,
D]`` that its row of ``masks [F, N]`` marks, to convergence or
``max_iters``, and reads nothing back: ``fit_hmm`` fits a word's states
with one K24 and one K25 launch a split level.  The wrappers that gate on
the device, count launches and hold the plain versions are
``train.kmeans.kmeans_batch`` and ``train.em.em_fit_batch``; they check
their arguments here (``check_frames``, ``check_tensor``) before the
kernel library is loaded.

``gmm_fit_plan`` is the pure host function that sizes a launch and
picks the kernel's instance: D = 39 at M = 1, 2 or 4 (compile-time
widths), a generic one, or the device one where a fit's parameter area
(``_param_floats``, the kernel's ``fit_layout``) passes the shared memory
or its owners (up to 4 mixtures and a 4-dim block each) pass the CTA's 256
threads.  On the
shared tiers a fit stages its frames in shared memory where they fit
(``cap``: about 1,100 at D = 39, rows of ``_row_stride(D)`` floats); a fit
with more is gathered once into a compact device scratch and streamed
through a ring of ``stages`` shared-memory tiles of ``tile`` frames by
bulk copies, so no size is refused.

Device memory a launch takes besides its inputs and outputs: the fits'
compacted frame indices, ``4 rows`` bytes; where a fit may pass ``cap``
(or on the device tier) the compact frame rows, ``4 rows _row_stride(D)``
bytes; on the device tier the per-frame values, ``4 rows V`` bytes (V =
1 for K24, M for K25), and ``4 F _param_floats(M, D)`` bytes of
parameters.  ``rows`` is N where the caller promises that no frame is in
two fits (``disjoint``: each fit's rows start at the count of the frames
in the mask rows before its own, which its CTA takes), else F N (N a
fit).  ``continuous_train`` over ~130,000 frames at D = 39 thus takes
~24 MB a launch, whatever its number of states.

``launch_kmeans`` / ``launch_em`` take an optional int64 ``trace [F, 8]``:
each fit's iterations, then its CTA's thread-0 clock64 cycles by phase
(compaction and staging, weights, distances or responsibilities,
statistics, update and stop, K24's last pass) and the whole fit's.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

__all__ = ["GmmFitPlan", "gmm_fit_plan", "check_frames", "check_tensor", "launch_kmeans",
           "launch_em", "THREADS", "MAX_STAGES", "TILE"]

# threads a CTA (a fit), and the ring's most stages, as csrc/gmm_fit.cu's
# kThreads and kMaxStages
THREADS = 256
MAX_STAGES = 4
# frames a ring tile holds at most
TILE = 256
# the dynamic shared memory a CTA may ask for: the card's 227 KB opt-in
# limit less the kernels' static scratch (block scan, mbarriers)
SMEM_LIMIT = 227 * 1024 - 128
_LOG_2PI = math.log(2.0 * math.pi)
# the instances with compile-time widths: (D, M)
_FIXED = {(39, 1), (39, 2), (39, 4)}


class GmmFitPlan(NamedTuple):
    """A launch's layout: the kernel's instance (``"d39m1"``, ``"d39m2"``,
    ``"d39m4"``, ``"generic"`` or ``"device"``), where the parameters live
    (``"shared"`` or ``"device"``), whether every fit's frames are staged
    (``frames``: ``"shared"``) or a fit may pass ``cap`` (``"device"``: the
    launch allocates the compact frame rows), the frames a fit stages in
    shared memory (``cap``), the ring's ``tile`` frames and ``stages`` (0
    where no fit can pass ``cap``), and the dynamic shared memory in
    bytes."""

    instance: str
    params: str
    frames: str
    cap: int
    tile: int
    stages: int
    smem: int


def _round4(v: int) -> int:
    return (v + 3) & ~3


def _row_stride(d: int) -> int:
    """Floats of a staged frame row: ``d`` rounded up to an odd number of
    float4s (``row_stride`` in the kernel)."""
    return 4 * (((d + 3) // 4) | 1)


def _owners(m: int, d: int) -> int:
    """The statistics' owners: up to 4 mixtures and a block of 4 dims."""
    return -(-m // 4) * ((d + 3) // 4)


def _groups(m: int, d: int) -> int:
    """Frame groups of each owner: at most 32, one owner a thread where
    the owners fit in the CTA, else 1."""
    owners = _owners(m, d)
    return min(32, THREADS // owners) if owners <= THREADS else 1


def _param_floats(m: int, d: int) -> int:
    """Floats of a fit's parameter area (``fit_layout`` in the kernel):
    two buffers of NLL weights ([M, Dq] twice and M constants), means,
    their start (the statistics' origin) and variances [M, D], weights and
    log weights [M], cluster 0's variances
    [D], and the partial sums of G frame groups, ``2 M Dq + M`` each (Dq
    the row stride); every part a multiple of 4."""
    dq = _row_stride(d)
    q = _round4(2 * m * dq + m)
    return (2 * (2 * m * dq + _round4(m)) + 3 * _round4(m * d) + 2 * _round4(m) + _round4(d)
            + _groups(m, d) * q)


@functools.lru_cache(maxsize=256)
def gmm_fit_plan(n: int, d: int, m: int, em: bool, limit: int = SMEM_LIMIT) -> GmmFitPlan:
    """The launch layout for fits of ``m`` mixtures (clusters) over ``n``
    frames of ``d`` dimensions: a staged frame is its row
    (``_row_stride(d)`` floats) and its values (M responsibilities for EM,
    one assignment for k-means); a ring tile of up to ``TILE`` frames, as
    many stages as fit (2 to ``MAX_STAGES``), halved until two stages
    fit."""
    dq, v = _row_stride(d), (m if em else 1)
    fixed = 4 * _param_floats(m, d)
    device = GmmFitPlan("device", "device", "device", 0, 0, 0, 0)
    if fixed > limit or _owners(m, d) > THREADS:
        return device
    instance = f"d39m{m}" if (d, m) in _FIXED else "generic"
    room = limit - fixed
    cap = min(n, room // (4 * (dq + v)))
    if cap == n:
        return GmmFitPlan(instance, "shared", "shared", cap, 0, 0, fixed + 4 * cap * (dq + v))
    tile = TILE
    while tile:
        stages = min(MAX_STAGES, (room - 8 * tile * v) // (4 * tile * dq))
        if stages >= 2:
            ring = 4 * (stages * tile * dq + 2 * tile * v)
            return GmmFitPlan(instance, "shared", "device", cap, tile, stages,
                              fixed + max(4 * cap * (dq + v), ring))
        tile //= 2
    return device


def check_tensor(name, t, shape, dtype, dev):
    """``ValueError`` unless ``t`` is ``dtype`` of ``shape`` on ``dev``."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, frames on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def check_frames(x, masks, disjoint: bool):
    """``ValueError`` unless ``x`` is float32 ``[N, D]`` (D >= 1) and
    ``masks`` bool ``[F, N]`` (F >= 1) on its device; on the CPU also
    unless the rows share no frame where ``disjoint`` promises it (on the
    card that check would be a host read: a launch whose fits overrun
    their rows returns NaN)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"the mixture fits take float32 frames x [N, D], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if masks.dim() != 2 or masks.shape[0] == 0:
        raise ValueError(f"masks must be bool [F, N] with F >= 1, got {tuple(masks.shape)}")
    check_tensor("masks", masks, (masks.shape[0], x.shape[0]), torch.bool, x.device)
    if x.shape[1] == 0:
        raise ValueError("the mixture fits need frames of at least one dimension")
    if disjoint and x.device.type == "cpu" and bool((masks.sum(0) > 1).any()):
        raise ValueError("disjoint fits share a frame")


def _scratch(plan: GmmFitPlan, f: int, n: int, per_frame: int, m: int, d: int,
             disjoint: bool, dev):
    """The launch's device scratch: the fits' compacted frame indices
    [rows] int32, the compact frame rows [rows, _row_stride(d)] where a fit
    may pass ``cap``, and on the device tier the per-frame values [rows,
    per_frame] and the parameter areas (one element where unused); rows = N
    with ``disjoint``, else F N."""
    rows = n if disjoint else f * n
    device = plan.instance == "device"
    idx = torch.empty((max(rows, 1),), dtype=torch.int32, device=dev)
    frames = torch.empty((max(rows * _row_stride(d), 1) if plan.frames == "device" else 1,),
                         dtype=torch.float32, device=dev)
    vals = torch.empty((max(rows * per_frame, 1) if device else 1,), dtype=torch.float32,
                       device=dev)
    params = torch.empty((f * _param_floats(m, d) if device else 1,), dtype=torch.float32,
                         device=dev)
    return idx, frames, vals, params


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_kmeans(x, masks, centroids0, k: int, init_assign, max_iters: int,
                  shared_cov_quirk: bool, var_floor: float, iters, disjoint: bool, trace=None):
    """One K24 launch on checked CUDA tensors (``train.kmeans.kmeans_batch``
    checks and counts): ``(assign [F, N] int64, centroids [F, k, D],
    variances [F, k, D], counts [F, k])``; ``iters``, an int32 ``[F]``
    tensor or None, gets each fit's iteration count, ``trace`` (int64 [F,
    8] or None) the counters."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    f, n = masks.shape
    d = x.shape[1]
    dev = x.device
    assign = torch.empty((f, n), dtype=torch.int64, device=dev)
    cent = torch.empty((f, k, d), dtype=torch.float32, device=dev)
    var = torch.empty_like(cent)
    counts = torch.empty((f, k), dtype=torch.float32, device=dev)
    plan = gmm_fit_plan(n, d, k, em=False)
    idx, frames, vals, params = _scratch(plan, f, n, 1, k, d, disjoint, dev)
    x, masks = x.contiguous(), masks.contiguous()
    c0, init = centroids0.contiguous(), init_assign.contiguous()
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.kmeans_fit_launch(
            x.data_ptr(), masks.data_ptr(), c0.data_ptr(), init.data_ptr(), assign.data_ptr(),
            cent.data_ptr(), var.data_ptr(), counts.data_ptr(), _ptr(iters), idx.data_ptr(),
            frames.data_ptr(), vals.data_ptr(), params.data_ptr(), _ptr(trace), f, n, d, k,
            int(disjoint), max_iters, var_floor, d * _LOG_2PI, int(shared_cov_quirk), plan.cap,
            plan.tile, plan.stages, int(plan.instance == "device"), plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "k-means kernel")
    return assign, cent, var, counts


def launch_em(x, masks, means0, variances0, weights0, max_iters: int, rtol: float,
              atol: float, var_floor: float, disjoint: bool, trace=None):
    """One K25 launch on checked CUDA tensors (``train.em.em_fit_batch``
    checks and counts): ``(means, variances, weights, n_iters [F] int32)``,
    all on the card; ``trace`` as ``launch_kmeans``'s."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    f, n = masks.shape
    m, d = means0.shape[1:]
    dev = x.device
    means = torch.empty((f, m, d), dtype=torch.float32, device=dev)
    var = torch.empty_like(means)
    weights = torch.empty((f, m), dtype=torch.float32, device=dev)
    n_iters = torch.empty((f,), dtype=torch.int32, device=dev)
    plan = gmm_fit_plan(n, d, m, em=True)
    idx, frames, vals, params = _scratch(plan, f, n, m, m, d, disjoint, dev)
    x, masks = x.contiguous(), masks.contiguous()
    m0, v0, w0 = means0.contiguous(), variances0.contiguous(), weights0.contiguous()
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.em_fit_launch(
            x.data_ptr(), masks.data_ptr(), m0.data_ptr(), v0.data_ptr(), w0.data_ptr(),
            means.data_ptr(), var.data_ptr(), weights.data_ptr(), n_iters.data_ptr(),
            idx.data_ptr(), frames.data_ptr(), vals.data_ptr(), params.data_ptr(), _ptr(trace),
            f, n, d, m, int(disjoint), max_iters, rtol, atol, var_floor, d * _LOG_2PI, plan.cap,
            plan.tile, plan.stages, int(plan.instance == "device"), plan.smem,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "EM kernel")
    return means, var, weights, n_iters

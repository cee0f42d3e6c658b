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

``gmm_fit_plan`` is the pure host function that sizes a launch: a fit's
parameter area (``_param_floats``, the kernel's ``fit_layout``) in shared
memory where it fits, else in a device scratch a CTA; and the frames a fit
stages in shared memory (``cap``: about 1,300 at D = 39).  A fit with more
frames reads them from device memory each iteration and keeps its
per-frame values in a device scratch, so no size is refused.

Device memory a launch takes besides its inputs and outputs: the fits'
compacted frame indices, ``4 rows`` bytes, and where a fit may pass
``cap`` their per-frame values, ``4 rows V`` bytes (V = 1 for K24, M for
K25); ``rows`` is N where the caller promises that no frame is in two
fits (``disjoint``: each fit's rows start at the count of the frames in
the mask rows before its own, which its CTA takes), else F N (N a fit);
and where the parameters do not fit in shared memory, ``4 F
_param_floats(M, D)`` bytes.  ``continuous_train`` over ~130,000 frames at M = 4 thus takes
~2.7 MB a launch, whatever its number of states.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["GmmFitPlan", "gmm_fit_plan", "check_frames", "check_tensor", "launch_kmeans",
           "launch_em", "THREADS"]

# threads a CTA (a fit), as csrc/gmm_fit.cu's kThreads
THREADS = 512
# the dynamic shared memory a CTA may ask for: the card's 227 KB opt-in
# limit less the kernels' static block-scan scratch
SMEM_LIMIT = 227 * 1024 - 4 * (THREADS // 32)
_LOG_2PI = math.log(2.0 * math.pi)


class GmmFitPlan(NamedTuple):
    """A launch's layout: where the parameters live (``"shared"`` or
    ``"device"``), the frames a fit stages in shared memory (``cap``; a
    fit with more reads them from device memory), the dynamic shared
    memory in bytes, and whether every fit's frames fit (``frames``:
    ``"shared"``) or a fit may pass ``cap`` (``"device"``: the launch
    allocates the per-frame scratch)."""

    params: str
    frames: str
    cap: int
    smem: int


def _param_floats(m: int, d: int) -> int:
    """Floats of a fit's parameter area (``fit_layout`` in the kernel):
    the NLL weights [M, 2D + 1], means and variances [M, D], weights and
    log weights [M], cluster 0's variances [D], and the partial sums of
    the Q = M (D + 1) statistics, two floats for each of G thread groups."""
    q = m * (d + 1)
    groups = THREADS // min(q, THREADS)
    return m * (2 * d + 1) + 2 * m * d + 2 * m + d + 2 * groups * q


def gmm_fit_plan(n: int, d: int, m: int, em: bool, limit: int = SMEM_LIMIT) -> GmmFitPlan:
    """The launch layout for fits of ``m`` mixtures (clusters) over ``n``
    frames of ``d`` dimensions: a staged frame is its row at an odd stride
    (``d | 1`` floats) and its values (M responsibilities for EM, one
    assignment for k-means)."""
    fixed = 4 * _param_floats(m, d)
    per_frame = 4 * ((d | 1) + (m if em else 1))
    params = "shared" if fixed <= limit else "device"
    room = limit - (fixed if params == "shared" else 0)
    cap = min(n, room // per_frame)
    smem = (fixed if params == "shared" else 0) + cap * per_frame
    return GmmFitPlan(params, "shared" if cap == n else "device", cap, smem)


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
    [rows] int32, the per-frame values [rows, per_frame] of fits past
    ``cap`` and the parameter areas where they are not in shared memory
    (one element where unused); rows = N with ``disjoint``, else F N."""
    rows = n if disjoint else f * n
    idx = torch.empty((max(rows, 1),), dtype=torch.int32, device=dev)
    vals = torch.empty((rows * per_frame if plan.frames == "device" else 1,),
                       dtype=torch.float32, device=dev)
    params = torch.empty((f * _param_floats(m, d) if plan.params == "device" else 1,),
                         dtype=torch.float32, device=dev)
    return idx, vals, params


def launch_kmeans(x, masks, centroids0, k: int, init_assign, max_iters: int,
                  shared_cov_quirk: bool, var_floor: float, iters, disjoint: bool):
    """One K24 launch on checked CUDA tensors (``train.kmeans.kmeans_batch``
    checks and counts): ``(assign [F, N] int64, centroids [F, k, D],
    variances [F, k, D], counts [F, k])``; ``iters``, an int32 ``[F]``
    tensor or None, gets each fit's iteration count."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    f, n = masks.shape
    d = x.shape[1]
    dev = x.device
    assign = torch.empty((f, n), dtype=torch.int64, device=dev)
    cent = torch.empty((f, k, d), dtype=torch.float32, device=dev)
    var = torch.empty_like(cent)
    counts = torch.empty((f, k), dtype=torch.float32, device=dev)
    plan = gmm_fit_plan(n, d, k, em=False)
    idx, vals, params = _scratch(plan, f, n, 1, k, d, disjoint, dev)
    x, masks = x.contiguous(), masks.contiguous()
    c0, init = centroids0.contiguous(), init_assign.contiguous()
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.kmeans_fit_launch(
            x.data_ptr(), masks.data_ptr(), c0.data_ptr(), init.data_ptr(), assign.data_ptr(),
            cent.data_ptr(), var.data_ptr(), counts.data_ptr(),
            None if iters is None else iters.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            params.data_ptr(), f, n, d, k, int(disjoint), max_iters, var_floor,
            d * _LOG_2PI, int(shared_cov_quirk), plan.cap, int(plan.params == "shared"),
            plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "k-means kernel")
    return assign, cent, var, counts


def launch_em(x, masks, means0, variances0, weights0, max_iters: int, rtol: float,
              atol: float, var_floor: float, disjoint: bool):
    """One K25 launch on checked CUDA tensors (``train.em.em_fit_batch``
    checks and counts): ``(means, variances, weights, n_iters [F] int32)``,
    all on the card."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    f, n = masks.shape
    m, d = means0.shape[1:]
    dev = x.device
    means = torch.empty((f, m, d), dtype=torch.float32, device=dev)
    var = torch.empty_like(means)
    weights = torch.empty((f, m), dtype=torch.float32, device=dev)
    n_iters = torch.empty((f,), dtype=torch.int32, device=dev)
    plan = gmm_fit_plan(n, d, m, em=True)
    idx, vals, params = _scratch(plan, f, n, m, m, d, disjoint, dev)
    x, masks = x.contiguous(), masks.contiguous()
    m0, v0, w0 = means0.contiguous(), variances0.contiguous(), weights0.contiguous()
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.em_fit_launch(
            x.data_ptr(), masks.data_ptr(), m0.data_ptr(), v0.data_ptr(), w0.data_ptr(),
            means.data_ptr(), var.data_ptr(), weights.data_ptr(), n_iters.data_ptr(),
            idx.data_ptr(), vals.data_ptr(), params.data_ptr(), f, n, d, m, int(disjoint),
            max_iters, rtol, atol, var_floor, d * _LOG_2PI, plan.cap,
            int(plan.params == "shared"), plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "EM kernel")
    return means, var, weights, n_iters

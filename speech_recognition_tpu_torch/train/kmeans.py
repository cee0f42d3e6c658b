"""K-means for mixture splitting.

Counterpart of ``speech_recognition_tpu/train/kmeans.py``: Mahalanobis
k-means (the distance is the single-Gaussian NLL, one GEMM through
``ops.gmm.pairwise_gaussian_nll``) on masked frames, with cluster
statistics as one-hot matmuls.  Empty clusters keep their previous
centroid; ``shared_cov_quirk=True`` replicates the original system's
use of cluster 0's covariance from the random initial assignment for
every distance and for the returned variances.  Covariances use ddof=1.

The random initial assignment is an argument (``init_assign``), so a
caller replays any draw; ``random_assign`` draws it from a CPU
``torch.Generator``, so every device trains from the same draws.  The
loop stops at the first iteration whose centroids pass ``allclose``, the
iteration the JAX ``while_loop`` stops at.

``kmeans_batch`` is K24's wrapper: it fits F clusterings of one frame
buffer, each with its own mask row, centroids and draw (``[F, N]``
int64 on the frames' device), on CUDA tensors in one launch of kernel
K24 (``csrc/gmm_fit.cu`` through ``ops.gmm_fit_kernels.launch_kmeans``:
the whole loop on the card, no host read), on CPU tensors by its plain
version ``kmeans_batch_ref``, ``kmeans_ref`` fit by fit (the loop of
tensor ops, one host read an iteration).  ``kmeans_batch.launches``
counts its launches.  ``kmeans`` is a batch of one.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops import gmm_fit_kernels as gfk
from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import use_kernels

__all__ = ["kmeans", "kmeans_batch", "kmeans_batch_ref", "kmeans_ref", "cluster_stats",
           "random_assign"]


def random_assign(generator: torch.Generator):
    """A ``draw_assign(n, k)`` that returns ``[n]`` int64 cluster ids,
    uniform in ``[0, k)``, from ``generator`` (a CPU generator)."""

    def draw(n: int, k: int) -> torch.Tensor:
        return torch.randint(0, k, (n,), generator=generator)

    return draw


def cluster_stats(x, mask, assign, k: int, var_floor: float = 1e-6):
    """Masked per-cluster ``(count [k], mean [k, D], ddof-1 variance
    [k, D])`` of ``x [N, D]`` via one-hot matmuls."""
    onehot = ((assign[:, None] == torch.arange(k, device=x.device)[None, :])
              & mask[:, None]).to(x.dtype)
    counts = onehot.sum(0)
    means = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
    sq = onehot.T @ (x * x)
    var = (sq - counts[:, None] * means * means) / torch.clamp(counts - 1.0, min=1.0)[:, None]
    return counts, means, torch.clamp(var, min=var_floor)


def kmeans_batch(x, masks, centroids0, k: int, init_assign, max_iters: int = 100,
                 shared_cov_quirk: bool = False, var_floor: float = 1e-6, iters=None,
                 disjoint: bool = False):
    """K24 for CUDA tensors (one CTA a fit), the plain version for CPU
    ones.  ``x [N, D]`` float32, ``masks [F, N]`` bool, ``centroids0 [F,
    k, D]`` float32, ``init_assign [F, N]`` int64 -> ``(assign [F, N]
    int64, centroids [F, k, D], variances [F, k, D], counts [F, k])``, each
    fit as ``kmeans_ref``.  ``iters``: an int32 ``[F]`` tensor on the
    frames' device that the kernel fills with each fit's iteration count
    (the bound model's input); the plain version leaves it as it is.
    ``disjoint``: no frame is in two fits, so the launch's scratch takes
    N rows, not F N (``ops.gmm_fit_kernels``)."""
    gfk.check_frames(x, masks, disjoint)
    f, n = masks.shape
    d = x.shape[1]
    if k < 1 or max_iters < 0:
        raise ValueError(f"k-means needs k >= 1 and max_iters >= 0, got {k} and {max_iters}")
    gfk.check_tensor("centroids0", centroids0, (f, k, d), torch.float32, x.device)
    gfk.check_tensor("init_assign", init_assign, (f, n), torch.int64, x.device)
    if iters is not None:
        gfk.check_tensor("iters", iters, (f,), torch.int32, x.device)
    if not use_kernels(x):
        return kmeans_batch_ref(x, masks, centroids0, k, init_assign, max_iters=max_iters,
                                shared_cov_quirk=shared_cov_quirk, var_floor=var_floor)
    out = gfk.launch_kmeans(x, masks, centroids0, k, init_assign, max_iters, shared_cov_quirk,
                            var_floor, iters, disjoint)
    kmeans_batch.launches += 1
    return out


kmeans_batch.launches = 0


def kmeans_batch_ref(x, masks, centroids0, k: int, init_assign, max_iters: int = 100,
                     shared_cov_quirk: bool = False, var_floor: float = 1e-6,
                     disjoint: bool = False):
    """Plain version of K24 (arguments and results as ``kmeans_batch``;
    ``disjoint`` sizes no scratch here): ``kmeans_ref`` fit by fit."""
    fits = [kmeans_ref(x, masks[i], centroids0[i], k, init_assign[i], max_iters=max_iters,
                       shared_cov_quirk=shared_cov_quirk, var_floor=var_floor)
            for i in range(masks.shape[0])]
    return tuple(torch.stack(t) for t in zip(*fits))


def kmeans(x, mask, centroids0, k: int, init_assign, max_iters: int = 100,
           shared_cov_quirk: bool = False, var_floor: float = 1e-6):
    """Mahalanobis k-means of ``x [N, D]`` (frames where ``mask [N]``)
    from ``centroids0 [k, D]`` and the initial assignment ``init_assign
    [N]``.  Returns ``(assign [N], centroids [k, D], variances [k, D],
    counts [k])``: ``kmeans_batch`` of one fit."""
    out = kmeans_batch(x, mask[None], centroids0[None], k,
                       init_assign.to(x.device, torch.int64)[None], max_iters=max_iters,
                       shared_cov_quirk=shared_cov_quirk, var_floor=var_floor)
    return tuple(t[0] for t in out)


def kmeans_ref(x, mask, centroids0, k: int, init_assign, max_iters: int = 100,
               shared_cov_quirk: bool = False, var_floor: float = 1e-6):
    """Plain version of K24 for one fit (arguments and results as
    ``kmeans``): the loop of tensor ops, one host read an iteration."""
    assign = init_assign.to(x.device, torch.int64)
    _, _, init_var = cluster_stats(x, mask, assign, k, var_floor)
    centroids = centroids0
    for _ in range(max_iters):
        if shared_cov_quirk:
            var = init_var[0].expand_as(centroids)
        else:
            var = cluster_stats(x, mask, assign, k, var_floor)[2]
        assign = torch.argmin(pairwise_gaussian_nll(x, centroids, var), dim=1)
        counts, means, _ = cluster_stats(x, mask, assign, k, var_floor)
        new = torch.where(counts[:, None] > 0, means, centroids)
        done = torch.all(torch.abs(new - centroids) <= 1e-8 + 1e-5 * torch.abs(centroids))
        centroids = new
        if bool(done):
            break
    counts, _, variances = cluster_stats(x, mask, assign, k, var_floor)
    if shared_cov_quirk:
        variances = init_var[0].expand_as(centroids).clone()
    return assign, centroids, variances, counts

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
loop stops at the first iteration whose centroids pass ``allclose``
(one host read a iteration), the iteration the JAX ``while_loop`` stops
at.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll

__all__ = ["kmeans", "cluster_stats", "random_assign"]


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


def kmeans(x, mask, centroids0, k: int, init_assign, max_iters: int = 100,
           shared_cov_quirk: bool = False, var_floor: float = 1e-6):
    """Mahalanobis k-means of ``x [N, D]`` (frames where ``mask [N]``)
    from ``centroids0 [k, D]`` and the initial assignment ``init_assign
    [N]``.  Returns ``(assign [N], centroids [k, D], variances [k, D],
    counts [k])``."""
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

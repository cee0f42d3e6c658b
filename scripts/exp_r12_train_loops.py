#!/usr/bin/env python3
"""Time the port's training loops on one GPU: how k-means and EM stop.

    python3 scripts/exp_r12_train_loops.py [--frames N] [--reps R]

The JAX package runs k-means and EM as ``lax.while_loop``s that stop on
``allclose`` at the end of an iteration.  The port can stop at the same
iteration in two ways:

  sync    the port's loops (``train.kmeans.kmeans``, ``train.em.em_fit``):
          one host read of the ``allclose`` flag an iteration;
  masked  every iteration up to the cap (100) is launched with no host
          read, and an iteration after the flag is set leaves the state
          as it was (``torch.where``); the variant is written here.

Both return the same tensors (checked bit for bit).  The input is the
shape of one state of ``isolated_train``'s mixture splitting: N pooled
frames (20 templates x ~150 frames) x 39 dims, a fifth of them the
state's, from 4 seeded Gaussian blobs; k-means to 2 and to 4 clusters,
then EM from its result.  Times are CUDA-event medians over R runs
(``chip_smoke.cuda_ms``), in ms; the line carries the card's name and
power limit.  Prints one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def masked_kmeans(x, mask, centroids0, k, init_assign, max_iters=100):
    """The port's kmeans (default covariances) with masked iterations."""
    import torch

    from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll
    from speech_recognition_tpu_torch.train.kmeans import cluster_stats

    assign = init_assign.to(x.device, torch.int64)
    centroids = centroids0
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(max_iters):
        var = cluster_stats(x, mask, assign, k, 1e-6)[2]
        new_assign = torch.argmin(pairwise_gaussian_nll(x, centroids, var), dim=1)
        counts, means, _ = cluster_stats(x, mask, new_assign, k, 1e-6)
        new = torch.where(counts[:, None] > 0, means, centroids)
        now = torch.all(torch.abs(new - centroids) <= 1e-8 + 1e-5 * torch.abs(centroids))
        centroids = torch.where(done, centroids, new)
        assign = torch.where(done, assign, new_assign)
        done = done | now
    counts, _, variances = cluster_stats(x, mask, assign, k, 1e-6)
    return assign, centroids, variances, counts


def masked_em(x, mask, means, variances, w, max_iters=100, rtol=1e-5, atol=1e-8,
              var_floor=1e-2):
    """The port's em_fit with masked iterations."""
    import torch

    from speech_recognition_tpu_torch.train.em import (
        _allclose,
        em_step_stats,
        em_update_from_stats,
    )

    n_valid = mask.to(x.dtype).sum()
    done = torch.zeros((), dtype=torch.bool, device=x.device)
    it = torch.zeros((), dtype=torch.int64, device=x.device)
    for _ in range(max_iters):
        stats = em_step_stats(x, mask, means, torch.log(variances), torch.log(w))
        nm, nv, nw = em_update_from_stats(*stats, n_valid, var_floor)
        now = (_allclose(nm, means, rtol, atol) & _allclose(nv, variances, rtol, atol)
               & _allclose(nw, w, rtol, atol))
        means = torch.where(done, means, nm)
        variances = torch.where(done, variances, nv)
        w = torch.where(done, w, nw)
        it = it + (~done).to(torch.int64)
        done = done | now
    return means, variances, w, it


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke
    from speech_recognition_tpu_torch.train.em import em_fit
    from speech_recognition_tpu_torch.train.kmeans import kmeans

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, d = args.frames, 39
    centers = 2.0 * rng.standard_normal((4, d))
    x = (centers[rng.integers(0, 4, n)] + rng.standard_normal((n, d))).astype(np.float32)
    mask = rng.uniform(size=n) < 0.2
    x_t, m_t = torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev)
    mu0 = x_t[m_t].mean(0)
    out = {"card": card, "frames": n, "state_frames": int(mask.sum())}
    for k in (2, 4):
        c0 = torch.cat([mu0[None] * (1 - 0.1 * (i + 1)) for i in range(k)])
        init = torch.from_numpy(rng.integers(0, k, n))
        a = kmeans(x_t, m_t, c0, k, init)
        b = masked_kmeans(x_t, m_t, c0, k, init)
        if not all(torch.equal(p, q) for p, q in zip(a, b)):
            sys.exit(f"masked k-means differs from the port's at k={k}")
        w0 = a[3] / a[3].sum()
        e_a = em_fit(x_t, m_t, a[1], a[2], w0, var_floor=1e-2)
        e_b = masked_em(x_t, m_t, a[1], a[2], w0)
        if not (all(torch.equal(p, q) for p, q in zip(e_a[:3], e_b[:3]))
                and int(e_b[3]) == e_a[3]):
            sys.exit(f"masked EM differs from the port's at k={k}")
        # k-means' iterations: the loop stops where the centroids settle
        iters = next(i for i in range(1, 101)
                     if torch.equal(kmeans(x_t, m_t, c0, k, init, max_iters=i)[1], a[1]))
        out[f"k{k}"] = {
            "kmeans_iters": iters, "em_iters": e_a[3],
            "kmeans_sync_ms": chip_smoke.cuda_ms(lambda: kmeans(x_t, m_t, c0, k, init),
                                                 args.reps),
            "kmeans_masked_ms": chip_smoke.cuda_ms(
                lambda: masked_kmeans(x_t, m_t, c0, k, init), args.reps),
            "em_sync_ms": chip_smoke.cuda_ms(
                lambda: em_fit(x_t, m_t, a[1], a[2], w0, var_floor=1e-2), args.reps),
            "em_masked_ms": chip_smoke.cuda_ms(
                lambda: masked_em(x_t, m_t, a[1], a[2], w0), args.reps)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

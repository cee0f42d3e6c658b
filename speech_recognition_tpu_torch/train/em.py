"""Diagonal-GMM expectation-maximization in log space.

Counterpart of ``speech_recognition_tpu/train/em.py``: responsibilities
by logsumexp, sufficient statistics as masked matmuls, variances
floored, and the loop stops at the first iteration whose ``(means,
variances, weights)`` pass ``allclose``, the iteration the JAX
``while_loop`` stops at.  The statistics (``em_step_stats``) and the
update (``em_update_from_stats``) stay separate, so a data-parallel
trainer can reduce between them.

``em_fit_batch`` is K25's wrapper: it fits F mixtures of one frame
buffer, each with its own mask row and start, on CUDA tensors in one
launch of kernel K25 (``csrc/gmm_fit.cu`` through
``ops.gmm_fit_kernels.launch_em``: the whole loop on the card, no host
read, the iteration counts left on the card), on CPU tensors by its
plain version ``em_fit_batch_ref``, ``em_fit_ref`` fit by fit (the loop
of tensor ops, one host read an iteration).  ``em_fit_batch.launches``
counts its launches.  ``em_fit`` is a batch of one.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops import gmm_fit_kernels as gfk
from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import use_kernels

__all__ = ["em_fit", "em_fit_batch", "em_fit_batch_ref", "em_fit_ref", "em_step_stats",
           "em_update_from_stats"]


def em_step_stats(x, mask, means, log_vars, log_w):
    """E-step: ``(r_sum [M], rx [M, D], rxx [M, D])`` of ``x [N, D]`` over
    the frames where ``mask [N]``."""
    lp = -pairwise_gaussian_nll(x, means, torch.exp(log_vars)) + log_w[None, :]
    resp = torch.exp(lp - torch.logsumexp(lp, dim=1, keepdim=True))
    resp = torch.where(mask[:, None], resp, torch.zeros_like(resp))
    return resp.sum(0), resp.T @ x, resp.T @ (x * x)


def em_update_from_stats(r_sum, rx, rxx, n_valid, var_floor):
    """M-step from (possibly reduced) sufficient statistics."""
    denom = torch.clamp(r_sum, min=1e-10)[:, None]
    means = rx / denom
    variances = torch.clamp(rxx / denom - means * means, min=var_floor)
    w = r_sum / torch.clamp(n_valid, min=1e-10)
    return means, variances, w


def _allclose(a, b, rtol, atol):
    return torch.all(torch.abs(a - b) <= atol + rtol * torch.abs(b))


def em_fit_batch(x, masks, means0, variances0, weights0, max_iters: int = 100,
                 rtol: float = 1e-5, atol: float = 1e-8, var_floor: float = 1e-6,
                 disjoint: bool = False):
    """K25 for CUDA tensors (one CTA a fit), the plain version for CPU
    ones.  ``x [N, D]`` float32, ``masks [F, N]`` bool, ``means0 /
    variances0 [F, M, D]``, ``weights0 [F, M]`` float32 -> ``(means,
    variances, weights, n_iters [F] int32)``, each fit as ``em_fit_ref``;
    on the card ``n_iters`` stays on the device.  ``disjoint`` as in
    ``train.kmeans.kmeans_batch``."""
    gfk.check_frames(x, masks, disjoint)
    f = masks.shape[0]
    d = x.shape[1]
    if means0.dim() != 3 or max_iters < 0:
        raise ValueError(f"EM takes means0 [F, M, D] and max_iters >= 0, got "
                         f"{tuple(means0.shape)} and {max_iters}")
    m = means0.shape[1]
    gfk.check_tensor("means0", means0, (f, m, d), torch.float32, x.device)
    gfk.check_tensor("variances0", variances0, (f, m, d), torch.float32, x.device)
    gfk.check_tensor("weights0", weights0, (f, m), torch.float32, x.device)
    if m < 1:
        raise ValueError("EM needs at least one mixture component")
    if not use_kernels(x):
        return em_fit_batch_ref(x, masks, means0, variances0, weights0, max_iters=max_iters,
                                rtol=rtol, atol=atol, var_floor=var_floor)
    out = gfk.launch_em(x, masks, means0, variances0, weights0, max_iters, rtol, atol,
                        var_floor, disjoint)
    em_fit_batch.launches += 1
    return out


em_fit_batch.launches = 0


def em_fit_batch_ref(x, masks, means0, variances0, weights0, max_iters: int = 100,
                     rtol: float = 1e-5, atol: float = 1e-8, var_floor: float = 1e-6,
                     disjoint: bool = False):
    """Plain version of K25 (arguments and results as ``em_fit_batch``;
    ``disjoint`` sizes no scratch here): ``em_fit_ref`` fit by fit, the
    iteration counts as an int32 ``[F]`` tensor."""
    fits = [em_fit_ref(x, masks[i], means0[i], variances0[i], weights0[i], max_iters=max_iters,
                       rtol=rtol, atol=atol, var_floor=var_floor)
            for i in range(masks.shape[0])]
    n_iters = torch.tensor([fit[3] for fit in fits], dtype=torch.int32, device=x.device)
    return (*(torch.stack(t) for t in list(zip(*fits))[:3]), n_iters)


def em_fit(x, mask, means0, variances0, weights0, max_iters: int = 100,
           rtol: float = 1e-5, atol: float = 1e-8, var_floor: float = 1e-6):
    """Fit one GMM to ``x [N, D]`` (frames where ``mask [N]``) from
    ``means0 / variances0 [M, D]`` and ``weights0 [M]``.  Returns
    ``(means, variances, weights, n_iters)``, ``n_iters`` a 0-d int32
    tensor on ``x``'s device: ``em_fit_batch`` of one fit."""
    out = em_fit_batch(x, mask[None], means0[None], variances0[None], weights0[None],
                       max_iters=max_iters, rtol=rtol, atol=atol, var_floor=var_floor)
    return tuple(t[0] for t in out)


def em_fit_ref(x, mask, means0, variances0, weights0, max_iters: int = 100,
               rtol: float = 1e-5, atol: float = 1e-8, var_floor: float = 1e-6):
    """Plain version of K25 for one fit (arguments as ``em_fit``): the
    loop of tensor ops, one host read an iteration; ``n_iters`` an int."""
    n_valid = mask.to(x.dtype).sum()
    means, variances, w = means0, variances0, weights0
    it = 0
    while it < max_iters:
        stats = em_step_stats(x, mask, means, torch.log(variances), torch.log(w))
        new_means, new_vars, new_w = em_update_from_stats(*stats, n_valid, var_floor)
        done = (_allclose(new_means, means, rtol, atol) & _allclose(new_vars, variances, rtol, atol)
                & _allclose(new_w, w, rtol, atol))
        means, variances, w = new_means, new_vars, new_w
        it += 1
        if bool(done):
            break
    return means, variances, w, it

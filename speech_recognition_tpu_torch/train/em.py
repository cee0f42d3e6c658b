"""Diagonal-GMM expectation-maximization in log space.

Counterpart of ``speech_recognition_tpu/train/em.py``: responsibilities
by logsumexp, sufficient statistics as masked matmuls, variances
floored, and the loop stops at the first iteration whose ``(means,
variances, weights)`` pass ``allclose`` (one host read a iteration), the
iteration the JAX ``while_loop`` stops at.  The statistics
(``em_step_stats``) and the update (``em_update_from_stats``) stay
separate, so a data-parallel trainer can reduce between them.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll

__all__ = ["em_fit", "em_step_stats", "em_update_from_stats"]


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


def em_fit(x, mask, means0, variances0, weights0, max_iters: int = 100,
           rtol: float = 1e-5, atol: float = 1e-8, var_floor: float = 1e-6):
    """Fit one GMM to ``x [N, D]`` (frames where ``mask [N]``) from
    ``means0 / variances0 [M, D]`` and ``weights0 [M]``.  Returns
    ``(means, variances, weights, n_iters)``."""
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

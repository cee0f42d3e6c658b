"""Batched diagonal-GMM negative log-likelihoods as one GEMM.

Counterpart of ``speech_recognition_tpu/ops/gmm.py``.  The per-mixture
Gaussian NLL is written as a quadratic form so a whole batch of frames
against a whole bank of mixtures is one matmul:

    nll = [x^2, x, 1] @ [0.5/var, -mu/var, const]^T

followed by a logsumexp over mixtures.  The emission GEMM is
``torch.matmul`` in f32 (TF32 off, see ``utils.numerics``); the
emission kernel of the banded decode and of the word trace
(``csrc/bank_emission.cu``) evaluates the same form.
"""

from __future__ import annotations

import math

import torch

__all__ = ["gmm_emission_weights", "augment_features", "augment_dtb",
           "gmm_neg_log_lik", "gmm_neg_log_lik_ubt", "mahalanobis",
           "pairwise_gaussian_nll", "pairwise_sq_euclidean"]

_LOG_2PI = math.log(2.0 * math.pi)


def gmm_emission_weights(means, log_vars, log_weights):
    """``means/log_vars [..., M, D]``, ``log_weights [..., M]`` ->
    ``(w [..., M, 2D+1], log_weights)`` with ``augment(x) @ w[..., m, :]``
    the Gaussian NLL of mixture m."""
    inv_var = torch.exp(-log_vars)
    d = means.shape[-1]
    const = 0.5 * ((means * means * inv_var).sum(-1) + log_vars.sum(-1)
                   + d * _LOG_2PI)
    w = torch.cat([0.5 * inv_var, -means * inv_var, const[..., None]], dim=-1)
    return w, log_weights


def augment_features(x):
    """``[..., D] -> [..., 2D+1]`` quadratic-form augmentation."""
    ones = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([x * x, x, ones], dim=-1)


def augment_dtb(feats, out=None):
    """``[B, T, D]`` features -> ``[2D+1, T, B]`` augmented tensor
    (``[x^2, x, 1]`` along the leading axis), the layout the fused
    decode kernel streams.  With ``out`` (a contiguous ``[2D+1, T, B]``
    buffer whose last row already holds the ones) its first ``2D`` rows
    are written in place and ``out`` is returned."""
    b, t, d = feats.shape
    ft = feats.permute(2, 1, 0)
    if out is not None:
        torch.mul(ft, ft, out=out[:d])
        out[d:2 * d].copy_(ft)
        return out
    ones = torch.ones((1, t, b), dtype=feats.dtype, device=feats.device)
    return torch.cat([ft * ft, ft, ones], dim=0).contiguous()


def _mix_lse(per_mix, log_weights, dim):
    """``-logsumexp(log_w - per_mix)`` over the mixture axis, stable."""
    z = log_weights - per_mix
    zmax = z.amax(dim=dim, keepdim=True)
    return -(torch.log(torch.exp(z - zmax).sum(dim)) + zmax.squeeze(dim))


def gmm_neg_log_lik(x, w, log_weights, frame_mask=None):
    """``x [..., T, D]``, ``w [S, M, 2D+1]``, ``log_weights [S, M]`` ->
    ``[..., T, S]`` NLLs (one GEMM over every frame); frames where
    ``frame_mask [..., T]`` is False get 0."""
    s, m, a = w.shape
    per_mix = torch.matmul(augment_features(x), w.reshape(s * m, a).T)
    nll = _mix_lse(per_mix.reshape(*x.shape[:-1], s, m), log_weights, -1)
    if frame_mask is not None:
        nll = torch.where(frame_mask[..., None], nll, torch.zeros_like(nll))
    return nll


def gmm_neg_log_lik_ubt(feats, w, log_weights, n_frames, xa=None):
    """``feats [B, T, D]``, ``n_frames [B]`` -> ``[U, T, B]`` NLLs in the
    state-major layout; masked frames get 0.  ``xa``: ``augment_dtb(feats)``
    where the caller has it."""
    b, t, _ = feats.shape
    u, m, a = w.shape
    xa = (augment_dtb(feats) if xa is None else xa).reshape(a, t * b)
    pm = torch.matmul(w.reshape(u * m, a), xa).reshape(u, m, t, b)
    nll = _mix_lse(pm, log_weights[:, :, None, None], 1)
    mask = (torch.arange(t, device=feats.device)[:, None]
            < n_frames.to(feats.device)[None, :])
    return torch.where(mask[None], nll, torch.zeros_like(nll))


def mahalanobis(x, mu, var):
    """Diagonal-Gaussian NLL of ``x`` under ``(mu, var)``, broadcasting."""
    d = x.shape[-1]
    m = x - mu
    return 0.5 * (d * _LOG_2PI + torch.log(var).sum(-1)) + 0.5 * (m * m / var).sum(-1)


def pairwise_gaussian_nll(x, means, variances):
    """``x [..., T, D]``, ``means [K, D]``, ``variances [K, D]`` or ``[D]``
    -> ``[..., T, K]`` single-Gaussian NLLs through the emission GEMM."""
    variances = torch.broadcast_to(variances, means.shape)
    w, _ = gmm_emission_weights(means, torch.log(variances), means.new_zeros(means.shape[:-1]))
    return torch.matmul(augment_features(x), w.reshape(means.shape[0], -1).T)


def pairwise_sq_euclidean(x, y):
    """``x [T, D]``, ``y [K, D]`` -> ``[T, K]`` squared L2 (one GEMM plus
    norms, clamped at 0)."""
    xn = (x * x).sum(-1, keepdim=True)
    yn = (y * y).sum(-1)
    return torch.clamp(xn + yn[None, :] - 2.0 * torch.matmul(x, y.T), min=0.0)

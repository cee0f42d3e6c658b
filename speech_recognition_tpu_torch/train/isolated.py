"""Isolated-word model training: segmental K-means, binary mixture
splitting, k-means and EM.

Counterpart of ``speech_recognition_tpu/train/isolated.py``.  Per HMM
state: start from the state's mean, perturb the centroids by +-10%,
k-means to 2^i clusters, weight by cluster counts, optionally refine by
EM; ``log2(n_mix)`` splits (``HMMConfig.ref_compat_splits`` gives the
original system's ``int(ln(n_mix))``, whose untrained components keep
the split seed).  Every state trains on the same flattened ``[B*T, D]``
frame buffer with its own mask, and ``fit_gmm_states`` fits the states
as one batch: on CUDA tensors each split level is one launch of the
k-means kernel K24 and one of the EM kernel K25 for all of a word's
states, with no host read.  The transitions come from segmental K-means
and are not re-estimated.

The only random draws are k-means' initial assignments, taken from
``draw_assign(n, k)`` (``train.kmeans.random_assign`` by default), all
before the first launch, in the order of a state-by-state loop: state by
state, and split by split within a state.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from speech_recognition_tpu_torch.config import HMMConfig, TrainConfig
from speech_recognition_tpu_torch.models.hmm import GMMHMM, linear_init_cost
from speech_recognition_tpu_torch.ops.gmm import gmm_emission_weights, gmm_neg_log_lik
from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense
from speech_recognition_tpu_torch.train.em import em_fit_batch
from speech_recognition_tpu_torch.train.kmeans import kmeans_batch, random_assign
from speech_recognition_tpu_torch.train.skmeans import skmeans
from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

__all__ = ["fit_gmm_state", "fit_gmm_states", "fit_hmm", "align_states"]

DrawAssign = Callable[[int, int], torch.Tensor]


def align_states(model: GMMHMM, feats, n_frames):
    """Viterbi re-segmentation of ``feats [B, T, D]`` (``n_frames [B]``)
    against the trained states of one word model: the GMM emissions,
    K11 on CUDA tensors, the backtrace from the last state.  Returns
    ``[B, T]`` int32 states."""
    b, t, _ = feats.shape
    s = model.n_states
    dev = feats.device
    n_frames = n_frames.to(dev)
    w, lw = gmm_emission_weights(model.means, model.log_vars, model.log_weights)
    mask = torch.arange(t, device=dev)[None, :] < n_frames[:, None]
    nll = gmm_neg_log_lik(feats, w, lw, mask)
    init = torch.from_numpy(linear_init_cost(s)).to(dev)
    _, bp, eps_bp = viterbi_dense(nll, model.trans_cost, init, n_frames)
    end = torch.full((b,), s - 1, dtype=torch.int64, device=dev)
    return viterbi_backtrace(bp, eps_bp, end, n_frames)[0]


def fit_gmm_state(x, mask, mu0, n_mix: int, use_em: bool = True,
                  train_cfg: TrainConfig = TrainConfig(), hmm_cfg: HMMConfig = HMMConfig(),
                  draw_assign: Optional[DrawAssign] = None):
    """Binary mixture splitting over one state's frames: ``x [N, D]``,
    ``mask [N]`` this state's frames, ``mu0 [D]`` its single-Gaussian
    mean.  Returns ``(means [n_mix, D], variances [n_mix, D], weights
    [n_mix])``: ``fit_gmm_states`` of one fit."""
    out = fit_gmm_states(x, mask[None], mu0[None], n_mix, use_em=use_em, train_cfg=train_cfg,
                         hmm_cfg=hmm_cfg, draw_assign=draw_assign)
    return tuple(t[0] for t in out)


def _masked_var(x, mask, denom, var_floor):
    """The pooled variance of one fit's frames (the single-Gaussian ML
    fit), floored."""
    mu = torch.where(mask[:, None], x, 0.0).sum(0) / denom
    sq = torch.where(mask[:, None], (x - mu) ** 2, 0.0).sum(0)
    return torch.clamp(sq / denom, min=var_floor)


def fit_gmm_states(x, masks, mu0, n_mix: int, use_em: bool = True,
                   train_cfg: TrainConfig = TrainConfig(), hmm_cfg: HMMConfig = HMMConfig(),
                   draw_assign: Optional[DrawAssign] = None):
    """Binary mixture splitting over F states of one frame buffer: ``x [N,
    D]``, ``masks [F, N]`` each state's frames (no frame in two states,
    as one segmentation or alignment gives them), ``mu0 [F, D]`` their
    single-Gaussian means.  Each split level is one ``kmeans_batch`` and
    one ``em_fit_batch`` over the F fits (K24 and K25 on CUDA tensors).
    Returns ``(means [F, n_mix, D], variances [F, n_mix, D], weights [F,
    n_mix])``, each fit as the state-by-state splitting gives it."""
    if draw_assign is None:
        draw_assign = random_assign(torch.Generator().manual_seed(train_cfg.seed))
    n_splits = hmm_cfg.n_splits
    n_trained = 2 ** n_splits
    f, n = masks.shape
    dev = x.device
    # every draw first, in the state-by-state loop's order, copied to the
    # card once, from pinned memory and without a wait
    draws = [[draw_assign(n, 2 ** (i + 1)) for i in range(n_splits)] for _ in range(f)]
    init = None
    if n_splits:
        init = torch.stack([torch.stack(row) for row in draws], dim=1).to(torch.int64)
        if dev.type == "cuda" and init.device.type == "cpu":
            init = init.pin_memory().to(dev, non_blocking=True)
        init = init.to(dev)
    denom = torch.clamp(masks.to(x.dtype).sum(1), min=1.0)

    def masked_var():
        return torch.stack([_masked_var(x, masks[i], denom[i], hmm_cfg.var_floor)
                            for i in range(f)])

    em_kw = dict(max_iters=train_cfg.em_max_iters, rtol=train_cfg.rtol, atol=train_cfg.atol,
                 var_floor=hmm_cfg.var_floor, disjoint=True)
    centroids = mu0[:, None, :]
    weights = torch.ones((f, 1), dtype=x.dtype, device=dev)
    if n_splits == 0:
        # no split (n_mix 1, or the ref-compat count int(ln 2) = 0): the
        # single-Gaussian masked ML fit, optionally refined by EM
        variances = masked_var()[:, None, :]
        if use_em:
            centroids, variances, weights, _ = em_fit_batch(x, masks, centroids, variances,
                                                            weights, **em_kw)
    pert = train_cfg.split_perturbation
    for i in range(n_splits):
        k = 2 ** (i + 1)
        centroids = torch.cat([centroids * (1.0 - pert), centroids * (1.0 + pert)], dim=1)
        _, centroids, variances, counts = kmeans_batch(
            x, masks, centroids, k, init[i], max_iters=train_cfg.kmeans_max_iters,
            disjoint=True)
        weights = counts / denom[:, None]
        if use_em:
            centroids, variances, weights, _ = em_fit_batch(x, masks, centroids, variances,
                                                            weights, **em_kw)

    if n_trained < n_mix:
        # ref-compat split count: the untrained components keep the split
        # seed with the pooled variance and weight 1/N
        extra = n_mix - n_trained
        centroids = torch.cat([centroids, mu0[:, None, :].expand(-1, extra, -1)], dim=1)
        variances = torch.cat([variances, masked_var()[:, None, :].expand(-1, extra, -1)],
                              dim=1)
        weights = torch.cat([weights, (1.0 / denom)[:, None].expand(-1, extra)], dim=1)
    return centroids, variances, weights


def fit_hmm(templates: List, use_em: bool = True, train_cfg: TrainConfig = TrainConfig(),
            hmm_cfg: HMMConfig = HMMConfig(), pad_to: int = None,
            draw_assign: Optional[DrawAssign] = None) -> GMMHMM:
    """Train one word model from its ``[T_i, D]`` templates (tensors on
    the device to train on): segmental K-means, then the states'
    mixtures as one batch (``fit_gmm_states``)."""
    if draw_assign is None:
        draw_assign = random_assign(torch.Generator().manual_seed(train_cfg.seed))
    s = hmm_cfg.n_states
    means0, _, trans, states, (x, n_frames) = skmeans(
        templates, s, max_iters=train_cfg.skmeans_max_iters, rtol=train_cfg.rtol,
        atol=train_cfg.atol, pad_to=pad_to)
    b, tmax, d = x.shape
    dev = x.device
    flat_x = x.reshape(b * tmax, d)
    frame_mask = (torch.arange(tmax, device=dev)[None, :] < n_frames[:, None]).reshape(-1)
    flat_states = states.reshape(-1)
    masks = (flat_states[None, :] == torch.arange(s, device=dev)[:, None]) & frame_mask
    means, variances, weights = fit_gmm_states(flat_x, masks, means0, hmm_cfg.n_mix,
                                               use_em=use_em, train_cfg=train_cfg,
                                               hmm_cfg=hmm_cfg, draw_assign=draw_assign)
    variances = torch.clamp(variances, min=hmm_cfg.var_floor)
    weights = torch.clamp(weights, min=1e-10)
    return GMMHMM(means, torch.log(variances),
                  torch.log(weights / weights.sum(1, keepdim=True)),
                  torch.from_numpy(to_cost_matrix(trans)).to(dev))

"""Forced alignment against per-utterance transcript graphs, and
embedded Viterbi re-estimation.

Counterpart of ``speech_recognition_tpu/train/continuous.py``.
``align_batch`` aligns every utterance in one batched decode: one
emission GEMM against the bank, gathered to each utterance's padded
graph states (``models.graph.pad_graphs``), then kernel K11 with
per-utterance matrices (the ``per_utterance_graph`` mode of the TPU
kernel) and ``ops.viterbi.viterbi_backtrace``.  CPU tensors run K11's
plain version.

``continuous_train`` is the from-scratch form: each iteration composes
one linear word graph per utterance, aligns them all, refits every
state that got frames by mixture splitting (``train.isolated.
fit_gmm_states``, all of them as one batch: on CUDA tensors one launch
of K24 and one of K25 a split level) and re-estimates the self and exit
costs from ``p_jump = runs / frames``; it stops when every GMM passes
``allclose`` (transitions excluded).  ``train.embedded_step`` is the
one-step form the ``continuous_train --algo hard`` command runs.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from speech_recognition_tpu_torch.config import HMMConfig, TrainConfig
from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll
from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["align_batch", "harvest_state_ids", "continuous_train"]


def align_batch(bank: HMMBank, feats, n_frames, trans, eps_trans, init_cost, end_states,
                bank_state, eps_depth: int = 1, nll=None):
    """Forced alignment of ``feats [B, T, D]`` against per-utterance
    graphs: ``trans`` / ``eps_trans [B, S, S]``, ``init_cost [B, S]``,
    ``end_states [B, E]``, ``bank_state [B, S]`` (tensors on the device of
    ``feats``).  ``nll [B, T, N*S]``: the bank's emissions where the
    caller has them (a rank that holds a slice of the bank gathers
    them), else ``bank_nll`` of ``bank``.

    Returns ``(ids [B, T], costs [B])``: ids index the flat (model, state)
    bank, -1 on padded frames; costs are the best end state's."""
    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    b, t, _ = feats.shape
    n_frames = n_frames.to(dev)
    mask = torch.arange(t, device=dev)[None, :] < n_frames[:, None]
    bank_state = bank_state.to(dev, torch.int64)
    s = bank_state.shape[1]
    if nll is None:
        nll = bank_nll(bank, feats, mask)
    nll = nll.gather(2, bank_state[:, None, :].expand(b, t, s))
    final, bp, eps_bp = viterbi_dense(nll.contiguous(), trans, init_cost, n_frames,
                                      eps_trans=eps_trans, eps_depth=eps_depth)
    end_states = end_states.to(dev, torch.int64)
    end_costs = final.gather(1, end_states)
    best = torch.argmin(end_costs, dim=1, keepdim=True)
    states, _ = viterbi_backtrace(bp, eps_bp, end_states.gather(1, best)[:, 0], n_frames,
                                  eps_depth=eps_depth)
    ids = torch.where(mask, bank_state.gather(1, states.to(torch.int64)), -1).to(torch.int32)
    return ids, end_costs.gather(1, best)[:, 0]


def harvest_state_ids(ids: np.ndarray):
    """Per-global-state frame counts and run (occurrence) counts of
    ``ids [B, T]`` (-1 padding), as numpy ``(frame_counts, run_counts)``
    of length ``max(ids) + 1``."""
    valid = ids >= 0
    changed = np.ones_like(ids, dtype=bool)
    changed[:, 1:] = ids[:, 1:] != ids[:, :-1]
    starts = valid & changed
    ns = int(ids.max()) + 1 if np.any(valid) else 0
    frame_counts = np.bincount(ids[valid].ravel(), minlength=ns)
    run_counts = np.bincount(ids[starts].ravel(), minlength=ns)
    return frame_counts, run_counts


def _graphs_for_labels(bank_np_trans, label_seqs):
    from speech_recognition_tpu_torch.models.graph import build_word_graph

    return [build_word_graph(bank_np_trans, [[lab] for lab in labels]) for labels in label_seqs]


def continuous_train(bank: HMMBank, feats, n_frames, label_seqs: List[List[int]],
                     hmm_cfg: HMMConfig = HMMConfig(), train_cfg: TrainConfig = TrainConfig(),
                     use_em: bool = True,
                     checkpoint_cb: Optional[Callable[[int, HMMBank], None]] = None,
                     verbose: bool = False, draw_assign=None) -> HMMBank:
    """Embedded Viterbi re-estimation from ``bank`` (isolated training's)
    on ``feats [B, T, D]`` (``n_frames [B]``, on the bank's device) with
    the transcripts ``label_seqs``.  ``checkpoint_cb(iteration, bank)``
    runs after every iteration; ``draw_assign`` gives k-means' initial
    assignments (default: ``random_assign`` seeded ``train_cfg.seed``).
    Returns the trained bank."""
    from speech_recognition_tpu_torch.models.graph import pad_graphs
    from speech_recognition_tpu_torch.train.isolated import fit_gmm_states
    from speech_recognition_tpu_torch.train.kmeans import random_assign

    if draw_assign is None:
        draw_assign = random_assign(torch.Generator().manual_seed(train_cfg.seed))
    dev = feats.device
    feats = feats.to(torch.float32)
    n_frames = n_frames.to(dev, torch.int32)
    b, t, d = feats.shape
    n_models, s = bank.n_models, bank.n_states
    ns = n_models * s
    flat_x = feats.reshape(b * t, d)

    for it in range(train_cfg.continuous_max_iters):
        # 1. per-utterance linear graphs with the current transitions
        trans_np = [bank.trans_cost[i].cpu().numpy() for i in range(n_models)]
        gb, eps_depth = pad_graphs(_graphs_for_labels(trans_np, label_seqs))
        # 2. batched forced alignment
        ids, costs = align_batch(bank, feats, n_frames,
                                 *(torch.as_tensor(gb[k], device=dev) for k in (
                                     "trans", "eps_trans", "init_cost", "end_states",
                                     "bank_state")), eps_depth=eps_depth)
        ids_np = ids.cpu().numpy()
        # 3. refit every state on its frames
        flat_ids = ids.reshape(-1)
        new_means = bank.means.clone()
        new_vars = torch.exp(bank.log_vars)
        new_w = torch.exp(bank.log_weights)
        frame_counts, run_counts = harvest_state_ids(ids_np)
        frame_counts = np.pad(frame_counts, (0, ns - len(frame_counts)))
        run_counts = np.pad(run_counts, (0, ns - len(run_counts)))
        # the states with frames, in order, as one batch (a state with no
        # frames keeps its GMM)
        fit = np.flatnonzero(frame_counts)
        if len(fit):
            gs_t = torch.as_tensor(fit, device=dev)
            masks = flat_ids[None, :] == gs_t[:, None]
            mu0 = torch.stack([torch.where(masks[i][:, None], flat_x, 0.0).sum(0)
                               / float(frame_counts[gs]) for i, gs in enumerate(fit)])
            m, v, w = fit_gmm_states(flat_x, masks, mu0, hmm_cfg.n_mix, use_em=use_em,
                                     train_cfg=train_cfg, hmm_cfg=hmm_cfg,
                                     draw_assign=draw_assign)
            new_means.view(ns, *new_means.shape[2:])[gs_t] = m
            new_vars.view(ns, *new_vars.shape[2:])[gs_t] = v
            new_w.view(ns, -1)[gs_t] = w / torch.clamp(w.sum(1, keepdim=True), min=1e-10)
        # 4. transitions: exit -log(p_jump), self -log(1 - p_jump)
        new_trans = bank.trans_cost.cpu().numpy().copy()
        with np.errstate(divide="ignore"):
            for gs in np.flatnonzero(frame_counts):
                mi, si = divmod(int(gs), s)
                p_jump = run_counts[gs] / frame_counts[gs]
                if si < s - 1:
                    new_trans[mi, si + 1, si] = -np.log(p_jump) if p_jump > 0 else POS_INF
                new_trans[mi, si, si] = -np.log(1.0 - p_jump) if p_jump < 1.0 else POS_INF
        new_bank = HMMBank(new_means, torch.log(torch.clamp(new_vars, min=hmm_cfg.var_floor)),
                           torch.log(torch.clamp(new_w, min=1e-10)),
                           torch.from_numpy(np.minimum(new_trans, POS_INF)).to(dev))
        if checkpoint_cb is not None:
            checkpoint_cb(it, new_bank)
        tol = dict(rtol=train_cfg.rtol, atol=train_cfg.atol)
        converged = (torch.allclose(new_means, bank.means, **tol)
                     and torch.allclose(new_vars, torch.exp(bank.log_vars), **tol)
                     and torch.allclose(new_w, torch.exp(bank.log_weights), **tol))
        bank = new_bank
        if verbose:
            print(f"continuous iteration {it}: mean align cost {float(costs.mean()):.2f}")
        if converged:
            break
    return bank

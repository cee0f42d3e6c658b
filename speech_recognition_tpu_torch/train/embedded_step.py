"""One embedded-training (Viterbi-EM) step.

Counterpart of ``speech_recognition_tpu/train/embedded_step.py``
``embedded_step`` (the hard form; ``embedded_step_soft`` is not ported
yet, ROADMAP queue A item 3).  One iteration:

  1. batched forced alignment against per-utterance transcript graphs
     (``train.continuous.align_batch``: one bank emission GEMM, kernel
     K11 with per-utterance matrices on CUDA tensors, the backtrace),
  2. mixture responsibilities within each frame's aligned state,
  3. the sufficient statistics as two weighted GEMMs ``W[C, NS*M].T @
     x`` accumulated over frame chunks of ``frame_chunk`` frames (plain
     sums over frames: no scatter, so CUDA runs sum in a fixed order),
  4. the M-step and the transition re-estimation ``p_jump = runs /
     frames`` over every state at once.

States with no aligned frames keep their previous parameters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
from speech_recognition_tpu_torch.models.hmm import HMMBank
from speech_recognition_tpu_torch.ops.gmm import augment_features, gmm_emission_weights
from speech_recognition_tpu_torch.train.continuous import align_batch
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["embedded_step", "EmbeddedStats", "compose_graphs"]

GRAPH_KEYS = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")


def compose_graphs(bank: HMMBank, label_seqs: List[List[int]], sil: Optional[int] = None):
    """The graph batch of :func:`embedded_step`: one transcript graph per
    label sequence over the bank's transition costs (optional ``sil``
    arcs between words), padded by ``models.graph.pad_graphs`` and moved
    to the bank's device.  Returns ``(graph_batch, eps_depth)``."""
    trans_np = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    gb, eps_depth = pad_graphs([transcript_graph(trans_np, ls, sil=sil) for ls in label_seqs])
    dev = bank.means.device
    return {k: torch.as_tensor(gb[k], device=dev) for k in GRAPH_KEYS}, eps_depth


class EmbeddedStats(NamedTuple):
    r_sum: torch.Tensor  # [NS, M] responsibility mass
    rx: torch.Tensor  # [NS, M, D]
    rxx: torch.Tensor  # [NS, M, D]
    frame_counts: torch.Tensor  # [NS]
    run_counts: torch.Tensor  # [NS]
    total_cost: torch.Tensor  # [] sum of alignment costs


def embedded_step(bank: HMMBank, feats, n_frames, graph_batch, eps_depth: int = 1,
                  var_floor: float = 1e-2, lr: float = 1.0, frame_chunk: int = 65536):
    """One Viterbi-EM iteration over ``feats [B, T, D]`` (``n_frames
    [B]``) and ``graph_batch``, the ``models.graph.pad_graphs`` arrays
    ``trans / eps_trans / init_cost / end_states / bank_state`` as
    tensors on the device of ``feats``.  ``lr`` interpolates toward the
    re-estimated parameters (1 replaces them).

    Returns ``(new_bank, EmbeddedStats)``."""
    b, t, d = feats.shape
    n, s, m = bank.n_models, bank.n_states, bank.n_mix
    ns = n * s
    dev = feats.device
    ids, costs = align_batch(bank, feats, n_frames, *(graph_batch[k] for k in GRAPH_KEYS),
                             eps_depth=eps_depth)
    ids = ids.to(torch.int64)
    # run starts (the per-state segment counts) before flattening
    prev = torch.cat([torch.full((b, 1), -2, dtype=ids.dtype, device=dev), ids[:, :-1]], 1)
    starts = (ids >= 0) & (ids != prev)
    frame_counts, run_counts, r_sum, rx, rxx = embedded_stats(
        bank, ids.reshape(b * t), feats.reshape(b * t, d), starts.reshape(b * t), frame_chunk)
    new_bank = embedded_update(bank, frame_counts, run_counts, r_sum, rx, rxx, var_floor, lr)
    return new_bank, EmbeddedStats(r_sum.reshape(ns, m), rx.reshape(ns, m, d),
                                   rxx.reshape(ns, m, d), frame_counts, run_counts,
                                   costs.sum())


def embedded_stats(bank: HMMBank, ids, x, starts, frame_chunk: int):
    """``(frame_counts [NS], run_counts [NS], r_sum [NS*M], rx [NS*M, D],
    rxx [NS*M, D])`` of the aligned frames ``x [BT, D]`` with global
    state ``ids [BT]`` (-1 padding) and run ``starts [BT]``."""
    n, s, m = bank.n_models, bank.n_states, bank.n_mix
    ns = n * s
    bt, d = x.shape
    dev = x.device
    w, lw = gmm_emission_weights(*bank.flat_states())
    w_flat_t = w.reshape(ns * m, -1).T
    iota = torch.arange(ns, device=dev)
    frame_counts = torch.zeros((ns,), dtype=x.dtype, device=dev)
    run_counts = torch.zeros_like(frame_counts)
    r_sum = torch.zeros((ns * m,), dtype=x.dtype, device=dev)
    rx = torch.zeros((ns * m, d), dtype=x.dtype, device=dev)
    rxx = torch.zeros_like(rx)
    c = max(min(frame_chunk, bt), 1)
    for lo in range(0, bt, c):
        ids_c, x_c, starts_c = ids[lo:lo + c], x[lo:lo + c], starts[lo:lo + c]
        valid = ids_c >= 0
        onehot = ((ids_c[:, None] == iota[None, :]) & valid[:, None]).to(x.dtype)
        frame_counts += onehot.sum(0)
        run_counts += (onehot * starts_c[:, None].to(x.dtype)).sum(0)
        # mixture responsibilities within the frame's aligned state
        own_ids = torch.clamp(ids_c, min=0)
        per_mix = (augment_features(x_c) @ w_flat_t).reshape(-1, ns, m)
        own = per_mix.gather(1, own_ids[:, None, None].expand(-1, 1, m))[:, 0, :]
        lp = lw[own_ids] - own
        resp = torch.exp(lp - lp.amax(-1, keepdim=True))
        resp = resp / resp.sum(-1, keepdim=True)
        resp = torch.where(valid[:, None], resp, 0.0)
        # the weighted one-hot [C, NS*M] -> statistics by two GEMMs
        wts = (onehot[:, :, None] * resp[:, None, :]).reshape(-1, ns * m)
        r_sum += wts.sum(0)
        rx += wts.T @ x_c
        rxx += wts.T @ (x_c * x_c)
    return frame_counts, run_counts, r_sum, rx, rxx


def embedded_update(bank: HMMBank, frame_counts, run_counts, r_sum, rx, rxx,
                    var_floor: float, lr: float = 1.0) -> HMMBank:
    """The M-step and the transition re-estimation from the statistics
    of ``embedded_stats``; states with no frames keep their parameters."""
    n, s, m, d = bank.means.shape
    ns = n * s
    r_sum, rx, rxx = r_sum.reshape(ns, m), rx.reshape(ns, m, d), rxx.reshape(ns, m, d)
    denom = torch.clamp(r_sum, min=1e-6)[..., None]
    new_means = rx / denom
    new_vars = torch.clamp(rxx / denom - new_means * new_means, min=var_floor)
    new_w = r_sum / torch.clamp(frame_counts.reshape(ns, 1), min=1e-6)
    new_w = torch.clamp(new_w, min=1e-8)
    new_w = new_w / new_w.sum(-1, keepdim=True)

    has_data = (frame_counts > 0).reshape(n, s)
    hd = has_data[..., None, None]
    means = torch.where(hd, new_means.reshape(n, s, m, d), bank.means)
    log_vars = torch.where(hd, torch.log(new_vars).reshape(n, s, m, d), bank.log_vars)
    log_w = torch.where(hd[..., 0], torch.log(new_w).reshape(n, s, m), bank.log_weights)
    if lr != 1.0:
        means = bank.means + lr * (means - bank.means)
        log_vars = bank.log_vars + lr * (log_vars - bank.log_vars)
        log_w = bank.log_weights + lr * (log_w - bank.log_weights)

    # p_jump = runs / frames per (model, state): exit -log p, self -log(1 - p)
    p_jump = (run_counts / torch.clamp(frame_counts, min=1.0)).reshape(n, s)
    exit_cost = torch.where(p_jump > 0, -torch.log(torch.clamp(p_jump, min=1e-30)), POS_INF)
    self_cost = torch.where(p_jump < 1, -torch.log(torch.clamp(1 - p_jump, min=1e-30)),
                            POS_INF)
    dev = bank.means.device
    eye = torch.eye(s, dtype=torch.bool, device=dev)
    sub = torch.diag(torch.ones(s - 1, device=dev), -1).bool()  # [i+1, i]: edge i -> i+1
    hd_t = has_data.reshape(n, 1, s)  # keyed by the origin state
    trans = torch.where(eye[None] & hd_t, self_cost[:, None, :], bank.trans_cost)
    trans = torch.where(sub[None] & hd_t, exit_cost[:, None, :], trans)
    return HMMBank(means, log_vars, log_w, torch.clamp(trans, max=POS_INF))

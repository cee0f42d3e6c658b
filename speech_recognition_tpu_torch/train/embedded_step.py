"""One embedded-training step: Viterbi-EM (``embedded_step``) or
Baum-Welch (``embedded_step_soft``).

Counterpart of ``speech_recognition_tpu/train/embedded_step.py``.  One
hard iteration:

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

One soft iteration: the same bank emission GEMM gathered to graph
states, the log-space forward-backward (``ops.forward_backward``: kernel
K16 on the dense dict of ``compose_graphs(..., end_scores=True)``, K15 on
the banded dict of ``models.graph.pad_graphs_banded``), the graph
posteriors mapped onto bank states by a one-hot GEMM, gamma-weighted
mixture responsibilities of every state in frame chunks, and the M-step
with soft EM's own two rules: a state keeps its parameters unless its
occupancy passes 1e-3, and ``p_stay = self / (self + exit)`` from the
expected self and step counts.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll
from speech_recognition_tpu_torch.ops.forward_backward import (
    forward_backward,
    forward_backward_banded,
)
from speech_recognition_tpu_torch.ops.gmm import augment_features, gmm_emission_weights
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.train.continuous import align_batch
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["embedded_step", "embedded_step_soft", "EmbeddedStats", "compose_graphs",
           "embedded_shard_stats", "soft_shard_stats"]

GRAPH_KEYS = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")
BANDED_KEYS = ("band", "init_cost", "eps_block", "word_starts", "word_ends", "start_pos",
               "is_start", "end_scores", "bank_state")


def compose_graphs(bank: HMMBank, label_seqs: List[List[int]], sil: Optional[int] = None,
                   end_scores: bool = False):
    """The graph batch of :func:`embedded_step`: one transcript graph per
    label sequence over the bank's transition costs (optional ``sil``
    arcs between words), padded by ``models.graph.pad_graphs`` and moved
    to the bank's device; with ``end_scores`` also the terminal scores
    :func:`embedded_step_soft` needs.  Returns ``(graph_batch,
    eps_depth)``."""
    trans_np = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    gb, eps_depth = pad_graphs([transcript_graph(trans_np, ls, sil=sil) for ls in label_seqs])
    dev = bank.means.device
    keys = GRAPH_KEYS + (("end_scores",) if end_scores else ())
    return {k: torch.as_tensor(gb[k], device=dev) for k in keys}, eps_depth


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
    d = feats.shape[2]
    ns, m = bank.n_models * bank.n_states, bank.n_mix
    frame_counts, run_counts, r_sum, rx, rxx, total_cost = embedded_shard_stats(
        bank, feats, n_frames, graph_batch, eps_depth, frame_chunk)
    new_bank = embedded_update(bank, frame_counts, run_counts, r_sum, rx, rxx, var_floor, lr)
    return new_bank, EmbeddedStats(r_sum.reshape(ns, m), rx.reshape(ns, m, d),
                                   rxx.reshape(ns, m, d), frame_counts, run_counts,
                                   total_cost)


def _local_ids(ids, first_state: int, n_local: int):
    """Global state ids -> indices into a bank slice whose first state is
    ``first_state`` (``n_local`` states), -1 outside it."""
    loc = ids - first_state
    return torch.where((ids >= 0) & (loc >= 0) & (loc < n_local), loc, -1)


def embedded_shard_stats(bank: HMMBank, feats, n_frames, graph_batch, eps_depth: int = 1,
                         frame_chunk: int = 65536, nll=None, first_state: int = 0):
    """The half of :func:`embedded_step` that one shard computes before
    the statistics are summed over shards: this batch's alignment and the
    statistics of ``bank``'s states.  Returns ``(frame_counts [NS],
    run_counts [NS], r_sum [NS*M], rx [NS*M, D], rxx [NS*M, D],
    total_cost)``.

    A rank that holds a slice of the bank passes ``nll [B, T, N*S]``, the
    whole bank's emissions (its own columns gathered with the others'),
    for the alignment, and ``first_state``, the flat index of its slice's
    first state: it then counts the frames aligned to its own states."""
    b, t, d = feats.shape
    dev = feats.device
    ids, costs = align_batch(bank, feats, n_frames, *(graph_batch[k] for k in GRAPH_KEYS),
                             eps_depth=eps_depth, nll=nll)
    ids = ids.to(torch.int64)
    # run starts (the per-state segment counts) before flattening
    prev = torch.cat([torch.full((b, 1), -2, dtype=ids.dtype, device=dev), ids[:, :-1]], 1)
    starts = (ids >= 0) & (ids != prev)
    ids = _local_ids(ids, first_state, bank.n_models * bank.n_states)
    stats = embedded_stats(bank, ids.reshape(b * t), feats.reshape(b * t, d),
                           starts.reshape(b * t), frame_chunk)
    return (*stats, costs.sum())


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


def _mixture_update(bank: HMMBank, frame_counts, r_sum, rx, rxx, var_floor: float, has_data):
    """The mixture M-step of both steps: ``(means, log_vars, log_weights)``
    re-estimated where ``has_data [N, S]``, the bank's elsewhere."""
    n, s, m, d = bank.means.shape
    ns = n * s
    r_sum, rx, rxx = r_sum.reshape(ns, m), rx.reshape(ns, m, d), rxx.reshape(ns, m, d)
    denom = torch.clamp(r_sum, min=1e-6)[..., None]
    new_means = rx / denom
    new_vars = torch.clamp(rxx / denom - new_means * new_means, min=var_floor)
    new_w = r_sum / torch.clamp(frame_counts.reshape(ns, 1), min=1e-6)
    new_w = torch.clamp(new_w, min=1e-8)
    new_w = new_w / new_w.sum(-1, keepdim=True)
    hd = has_data[..., None, None]
    return (torch.where(hd, new_means.reshape(n, s, m, d), bank.means),
            torch.where(hd, torch.log(new_vars).reshape(n, s, m, d), bank.log_vars),
            torch.where(hd[..., 0], torch.log(new_w).reshape(n, s, m), bank.log_weights))


def _self_exit_trans(bank: HMMBank, has_data, self_cost, exit_cost):
    """The bank's transition costs with each state that ``has_data``
    given ``self_cost`` on its self loop and ``exit_cost`` on its step
    (``[N, S]`` each, keyed by the origin state)."""
    n, s = has_data.shape
    dev = bank.means.device
    eye = torch.eye(s, dtype=torch.bool, device=dev)
    sub = torch.diag(torch.ones(s - 1, device=dev), -1).bool()  # [i+1, i]: edge i -> i+1
    hd_t = has_data.reshape(n, 1, s)
    trans = torch.where(eye[None] & hd_t, self_cost[:, None, :], bank.trans_cost)
    trans = torch.where(sub[None] & hd_t, exit_cost[:, None, :], trans)
    return torch.clamp(trans, max=POS_INF)


def _neg_log(p):
    """-log p where p > 0, POS_INF where p is 0."""
    return torch.where(p > 0, -torch.log(torch.clamp(p, min=1e-30)), POS_INF)


def embedded_update(bank: HMMBank, frame_counts, run_counts, r_sum, rx, rxx,
                    var_floor: float, lr: float = 1.0) -> HMMBank:
    """The M-step and the transition re-estimation from the statistics
    of ``embedded_stats``; states with no frames keep their parameters."""
    n, s = bank.n_models, bank.n_states
    has_data = (frame_counts > 0).reshape(n, s)
    means, log_vars, log_w = _mixture_update(bank, frame_counts, r_sum, rx, rxx, var_floor,
                                             has_data)
    if lr != 1.0:
        means = bank.means + lr * (means - bank.means)
        log_vars = bank.log_vars + lr * (log_vars - bank.log_vars)
        log_w = bank.log_weights + lr * (log_w - bank.log_weights)
    # p_jump = runs / frames per (model, state): exit -log p, self -log(1 - p)
    p_jump = (run_counts / torch.clamp(frame_counts, min=1.0)).reshape(n, s)
    self_cost = torch.where(p_jump < 1, -torch.log(torch.clamp(1 - p_jump, min=1e-30)),
                            POS_INF)
    return HMMBank(means, log_vars, log_w,
                   _self_exit_trans(bank, has_data, self_cost, _neg_log(p_jump)))


def soft_stats(bank: HMMBank, feats, gamma, xi_band, bank_state, frame_chunk: int):
    """Soft EM's statistics: graph posteriors ``gamma [B, T, Sg]`` and the
    self / step counts ``xi_band [B, 3, Sg]`` mapped onto the bank's
    states by a one-hot GEMM over ``bank_state [B, Sg]``, then
    gamma-weighted mixture responsibilities of every state over frame
    chunks of ``frame_chunk`` frames.  Returns ``(frame_counts [NS],
    self_counts [NS], exit_counts [NS], r_sum [NS*M], rx [NS*M, D], rxx
    [NS*M, D])``; plain sums and GEMMs, no scatter."""
    b, t, d = feats.shape
    ns, m = bank.n_models * bank.n_states, bank.n_mix
    onehot = (bank_state.to(torch.int64)[:, :, None]
              == torch.arange(ns, device=feats.device)).to(feats.dtype)  # [B, Sg, NS]
    gamma_bank = torch.bmm(gamma, onehot).reshape(b * t, ns)
    self_counts = torch.bmm(xi_band[:, 0:1], onehot)[:, 0].sum(0)
    exit_counts = torch.bmm(xi_band[:, 1:2], onehot)[:, 0].sum(0)
    frame_counts = gamma_bank.sum(0)
    w, lw = gmm_emission_weights(*bank.flat_states())
    w_flat_t = w.reshape(ns * m, -1).T
    x = feats.reshape(b * t, d)
    r_sum = torch.zeros((ns * m,), dtype=x.dtype, device=x.device)
    rx = torch.zeros((ns * m, d), dtype=x.dtype, device=x.device)
    rxx = torch.zeros_like(rx)
    c = max(min(frame_chunk, b * t), 1)
    for lo in range(0, b * t, c):
        x_c, g_c = x[lo:lo + c], gamma_bank[lo:lo + c]
        lp = lw[None] - (augment_features(x_c) @ w_flat_t).reshape(-1, ns, m)
        resp = torch.exp(lp - lp.amax(-1, keepdim=True))
        resp = resp / torch.clamp(resp.sum(-1, keepdim=True), min=1e-30)
        wts = (g_c[:, :, None] * resp).reshape(-1, ns * m)
        r_sum += wts.sum(0)
        rx += wts.T @ x_c
        rxx += wts.T @ (x_c * x_c)
    return frame_counts, self_counts, exit_counts, r_sum, rx, rxx


def soft_update(bank: HMMBank, frame_counts, self_counts, exit_counts, r_sum, rx, rxx,
                var_floor: float) -> HMMBank:
    """Soft EM's M-step: the mixture update where the occupancy passes
    1e-3, and the Baum-Welch self / step costs from the expected counts."""
    n, s = bank.n_models, bank.n_states
    has_data = (frame_counts > 1e-3).reshape(n, s)
    means, log_vars, log_w = _mixture_update(bank, frame_counts, r_sum, rx, rxx, var_floor,
                                             has_data)
    denom = torch.clamp(self_counts + exit_counts, min=1e-6)
    p_stay = (self_counts / denom).reshape(n, s)
    p_jump = (exit_counts / denom).reshape(n, s)
    return HMMBank(means, log_vars, log_w,
                   _self_exit_trans(bank, has_data, _neg_log(p_stay), _neg_log(p_jump)))


def embedded_step_soft(bank: HMMBank, feats, n_frames, graph_batch, eps_depth: int = 1,
                       var_floor: float = 1e-2, frame_chunk: int = 65536):
    """One Baum-Welch iteration over ``feats [B, T, D]`` (``n_frames
    [B]``): state occupancy is the forward-backward posterior instead of
    the Viterbi one-hot.  ``graph_batch`` is the dense dict of
    ``compose_graphs(..., end_scores=True)`` (``trans / eps_trans /
    init_cost / end_scores / bank_state``: kernel K16) or the banded dict
    of ``models.graph.pad_graphs_banded`` (detected by its ``band`` key:
    kernel K15), as tensors on the device of ``feats``.

    Returns ``(new_bank, EmbeddedStats)`` with ``run_counts`` the expected
    step counts and ``total_cost`` ``-sum log Z``."""
    d = feats.shape[2]
    ns, m = bank.n_models * bank.n_states, bank.n_mix
    frame_counts, self_counts, exit_counts, r_sum, rx, rxx, total_cost = soft_shard_stats(
        bank, feats, n_frames, graph_batch, eps_depth, frame_chunk)
    new_bank = soft_update(bank, frame_counts, self_counts, exit_counts, r_sum, rx, rxx,
                           var_floor)
    return new_bank, EmbeddedStats(r_sum.reshape(ns, m), rx.reshape(ns, m, d),
                                   rxx.reshape(ns, m, d), frame_counts, exit_counts,
                                   total_cost)


def soft_shard_stats(bank: HMMBank, feats, n_frames, graph_batch, eps_depth: int = 1,
                     frame_chunk: int = 65536, nll=None, first_state: int = 0):
    """The half of :func:`embedded_step_soft` that one shard computes
    before the statistics are summed over shards: the forward-backward
    of this batch and the statistics of ``bank``'s states.  Returns
    ``(frame_counts [NS], self_counts [NS], exit_counts [NS], r_sum
    [NS*M], rx [NS*M, D], rxx [NS*M, D], total_cost)``; ``nll`` and
    ``first_state`` as for :func:`embedded_shard_stats`."""
    b, t, d = feats.shape
    dev = feats.device
    n_frames = n_frames.to(dev)
    bstate = graph_batch["bank_state"].to(dev, torch.int64)
    sg = bstate.shape[1]
    mask = torch.arange(t, device=dev)[None, :] < n_frames[:, None]
    if nll is None:
        nll = bank_nll(bank, feats, mask)
    nll = nll.gather(2, bstate[:, None, :].expand(b, t, sg)).contiguous()
    g = graph_batch
    if "band" in g:
        bg = BandedGraph(band=g["band"], init_cost=g["init_cost"], word_starts=g["word_starts"],
                         word_ends=g["word_ends"], eps_block=g["eps_block"],
                         start_pos=g["start_pos"], is_start=g["is_start"], end_states=None,
                         end_bonus=None, bank_state=bstate)
        res = forward_backward_banded(nll, bg, n_frames, eps_depth, g["end_scores"])
    else:
        res = forward_backward(nll, g["trans"], g["init_cost"], n_frames, g["eps_trans"],
                               eps_depth, g["end_scores"], xi_mode="band")
    stats = soft_stats(bank, feats, res.gamma, res.xi_sum, bstate - first_state, frame_chunk)
    return (*stats, -res.log_z.sum())

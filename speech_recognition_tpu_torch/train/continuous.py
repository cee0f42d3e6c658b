"""Forced alignment against per-utterance transcript graphs.

Counterpart of the alignment half of
``speech_recognition_tpu/train/continuous.py``: ``align_batch`` and
``harvest_state_ids``.  Every utterance aligns in one batched decode:
one emission GEMM against the bank, gathered to each utterance's padded
graph states (``models.graph.pad_graphs``), then kernel K11 with
per-utterance matrices (the ``per_utterance_graph`` mode of the TPU
kernel) and ``ops.viterbi.viterbi_backtrace``.  CPU tensors run K11's
plain version.

``continuous_train`` (embedded Viterbi re-estimation) waits for the
training slice, ROADMAP queue A item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll
from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense

__all__ = ["align_batch", "harvest_state_ids"]


def align_batch(bank: HMMBank, feats, n_frames, trans, eps_trans, init_cost, end_states,
                bank_state, eps_depth: int = 1):
    """Forced alignment of ``feats [B, T, D]`` against per-utterance
    graphs: ``trans`` / ``eps_trans [B, S, S]``, ``init_cost [B, S]``,
    ``end_states [B, E]``, ``bank_state [B, S]`` (tensors on the device of
    ``feats``).

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
    nll = bank_nll(bank, feats, mask).gather(2, bank_state[:, None, :].expand(b, t, s))
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

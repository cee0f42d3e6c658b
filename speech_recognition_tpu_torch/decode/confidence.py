"""Word-level confidence from forward-backward posteriors.

Counterpart of ``speech_recognition_tpu/decode/confidence.py``.  The
banded forward-backward (``ops.forward_backward.forward_backward_banded``,
kernel K15 on CUDA tensors) gives per-frame state posteriors over the
decoding graph; a decoded word's confidence is the mean posterior of the
Viterbi path's states over the word's frames (the frame-posterior
confidence measure).  Well-separated decodes score near 1; competing
hypotheses pull the posterior mass apart.

``path_posteriors`` runs on the device of the features; the per-word
averaging (``word_confidence``) is host numpy over one ``[B, T]`` fetch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll
from speech_recognition_tpu_torch.ops.forward_backward import forward_backward_banded
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph

__all__ = ["path_posteriors", "word_confidence"]


def path_posteriors(bank: HMMBank, g: BandedGraph, feats, n_frames, states,
                    eps_depth: int = 1):
    """Per-frame posterior of the decoded state path: ``feats [B, T, D]``,
    ``n_frames [B]``, ``states [B, T]`` (the Viterbi path) -> ``[B, T]``
    with ``gamma[t, states[t]]`` on valid frames (clipped to [0, 1]), 0
    beyond.  The terminal mass sits on the graph's end states."""
    b, t, _ = feats.shape
    dev = feats.device
    g = g.to(dev)
    n_frames = n_frames.to(dev)
    end_scores = torch.full((g.n_states,), -torch.inf, device=dev)
    end_scores[g.end_states] = 0.0
    mask = torch.arange(t, device=dev)[None, :] < n_frames[:, None]
    nll = bank_nll(bank, feats, mask)[:, :, g.bank_state].contiguous()
    res = forward_backward_banded(nll, g, n_frames, eps_depth, end_scores)
    p = res.gamma.gather(2, states.to(dev, torch.int64)[:, :, None])[:, :, 0]
    # float rounding can push exp(alpha + beta - log Z) a hair past 1
    return torch.where(mask, torch.clamp(p, 0.0, 1.0), 0.0)


def word_confidence(graph, states: np.ndarray, eps_flags: np.ndarray, post: np.ndarray,
                    n_frames: int) -> List[Tuple[int, float]]:
    """Split the path into word segments (the boundary rule of
    ``states_to_words``) and average the frame posterior over each.

    Returns ``[(word_id, confidence), ...]``."""
    slots = np.asarray(graph.slot)[np.asarray(states)[:n_frames]]
    post = np.asarray(post)[:n_frames]
    out: List[Tuple[int, float]] = []
    seg_start, prev = 0, -1
    for t, s in enumerate(slots):
        if s != prev or (eps_flags is not None and t > 0 and eps_flags[t]):
            if t > seg_start:
                out[-1] = (out[-1][0], float(post[seg_start:t].mean()))
            out.append((int(np.asarray(graph.slot_label)[s]), 0.0))
            seg_start = t
            prev = s
    if out:
        out[-1] = (out[-1][0], float(post[seg_start:n_frames].mean()))
    return out

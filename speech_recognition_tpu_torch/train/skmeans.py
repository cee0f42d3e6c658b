"""Segmental K-means over batched, masked templates.

Counterpart of ``speech_recognition_tpu/train/skmeans.py``: a uniform
time split, then [transition costs from segment lengths -> align every
template to the segment means -> re-cut the segments from the path ->
recompute means and variances] until the means pass ``allclose``.

* All templates of a word align in one ``ops.viterbi_kernels.
  viterbi_dense`` call (kernel K11 on CUDA tensors) with the shared
  ``[S, S]`` matrix and ``[B, T, S]`` unsquared Euclidean distances,
  then one batched ``ops.viterbi.viterbi_backtrace`` from state S-1.
* Segment statistics are masked one-hot matmuls over the padded
  ``[B, T]`` state plane.
* ``update_seg_lens=False`` replicates the original system, whose
  transition costs stay those of the uniform initial cut; the default
  re-estimates them from the current alignment.

``calc_transition_costs`` is a float64 numpy copy of the JAX function,
including the skip-over-empty-segments jump (``max_jump_dist`` 2) and
the degenerate branch of a segment with no frames.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from speech_recognition_tpu_torch.models.hmm import linear_init_cost
from speech_recognition_tpu_torch.ops.gmm import pairwise_sq_euclidean
from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense
from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

__all__ = ["skmeans", "calc_transition_costs", "pad_templates", "segment_stats"]


def pad_templates(templates: List, pad_to: int = None):
    """Stack variable-length ``[T_i, D]`` templates (tensors on one
    device, or numpy) into ``(x [B, T, D] float32, n_frames [B] int32)``
    on that device; ``pad_to`` fixes T."""
    templates = [torch.as_tensor(t) for t in templates]
    dev = templates[0].device
    tmax = pad_to or max(t.shape[0] for t in templates)
    x = torch.zeros((len(templates), tmax, templates[0].shape[1]), dtype=torch.float32,
                    device=dev)
    for i, t in enumerate(templates):
        x[i, : t.shape[0]] = t
    n = torch.tensor([t.shape[0] for t in templates], dtype=torch.int32, device=dev)
    return x, n


def calc_transition_costs(n_temps: int, seg_lens: np.ndarray,
                          max_jump_dist: int = 2) -> np.ndarray:
    """``seg_lens [n_temps, S]`` frames per segment per template ->
    ``[S, S]`` float64 costs ``T[to, from]``, ``np.inf`` where absent."""
    n_segments = seg_lens.shape[1]
    empty_segs = seg_lens == 0
    res = np.full((n_segments, n_segments), np.inf)
    with np.errstate(divide="ignore"):
        for i in range(n_segments):
            jump_dist = 1
            n_jump = 0 if i == n_segments - 1 else n_temps
            s = i + 1
            while s < n_segments - 1:
                if np.sum(empty_segs[:, s + 1]) == 0:
                    break
                jump_dist += 1
                if jump_dist > max_jump_dist:
                    break
                s += 1
            n_all = int(np.sum(seg_lens[:, i]))
            if n_all == 0:
                # degenerate (the original divides by zero here): keep
                # the state enterable
                res[i, i] = np.inf
                if i + jump_dist < n_segments:
                    res[i + jump_dist, i] = 0.0
                continue
            n_stay = n_all - n_jump
            p_stay = n_stay / n_all
            p_jump = n_jump / n_all
            if n_jump:
                res[i + jump_dist, i] = -np.log(p_jump)
            res[i, i] = -np.log(p_stay)
    return res


def _align_batch(x, n_frames, means, trans, n_segments: int):
    """Align every template ``x [B, T, D]`` to the segment means: K11
    with the shared matrix ``trans [S, S]``, then the backtrace from
    state S-1.  Returns ``[B, T]`` int32 states."""
    b, t, d = x.shape
    dists = torch.sqrt(torch.clamp(pairwise_sq_euclidean(x.reshape(-1, d), means),
                                   min=1e-24)).reshape(b, t, n_segments)
    init = torch.from_numpy(linear_init_cost(n_segments)).to(x.device)
    _, bp, eps_bp = viterbi_dense(dists, trans, init, n_frames)
    end = torch.full((b,), n_segments - 1, dtype=torch.int64, device=x.device)
    return viterbi_backtrace(bp, eps_bp, end, n_frames)[0]


def segment_stats(x, n_frames, states, n_segments: int):
    """Pooled per-segment ``(count [S], mean [S, D], ddof-1 var [S, D])``
    over the valid frames of ``x [B, T, D]``, and the per-template
    segment lengths ``[B, S]``."""
    b, t, d = x.shape
    frame_mask = torch.arange(t, device=x.device)[None, :] < n_frames[:, None]
    onehot = ((states[:, :, None] == torch.arange(n_segments, device=x.device))
              & frame_mask[:, :, None]).to(x.dtype)
    seg_lens = onehot.sum(1)
    counts = seg_lens.sum(0)
    flat_oh = onehot.reshape(b * t, n_segments)
    flat_x = x.reshape(b * t, d)
    means = (flat_oh.T @ flat_x) / torch.clamp(counts, min=1.0)[:, None]
    sq = flat_oh.T @ (flat_x * flat_x)
    var = (sq - counts[:, None] * means * means) / torch.clamp(counts - 1.0, min=1.0)[:, None]
    return counts, means, torch.clamp(var, min=1e-12), seg_lens


def skmeans(templates: List, n_segments: int, max_iters: int = 100,
            update_seg_lens: bool = True, rtol: float = 1e-5, atol: float = 1e-8,
            pad_to: int = None):
    """Segmental K-means of ``[T_i, D]`` templates (tensors on the device
    to train on).  Returns ``(means [S, D], variances [S, D], trans [S, S]
    float64 numpy with np.inf, states [B, T], (x [B, T, D], n_frames
    [B]))``."""
    for t in templates:
        if t.shape[0] < n_segments:
            raise ValueError("template is too small, cannot do dtw on it")
    x, n_frames = pad_templates(templates, pad_to)
    b, tmax, _ = x.shape
    dev = x.device

    # uniform initial cut: T // S frames a segment, the last to the end
    nf = np.array([t.shape[0] for t in templates])
    seg_len0 = np.maximum(nf // n_segments, 1)
    states = np.minimum(np.arange(tmax)[None, :] // seg_len0[:, None], n_segments - 1)
    states = torch.from_numpy(states.astype(np.int32)).to(dev)

    _, means, variances, seg_lens = segment_stats(x, n_frames, states, n_segments)
    seg_lens_np = seg_lens.cpu().numpy().astype(np.int64)
    trans = calc_transition_costs(b, seg_lens_np)

    for _ in range(max_iters):
        trans_dev = torch.from_numpy(to_cost_matrix(trans)).to(dev)
        states = _align_batch(x, n_frames, means, trans_dev, n_segments)
        _, new_means, variances, seg_lens = segment_stats(x, n_frames, states, n_segments)
        if update_seg_lens:
            seg_lens_np = seg_lens.cpu().numpy().astype(np.int64)
        trans = calc_transition_costs(b, seg_lens_np)
        done = torch.allclose(new_means, means, rtol=rtol, atol=atol)
        means = new_means
        if done:
            break
    return means, variances, trans, states, (x, n_frames)

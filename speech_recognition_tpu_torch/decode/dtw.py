"""DTW template matching: the single-Gaussian model path.

Counterpart of ``speech_recognition_tpu/decode/dtw.py``.  Templates are
``(means [S, D], variances [S, D], trans [S, S])`` per model; the
distance matrix of a batch against every template state is one GEMM
(``ops.gmm.pairwise_gaussian_nll``), and the DP is the isolated path's
(DTW is Viterbi with distances as emissions): kernel K11 on CUDA
tensors, its plain version on CPU tensors.  ``fit_template`` trains a
template by segmental K-means alone (``train.skmeans``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speech_recognition_tpu_torch.decode.isolated import _frame_mask, model_costs
from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll

__all__ = ["TemplateBank", "fit_template", "stack_templates", "dtw_score_models",
           "dtw_classify_batch"]


class TemplateBank(NamedTuple):
    """Stack of single-Gaussian segment templates."""

    means: torch.Tensor  # [N, S, D]
    variances: torch.Tensor  # [N, S, D]
    trans_cost: torch.Tensor  # [N, S, S]

    @property
    def n_models(self) -> int:
        return self.means.shape[0]

    @property
    def n_states(self) -> int:
        return self.means.shape[1]

    @classmethod
    def from_numpy(cls, means, variances, trans_cost) -> "TemplateBank":
        """The reference package's template arrays as a port bank (CPU)."""
        return cls(*[torch.from_numpy(np.array(a, dtype=np.float32))
                     for a in (means, variances, trans_cost)])

    def to(self, device) -> "TemplateBank":
        return TemplateBank(*[x.to(device) for x in self])


def fit_template(templates, n_segments: int = 5, **kw):
    """Segmental K-means alone (the original ``HMM.fit(use_gmm=False)``)
    on ``[T_i, D]`` templates.  Returns ``(means [S, D], variances [S, D]
    floored at 1e-3, trans [S, S])`` as tensors on the templates' device
    (``trans`` with ``POS_INF`` where absent)."""
    from speech_recognition_tpu_torch.train.skmeans import skmeans
    from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

    means, variances, trans, _, _ = skmeans(templates, n_segments, **kw)
    return (means, torch.clamp(variances, min=1e-3),
            torch.from_numpy(to_cost_matrix(trans)).to(means.device))


def stack_templates(models) -> TemplateBank:
    """``[(means, variances, trans), ...]`` (numpy, or tensors on one
    device) -> a TemplateBank."""
    return TemplateBank(*[torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in xs])
                          for xs in zip(*models)])


def dtw_classify_batch(bank: TemplateBank, feats, n_frames):
    """``feats [B, T, D]``, ``n_frames [B]`` -> ``(pred [B], costs [B, N])``
    with each cost the template's last state at the last valid frame."""
    n, s, d = bank.means.shape
    if bank.means.device != feats.device:
        raise ValueError(f"templates are on {bank.means.device}, features on {feats.device}")
    dists = pairwise_gaussian_nll(feats, bank.means.reshape(n * s, d),
                                  bank.variances.reshape(n * s, d))
    mask = _frame_mask(n_frames, feats.shape[1], feats.device)
    dists = torch.where(mask[..., None], dists, torch.zeros_like(dists))
    costs = model_costs(dists, bank.trans_cost, n_frames)
    return torch.argmin(costs, dim=1), costs


def dtw_score_models(bank: TemplateBank, feats, n_frames):
    """Per-model DTW cost of one utterance ``feats [T, D]``: ``[N]``."""
    nf = torch.as_tensor(n_frames, device=feats.device).reshape(1)
    return dtw_classify_batch(bank, feats[None], nf)[1][0]

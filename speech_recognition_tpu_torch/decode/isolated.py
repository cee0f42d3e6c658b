"""Isolated-word classification: the argmin path cost over the bank.

Counterpart of ``speech_recognition_tpu/decode/isolated.py``.  One
emission GEMM against the whole bank gives ``[B, T, N*S]``; it is
regrouped into ``B*N`` (utterance, model) items of ``S`` states, and
kernel K11 (``ops.viterbi_kernels.viterbi_dense``) runs them all with
per-item transition matrices and no backpointer planes.  A model's cost
is its last state's cost at the last valid frame; the decision is the
argmin over models.  CPU tensors run K11's plain version.
"""

from __future__ import annotations

import torch

from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll, linear_init_cost
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense

__all__ = ["score_models", "classify_batch", "model_costs"]


def model_costs(nll, trans_cost, n_frames):
    """``nll [B, T, N*S]`` emissions, ``trans_cost [N, S, S]``, ``n_frames
    [B]`` -> ``[B, N]`` left-to-right path costs (entry in state 0, exit
    from state S-1)."""
    b, t, _ = nll.shape
    n, s, _ = trans_cost.shape
    dev = nll.device
    items = nll.reshape(b, t, n, s).permute(0, 2, 1, 3).reshape(b * n, t, s)
    trans = trans_cost[None].expand(b, n, s, s).reshape(b * n, s, s)
    init = torch.from_numpy(linear_init_cost(s)).to(dev)
    nf = n_frames.to(dev).repeat_interleave(n)
    final, _, _ = viterbi_dense(items.contiguous(), trans.contiguous(), init, nf,
                                planes=False)
    return final[:, -1].reshape(b, n)


def _frame_mask(n_frames, t: int, dev):
    return torch.arange(t, device=dev)[None, :] < n_frames.to(dev)[:, None]


def classify_batch(bank: HMMBank, feats, n_frames):
    """``feats [B, T, D]``, ``n_frames [B]`` -> ``(pred [B], costs [B, N])``,
    on the device of ``feats``."""
    if bank.means.device != feats.device:
        raise ValueError(f"bank is on {bank.means.device}, features on {feats.device}")
    nll = bank_nll(bank, feats, _frame_mask(n_frames, feats.shape[1], feats.device))
    costs = model_costs(nll, bank.trans_cost, n_frames)
    return torch.argmin(costs, dim=1), costs


def score_models(bank: HMMBank, feats, n_frames):
    """Path cost of one utterance ``feats [T, D]`` under every model: ``[N]``."""
    nf = torch.as_tensor(n_frames, device=feats.device).reshape(1)
    return classify_batch(bank, feats[None], nf)[1][0]

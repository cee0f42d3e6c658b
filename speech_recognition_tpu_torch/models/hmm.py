"""GMM-HMM word models as ``nn.Module``s holding buffers.

Counterpart of ``speech_recognition_tpu/models/hmm.py``:

  ``GMMHMM``  one word model: means [S, M, D], log_vars [S, M, D],
              log_weights [S, M], trans_cost [S, S] (T[to, from],
              POS_INF where absent).
  ``HMMBank`` every field gains a leading model axis [N]; the unit the
              emission GEMM consumes.

Parameters are buffers (decoding has no gradients), so ``bank.to(dev)``
moves them and ``state_dict`` saves them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from speech_recognition_tpu_torch.ops.gmm import (
    gmm_emission_weights,
    gmm_neg_log_lik,
    gmm_neg_log_lik_ubt,
)
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["GMMHMM", "HMMBank", "bank_nll", "bank_nll_ubt", "linear_init_cost",
           "uniform_left_to_right_trans"]

_FIELDS = ("means", "log_vars", "log_weights", "trans_cost")


class _Params(nn.Module):
    def __init__(self, means, log_vars, log_weights, trans_cost):
        super().__init__()
        for name, v in zip(_FIELDS, (means, log_vars, log_weights, trans_cost)):
            self.register_buffer(name, torch.as_tensor(v, dtype=torch.float32))

    @property
    def n_states(self) -> int:
        return self.means.shape[-3]

    @property
    def n_mix(self) -> int:
        return self.means.shape[-2]

    @property
    def feature_dim(self) -> int:
        return self.means.shape[-1]


class GMMHMM(_Params):
    """One left-to-right word HMM with diagonal-GMM emissions."""


class HMMBank(_Params):
    """A stack of word models: every field has a leading [N] axis."""

    @property
    def n_models(self) -> int:
        return self.means.shape[0]

    @classmethod
    def stack(cls, models) -> "HMMBank":
        return cls(*[torch.stack([getattr(m, f) for m in models])
                     for f in _FIELDS])

    @classmethod
    def from_numpy(cls, means, log_vars, log_weights, trans_cost) -> "HMMBank":
        """The reference package's bank parameters, given as numpy
        arrays (``np.asarray(jax_bank.means)`` etc.), as a port bank."""
        return cls(*[torch.from_numpy(np.array(a, dtype=np.float32))
                     for a in (means, log_vars, log_weights, trans_cost)])

    def model(self, i: int) -> GMMHMM:
        return GMMHMM(*[getattr(self, f)[i] for f in _FIELDS])

    def flat_states(self):
        """Collapse (model, state) -> bank-state axis [N*S, ...]."""
        n, s, m, d = self.means.shape
        return (self.means.reshape(n * s, m, d),
                self.log_vars.reshape(n * s, m, d),
                self.log_weights.reshape(n * s, m))


def bank_nll(bank: HMMBank, x, frame_mask=None):
    """Emission costs of every frame against every bank state, one GEMM:
    ``[..., T, D] -> [..., T, N*S]``."""
    w, lw = gmm_emission_weights(*bank.flat_states())
    return gmm_neg_log_lik(x, w, lw, frame_mask)


def bank_nll_ubt(bank: HMMBank, feats, n_frames):
    """Batched emission costs in the state-major ``[N*S, T, B]`` layout."""
    w, lw = gmm_emission_weights(*bank.flat_states())
    return gmm_neg_log_lik_ubt(feats, w, lw, n_frames)


def uniform_left_to_right_trans(n_states: int, self_loop_cost: float = 0.6931472,
                                step_cost: float = 0.6931472) -> np.ndarray:
    """A generic initial left-to-right transition matrix (-log 0.5 each;
    the final state absorbs at cost 0), before segmental K-means."""
    t = np.full((n_states, n_states), POS_INF, dtype=np.float32)
    for i in range(n_states):
        t[i, i] = self_loop_cost
        if i + 1 < n_states:
            t[i + 1, i] = step_cost
    t[n_states - 1, n_states - 1] = 0.0
    return t


def linear_init_cost(n_states: int) -> np.ndarray:
    """Entry in state 0 only (the isolated decode's initialization)."""
    init = np.full((n_states,), POS_INF, dtype=np.float32)
    init[0] = 0.0
    return init

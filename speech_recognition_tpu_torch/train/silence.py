"""Optional silence model.

Counterpart of ``speech_recognition_tpu/train/silence.py``: silence
samples are harvested from the training wavs themselves (what lies
outside the energy endpointer's speech span, ``data/endpoint.py``), one
GMM is fit to their pooled feature frames and replicated over the
model's states with self-loop-heavy transitions.  The bank holds it as
one more word; decoders drop it from their output.

The silence GMM has at most 2 components, the digits 4 by default, and
a bank holds one mixture count: ``pad_mixtures`` repeats the trained
components with weight 1e-10 to fill the bank's count, which moves no
emission by more than a part in 1e10.  (The JAX CLI's ``isolated_train
--silence`` stacks the two counts and raises for ``--n-gaussians`` above
2, ROADMAP C10.)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from speech_recognition_tpu_torch.config import EndpointConfig, HMMConfig, TrainConfig
from speech_recognition_tpu_torch.data.endpoint import endpoint_signal
from speech_recognition_tpu_torch.models.hmm import GMMHMM
from speech_recognition_tpu_torch.train.isolated import DrawAssign, fit_gmm_state
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["harvest_silence_samples", "fit_silence_hmm", "pad_mixtures"]


def harvest_silence_samples(wavs: List[np.ndarray], cfg: EndpointConfig = EndpointConfig(),
                            margin_ms: float = 50.0) -> List[np.ndarray]:
    """Sample regions outside each wav's endpointed speech span (lead and
    tail, ``margin_ms`` away from it, of at least 5 frames).  A wav in
    which the endpointer finds no speech is skipped: it is a training
    utterance, so its whole length would be a spoken digit."""
    margin = int(margin_ms / 1000 * cfg.sample_rate)
    out = []
    for w in wavs:
        s, e = endpoint_signal(w, cfg)
        if s is None:
            continue
        for seg in (np.asarray(w[: max(s - margin, 0)]), np.asarray(w[e + margin:])):
            if len(seg) >= cfg.samples_per_frame * 5:
                out.append(seg)
    return out


def fit_silence_hmm(silence_frames, n_states: int = 5, n_mix: int = 2,
                    hmm_cfg: HMMConfig = HMMConfig(), train_cfg: TrainConfig = TrainConfig(),
                    p_stay: float = 0.9, draw_assign: Optional[DrawAssign] = None) -> GMMHMM:
    """Fit one GMM on the pooled silence frames ``[N, D]`` (a tensor on
    the device to train on) and replicate it over ``n_states`` states
    of a self-loop-heavy chain."""
    x = torch.as_tensor(silence_frames, dtype=torch.float32)
    mask = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
    m, v, w = fit_gmm_state(
        x, mask, x.mean(0), n_mix, train_cfg=train_cfg,
        hmm_cfg=HMMConfig(n_states=n_states, n_mix=n_mix, var_floor=hmm_cfg.var_floor),
        draw_assign=draw_assign)
    w = torch.clamp(w, min=1e-8)
    trans = np.full((n_states, n_states), POS_INF, dtype=np.float32)
    for i in range(n_states):
        trans[i, i] = -np.log(p_stay)
        if i + 1 < n_states:
            trans[i + 1, i] = -np.log(1.0 - p_stay)
    trans[n_states - 1, n_states - 1] = 0.0
    return GMMHMM(m[None].expand(n_states, -1, -1),
                  torch.log(torch.clamp(v, min=hmm_cfg.var_floor))[None].expand(n_states, -1, -1),
                  torch.log(w / w.sum())[None].expand(n_states, -1),
                  torch.from_numpy(trans).to(x.device))


def pad_mixtures(model: GMMHMM, n_mix: int) -> GMMHMM:
    """``model`` with ``n_mix`` mixture components: its own, then copies
    of them cycled, each copy with weight 1e-10 before renormalizing."""
    m = model.n_mix
    if n_mix <= m:
        return model
    idx = torch.arange(n_mix, device=model.means.device) % m
    w = torch.exp(model.log_weights)
    w = torch.cat([w, torch.full_like(w[:, :1], 1e-10).expand(-1, n_mix - m)], dim=1)
    return GMMHMM(model.means[:, idx], model.log_vars[:, idx],
                  torch.log(w / w.sum(1, keepdim=True)), model.trans_cost)

"""Energy-based endpointing as a pure function over sample arrays.

Numpy copy of ``speech_recognition_tpu/data/endpoint.py``: 20 ms frames
at a 10 ms stride, per-frame dB energy ``10*log10(sum(x^2))``, a
smoothed level with a forget factor, an adaptive background estimate
(the first 10 frames, then ``bg += (E - bg) * adjustment``), onset and
offset hysteresis, hold times for speech and silence, and a start
boundary pad.  The silence harvest of ``train/silence.py`` reads it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from speech_recognition_tpu_torch.config import EndpointConfig

__all__ = ["frame_energies_db", "endpoint_signal", "trim_to_speech"]


def frame_energies_db(samples: np.ndarray, cfg: EndpointConfig) -> np.ndarray:
    """Per-frame dB energies (0 where sum(x^2) <= 1)."""
    x = np.asarray(samples, dtype=np.float64)
    w, st = cfg.samples_per_frame, cfg.frame_stride
    if len(x) < w:
        x = np.pad(x, (0, w - len(x)))
    n_frames = 1 + (len(x) - w) // st
    idx = np.arange(n_frames)[:, None] * st + np.arange(w)[None, :]
    e = np.sum(x[idx] ** 2, axis=1)
    return np.where(e <= 1.0, 0.0, 10.0 * np.log10(np.maximum(e, 1e-12)))


def endpoint_signal(
    samples: np.ndarray, cfg: EndpointConfig = EndpointConfig()
) -> Tuple[Optional[int], Optional[int]]:
    """Find (start_sample, end_sample) of the first utterance, or (None, None).

    The recorder's state machine: level smoothing with the forget
    factor, a background level over the first 10 frames then adapted,
    onset/offset hysteresis, speech and silence hold counts, and the
    start boundary pad.
    """
    energies = frame_energies_db(samples, cfg)
    n = len(energies)
    st = cfg.frame_stride
    w = cfg.samples_per_frame

    silence_hold = int(cfg.silence_threshold_ms * cfg.sample_rate / (1000 * st))
    speech_hold = int(cfg.speech_threshold_ms * cfg.sample_rate / (1000 * st))
    start_pad = int(cfg.start_boundary_ms / 1000 * cfg.sample_rate)

    level = 0.0
    background = 0.0
    is_speech = False
    speech_time = 0
    silence_time = 0
    started = False
    start_idx: Optional[int] = None
    end_idx: Optional[int] = None

    for i in range(n):
        e = energies[i]
        if i <= 10:
            level = e
        else:
            level = (level + cfg.forget_factor * e) / (cfg.forget_factor + 1.0)
        if i < 10:
            # the first 10 frames classify as silence
            silence_time += 1
            continue
        if i == 10:
            # frames 0..10 inclusive averaged over 10, as the original
            background = float(np.sum(energies[:11]) / 10.0)
        else:
            background += (e - background) * cfg.adjustment

        if level < background:
            level = background
        elif level - background > cfg.onset_threshold_db:
            is_speech = True
        elif level - background < cfg.offset_threshold_db:
            is_speech = False

        if is_speech:
            speech_time += 1
            silence_time = 0
        else:
            silence_time += 1
            speech_time = 0

        s = i * st
        if speech_time > speech_hold and not started:
            started = True
            silence_time = 0
            start_idx = max(0, s - start_pad)
        elif silence_time > silence_hold and started:
            end_idx = s + w
            break

    if started and end_idx is None:
        end_idx = len(samples)
    return (start_idx, end_idx) if started else (None, None)


def trim_to_speech(samples: np.ndarray, cfg: EndpointConfig = EndpointConfig()) -> np.ndarray:
    s, e = endpoint_signal(samples, cfg)
    if s is None:
        return np.asarray(samples)
    return np.asarray(samples)[s:e]

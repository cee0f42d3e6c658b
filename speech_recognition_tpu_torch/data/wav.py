"""Wav reading and writing (counterpart of
``speech_recognition_tpu/data/wav.py`` and the scipy path of
``speech_recognition_tpu/runtime/loader.load_wav_batch``)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.io import wavfile

__all__ = ["write_wav", "load_wav_batch"]


def write_wav(path, samples, sample_rate: int = 16000):
    """Write ``samples`` as 16-bit PCM."""
    wavfile.write(path, sample_rate, np.asarray(samples).astype(np.int16))


def load_wav_batch(paths: List[str], cap_samples: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read PCM wavs into a padded float32 batch.

    Returns ``(samples [B, cap], lengths [B], rates [B])``: samples past
    each file's length are exact zeros, files longer than ``cap`` are
    truncated, and a multi-channel file keeps its first channel."""
    b = len(paths)
    out = np.zeros((b, cap_samples), dtype=np.float32)
    lengths = np.zeros((b,), dtype=np.int32)
    rates = np.zeros((b,), dtype=np.int32)
    for i, p in enumerate(paths):
        rate, sig = wavfile.read(p)
        if sig.ndim > 1:
            sig = sig[:, 0]
        n = min(len(sig), cap_samples)
        out[i, :n] = sig[:n].astype(np.float32)
        lengths[i] = n
        rates[i] = rate
    return out, lengths, rates

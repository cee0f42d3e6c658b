"""Deterministic synthetic Aurora-style digit corpus and random GMM-HMM
parameters, in numpy.

Counterpart of ``speech_recognition_tpu/data/synthetic.py`` (the parts
the decode paths need): the same seed gives the same samples,
file names and parameters.  Each digit is three quasi-phoneme segments
of digit-specific formant triples plus noise under an amplitude
envelope; utterances join digits with silences and are named
``<SPEAKER>_<digits>A.wav`` so the CLI reads their transcripts.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List

import numpy as np

from speech_recognition_tpu_torch.config import DIGIT_NAMES, FILENAME_INDEX_MAP

__all__ = ["Utterance", "SyntheticDigits", "random_gmm_hmm"]


@dataclasses.dataclass
class Utterance:
    name: str
    transcript: str
    samples: np.ndarray  # int16
    labels: List[int]


class SyntheticDigits:
    """Seeded generator for digit audio."""

    def __init__(self, seed: int = 0, sample_rate: int = 16000, noise: float = 0.05):
        self.sample_rate = sample_rate
        self.seed = seed
        self.noise = noise  # in-word noise amplitude (signal partials are O(1))
        base = np.random.default_rng(seed)
        # per (digit, segment) formant targets on a well-separated grid
        self.n_segs = 3
        seg = np.arange(self.n_segs)[None, :]
        self.f1 = 250.0 + 55.0 * base.permutation(11)[:, None] + 35.0 * seg
        self.f2 = 900.0 + 140.0 * base.permutation(11)[:, None] + 90.0 * ((seg + 1) % self.n_segs)
        self.f3 = 2200.0 + 120.0 * base.permutation(11)[:, None] + 60.0 * seg

    def _rng(self, *key_parts) -> np.random.Generator:
        # crc32 is stable across processes, unlike str hash
        keys = [zlib.crc32(str(k).encode()) for k in key_parts]
        return np.random.default_rng([self.seed, *keys])

    def digit_samples(self, digit: int, rng: np.random.Generator) -> np.ndarray:
        """Render one spoken digit (~0.25-0.45 s)."""
        sr = self.sample_rate
        chunks = []
        for seg in range(self.n_segs):
            n = int(rng.uniform(0.07, 0.15) * sr)
            t = np.arange(n) / sr
            jitter = rng.uniform(0.97, 1.03)
            sig = (
                1.0 * np.sin(2 * np.pi * self.f1[digit, seg] * jitter * t + rng.uniform(0, 6.28))
                + 0.6 * np.sin(2 * np.pi * self.f2[digit, seg] * jitter * t + rng.uniform(0, 6.28))
                + 0.3 * np.sin(2 * np.pi * self.f3[digit, seg] * jitter * t + rng.uniform(0, 6.28))
                + self.noise * rng.standard_normal(n)
            )
            ramp = min(n // 4, 160)
            env = np.ones(n)
            env[:ramp] = np.linspace(0.3, 1.0, ramp)
            env[-ramp:] = np.linspace(1.0, 0.3, ramp)
            chunks.append(sig * env)
        return np.concatenate(chunks) * rng.uniform(0.6, 1.0)

    def silence(self, dur_s: float, rng: np.random.Generator) -> np.ndarray:
        return 0.004 * rng.standard_normal(int(dur_s * self.sample_rate))

    def utterance(self, transcript: str, speaker: str = "AA") -> Utterance:
        """Render a digit string with inter-word silences."""
        rng = self._rng("utt", speaker, transcript)
        labels = [FILENAME_INDEX_MAP[c] for c in transcript]
        parts = [self.silence(rng.uniform(0.05, 0.12), rng)]
        for label in labels:
            parts.append(self.digit_samples(label, rng))
            parts.append(self.silence(rng.uniform(0.04, 0.1), rng))
        sig = np.concatenate(parts)
        sig = sig / (np.max(np.abs(sig)) + 1e-9)
        return Utterance(name=f"{speaker}_{transcript}A.wav", transcript=transcript,
                         samples=np.round(sig * 12000).astype(np.int16), labels=labels)

    def isolated_corpus(self, n_per_digit: int, tag: str = "train") -> List[Utterance]:
        """``n_per_digit`` single-digit utterances for each of the 11 models,
        named ``<SPEAKER>_<digit>A.wav``."""
        return [self.utterance(name, speaker=_speaker(self._rng(tag, name, i)))
                for name in DIGIT_NAMES for i in range(n_per_digit)]

    def continuous_corpus(self, n: int, min_len: int = 2, max_len: int = 7,
                          tag: str = "train", markov: float = 0.0) -> List[Utterance]:
        """``n`` digit strings; ``markov`` > 0 makes the next digit
        prev+1 (mod 11) with that probability."""
        utts = []
        for i in range(n):
            rng = self._rng(tag, "cont", i)
            length = int(rng.integers(min_len, max_len + 1))
            digits = [int(rng.integers(0, 11))]
            for _ in range(length - 1):
                if rng.uniform() < markov:
                    digits.append((digits[-1] + 1) % 11)
                else:
                    digits.append(int(rng.integers(0, 11)))
            speaker = _speaker(rng)
            utts.append(self.utterance("".join(DIGIT_NAMES[d] for d in digits),
                                       speaker=speaker))
        return utts


def _speaker(rng: np.random.Generator) -> str:
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return "".join(letters[int(rng.integers(0, 26))] for _ in range(2))


def random_gmm_hmm(rng: np.random.Generator, n_states=5, n_mix=2, dim=8,
                   sep=4.0) -> Dict[str, np.ndarray]:
    """A well-separated random left-to-right GMM-HMM parameter dict;
    ``trans`` holds probabilities' negative logs (inf = no arc), indexed
    ``[to, from]``."""
    means = sep * rng.standard_normal((n_states, n_mix, dim))
    variances = rng.uniform(0.3, 1.0, size=(n_states, n_mix, dim))
    w = rng.uniform(0.5, 1.5, size=(n_states, n_mix))
    w /= w.sum(axis=1, keepdims=True)
    p_stay = rng.uniform(0.5, 0.9, size=n_states)
    trans = np.full((n_states, n_states), np.inf)
    for i in range(n_states):
        if i + 1 < n_states:
            trans[i, i] = -np.log(p_stay[i])
            trans[i + 1, i] = -np.log(1 - p_stay[i])
        else:
            trans[i, i] = 0.0
    return {"means": means, "variances": variances, "weights": w, "trans": trans}

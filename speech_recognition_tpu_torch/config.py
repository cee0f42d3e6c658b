"""Typed configuration of the port.

Counterpart of ``speech_recognition_tpu/config.py``, carrying what the
port reads: the digit names and the Aurora filename map, the MFCC
frontend parameters, the acoustic-model topology, the training loop's
parameters, the endpointer's and the decoder defaults.  The reference's TPU
matmul-precision dials (``dft_as_gemm``, ``*_precision``) are not
carried: every GEMM of the port runs in f32.  The dataclasses are
frozen, so a config is hashable and can key a cache of constants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["DIGIT_NAMES", "FILENAME_INDEX_MAP", "FrontendConfig", "HMMConfig", "TrainConfig",
           "DecodeConfig", "EndpointConfig"]

# The 11 digit models: '1'..'9' plus two pronunciations of zero
# ("oh" = O and "zero" = Z).
DIGIT_NAMES: Tuple[str, ...] = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "O", "Z")

# Aurora filename transcript character -> model index.
FILENAME_INDEX_MAP = {
    "1": 0, "2": 1, "3": 2, "4": 3, "5": 4, "6": 5, "7": 6, "8": 7, "9": 8,
    "O": 9, "Z": 10,
}


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """MFCC frontend parameters.

    ``variant='psf'`` (the default) is ``python_speech_features.mfcc(
    nfilt=40, preemph=0.95, appendEnergy=False, winfunc=np.hamming)``:
    c0 kept, sinusoidal lifter 22, low_freq 0, high_freq Nyquist, a
    512-point FFT at 16 kHz.  ``variant='scratch'`` is the from-scratch
    path: preemph 0.97, centre-zero-padded 512-sample frames, low_freq
    80 Hz, log10 filterbanks, DCT coefficients 1..13, no lifter.
    """

    sample_rate: int = 16000
    frame_len_s: float = 0.025
    frame_step_s: float = 0.01
    n_fft: int = 512
    n_mels: int = 40
    n_ceps: int = 13
    # None -> variant default (0.95 for 'psf', 0.97 for 'scratch')
    preemph: Optional[float] = None
    low_freq: float = 0.0
    high_freq: Optional[float] = None  # None -> Nyquist
    cep_lifter: int = 22
    variant: str = "psf"  # 'psf' (production) | 'scratch'

    @property
    def effective_preemph(self) -> float:
        if self.preemph is not None:
            return self.preemph
        return 0.97 if self.variant == "scratch" else 0.95

    @property
    def frame_len(self) -> int:
        return int(round(self.frame_len_s * self.sample_rate))

    @property
    def frame_step(self) -> int:
        return int(round(self.frame_step_s * self.sample_rate))

    @property
    def feature_dim(self) -> int:
        """Output dim after [mfcc, delta, delta-delta] stacking."""
        return 3 * self.n_ceps


@dataclasses.dataclass(frozen=True)
class HMMConfig:
    """Acoustic-model topology: 5-state left-to-right word HMMs with
    4-mixture diagonal-GMM emissions, as the original system trains.

    ``ref_compat_splits``: the original system counts its binary mixture
    splits as ``int(ln(n_mix))``, so "4 gaussians" trains 2 components
    and evaluation sums over 2 never-updated extras.  The default is the
    intended ``log2(n_mix)``; True replicates the quirk.
    """

    n_states: int = 5
    n_mix: int = 4
    ref_compat_splits: bool = False
    var_floor: float = 1e-2

    @property
    def n_splits(self) -> int:
        import math

        if self.ref_compat_splits:
            return int(math.log(self.n_mix))
        return int(math.log2(self.n_mix))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop parameters: iteration caps of segmental K-means,
    k-means, EM and embedded training, the +-10% mixture-split
    perturbation, the seed and the ``allclose`` convergence
    tolerances."""

    skmeans_max_iters: int = 100
    kmeans_max_iters: int = 100
    em_max_iters: int = 100
    continuous_max_iters: int = 20
    split_perturbation: float = 0.1
    seed: int = 0
    rtol: float = 1e-5
    atol: float = 1e-8


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoder parameters.  ``n_slots`` is the fixed-slot sausage depth
    of the reference's connected-digit decoder (7)."""

    n_slots: int = 7
    beam_width: int = 0  # 0 -> no pruning
    word_insertion_cost: float = 0.0
    lm_weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class EndpointConfig:
    """Energy-based endpointing (``data/endpoint.py``): frame geometry in
    seconds, thresholds in dB and milliseconds."""

    sample_rate: int = 16000
    frame_time_s: float = 0.02
    frame_stride_s: float = 0.01
    forget_factor: float = 1.0
    adjustment: float = 0.01
    onset_threshold_db: float = 3.0
    offset_threshold_db: float = 0.2
    silence_threshold_ms: float = 500.0
    speech_threshold_ms: float = 250.0
    start_boundary_ms: float = 200.0

    @property
    def samples_per_frame(self) -> int:
        return int(self.frame_time_s * self.sample_rate)

    @property
    def frame_stride(self) -> int:
        return int(self.frame_stride_s * self.sample_rate)

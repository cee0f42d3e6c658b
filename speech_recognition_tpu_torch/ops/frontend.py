"""MFCC feature frontend.

Counterpart of ``speech_recognition_tpu/ops/frontend.py``:

* ``variant='psf'`` — ``python_speech_features.mfcc(nfilt=40,
  preemph=0.95, appendEnergy=False, winfunc=np.hamming)`` semantics
  (13 ceps including c0, sinusoidal lifter 22, natural-log filterbanks);
* ``variant='scratch'`` — the from-scratch path (preemph 0.97, 512-point
  centre window slice, low_freq 80, log10 filterbanks, ceps 1..13).

The host-side constant builders are numpy (float64, cast to f32 at use)
and are rebuilt here because the reference module imports jax.  The
tensor path is batched: ``[B, L]`` signals, static frame capacity ``F``
and per-utterance frame counts; frames >= nf are exact zeros.

Every GEMM runs in f32 (TF32 off).  ``FrontendConfig.*_precision`` are
TPU pass-count dials and are not read here.

``mfcc39_auto`` is the production entry: a CUDA tensor runs kernel K3
(``ops.frontend_kernel``, ``csrc/mfcc39.cu``: the cepstra kernel, then
the tail kernel K14), which raises for a config it does not implement
(``fused_supported``); a CPU tensor runs the plain pipeline below, which
is also K3's plain version.  ``mfcc`` routes the same way to kernel K12
(the cepstra kernel alone).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.config import FrontendConfig

__all__ = ["padded_length", "max_frames", "mfcc", "mfcc39", "mfcc39_batch",
           "mfcc39_auto", "delta_feature", "standardize", "cmvn_stats",
           "apply_cmvn", "fused_supported", "FrontendConfig"]


# ---------------------------------------------------------------------------
# Host-side constant builders (numpy float64, cached per config)
# ---------------------------------------------------------------------------


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def _mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                    low_freq: float, high_freq: float) -> np.ndarray:
    """Triangular mel filterbank ``[n_mels, n_fft//2+1]`` with integral
    bin boundaries ``floor((n_fft+1) * hz / rate)``, evaluated at integer
    FFT bins against the floored boundaries (psf ``get_filterbanks``)."""
    mel_points = np.linspace(_hz2mel(low_freq), _hz2mel(high_freq), n_mels + 2)
    bins = np.floor((n_fft + 1) * _mel2hz(mel_points) / sample_rate)
    fbank = np.zeros((n_mels, n_fft // 2 + 1), dtype=np.float64)
    for m in range(1, n_mels + 1):
        f_lo, f_c, f_hi = int(bins[m - 1]), int(bins[m]), int(bins[m + 1])
        for k in range(f_lo, f_c):
            fbank[m - 1, k] = (k - bins[m - 1]) / (bins[m] - bins[m - 1])
        for k in range(f_c, f_hi):
            fbank[m - 1, k] = (bins[m + 1] - k) / (bins[m + 1] - bins[m])
    return fbank


def _dct2_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_in, n_out]`` right-multiply computing scipy
    ``dct(x, type=2, norm='ortho')`` truncated to ``n_out`` coefficients."""
    n = np.arange(n_in, dtype=np.float64)
    k = np.arange(n_out, dtype=np.float64)
    basis = 2.0 * np.cos(np.pi * k[None, :] * (2.0 * n[:, None] + 1.0) / (2.0 * n_in))
    scale = np.where(k == 0, np.sqrt(1.0 / (4.0 * n_in)), np.sqrt(1.0 / (2.0 * n_in)))
    return basis * scale[None, :]


def _dft_power_bases(window: np.ndarray, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin DFT bases ``[frame_len, n_fft//2+1]`` with the window
    folded in: ``(f @ C)**2 + (f @ S)**2`` is the ``n_fft``-point power
    spectrum of ``f * window``; a frame longer than ``n_fft`` folds onto it
    (sample n adds at n mod n_fft)."""
    n = np.arange(window.shape[0], dtype=np.float64)
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    phase = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(phase) * window[:, None], np.sin(phase) * window[:, None]


@functools.lru_cache(maxsize=8)
def _frontend_constants(cfg: FrontendConfig):
    """All constant matrices for one config, as float64 numpy arrays."""
    rate = cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq is not None else rate / 2.0
    if cfg.variant == "psf":
        window = np.hamming(cfg.frame_len)
        fbank = _mel_filterbank(cfg.n_mels, cfg.n_fft, rate, cfg.low_freq, high)
        lift_n = np.arange(cfg.n_ceps, dtype=np.float64)
        lifter = (1.0 + (cfg.cep_lifter / 2.0) * np.sin(np.pi * lift_n / cfg.cep_lifter)
                  if cfg.cep_lifter > 0 else np.ones(cfg.n_ceps))
        dct_m = _dct2_ortho_matrix(cfg.n_mels, cfg.n_ceps)
    elif cfg.variant == "scratch":
        # 400-sample frames centre-padded to 512 under a 512-point
        # Hamming window: the effective window is the centre slice (the
        # pad placement only shifts DFT phase)
        pad_left = (cfg.n_fft - cfg.frame_len) // 2
        window = np.hamming(cfg.n_fft)[pad_left: pad_left + cfg.frame_len]
        low = cfg.low_freq if cfg.low_freq else 80.0
        fbank = _mel_filterbank(cfg.n_mels, cfg.n_fft, rate, low, high)
        lifter = np.ones(cfg.n_ceps)
        dct_m = _dct2_ortho_matrix(cfg.n_mels, cfg.n_ceps + 1)[:, 1:]
    else:
        raise ValueError(f"unknown frontend variant {cfg.variant!r}")
    dft_cos, dft_sin = _dft_power_bases(window, cfg.n_fft)
    return {
        "window": window,
        "dft_cs": np.concatenate([dft_cos, dft_sin], axis=1),  # [fl, 2*bins]
        "mel_w": fbank.T.copy(),  # [n_bins, n_mels]
        "dct_m": dct_m,  # [n_mels, n_ceps]
        "lifter": lifter,
    }


def _const(cfg: FrontendConfig, name: str, device) -> torch.Tensor:
    return torch.as_tensor(_frontend_constants(cfg)[name], dtype=torch.float32,
                           device=device)


# ---------------------------------------------------------------------------
# Shape helpers
# ---------------------------------------------------------------------------


def max_frames(cfg: FrontendConfig, max_signal_len: int) -> int:
    """Static frame capacity for signals up to ``max_signal_len`` samples."""
    fl, fs = cfg.frame_len, cfg.frame_step
    if cfg.variant == "psf":
        if max_signal_len <= fl:
            return 1
        return 1 + int(np.ceil((max_signal_len - fl) / fs))
    return int(np.ceil(max_signal_len / fs))


def padded_length(cfg: FrontendConfig, max_signal_len: int) -> int:
    """Buffer length needed so every frame slice is in bounds."""
    return (max_frames(cfg, max_signal_len) - 1) * cfg.frame_step + cfg.frame_len


def _num_frames(cfg: FrontendConfig, length: torch.Tensor) -> torch.Tensor:
    """psf: 1 if len <= fl else 1 + ceil((len - fl) / fs); scratch:
    ceil(len / fs)."""
    fl, fs = cfg.frame_len, cfg.frame_step
    length = length.to(torch.int64)
    if cfg.variant == "psf":
        extra = torch.clamp(length - fl, min=0)
        return torch.where(length <= fl, torch.ones_like(length),
                           1 + (extra + fs - 1) // fs)
    return (length + fs - 1) // fs


def _frames_and_nf(signals, lengths, cfg: FrontendConfig, n_frames_cap):
    """Static frame capacity ``F`` of a ``[B, L]`` buffer (or the cap)
    and the per-utterance frame counts clamped to it."""
    F = n_frames_cap or (1 + max(0, (signals.shape[1] - cfg.frame_len) // cfg.frame_step))
    return F, torch.clamp(_num_frames(cfg, lengths), max=F).to(torch.int32)


def _preemph_frames(signals, lengths, cfg: FrontendConfig, F: int):
    """``[B, L]`` -> pre-emphasized, length-masked ``[B, F, fl]`` frames.
    ``emph[0] = s[0]``; samples at and beyond ``length`` are zeros."""
    b, L = signals.shape
    fl, fs = cfg.frame_len, cfg.frame_step
    emph = torch.cat([signals[:, :1],
                      signals[:, 1:] - cfg.effective_preemph * signals[:, :-1]], 1)
    idx = torch.arange(L, device=signals.device)
    emph = torch.where(idx[None, :] < lengths[:, None], emph, torch.zeros_like(emph))
    need = (F - 1) * fs + fl
    if need > L:
        emph = torch.nn.functional.pad(emph, (0, need - L))
    return emph[:, :need].unfold(1, fl, fs)  # [B, F, fl]


def _frame_mask(nf: torch.Tensor, F: int) -> torch.Tensor:
    return torch.arange(F, device=nf.device)[None, :] < nf[:, None]


# ---------------------------------------------------------------------------
# Tensor pipeline
# ---------------------------------------------------------------------------


def _mfcc_batch(signals, lengths, cfg: FrontendConfig, n_frames_cap=None):
    """``[B, L]`` -> ``(ceps [B, F, n_ceps], nf [B] int32)`` by the
    NDFT-as-GEMM formulation of the reference's XLA path."""
    if not signals.is_floating_point():
        signals = signals.float()
    dev = signals.device
    lengths = lengths.to(dev)
    F, nf = _frames_and_nf(signals, lengths, cfg, n_frames_cap)
    frames = _preemph_frames(signals, lengths, cfg, F)
    reim = torch.matmul(frames, _const(cfg, "dft_cs", dev))  # [B, F, 2*bins]
    sq = (reim * reim).reshape(reim.shape[0], F, 2, -1)
    power = (sq[:, :, 0] + sq[:, :, 1]) * (1.0 / cfg.n_fft)
    mel = torch.matmul(power, _const(cfg, "mel_w", dev))
    # psf floors exact zeros to float64 eps
    mel = torch.where(mel <= 0.0, torch.full_like(mel, np.finfo(np.float64).eps), mel)
    log_mel = torch.log(mel) if cfg.variant == "psf" else torch.log10(mel)
    ceps = torch.matmul(log_mel, _const(cfg, "dct_m", dev)) * _const(cfg, "lifter", dev)
    ceps = torch.where(_frame_mask(nf, F)[..., None], ceps, torch.zeros_like(ceps))
    return ceps, nf


def mfcc(signal, length, cfg: FrontendConfig = FrontendConfig(),
         n_frames_cap: int = None):
    """MFCC for one utterance: ``[L]`` -> ``(ceps [F, n_ceps], nf)``.  A
    CUDA tensor runs kernel K12 (``ops.frontend_kernel.mfcc_fused``), which
    raises for a config it does not implement; a CPU tensor the plain
    pipeline."""
    length = torch.as_tensor(length, device=signal.device).reshape(1)
    if signal.is_cuda:
        from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc_fused

        ceps, nf = mfcc_fused(signal[None].contiguous(), length, cfg, n_frames_cap)
    else:
        ceps, nf = _mfcc_batch(signal[None], length, cfg, n_frames_cap)
    return ceps[0], nf[0]


def delta_feature(feat, n_frames):
    """Symmetric +-1-frame difference with one-sided ends, masked:
    ``d[0] = f[1]-f[0]``, ``d[n-1] = f[n-1]-f[n-2]``, else
    ``f[i+1]-f[i-1]``.  ``feat [..., F, D]``, ``n_frames [...]``."""
    F = feat.shape[-2]
    i = torch.arange(F, device=feat.device)[:, None]
    n = torch.as_tensor(n_frames, device=feat.device)[..., None, None]
    fwd = torch.cat([feat[..., 1:, :], feat[..., -1:, :]], dim=-2)
    bwd = torch.cat([feat[..., :1, :], feat[..., :-1, :]], dim=-2)
    d = torch.where(i == n - 1, feat - bwd, fwd - bwd)
    return torch.where(i < n, d, torch.zeros_like(d))


def standardize(feat, n_frames):
    """Per-utterance mean/variance normalization over valid frames
    (population variance, floored at 1e-20)."""
    F = feat.shape[-2]
    n = torch.as_tensor(n_frames, device=feat.device)[..., None, None]
    mask = torch.arange(F, device=feat.device)[:, None] < n
    denom = torch.clamp(n, min=1).to(feat.dtype)
    zero = torch.zeros_like(feat)
    mean = torch.where(mask, feat, zero).sum(-2, keepdim=True) / denom
    centered = torch.where(mask, feat - mean, zero)
    var = (centered * centered).sum(-2, keepdim=True) / denom
    out = centered / torch.sqrt(torch.clamp(var, min=1e-20))
    return torch.where(mask, out, zero)


def _stack39(ceps, nf, norm: str):
    d1 = delta_feature(ceps, nf)
    d2 = delta_feature(d1, nf)
    feats = torch.cat([ceps, d1, d2], dim=-1)
    if norm == "utterance":
        feats = standardize(feats, nf)
    return feats


def mfcc39_batch(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
                 n_frames_cap: int = None, norm: str = "utterance"):
    """``[B, L]`` -> ``([B, F, 3*n_ceps], nf [B])``: MFCC, delta,
    delta-delta, then per-utterance standardization (``norm='utterance'``)
    or raw features (``norm='none'``)."""
    ceps, nf = _mfcc_batch(signals, lengths, cfg, n_frames_cap)
    return _stack39(ceps, nf, norm), nf


def mfcc39(signal, length, cfg: FrontendConfig = FrontendConfig(),
           n_frames_cap: int = None, norm: str = "utterance"):
    """One utterance: ``[L]`` -> ``(features [F, 3*n_ceps], nf)``."""
    length = torch.as_tensor(length, device=signal.device).reshape(1)
    feats, nf = mfcc39_batch(signal[None], length, cfg, n_frames_cap, norm)
    return feats[0], nf[0]


def cmvn_stats(feats, n_frames):
    """Corpus mean/std from ``[B, T, D]`` raw features (masked)."""
    mask = _frame_mask(torch.as_tensor(n_frames, device=feats.device),
                       feats.shape[1])[..., None]
    total = mask.sum()
    zero = torch.zeros_like(feats)
    mean = torch.where(mask, feats, zero).sum((0, 1)) / total
    var = torch.where(mask, (feats - mean) ** 2, zero).sum((0, 1)) / total
    return mean, torch.sqrt(torch.clamp(var, min=1e-12))


def apply_cmvn(feats, n_frames, mean, std):
    """Apply corpus CMVN to ``[T, D]`` or ``[B, T, D]`` features, masked."""
    out = (feats - mean) / std
    n = torch.as_tensor(n_frames, device=feats.device)
    if feats.ndim == 2:
        m = (torch.arange(feats.shape[0], device=feats.device) < n)[:, None]
    else:
        m = _frame_mask(n, feats.shape[1])[..., None]
    return torch.where(m, out, torch.zeros_like(out))


def fused_supported(cfg: FrontendConfig, norm: str) -> bool:
    """The configs kernel K3 implements and its tests cover: the psf
    variant at any sample rate, a 512-point FFT (longer frames fold onto
    it), standardized or raw output, and zero mel weight on the Nyquist
    bin."""
    if cfg.variant != "psf" or cfg.n_fft != 512:
        return False
    if norm not in ("utterance", "none"):
        return False
    return bool(np.all(_frontend_constants(cfg)["mel_w"][cfg.n_fft // 2] == 0.0))


def mfcc39_auto(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
                n_frames_cap: int = None, norm: str = "utterance"):
    """Production batched frontend: kernel K3 for CUDA tensors (it raises
    for a config it does not implement), the plain pipeline for CPU
    tensors."""
    if signals.is_cuda:
        from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc39_fused

        return mfcc39_fused(signals, lengths, cfg, n_frames_cap, norm)
    return mfcc39_batch(signals, lengths, cfg, n_frames_cap, norm)

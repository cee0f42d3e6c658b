"""Fused MFCC frontends: kernel K3 (MFCC-39) and kernel K12 (cepstra
only), both in ``csrc/mfcc39.cu``, with their plain PyTorch versions.

K3 is the counterpart of ``speech_recognition_tpu/ops/frontend_pallas.py``
(``mfcc39_pallas_batch``), with the XLA ``mfcc39`` semantics: ``nf`` is
clamped to the frame capacity ``F``.  K12 is the counterpart of
``speech_recognition_tpu/ops/pallas_kernels.py`` ``pallas_mfcc`` (the
psf cepstra of ``ops/frontend.mfcc``), K3's ``kCepsOnly`` mode.  Both
compute the power spectrum with a radix-2 FFT in shared memory and fold
the lifter into the DCT matrix; their plain versions ``mfcc39_fused_ref``
and ``mfcc_fused_ref`` are the frontend's own ``mfcc39_batch`` and
``_mfcc_batch`` (DFT bases as GEMMs).

``mfcc39_fused`` and ``mfcc_fused`` run the plain version for CPU
tensors and launch the kernel for CUDA tensors; ``<wrapper>.launches``
counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from speech_recognition_tpu_torch.config import FrontendConfig
from speech_recognition_tpu_torch.ops.frontend import (
    _frames_and_nf,
    _frontend_constants,
    _mfcc_batch,
    fused_supported,
    mfcc39_batch,
)

__all__ = ["mfcc39_fused", "mfcc39_fused_ref", "mfcc_fused", "mfcc_fused_ref"]

# the plain versions: the frontend's batched pipelines
mfcc39_fused_ref = mfcc39_batch
mfcc_fused_ref = _mfcc_batch


@functools.lru_cache(maxsize=8)
def _fused_constants_np(cfg: FrontendConfig):
    c = _frontend_constants(cfg)
    fbank = c["mel_w"].T  # [n_mels, n_bins]
    nz = fbank > 0.0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), fbank.shape[1] - nz[:, ::-1].argmax(1), 0)
    return {
        "window": c["window"].astype(np.float32),
        "mel_w": np.ascontiguousarray(fbank, dtype=np.float32),
        "mel_lo": lo.astype(np.int32),
        "mel_hi": hi.astype(np.int32),
        "dct_lift": np.ascontiguousarray(c["dct_m"] * c["lifter"][None, :],
                                         dtype=np.float32),
    }


@functools.lru_cache(maxsize=8)
def _fused_constants(cfg: FrontendConfig, device: torch.device):
    return {k: torch.from_numpy(v).to(device)
            for k, v in _fused_constants_np(cfg).items()}


def _kernel_inputs(signals, lengths, cfg: FrontendConfig, n_frames_cap, what: str):
    """The checks K3 and K12 share; returns ``(lengths int32, F, nf,
    constants on the device)``."""
    if signals.dtype != torch.float32 or signals.ndim != 2 or not signals.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous float32 [B, L] tensor, "
                         f"got {signals.dtype} {tuple(signals.shape)}")
    dev = signals.device
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if lengths.shape != (signals.shape[0],):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({signals.shape[0]},)")
    F, nf = _frames_and_nf(signals, lengths, cfg, n_frames_cap)
    return lengths, F, nf, _fused_constants(cfg, dev)


def mfcc39_fused(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
                 n_frames_cap: int = None, norm: str = "utterance"):
    """Kernel K3 for a CUDA ``signals [B, L]`` (f32, contiguous); the
    plain version for a CPU tensor.  Returns ``([B, F, 39], nf [B])``.
    Any frame count: above ~1,967 frames the kernel keeps its cepstra and
    deltas in a device-memory scratch instead of shared memory."""
    if not signals.is_cuda:
        return mfcc39_fused_ref(signals, lengths, cfg, n_frames_cap, norm)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if not fused_supported(cfg, norm):
        raise ValueError(f"mfcc39 kernel does not implement {cfg} / norm={norm!r}")
    lengths, F, nf, c = _kernel_inputs(signals, lengths, cfg, n_frames_cap, "mfcc39")
    dev = signals.device
    b, L = signals.shape
    n_mels, n_ceps = c["dct_lift"].shape
    lib = load_library()
    out = torch.empty((b, F, 3 * n_ceps), dtype=torch.float32, device=dev)
    if b == 0:
        return out, nf
    # cepstra and first deltas too long for shared memory go to a
    # [B, 2, F, n_ceps] device-memory scratch
    scratch = None
    if lib.mfcc39_smem_bytes(F, n_mels, n_ceps) > lib.srt_smem_limit():
        scratch = torch.empty((b, 2, F, n_ceps), dtype=torch.float32, device=dev)
    ptr = [t.data_ptr() for t in (signals, lengths, nf, c["window"], c["mel_w"],
                                  c["mel_lo"], c["mel_hi"], c["dct_lift"], out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mfcc39_launch(*ptr, scratch.data_ptr() if scratch is not None else None,
                               b, L, F, cfg.frame_len, cfg.frame_step,
                               ctypes.c_float(cfg.effective_preemph), n_mels,
                               n_ceps, int(norm == "utterance"), stream)
    check(rc, "mfcc39 kernel")
    mfcc39_fused.launches += 1
    return out, nf


mfcc39_fused.launches = 0


def mfcc_fused(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
               n_frames_cap: int = None):
    """Kernel K12 for a CUDA ``signals [B, L]`` (f32, contiguous); the
    plain version for a CPU tensor.  Returns ``(ceps [B, F, n_ceps], nf
    [B])`` with ``F = 1 + max(0, (L - frame_len) // frame_step)`` (or the
    cap) and ``nf`` clamped to it; rows >= nf are zeros."""
    if not signals.is_cuda:
        return mfcc_fused_ref(signals, lengths, cfg, n_frames_cap)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if not fused_supported(cfg, "none"):
        raise ValueError(f"mfcc kernel does not implement {cfg}")
    lengths, F, nf, c = _kernel_inputs(signals, lengths, cfg, n_frames_cap, "mfcc")
    dev = signals.device
    b, L = signals.shape
    n_mels, n_ceps = c["dct_lift"].shape
    out = torch.empty((b, F, n_ceps), dtype=torch.float32, device=dev)
    if b == 0:
        return out, nf
    lib = load_library()
    ptr = [t.data_ptr() for t in (signals, lengths, nf, c["window"], c["mel_w"],
                                  c["mel_lo"], c["mel_hi"], c["dct_lift"], out)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mfcc_ceps_launch(*ptr, b, L, F, cfg.frame_len, cfg.frame_step,
                                  ctypes.c_float(cfg.effective_preemph), n_mels, n_ceps,
                                  stream)
    check(rc, "mfcc kernel")
    mfcc_fused.launches += 1
    return out, nf


mfcc_fused.launches = 0

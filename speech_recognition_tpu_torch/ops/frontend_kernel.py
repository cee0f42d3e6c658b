"""Fused MFCC frontends: kernels K12 (cepstra), K3 (MFCC-39) and K14
(the MFCC-39 tail), all in ``csrc/mfcc39.cu``, with their plain PyTorch
versions.

K12 is the counterpart of ``speech_recognition_tpu/ops/pallas_kernels.py``
``pallas_mfcc`` (the psf cepstra of ``ops/frontend.mfcc``): a
frame-parallel kernel, one warp per pair of frames, whose 512-point FFT
runs in registers and a per-warp shared-memory buffer.  K3 is the
counterpart of ``speech_recognition_tpu/ops/frontend_pallas.py``
(``mfcc39_pallas_batch``), with the XLA ``mfcc39`` semantics (``nf`` is
clamped to the frame capacity ``F``): K12's kernel into a ``[B, F,
n_ceps]`` intermediate, then K14, one CTA per utterance for the deltas
and the standardization.  The plain versions ``mfcc39_fused_ref``,
``mfcc_fused_ref`` and ``_stack39`` are the frontend's own
``mfcc39_batch``, ``_mfcc_batch`` (DFT bases as GEMMs) and tail.

``mfcc39_fused``, ``mfcc_fused`` and ``mfcc_tail`` run the plain version
for CPU tensors and launch the kernel for CUDA tensors;
``<wrapper>.launches`` counts launches (``mfcc39_fused`` its cepstra
launch, ``mfcc_tail`` K14's).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from speech_recognition_tpu_torch.config import FrontendConfig
from speech_recognition_tpu_torch.ops.frontend import (
    _frontend_constants,
    _mfcc_batch,
    _stack39,
    fused_supported,
    mfcc39_batch,
)

__all__ = ["mfcc39_fused", "mfcc39_fused_ref", "mfcc_fused", "mfcc_fused_ref", "mfcc_tail"]

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


def _launch_ceps(signals, lengths, cfg: FrontendConfig, n_frames_cap, what: str):
    """The checks K3 and K12 share, then the cepstra kernel's launch:
    returns ``(ceps [B, F, n_ceps], nf [B] int32)``, the frame counts
    computed by the kernel (as ``_frames_and_nf`` computes them)."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if signals.dtype != torch.float32 or signals.ndim != 2 or not signals.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous float32 [B, L] tensor, "
                         f"got {signals.dtype} {tuple(signals.shape)}")
    dev = signals.device
    b, L = signals.shape
    lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    if lengths.shape != (b,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({b},)")
    F = n_frames_cap or (1 + max(0, (L - cfg.frame_len) // cfg.frame_step))
    c = _fused_constants(cfg, dev)
    n_mels, n_ceps = c["dct_lift"].shape
    out = torch.empty((b, F, n_ceps), dtype=torch.float32, device=dev)
    nf = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out, nf
    ptr = [t.data_ptr() for t in (signals, lengths, nf, c["window"], c["mel_w"],
                                  c["mel_lo"], c["mel_hi"], c["dct_lift"], out)]
    with torch.cuda.device(dev):
        rc = load_library().mfcc_ceps_launch(
            *ptr, b, L, F, cfg.frame_len, cfg.frame_step, ctypes.c_float(cfg.effective_preemph),
            n_mels, n_ceps, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, f"{what} kernel")
    return out, nf


def mfcc39_fused(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
                 n_frames_cap: int = None, norm: str = "utterance"):
    """Kernel K3 for a CUDA ``signals [B, L]`` (f32, contiguous); the
    plain version for a CPU tensor.  Returns ``([B, F, 39], nf [B])``.
    Two launches, neither with a frame limit: the cepstra kernel (K12's)
    into a ``[B, F, n_ceps]`` intermediate, counted here, then K14
    (``mfcc_tail``, counted there)."""
    if not signals.is_cuda:
        return mfcc39_fused_ref(signals, lengths, cfg, n_frames_cap, norm)
    if not fused_supported(cfg, norm):
        raise ValueError(f"mfcc39 kernel does not implement {cfg} / norm={norm!r}")
    ceps, nf = _launch_ceps(signals, lengths, cfg, n_frames_cap, "mfcc39")
    if signals.shape[0]:
        mfcc39_fused.launches += 1
    return mfcc_tail(ceps, nf, norm), nf


mfcc39_fused.launches = 0


def mfcc_tail(ceps, nf, norm: str = "utterance"):
    """Kernel K14 for a CUDA ``ceps [B, F, n_ceps]`` (f32, contiguous;
    rows < ``nf [B]`` read); its plain version ``_stack39`` for a CPU
    tensor.  Returns ``[B, F, 3 n_ceps]``: cepstra, deltas and
    delta-deltas (one-sided end rows), standardized per utterance for
    ``norm="utterance"``, raw for ``"none"``; rows >= nf zeros."""
    if not ceps.is_cuda:
        return _stack39(ceps, nf, norm)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if norm not in ("utterance", "none"):
        raise ValueError(f"mfcc tail kernel does not implement norm={norm!r}")
    if ceps.dtype != torch.float32 or ceps.dim() != 3 or not ceps.is_contiguous():
        raise ValueError(f"mfcc tail kernel takes a contiguous float32 [B, F, C] tensor, "
                         f"got {ceps.dtype} {tuple(ceps.shape)}")
    b, F, n_ceps = ceps.shape
    dev = ceps.device
    if nf.device != dev or nf.dtype != torch.int32 or nf.shape != (b,):
        raise ValueError(f"nf must be an int32 [{b}] tensor on {dev}")
    out = torch.empty((b, F, 3 * n_ceps), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.mfcc_tail_launch(ceps.data_ptr(), nf.contiguous().data_ptr(), out.data_ptr(),
                                  b, F, n_ceps, int(norm == "utterance"),
                                  torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "mfcc tail kernel")
    mfcc_tail.launches += 1
    return out


mfcc_tail.launches = 0


def mfcc_fused(signals, lengths, cfg: FrontendConfig = FrontendConfig(),
               n_frames_cap: int = None):
    """Kernel K12 for a CUDA ``signals [B, L]`` (f32, contiguous); the
    plain version for a CPU tensor.  Returns ``(ceps [B, F, n_ceps], nf
    [B])`` with ``F = 1 + max(0, (L - frame_len) // frame_step)`` (or the
    cap) and ``nf`` clamped to it; rows >= nf are zeros."""
    if not signals.is_cuda:
        return mfcc_fused_ref(signals, lengths, cfg, n_frames_cap)
    if not fused_supported(cfg, "none"):
        raise ValueError(f"mfcc kernel does not implement {cfg}")
    out, nf = _launch_ceps(signals, lengths, cfg, n_frames_cap, "mfcc")
    if signals.shape[0]:
        mfcc_fused.launches += 1
    return out, nf


mfcc_fused.launches = 0

"""Live microphone capture (optional; needs pyaudio).

Counterpart of ``speech_recognition_tpu/data/capture.py``: a PyAudio
input stream polled in frame-size chunks, with the shared energy
endpointer (``data.endpoint.endpoint_signal``) run over everything so
far every quarter second until an utterance has both endpoints.  Without
pyaudio, importing this module works and :func:`record` raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from speech_recognition_tpu_torch.config import EndpointConfig
from speech_recognition_tpu_torch.data.endpoint import endpoint_signal
from speech_recognition_tpu_torch.data.wav import write_wav

try:  # optional hardware dependency
    import pyaudio  # type: ignore

    HAVE_PYAUDIO = True
except ImportError:
    pyaudio = None
    HAVE_PYAUDIO = False

__all__ = ["record", "HAVE_PYAUDIO"]


def record(file: Optional[str] = None, cfg: EndpointConfig = EndpointConfig(),
           max_record_time_s: float = 1000.0) -> np.ndarray:
    """Record one endpointed utterance from the default microphone.

    Returns the trimmed int16 samples and writes them to ``file`` if
    given."""
    if not HAVE_PYAUDIO:
        raise RuntimeError("pyaudio is not available in this environment; "
                           "use data.synthetic or wav files instead")

    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=cfg.sample_rate, input=True,
                     frames_per_buffer=cfg.samples_per_frame)
    chunks = []
    n_target = int(max_record_time_s * cfg.sample_rate)
    collected = 0
    try:
        while collected < n_target:
            data = stream.read(cfg.samples_per_frame, exception_on_overflow=False)
            chunk = np.frombuffer(data, dtype=np.int16)
            chunks.append(chunk)
            collected += len(chunk)
            if collected % (cfg.sample_rate // 4) < cfg.samples_per_frame:
                samples = np.concatenate(chunks)
                s, e = endpoint_signal(samples, cfg)
                if s is not None and e is not None and e < len(samples):
                    samples = samples[s:e]
                    if file:
                        write_wav(file, samples, cfg.sample_rate)
                    return samples
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()

    samples = np.concatenate(chunks) if chunks else np.zeros(0, np.int16)
    s, e = endpoint_signal(samples, cfg)
    if s is not None:
        samples = samples[s:e]
    if file:
        write_wav(file, samples, cfg.sample_rate)
    return samples

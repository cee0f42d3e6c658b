"""The native batched wav loader and the prefetching input pipeline.

Counterpart of ``speech_recognition_tpu/runtime/loader.py``.
``wav_loader.cc`` (the port's own copy) is compiled with ``g++`` at first
use into ``speech_recognition_tpu_torch/_build/`` (the directory of the
kernel library, listed in ``.gitignore``), named by the hash of the
source and flags, and bound with ``ctypes``.  A failed build raises with
g++'s output; there is no fallback.  ``data.wav.load_wav_batch`` is the
scipy reading of the same files, which the tests hold this loader to,
sample for sample.

``PrefetchWavBatches`` reads batch k + 1 on a worker thread while the
caller featurizes and decodes batch k on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import queue
import subprocess
import threading
from typing import List, Tuple

import numpy as np

from speech_recognition_tpu_torch.utils.build import BUILD_DIR

__all__ = ["load_wav_batch", "PrefetchWavBatches", "library_path"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "wav_loader.cc")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()


def library_path() -> str:
    """``_build/wav_loader_<hash>.so`` for the current source and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"wav_loader_{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """Build (if needed) and load the loader library."""
    out = library_path()
    with _lock:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"the native wav loader needs g++: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    p = ctypes.POINTER
    lib.load_wav_batch.restype = ctypes.c_int
    lib.load_wav_batch.argtypes = [p(ctypes.c_char_p), ctypes.c_int, p(ctypes.c_float),
                                   ctypes.c_int64, p(ctypes.c_int32), p(ctypes.c_int32),
                                   ctypes.c_int]
    return lib


def load_wav_batch(paths: List[str], cap_samples: int, n_threads: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read PCM16 wavs into a padded float32 batch with the native loader.

    Returns ``(samples [B, cap], lengths [B], rates [B])``: samples past
    each file's length are exact zeros, files longer than ``cap`` are
    truncated, a multi-channel file keeps its first channel.  Raises
    ``IOError`` naming the first file that does not parse."""
    b = len(paths)
    out = np.zeros((b, cap_samples), dtype=np.float32)
    lengths = np.zeros((b,), dtype=np.int32)
    rates = np.zeros((b,), dtype=np.int32)
    if b == 0:
        return out, lengths, rates
    lib = _library()
    arr = (ctypes.c_char_p * b)(*[os.fsencode(p) for p in paths])
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    err = lib.load_wav_batch(arr, b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             cap_samples,
                             lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                             rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_threads)
    if err:
        raise IOError(f"failed to parse wav file: {paths[err - 1]}")
    return out, lengths, rates


class PrefetchWavBatches:
    """Iterate padded wav batches with ``depth`` batches of lookahead.

    A worker thread runs the native loader for the next batches while the
    caller works on this one.  Yields ``(paths_chunk, samples [b, cap],
    lengths [b], rates [b])`` in order; an IO error surfaces in the
    consuming thread.  The worker stops when the iteration ends or is
    abandoned."""

    def __init__(self, paths: List[str], batch_size: int, cap_samples: int,
                 n_threads: int = 0, depth: int = 2):
        self.paths = list(paths)
        self.batch_size = int(batch_size)
        self.cap_samples = int(cap_samples)
        self.n_threads = n_threads
        self.depth = max(1, int(depth))

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        chunks = [self.paths[i:i + self.batch_size]
                  for i in range(0, len(self.paths), self.batch_size)]

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for chunk in chunks:
                    if not put(("ok", chunk, load_wav_batch(chunk, self.cap_samples,
                                                            self.n_threads))):
                        return
            except BaseException as e:  # surfaces in the consumer
                put(("err", e, None))
                return
            put(("done", None, None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                kind, a, b = q.get()
                if kind == "done":
                    break
                if kind == "err":
                    raise a
                yield (a, *b)
        finally:
            stop.set()
            t.join()

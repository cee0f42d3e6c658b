"""Timing and throughput accounting.

Counterpart of ``speech_recognition_tpu/utils/profiling.py``:

* :func:`timed`: the time of a call, per call; on a card from CUDA
  events around each call, with a synchronize as the fence (PyTorch
  returns before the device finishes), on the CPU from the host clock;
* :class:`Meter`: audio seconds per second and utterances per second by
  stage, with the JAX ``Meter``'s arithmetic;
* :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch

__all__ = ["timed", "Meter", "trace"]


def timed(fn: Callable, *args, warmup: int = 2, iters: int = 5, device=None, **kw):
    """Time ``fn(*args, **kw)``: ``warmup`` calls, then ``iters`` timed
    ones.  Returns ``(seconds_per_call, last_result)``, the median of the
    timed calls (one slow call does not move it).

    ``device`` (default: the current CUDA device where CUDA is available,
    else the CPU) says which clock: on a CUDA device each call sits
    between two CUDA events and the second is synchronized; on the CPU
    each call is timed by ``time.perf_counter``."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(iters):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.append(time.perf_counter() - t0)
    return statistics.median(times), out


@dataclass
class Meter:
    """Throughput accounting for audio pipelines."""

    frame_step_s: float = 0.01
    totals: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, seconds: float, n_frames: int = 0, n_utts: int = 0):
        t = self.totals
        t[f"{name}.seconds"] = t.get(f"{name}.seconds", 0.0) + seconds
        t[f"{name}.frames"] = t.get(f"{name}.frames", 0) + n_frames
        t[f"{name}.utts"] = t.get(f"{name}.utts", 0) + n_utts

    def report(self) -> Dict[str, float]:
        out = {}
        stages = {k.split(".")[0] for k in self.totals}
        for s in stages:
            sec = self.totals.get(f"{s}.seconds", 0.0)
            if sec <= 0:
                continue
            frames = self.totals.get(f"{s}.frames", 0)
            utts = self.totals.get(f"{s}.utts", 0)
            if frames:
                out[f"{s}.audio_s_per_s"] = frames * self.frame_step_s / sec
            if utts:
                out[f"{s}.utts_per_s"] = utts / sec
            out[f"{s}.seconds"] = sec
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` context over the CPU and, where there is one,
    the card; on exit it writes ``trace.json`` (a Chrome trace) into
    ``log_dir`` and yields the profiler for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

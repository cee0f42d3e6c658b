"""Bank checkpoints in the reference package's npz format.

Same archive layout as ``speech_recognition_tpu/utils/checkpoint.py``:
the four bank fields as float32 arrays, an optional ``_meta`` entry
holding JSON as uint8 bytes, and auxiliary arrays as ``x_<name>``
(returned in ``meta['arrays']``).  A bank saved by either package loads
in the other.  Embedded training writes one ``bank_NNNNN.npz`` per
iteration into its output directory and resumes from the newest.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from speech_recognition_tpu_torch.models.hmm import _FIELDS, HMMBank

__all__ = ["save_bank", "load_bank", "latest_iteration", "save_iteration"]


def save_bank(path: str, bank: HMMBank, meta: Optional[dict] = None,
              arrays: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = {f: getattr(bank, f).detach().cpu().numpy() for f in _FIELDS}
    if meta:
        out["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    for k, v in (arrays or {}).items():
        out[f"x_{k}"] = np.asarray(v)
    np.savez(path, **out)


def load_bank(path: str) -> Tuple[HMMBank, dict]:
    """Returns ``(bank on the CPU, meta)``; move it with ``bank.to(dev)``."""
    with np.load(path) as z:
        bank = HMMBank.from_numpy(*[z[f] for f in _FIELDS])
        meta = {}
        if "_meta" in z:
            meta = json.loads(bytes(z["_meta"]).decode())
        extras = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
        if extras:
            meta["arrays"] = extras
    return bank, meta


def save_iteration(out_dir: str, iteration: int, bank: HMMBank, meta: Optional[dict] = None,
                   arrays: Optional[dict] = None) -> str:
    """Per-iteration checkpoint ``<out_dir>/bank_<iteration:05d>.npz``;
    ``meta`` gains the ``iteration``."""
    path = os.path.join(out_dir, f"bank_{iteration:05d}.npz")
    save_bank(path, bank, {**(meta or {}), "iteration": iteration}, arrays)
    return path


def latest_iteration(out_dir: str) -> Tuple[Optional[int], Optional[str]]:
    """``(iteration, path)`` of the newest ``bank_NNNNN.npz`` in
    ``out_dir``, or ``(None, None)``."""
    if not os.path.isdir(out_dir):
        return None, None
    best = None
    for f in os.listdir(out_dir):
        if f.startswith("bank_") and f.endswith(".npz"):
            try:
                it = int(f[5:10])
            except ValueError:
                continue
            if best is None or it > best[0]:
                best = (it, os.path.join(out_dir, f))
    return best if best else (None, None)

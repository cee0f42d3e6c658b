"""Run one gloo world of worker processes for the port's multi-process
CPU tests (``tests/torch_parallel_worker.py``).

The world starts once per test module: spawning a process and importing
torch takes seconds, so every case of a module runs in the same world.
Each worker joins through a ``FileStore`` in the module's temporary
directory (no TCP port, so concurrent test workers cannot collide), runs
its suite with one thread, and writes ``out_<rank>.npz``.  A worker that
fails (or a world that outlives its timeout) fails the caller, and the
other workers are killed.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"


def run_world(suite: str, workdir, world: int = 4, timeout: float = 300.0):
    """Run ``suite`` on ``world`` gloo ranks with ``workdir/inputs.npz``;
    returns each rank's outputs (dicts of arrays), rank order."""
    workdir = pathlib.Path(workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    logs = [open(workdir / f"log_{r}.txt", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), suite, str(r), str(world),
                               str(workdir)], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=str(REPO)) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if failed:
        raise RuntimeError(f"{suite}: ranks {failed} failed or timed out:\n"
                           + "\n".join(f"--- rank {r} ---\n{texts[r][-4000:]}" for r in failed))
    return [dict(np.load(workdir / f"out_{r}.npz")) for r in range(world)]

#!/usr/bin/env python3
"""Time the mixture-fit kernels K24 (k-means) and K25 (EM),
``csrc/gmm_fit.cu``, on one GPU, against an older tree and against the
design they replaced.

    python3 scripts/exp_r26_gmm_fit.py [--root DIR] [--tag NAME] [--inputs FILE]
                                       [--turns DIR] [--phases]

Three shapes, each a K24 and a K25 call recorded from the port's own
training on the card (``chip_smoke.recording`` around
``train.isolated.kmeans_batch`` / ``em_fit_batch``): the synthetic corpus
of ``chip_smoke.py`` 6b (``cli synth --n-train 20 --n-test 5
--n-continuous 200``), ``isolated_train --silence --device cuda``, then
one ``continuous_train`` iteration from that bank.

- ``digit 0, level 2``: ``fit_hmm``'s second split level of the first
  digit (5 states of ~110-300 frames in a buffer of ~1,200, D 39, k = M
  = 4);
- ``planted 8,000``: ``chip_smoke.planted_fits(40, (8000, 300, 40))``, the
  first fit past the frames a CTA stages in shared memory, K25 from the
  plain k-means' result;
- ``continuous refit``: ``continuous_train``'s second split level (the
  states that got frames from ``align_batch`` of the corpus with the
  cuda-trained bank, over every frame of it, as
  ``train/continuous.py`` forms the masks).

Through the public wrappers (so any tree since the kernels exist runs
them): CUDA-event medians (ms), device times (torch.profiler,
``chip_smoke.device_ms``), the host's time to enqueue a call (a mean of
20, no synchronization between) and the iterations a fit.  ``--phases`` adds
each fit's counters, ``[F, 8]``: iterations, then thread 0's clock64
cycles by phase (compaction and staging, weights, distances or
responsibilities, statistics, update and stop, K24's last pass) and the
whole fit's, for this tree's kernels (``ops.gmm_fit_kernels.launch_*(...,
trace=)``, where the tree has it) and for the design they replaced
(``scripts/exp_r26_parent_gmm_fit.cu``, built here with nvcc into a
library of its own).  ``--root`` imports the port and ``chip_smoke``
from DIR; ``--turns DIR`` records the inputs once with this tree into a
temporary file, then runs this script on DIR, here, here, DIR (one
process each, ``--inputs`` that file) and prints their lines.
``--accuracy`` (alone): one iteration of K24 and K25 on
``chip_smoke.py``'s planted fits at ``fit_hmm``'s shape, the largest difference of each
output from the plain version run in float64 on the card, for this tree's
kernels, the replaced design's and the float32 plain version itself.
``--lab``: the bytes one SM's bulk copies bring from L2 a cycle (one CTA
streaming 44 KB tiles of an L2-resident buffer through a ring of 2 or 4
stages, an mbarrier a stage: ``utils/roofline.SM_BULK_BYTES_PER_CYCLE``),
and the registers and spills ptxas reports for the kernels' instances.
Prints one JSON line with the card's name and power limit.
"""

import argparse
import contextlib
import ctypes
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT_SRC = os.path.join(HERE, "scripts", "exp_r26_parent_gmm_fit.cu")
SHAPES = ("digit 0, level 2", "planted 8,000", "continuous refit")
LAB = r'''
#include "common.cuh"

// one CTA: thread 0 streams `reps` tiles of `bytes` (cycling over n_tiles
// tiles of src) through a ring of `stages` shared-memory stages by bulk
// copies; every thread waits for a tile, reads a float of it, and a
// barrier frees its stage for the tile `stages` on
__global__ void bulk_stream(const float* src, int n_tiles, int bytes, int stages, int reps,
                            long long* out) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) unsigned long long bars[8];
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  const int fl = bytes / 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long c0 = clock64();
  if (threadIdx.x == 0)
    for (int v = 0; v < stages; ++v) {
      mbar_arrive_expect(bar0 + 8u * v, bytes);
      bulk_copy((unsigned)__cvta_generic_to_shared(ring + v * fl), src + (v % n_tiles) * fl,
                bytes, bar0 + 8u * v);
    }
  float acc = 0.f;
  for (int v = 0; v < reps; ++v) {
    const int st = v % stages;
    mbar_wait(bar0 + 8u * st, (unsigned)(v / stages) & 1u);
    acc += ring[st * fl + threadIdx.x];
    __syncthreads();
    if (threadIdx.x == 0 && v + stages < reps) {
      const int w = v + stages;
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive_expect(bar0 + 8u * st, bytes);
      bulk_copy((unsigned)__cvta_generic_to_shared(ring + st * fl), src + (w % n_tiles) * fl,
                bytes, bar0 + 8u * st);
    }
  }
  const long long c1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)acc;
  }
}

extern "C" int lab_bulk(const float* src, int n_tiles, int bytes, int stages, int reps,
                        long long* out) {
  const int smem = stages * bytes;
  cudaError_t e = cudaFuncSetAttribute(bulk_stream, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return (int)e;
  bulk_stream<<<1, 512, smem>>>(src, n_tiles, bytes, stages, reps, out);
  return (int)cudaGetLastError();
}
'''
PHASES = ("iterations", "compaction and staging", "weights", "distances or responsibilities",
          "statistics", "update and stop", "last pass", "whole fit")


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def make_inputs(dev, path: str) -> None:
    """Record the three shapes' K24 and K25 calls (see the head of the
    file) and save them, on the CPU, to ``path``."""
    import importlib

    import torch

    from chip_smoke import planted_fits, recording
    from speech_recognition_tpu_torch import cli
    from speech_recognition_tpu_torch.config import FrontendConfig, HMMConfig, TrainConfig
    from speech_recognition_tpu_torch.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank

    iso = importlib.import_module("speech_recognition_tpu_torch.train.isolated")
    cont = importlib.import_module("speech_recognition_tpu_torch.train.continuous")
    tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")

    def run(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)

    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        tr_dir = os.path.join(corpus, "train")
        run(["synth", "-o", corpus, "--n-train", "20", "--n-test", "5", "--n-continuous",
             "200"])
        bank_path = os.path.join(tmp, "bank.npz")
        with recording(iso, "kmeans_batch", []) as km, recording(iso, "em_fit_batch", []) as em:
            run(["isolated_train", "-i", tr_dir, "-o", bank_path, "--silence", "--device",
                 "cuda"])
        calls["iso"] = (km, em)
        # continuous_train's refit: the corpus's transcribed files aligned
        # with the cuda-trained bank, one iteration
        bank, meta = load_bank(bank_path)
        files = [f for f in sorted(glob.glob(os.path.join(tr_dir, "*.wav")))
                 if transcript_from_filename(os.path.basename(f))]
        labels = [labels_from_transcript(transcript_from_filename(os.path.basename(f)))
                  for f in files]
        feats, nf = cli._featurize_files(files, FrontendConfig(), 120000, dev,
                                         norm=cli._norm_from_meta(meta)[0],
                                         cmvn=cli._norm_from_meta(meta)[1])
        feats = feats[:, : int(nf.max())].contiguous()
        with recording(iso, "kmeans_batch", []) as km, recording(iso, "em_fit_batch", []) as em:
            cont.continuous_train(bank.to(dev), feats, nf, labels,
                                  hmm_cfg=HMMConfig(n_states=bank.n_states, n_mix=bank.n_mix),
                                  train_cfg=TrainConfig(continuous_max_iters=1))
        calls["cont"] = (km, em)
    x, masks, c0, init = planted_fits(40, (8000, 300, 40), dev)
    _, m0, v0, cnt = tkm.kmeans_batch_ref(x, masks, c0, 4, init)
    w0 = cnt / masks.sum(1, keepdim=True).clamp(min=1).float()
    shapes = {
        SHAPES[0]: {"K24": calls["iso"][0][1], "K25": calls["iso"][1][1]},
        SHAPES[1]: {"K24": ((x, masks, c0, 4, init), {"disjoint": True}),
                    "K25": ((x, masks, m0, v0, w0), {"disjoint": True})},
        SHAPES[2]: {"K24": calls["cont"][0][-1], "K25": calls["cont"][1][-1]},
    }

    def cpu(a):
        return a.cpu() if torch.is_tensor(a) else a

    torch.save({s: {k: (tuple(cpu(a) for a in args), kw) for k, (args, kw) in v.items()}
                for s, v in shapes.items()}, path)


def load_inputs(path: str, dev) -> dict:
    import torch

    raw = torch.load(path)
    return {s: {k: (tuple(a.to(dev) if torch.is_tensor(a) else a for a in args), kw)
                for k, (args, kw) in v.items()} for s, v in raw.items()}


def describe(inputs) -> dict:
    out = {}
    for s, v in inputs.items():
        args = v["K24"][0]
        out[s] = {"fits": int(args[1].shape[0]), "buffer": list(args[0].shape),
                  "k": int(args[3]), "frames a fit": args[1].sum(1).tolist()}
    return out


def public_times(dev, inputs) -> dict:
    """K24's and K25's event and device ms through the wrappers, and the
    iterations of each fit."""
    import importlib

    import torch

    from chip_smoke import cuda_ms, device_ms

    tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")
    tem = importlib.import_module("speech_recognition_tpu_torch.train.em")
    out = {}
    for s, v in inputs.items():
        args, kw = v["K24"]
        its = torch.zeros(args[1].shape[0], dtype=torch.int32, device=dev)
        tkm.kmeans_batch(*args, **kw, iters=its)
        args25, kw25 = v["K25"]
        reps = 3 if s == SHAPES[2] else 10

        def host_ms(fn, n=20):
            """Host time a call takes to enqueue (no synchronization)."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            return (t1 - t0) / n * 1e3

        out[s] = {
            "K24 ms": cuda_ms(lambda: tkm.kmeans_batch(*args, **kw), reps=reps),
            "K24 device ms": device_ms(lambda: tkm.kmeans_batch(*args, **kw), reps=3,
                                       what=f"K24 {s}"),
            "K24 iterations": its.tolist(),
            "K25 ms": cuda_ms(lambda: tem.em_fit_batch(*args25, **kw25), reps=reps),
            "K25 device ms": device_ms(lambda: tem.em_fit_batch(*args25, **kw25), reps=3,
                                       what=f"K25 {s}"),
            "K25 iterations": tem.em_fit_batch(*args25, **kw25)[3].tolist(),
            "K24 host ms": host_ms(lambda: tkm.kmeans_batch(*args, **kw)),
            "K25 host ms": host_ms(lambda: tem.em_fit_batch(*args25, **kw25)),
        }
        print(f"[exp_r26] {s}: {json.dumps(out[s])}", file=sys.stderr, flush=True)
    return out


# ---- the design the kernels replaced, built from its lab copy ---------------


def _parent_param_floats(m: int, d: int) -> int:
    q = m * (d + 1)
    return m * (2 * d + 1) + 2 * m * d + 2 * m + d + 2 * (512 // min(q, 512)) * q


def _parent_plan(n: int, d: int, m: int, em: bool):
    """That design's launch plan: parameters in shared memory where they
    fit, then ``cap`` staged frames of ``d | 1`` floats and their values."""
    limit = 227 * 1024 - 4 * 16
    fixed = 4 * _parent_param_floats(m, d)
    per_frame = 4 * ((d | 1) + (m if em else 1))
    shared = fixed <= limit
    cap = min(n, (limit - (fixed if shared else 0)) // per_frame)
    return shared, cap, (fixed if shared else 0) + cap * per_frame


def parent_library(out_dir: str):
    """nvcc the lab copy into ``out_dir`` and load it (ptxas lines kept)."""
    from speech_recognition_tpu_torch.utils import build

    so = os.path.join(out_dir, "exp_r26_parent_gmm_fit.so")
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-shared", "-o", so,
           PARENT_SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {PARENT_SRC}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.parent_kmeans_fit_launch.argtypes = [p] * 12 + [i] * 6 + [f, f] + [i] * 3 + [q, p, p]
    lib.parent_em_fit_launch.argtypes = [p] * 12 + [i] * 6 + [f] * 4 + [i, i, q, p, p]
    lib.parent_kmeans_fit_launch.restype = lib.parent_em_fit_launch.restype = ctypes.c_int
    return lib


def parent_run(lib, name, args, kw, trace):
    """One launch of the replaced design's K24 or K25 on a recorded call,
    its counters into ``trace`` (int64 ``[F, 8]``)."""
    import math

    import torch

    x, masks = args[0].contiguous(), args[1].contiguous()
    f, n = masks.shape
    d = x.shape[1]
    dev = x.device
    disjoint = bool(kw.get("disjoint", False))
    rows = n if disjoint else f * n
    st = torch.cuda.current_stream(dev).cuda_stream
    if name == "K24":
        c0, k, init = args[2].contiguous(), int(args[3]), args[4].contiguous()
        shared, cap, smem = _parent_plan(n, d, k, em=False)
        idx = torch.empty(max(rows, 1), dtype=torch.int32, device=dev)
        vals = torch.empty(rows if cap < n else 1, device=dev)
        params = torch.empty(1 if shared else f * _parent_param_floats(k, d), device=dev)
        assign = torch.empty((f, n), dtype=torch.int64, device=dev)
        cent = torch.empty((f, k, d), device=dev)
        var, counts = torch.empty_like(cent), torch.empty((f, k), device=dev)
        rc = lib.parent_kmeans_fit_launch(
            x.data_ptr(), masks.data_ptr(), c0.data_ptr(), init.data_ptr(), assign.data_ptr(),
            cent.data_ptr(), var.data_ptr(), counts.data_ptr(), None, idx.data_ptr(),
            vals.data_ptr(), params.data_ptr(), f, n, d, k, int(disjoint),
            int(kw.get("max_iters", 100)), float(kw.get("var_floor", 1e-6)),
            d * math.log(2 * math.pi), int(kw.get("shared_cov_quirk", False)), cap,
            int(shared), smem, st, trace.data_ptr())
        out = (assign, cent, var, counts)
    else:
        m0, v0, w0 = (a.contiguous() for a in args[2:5])
        m = m0.shape[1]
        shared, cap, smem = _parent_plan(n, d, m, em=True)
        idx = torch.empty(max(rows, 1), dtype=torch.int32, device=dev)
        vals = torch.empty(rows * m if cap < n else 1, device=dev)
        params = torch.empty(1 if shared else f * _parent_param_floats(m, d), device=dev)
        means = torch.empty((f, m, d), device=dev)
        var, wts = torch.empty_like(means), torch.empty((f, m), device=dev)
        n_it = torch.empty(f, dtype=torch.int32, device=dev)
        rc = lib.parent_em_fit_launch(
            x.data_ptr(), masks.data_ptr(), m0.data_ptr(), v0.data_ptr(), w0.data_ptr(),
            means.data_ptr(), var.data_ptr(), wts.data_ptr(), n_it.data_ptr(), idx.data_ptr(),
            vals.data_ptr(), params.data_ptr(), f, n, d, m, int(disjoint),
            int(kw.get("max_iters", 100)), float(kw.get("rtol", 1e-5)),
            float(kw.get("atol", 1e-8)), float(kw.get("var_floor", 1e-6)),
            d * math.log(2 * math.pi), cap, int(shared), smem, st, trace.data_ptr())
        out = (means, var, wts, n_it)
    if rc:
        raise RuntimeError(f"the replaced design's {name} launch failed: CUDA error {rc}")
    return out


def summarize(trace) -> dict:
    """A launch's counters: each phase's cycles summed over the fits and
    per iteration of the slowest fit, and that fit's iterations."""
    rows = trace.cpu().tolist()
    slow = max(rows, key=lambda r: r[7])
    its = max(slow[0], 1)
    return {"slowest fit": {ph: slow[j] for j, ph in enumerate(PHASES)},
            "slowest fit, cycles an iteration": {ph: round(slow[j] / its, 1)
                                                 for j, ph in enumerate(PHASES) if j},
            "all fits, cycles": {ph: sum(r[j] for r in rows) for j, ph in enumerate(PHASES)}}


def change_phases(dev, inputs) -> dict:
    """This tree's counters at each shape (``launch_*(..., trace=)``), or
    None where the tree's launches take no counter."""
    import importlib
    import inspect

    import torch

    gfk = importlib.import_module("speech_recognition_tpu_torch.ops.gmm_fit_kernels")
    if "trace" not in inspect.signature(gfk.launch_kmeans).parameters:
        return None
    out = {}
    for s, v in inputs.items():
        out[s] = {}
        for name in ("K24", "K25"):
            args, kw = v[name]
            trace = torch.zeros((args[1].shape[0], 8), dtype=torch.int64, device=dev)
            if name == "K24":
                gfk.launch_kmeans(*args, kw.get("max_iters", 100),
                                  kw.get("shared_cov_quirk", False), kw.get("var_floor", 1e-6),
                                  None, kw.get("disjoint", False), trace=trace)
            else:
                gfk.launch_em(*args, kw.get("max_iters", 100), kw.get("rtol", 1e-5),
                              kw.get("atol", 1e-8), kw.get("var_floor", 1e-6),
                              kw.get("disjoint", False), trace=trace)
            torch.cuda.synchronize()
            out[s][name] = summarize(trace)
    return out


def parent_phases(dev, inputs, lib) -> dict:
    """The replaced design's counters at each shape, and whether its
    outputs equal this tree's wrappers' (informational: the two sum in
    other orders)."""
    import importlib

    import torch

    tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")
    tem = importlib.import_module("speech_recognition_tpu_torch.train.em")
    out = {}
    for s, v in inputs.items():
        out[s] = {}
        for name in ("K24", "K25"):
            args, kw = v[name]
            trace = torch.zeros((args[1].shape[0], 8), dtype=torch.int64, device=dev)
            got = parent_run(lib, name, args, kw, trace)
            now = (tkm.kmeans_batch if name == "K24" else tem.em_fit_batch)(*args, **kw)
            torch.cuda.synchronize()
            out[s][name] = summarize(trace)
            exact = 0 if name == "K24" else 3
            out[s][name]["same " + ("assignments" if name == "K24" else "iterations")] = \
                bool(torch.equal(got[exact], now[exact]))
    return out


def lab(dev, out_dir: str) -> dict:
    """One SM's bulk-copy rate from L2 (bytes a cycle), and ptxas's report
    for the kernels' instances (registers, spills)."""
    import torch

    from speech_recognition_tpu_torch.utils import build

    src, so = os.path.join(out_dir, "lab.cu"), os.path.join(out_dir, "lab.so")
    with open(src, "w") as f:
        f.write(LAB)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-shared",
                           "-o", so, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lab_bulk.argtypes = [p, i, i, i, i, p]
    tile = 256 * 44 * 4  # a ring tile at D = 39
    buf = torch.randn(64 * tile // 4, device=dev)  # 2.9 MB: L2-resident after a lap
    res = torch.zeros(2, dtype=torch.int64, device=dev)
    out = {}
    for stages in (2, 4):
        best = 0.0
        for _ in range(3):
            if lib.lab_bulk(buf.data_ptr(), 64, tile, stages, 2000, res.data_ptr()):
                raise RuntimeError("lab launch failed")
            torch.cuda.synchronize()
            best = max(best, 2000 * tile / float(res[0]))
        out[f"bulk bytes a cycle, {stages} stages of {tile} B"] = best
    with open(build.library_path() + ".log") as f:
        lines = f.read().splitlines()
    out["ptxas"] = [" ".join(x.strip() for x in lines[j:j + 4]) for j, ln in enumerate(lines)
                    if "gmm_fit_kernel" in ln and "Compiling entry" in ln]
    return out


def accuracy(dev, out_dir: str) -> dict:
    """One iteration's largest differences from the float64 plain version
    (see the head of the file)."""
    import importlib

    import torch

    from chip_smoke import planted_fits

    tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")
    tem = importlib.import_module("speech_recognition_tpu_torch.train.em")
    lib = parent_library(out_dir)
    x, masks, c0, init = planted_fits(40, (260, 240, 300, 180, 220), dev)
    _, m0, v0, cnt = tkm.kmeans_batch_ref(x, masks, c0, 4, init)
    w0 = cnt / masks.sum(1, keepdim=True).clamp(min=1).float()
    cases = {"K24": (tkm.kmeans_batch, tkm.kmeans_batch_ref, (x, masks, c0, 4, init), (1, 2)),
             "K25": (tem.em_fit_batch, tem.em_fit_batch_ref, (x, masks, m0, v0, w0), (0, 1, 2))}
    out = {}
    for name, (kernel, plain, args, close) in cases.items():
        kw = dict(max_iters=1, disjoint=True)
        args64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                       for a in args)
        truth = plain(*args64, **kw)
        trace = torch.zeros((masks.shape[0], 8), dtype=torch.int64, device=dev)
        runs = {"change": kernel(*args, **kw), "float32 plain": plain(*args, **kw),
                "replaced design": parent_run(lib, name, args, kw, trace)}
        out[name] = {who: [float((got[j].double() - truth[j]).abs().max()) for j in close]
                     for who, got in runs.items()}
        out[name]["change vs float32 plain"] = [
            float((runs["change"][j] - runs["float32 plain"][j]).abs().max()) for j in close]
        out[name]["replaced design vs float32 plain"] = [
            float((runs["replaced design"][j] - runs["float32 plain"][j]).abs().max())
            for j in close]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="change")
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--turns", default=None)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--lab", action="store_true")
    ap.add_argument("--accuracy", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("exp_r26: needs a CUDA device", file=sys.stderr)
        return 1
    import speech_recognition_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r26: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        if args.accuracy:  # alone: no recorded inputs
            print(json.dumps({"card": card_name(), "accuracy": accuracy(dev, tmp)}))
            return 0
        path = args.inputs or os.path.join(tmp, "inputs.pt")
        if not args.inputs:
            make_inputs(dev, path)
        if args.turns:
            lines = []
            for tree, tag in ((args.turns, "parent"), (HERE, "change"), (HERE, "change"),
                              (args.turns, "parent")):
                proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                                       tree, "--tag", tag, "--inputs", path],
                                      capture_output=True, text=True)
                sys.stderr.write(proc.stderr[-3000:])
                if proc.returncode:
                    return proc.returncode
                lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(json.dumps({"card": card_name(), "turns": lines}))
            return 0
        inputs = load_inputs(path, dev)
        out = {"tag": args.tag, "root": root, "card": card_name(), "shapes": describe(inputs),
               "ms": public_times(dev, inputs)}
        if args.phases:
            out["phases"] = change_phases(dev, inputs)
            out["replaced design's phases"] = parent_phases(dev, inputs, parent_library(tmp))
        if args.lab:
            out["lab"] = lab(dev, tmp)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

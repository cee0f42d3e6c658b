#!/usr/bin/env python3
"""Where the bank emission kernel K13 (csrc/bank_emission.cu) spends its
time, on one GPU: the kernel as it is, and copies of its source with one
part taken out, each compiled by nvcc into a library of its own and
launched at the main-path shape (512 x 500 frames, chip_smoke.py's
11 x 5-state x 4-mixture x 39-dim bank):

* ``as is``: the kernel (checked against its plain version);
* ``FMAs only``: the product's shared-memory loads after the first step
  taken out (every step reuses the first step's weights and features);
* ``loads only``: the FMAs replaced by one add per loaded value;
* ``no logsumexp``: ``__expf`` and ``__logf`` replaced by the identity;
* ``no stores``: the plane written only where a sum is negative (never);
* with ``--old PATH``: another version of the source (the parent's
  kernel, whose wrapper passed ``[A, U, Mp]`` padded weights and no warp
  count), timed beside the others;
* the kernel as it is at 4-8 warps per CTA and 1 or 2 CTAs per SM (the
  wrapper picks 7 warps at U = 55 and 2 CTAs per SM).

Times are CUDA-event medians of the launch alone (no wrapper), printed
with the card's name and power limit, with ptxas' registers and spills.

    python3 scripts/exp_r8_k13_variants.py [--old path/to/bank_emission.cu]
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk  # noqa: E402
from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights  # noqa: E402
from speech_recognition_tpu_torch.utils.build import CSRC_DIR, NVCC_FLAGS, _nvcc  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "scripts"))
from exp_r8_emission import bank  # noqa: E402

FMA_LOOP = """#pragma unroll
          for (int m = 0; m < 2 * kMixT; ++m)
#pragma unroll
            for (int j = 0; j < kColsT; ++j) acc[m][j] = fmaf(wm[m], xj[j], acc[m][j]);"""
NEXT_LOADS = """            if (a < A) {
              wp += wstep;
              xp += kCols;
              na = lds4(wp);
              nb = lds4(wp + dw);
              n0v = lds4(xp);
              n1v = lds4(xp + 32);
            }"""
STORE = "if (col < N) out[(size_t)col * U + uu]"
PATCHES = {
    "as is": [],
    "FMAs only": [(NEXT_LOADS, "")],
    "loads only": [(FMA_LOOP, """#pragma unroll
          for (int m = 0; m < 2 * kMixT; ++m) acc[m][0] += wm[m];
#pragma unroll
          for (int j = 0; j < kColsT; ++j) acc[0][j] += xj[j];""")],
    "no logsumexp": [('#include "common.cuh"\n',
                      '#include "common.cuh"\n#define __expf(x) (x)\n#define __logf(x) (x)\n')],
    "no stores": [(STORE, "if (col < N && sum[s2][j] < 0.f) out[(size_t)col * U + uu]")],
}


def build(name, src, tmp):
    path = os.path.join(tmp, f"{len(os.listdir(tmp))}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-shared", "-I", CSRC_DIR, "-o", so, path]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def launch_ms(launch, reps=15):
    """``(median, min)`` CUDA-event ms of ``launch()`` over ``reps`` runs."""
    ts = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        launch()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts), min(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="another bank_emission.cu to time beside this one")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    with open(os.path.join(CSRC_DIR, "bank_emission.cu")) as f:
        base = f.read()
    tmp = tempfile.mkdtemp(prefix="k13_variants_")
    jobs = {}
    for name, patches in PATCHES.items():
        src = base
        for old, new in patches:
            if src.count(old) != 1:
                sys.exit(f"variant {name!r}: the patch does not match the source once")
            src = src.replace(old, new)
        jobs[name] = build(name, src, tmp)
    if args.old:
        with open(args.old) as f:
            jobs["old source"] = build("old source", f.read(), tmp)
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: " + " | ".join(regs), flush=True)
        libs[name] = ctypes.CDLL(so)

    dev = torch.device("cuda", 0)
    b5 = bank(5, 0).to(dev)
    w, lw = gmm_emission_weights(*b5.flat_states())
    u, m, a = w.shape
    B, T = 512, 500
    n = B * T
    xa = augment_dtb(torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, 39))
                                      .astype(np.float32)).to(dev))
    want = vk.bank_emission_ref(xa, w, lw)
    out = torch.empty((T, B, u), device=dev)
    wp = torch.zeros((a, u, -(-m // 4) * 4), device=dev)  # the old source's weight layout
    wp[:, :, :m] = w.permute(2, 0, 1)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        fn = lib.bank_emission_launch
        fn.restype = ctypes.c_int
        if name == "old source":
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
            launch = (lambda fn=fn: fn(xa.data_ptr(), wp.data_ptr(), lw.data_ptr(),
                                       out.data_ptr(), a, n, u, m, 1, 2 * n_sm, stream))
        else:
            fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
            launch = (lambda fn=fn: fn(xa.data_ptr(), w.data_ptr(), lw.data_ptr(),
                                       out.data_ptr(), a, n, u, m, 1, vk._emission_warps(u),
                                       2 * n_sm, stream))
        rc = launch()
        torch.cuda.synchronize()
        if rc:
            sys.exit(f"{name}: launch failed with CUDA error {rc}")
        check = ""
        if name in ("as is", "old source"):
            ok = torch.allclose(out.permute(2, 0, 1), want, rtol=1e-5, atol=1e-4)
            if not ok:
                sys.exit(f"{name}: disagrees with the plain version")
            check = ", == plain (rtol 1e-5, atol 1e-4)"
        med, low = launch_ms(launch)
        print(f"K13 {name}: {med:.4f} ms median, {low:.4f} min of 15 launches{check} "
              f"({card})", flush=True)
    fn = libs["as is"].bank_emission_launch
    for warps in range(4, 9):
        for per_sm in (1, 2):
            med, _ = launch_ms(lambda: fn(xa.data_ptr(), w.data_ptr(), lw.data_ptr(),
                                          out.data_ptr(), a, n, u, m, 1, warps, per_sm * n_sm,
                                          stream), reps=9)
            print(f"K13 as is, {warps} warps per CTA, {per_sm} CTA(s) per SM: {med:.4f} ms "
                  f"median ({card})", flush=True)


if __name__ == "__main__":
    main()

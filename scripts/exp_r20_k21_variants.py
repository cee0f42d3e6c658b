#!/usr/bin/env python3
"""Time K21 (csrc/dense_backtrace.cu) with one part changed at a time, to
find what a frame of the walk costs, on one GPU.

    python3 scripts/exp_r20_k21_variants.py

Each variant is the kernel source with a textual change, built by nvcc
(the port's flags) into its own library under
``speech_recognition_tpu_torch/_build/exp_r20/`` and launched through its
``dense_backtrace_launch`` on K11's planes of the sausage (64 x 500 x 385),
the isolated shape (5,632 x 500 x 5), the transcript graphs and the tie
batch (``exp_r20_dense_backtrace.dense_walks``), in the form and sizes
``dense_backtrace_plan`` picks (window), in the window form at 32 frames
x every state (the block layout) where that differs, and in the chain
form:

  as is                  the kernel
  rows by cp.async       the row layout's rows copied 16 bytes a lane with
                         cp.async (landing on the stage's mbarrier), not
                         as one bulk copy (TMA) a row
  block by bulk copies   every block-layout segment as one bulk copy a
                         plane (the kernel: from 4 KB a plane)
  block by cp.async      every block-layout segment 16 bytes a lane by
                         cp.async (the kernel: below 4 KB a plane)
  every frame in full    no fast loop: every frame through the window
                         check and the eps chain's loop
  no load ahead          the window form loads only the window it waits for

Times are device ms a call from CUDA events around 10 queued calls behind
a sleep kernel (``chip_smoke.queued_ms``).  Prints one JSON line with the
card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each change: (text, replacement, occurrences)
FULL_FRAMES = [  # every frame through the full path (window check, eps chain)
    ("        if (active && (!in || (eps_depth > 0 && e >= 0))) break;",
     "        if (active) break;", 1),
]
ROWS_CP_ASYNC = [  # rows copied 16 bytes a lane with cp.async, not a bulk copy a row
    (
        ('    } else {\n'
         '      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");\n'
         '      unsigned mine = 0;\n'
         '      for (int f = l; f < rows; f += lanes) {\n'
         '        const long long t = t_lo + f;\n'
         '        mine += 16u * chunks((uintptr_t)(bp + t * bp_t + lo), R);\n'
         '        if (plane) mine += 16u * chunks((uintptr_t)(ep + t * ep_t + lo), R);\n'
         '      }\n'
         '      mbar_arrive_expect(bar, mine);\n'
         '      for (int f = l; f < rows; f += lanes) {\n'
         '        const long long t = t_lo + f;\n'
         '        const unsigned d = dst + 4u * (unsigned)(f * rstride);\n'
         '        const uintptr_t ub = (uintptr_t)(bp + t * bp_t + lo);\n'
         '        bulk_copy(d, (const void*)(ub & ~(uintptr_t)15), 16u * chunks(ub, R), bar);\n'
         '        if (plane) {\n'
         '          const uintptr_t ue = (uintptr_t)(ep + t * ep_t + lo);\n'
         '          bulk_copy(d + 4u * plane, (const void*)(ue & ~(uintptr_t)15), 16u * chunks(ue, R),\n'
         '                    bar);\n'
         '        }\n'
         '      }\n'
         '      words += __reduce_add_sync(mask, mine) / 4;\n'
         '    }\n'),
        ('    } else {\n'
         '      for (int f = 0; f < rows; ++f) {\n'
         '        const long long t = t_lo + f;\n'
         '        const unsigned d = dst + 4u * (unsigned)(f * rstride);\n'
         '        const uintptr_t ub = (uintptr_t)(bp + t * bp_t + lo);\n'
         '        const char* gb = (const char*)(ub & ~(uintptr_t)15);\n'
         '        for (int c = l; c < chunks(ub, R); c += lanes) cp_async16_s(d + 16u * c, gb + 16 * c);\n'
         '        words += 4 * chunks(ub, R);\n'
         '        if (plane) {\n'
         '          const uintptr_t ue = (uintptr_t)(ep + t * ep_t + lo);\n'
         '          const char* ge = (const char*)(ue & ~(uintptr_t)15);\n'
         '          for (int c = l; c < chunks(ue, R); c += lanes)\n'
         '            cp_async16_s(d + 4u * plane + 16u * c, ge + 16 * c);\n'
         '          words += 4 * chunks(ue, R);\n'
         '        }\n'
         '      }\n'
         '      cp_async_commit();\n'
         '    }\n'), 1),
    ('  w.bulk = !w.block || W * S * 4 >= kBulkBytes;', "  w.bulk = false;", 1),
]
BLOCK_BULK = [  # every block-layout window as one bulk copy a plane
    ('  w.bulk = !w.block || W * S * 4 >= kBulkBytes;', "  w.bulk = true;", 1),
]
BLOCK_CP_ASYNC = [  # every block-layout window 16 bytes a lane by cp.async
    ('  w.bulk = !w.block || W * S * 4 >= kBulkBytes;', "  w.bulk = !w.block;", 1),
]
NO_AHEAD = [  # the window form loads only the window it waits for
    ("      if (t_lo > 0) {\n        pt = max(0, t_lo - W);",
     "      if (false) {\n        pt = max(0, t_lo - W);", 1),
]
VARIANTS = {"as is": [], "rows by cp.async": ROWS_CP_ASYNC,
            "block by bulk copies": BLOCK_BULK, "block by cp.async": BLOCK_CP_ASYNC,
            "every frame in full": FULL_FRAMES, "no load ahead": NO_AHEAD}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", default=None)
    ap.add_argument("--only", default=None, help="time only the variants named, ';'-separated")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    if not torch.cuda.is_available():
        print("exp_r20: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from exp_r20_dense_backtrace import dense_walks
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk
    from speech_recognition_tpu_torch.utils import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build.build()
    lim = build.load_library().srt_smem_limit()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    walks = dense_walks(dev)
    walks = {k: walks[k] for k in ("sausage", "isolated", "transcripts", "ties")}
    with open(os.path.join(build.CSRC_DIR, "dense_backtrace.cu")) as f:
        source = f.read()
    out_dir = os.path.join(build.BUILD_DIR, "exp_r20")
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    procs = []
    chosen = VARIANTS if args.only is None else {k: VARIANTS[k] for k in args.only.split(";")}
    for k, (name, changes) in enumerate(chosen.items()):
        text = source
        for a, b, count in changes:
            if text.count(a) != count:
                print(f"exp_r20: variant {name!r}: {a[:40]!r} found {text.count(a)} times",
                      file=sys.stderr)
                return 1
            text = text.replace(a, b)
        src = os.path.join(out_dir, f"v{k}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{k}.so")
        procs.append((name, so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC_DIR, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            with open(os.path.join(args.sass, os.path.basename(so) + ".sass"), "w") as f:
                f.write(f"// {name}\n" + subprocess.run(
                    [os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass", so],
                    capture_output=True, text=True).stdout)
        lib = ctypes.CDLL(so)
        main_fn = build.load_library().dense_backtrace_launch
        lib.dense_backtrace_launch.argtypes = main_fn.argtypes
        lib.dense_backtrace_launch.restype = main_fn.restype
        libs[name] = (lib, regs)

    res = {"card": card, "device_ms": {}, "registers": {k: v[1] for k, v in libs.items()}}
    for case, (bp, ebp, end, nf, depth) in walks.items():
        b, t, s = bp.shape
        end, nf = end.to(torch.int32).contiguous(), nf.to(torch.int32).contiguous()
        plans = {"window": dk.dense_backtrace_plan(b, t, s, [bp.stride()] * 2, lim, n_sm, depth),
                 "chain": dk.BacktracePlan("chain", 0, 0, 1, 4, 0, 0)}
        full = dk.window_plan(b, t, s, depth, 32, s, lim, n_sm, block=True)
        if full is not None and full != plans["window"]:
            plans["window, windows of every state"] = full
        states = torch.empty((b, t), dtype=torch.int32, device=dev)
        flags = torch.empty((b, t), dtype=torch.bool, device=dev)
        for name, (lib, _) in libs.items():
            for form, pl in plans.items():
                def run(lib=lib, pl=pl):
                    rc = lib.dense_backtrace_launch(
                        int(pl.form == "window"), bp.data_ptr(), *bp.stride(), ebp.data_ptr(),
                        *ebp.stride(), end.data_ptr(), nf.data_ptr(), states.data_ptr(),
                        flags.data_ptr(), t, s, b, depth, pl.rows, pl.states, pl.lanes,
                        pl.warps, pl.grid, pl.smem, int(pl.block), None,
                        torch.cuda.current_stream(dev).cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: {rc}")
                ms = cs.queued_ms(run)
                res["device_ms"][f"{case} {form} {name}"] = ms
                print(f"[exp_r20 variants] {case} {b}x{t}x{s}, {form} form, {name}: "
                      f"{ms:.4f} ms device ({card})", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

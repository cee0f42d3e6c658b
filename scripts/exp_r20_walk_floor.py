#!/usr/bin/env python3
"""What one frame of a serial walk through shared memory costs on this card:
a micro-benchmark of the step K21's window form repeats, built by nvcc
(the port's flags) and timed on one GPU.

    python3 scripts/exp_r20_walk_floor.py

One warp a CTA, 64 CTAs (the sausage's streams), each walks 500 frames
through a 32-frame x 128-state table in shared memory whose entries step
the state down by 0-3 (a left-to-right walk), every lane of the warp in
step.  The kernel reads ``clock64`` around the walk and reports cycles a
frame (the mean over the warps).  Variants add one part of K21's frame at
a time:

  lds             s = row[s]: one dependent shared-memory read a frame
  lds x2          and the eps entry beside it, a select on it
  + branch        and a branch on it (never taken)
  + sts           and the state stored to a ring in shared memory
  + sts x2        and the flag too (K21's ring of 32)
  + register ring the state and flag kept in registers instead (lane t % 32)
  + stg           the state and flag stored to device memory every frame
  + window check  and K21's in-window test on the raw state (a select)

Prints one JSON line with the card's name and power limit.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r'''
#include <stdint.h>
#include <cuda_runtime.h>

constexpr int W = 32, R = 128, T = 500;

template <int V>
__global__ void __launch_bounds__(32) walk(long long* cycles, int* out, uint8_t* flag,
                                            int seed) {
  __shared__ int tab[2 * W * R];
  __shared__ int ring[40];
  const int lane = threadIdx.x;
  for (int i = lane; i < 2 * W * R; i += 32) {
    const unsigned h = (unsigned)(i * 2654435761u) ^ (unsigned)seed;
    const int st = i % R;
    tab[i] = i < W * R ? max(0, st - (int)(h % 4)) : ((h >> 8) % 64 == 0 ? 0 : -1);
  }
  __syncwarp();
  int s = R - 1, keep = 0;
  unsigned fbits = 0;
  int* o = out + blockIdx.x * T;
  uint8_t* fl = flag + blockIdx.x * T;
  const int wlo = 0;
  const long long c0 = clock64();
  for (int t = T - 1; t >= 0; --t) {
    const int f = t & (W - 1);
    int k = f * R + s;
    if (V >= 7) {
      const unsigned d = (unsigned)(s - wlo);
      k = d < (unsigned)R ? f * R + (int)d : 0;
    }
    int p = tab[k];
    bool used = false;
    if (V >= 1) {
      const int e = tab[W * R + k];
      if (V >= 2) {
        if (e >= 1000000) {  // never taken
          p = tab[e & 1023];
          used = true;
        }
      } else {
        p = e > 1000000 ? e : p;
      }
    }
    if (V == 3 || V == 4) ring[t & 31] = s;
    if (V == 4) ((uint8_t*)(ring + 32))[t & 31] = used;
    if (V == 5) {
      keep = lane == (t & 31) ? s : keep;
      fbits = used ? fbits | (1u << (t & 31)) : fbits;
    }
    if (V == 6 || V == 7) {
      o[t] = s;
      fl[t] = used;
    }
    s = p;
  }
  const long long c1 = clock64();
  if (V == 5) {
    o[lane] = keep;
    fl[lane] = (fbits >> lane) & 1;
  }
  if (V == 3 || V == 4) o[lane] = ring[lane];
  if (lane == 0) {
    cycles[blockIdx.x] = c1 - c0;
    o[T - 1] += s;
  }
}

extern "C" int walk_launch(int v, long long* cycles, int* out, uint8_t* flag, int ctas) {
  switch (v) {
    case 0: walk<0><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 1: walk<1><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 2: walk<2><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 3: walk<3><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 4: walk<4><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 5: walk<5><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 6: walk<6><<<ctas, 32>>>(cycles, out, flag, 7); break;
    case 7: walk<7><<<ctas, 32>>>(cycles, out, flag, 7); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
'''

NAMES = ["lds", "lds x2", "+ branch", "+ sts", "+ sts x2", "+ register ring", "+ stg",
         "+ window check"]


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("exp_r20: needs a CUDA device", file=sys.stderr)
        return 1
    from speech_recognition_tpu_torch.utils import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out_dir = os.path.join(build.BUILD_DIR, "exp_r20")
    os.makedirs(out_dir, exist_ok=True)
    src, so = os.path.join(out_dir, "walk_floor.cu"), os.path.join(out_dir, "walk_floor.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stdout + proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.walk_launch.argtypes = [ctypes.c_int, p, p, p, ctypes.c_int]
    lib.walk_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    ctas = 64
    cycles = torch.zeros(ctas, dtype=torch.int64, device=dev)
    out = torch.zeros((ctas, 500), dtype=torch.int32, device=dev)
    flag = torch.zeros((ctas, 500), dtype=torch.uint8, device=dev)
    res = {"card": card, "cycles a frame": {}}
    for v, name in enumerate(NAMES):
        for _ in range(3):  # the last of three runs
            rc = lib.walk_launch(v, cycles.data_ptr(), out.data_ptr(), flag.data_ptr(), ctas)
            if rc:
                print(f"exp_r20: launch failed: {rc}", file=sys.stderr)
                return 1
        torch.cuda.synchronize()
        res["cycles a frame"][name] = float(cycles.double().mean()) / 500
        print(f"[exp_r20 walk floor] {name}: {res['cycles a frame'][name]:.1f} cycles a frame "
              f"({card})", flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

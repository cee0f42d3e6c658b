#!/usr/bin/env python3
"""Time the token beam's kernels K19 (csrc/token_beam.cu) and K26
(csrc/word_walk.cu) and its route on one GPU, against an older tree.

    python3 scripts/exp_r25_token_beam.py [--root DIR] [--tag NAME]
                                          [--turns DIR] [--variants] [--parts]
                                          [--lab]

Inputs (seeded) are ``chip_smoke.py``'s: the 1k trie (``make_lex_pipeline``)
with 32 x 500 planted frames, k = 64, with and without its bigram; the
dictionary-shaped trie (86,520 states, uniform emissions, 32 x 500) at k
= 64 (the device tier); the 1k trie at k = S.  Through the public gates
(``ops.beam.beam_search`` / ``beam_backtrace``, so any tree since PR 24
runs them): K19's and K26's CUDA-event medians (ms) and device times
(torch.profiler, ``chip_smoke.device_ms``), the route
``beam_decode_lextree`` and its stages (tables, ``bank_nll_ubt``, K19,
K26, the host's word lists) and its idle share.  ``--root`` imports the
port and ``chip_smoke`` from DIR; ``--turns DIR`` runs this script on
DIR, here, here, DIR (one process each) and prints their lines.

``--variants`` (this tree): K19 under other plans (256, 512 and 1,024
threads; the device tier at k = 64) and K26 in both forms, each first
held to the plain versions on live slots; the survivors a frame and
the cycles a frame by phase from K19's counters (its clock64 trace).
``--parts``: K19 and K26 built from copies of their sources with one
part changed or taken out (``PARTS``, ``WALK_PARTS``; "timing only"
ones give wrong results), K19 with its cycles a frame by phase (its
plan: shared tier, 256 threads), each held to the plain version.
``--lab``: the latencies of one dependent step by kind
(a pointer chase through shared memory and through L2 with
``ld.global.cg``, a chain of 64-bit shuffles, a chain of block barriers
at 256 threads), in SM cycles by ``clock64``, and the registers and
spills ptxas reports for K19 and K26.  Prints one JSON line with the
card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LAB = r'''
#include <stdint.h>
#include <cuda_runtime.h>

// one thread chases a random cycle through shared memory
__global__ void smem_chase(const int* perm, int n, int steps, long long* out) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = perm[i];
  __syncthreads();
  if (threadIdx.x) return;
  int p = 0;
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) p = tab[p];
  const long long c1 = clock64();
  out[0] = c1 - c0;
  out[1] = p;
}

// one thread chases a random cycle through device memory, past L1
__global__ void l2_chase(const int* perm, int steps, long long* out) {
  int p = 0;
  for (int s = 0; s < steps; ++s) p = __ldcg(perm + p);  // warm L2
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) p = __ldcg(perm + p);
  const long long c1 = clock64();
  out[0] = c1 - c0;
  out[1] = p;
}

// one warp: a chain of 64-bit shuffles, each feeding the next
__global__ void shfl_chain(int steps, long long* out) {
  unsigned long long v = threadIdx.x * 2654435761ull;
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, (s & 15) + 1);
    v = o < v ? o : v + 1;
  }
  const long long c1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)v;
  }
}

// a CTA: a chain of block barriers, each after a shared-memory store
__global__ void barrier_chain(int steps, long long* out) {
  __shared__ int x[1024];
  x[threadIdx.x] = 0;
  __syncthreads();
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) {
    x[threadIdx.x] += x[(threadIdx.x + s) & (blockDim.x - 1)];
    __syncthreads();
  }
  const long long c1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = x[5];
  }
}

extern "C" int lab_run(int which, const int* perm, int n, int steps, int threads,
                       long long* out) {
  switch (which) {
    case 0: smem_chase<<<1, 256, n * 4>>>(perm, n, steps, out); break;
    case 1: l2_chase<<<1, 1>>>(perm, steps, out); break;
    case 2: shfl_chain<<<1, 32>>>(steps, out); break;
    case 3: barrier_chain<<<1, threads>>>(steps, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
'''


# K19 with one part changed: (name, [(old, new), ...]) text patches of
# csrc/token_beam.cu; "(timing only)" ones change the result
PARTS = [
    ("as is", []),
    ("no L1 prefetch", [('asm volatile("prefetch.global.L1 [%0];" ::"l"(ptr));', "")]),
    ("no next-row copy (timing only)", [
        ("      for (int u = tid; u < U; u += nt) cp_async4(next + u, nll_b + (long long)(t + 1) * U + u);\n", "")]),
    # the key table's min by a 32-bit atomicMin of the cost key alone, the
    # origin stored by whoever is not above it (racy: ties and the origin
    # may differ from the kernel's rule)
    ("32-bit key min (timing only)", [
        ("  if (atomicMin(&p.key[tgt], key) == kEmpty) {",
         "  unsigned* kw_ = (unsigned*)&p.key[tgt];\n"
         "  const unsigned ck_ = (unsigned)(key >> 32);\n"
         "  const unsigned old_ = atomicMin(kw_ + 1, ck_);\n"
         "  if (ck_ <= old_) kw_[0] = (unsigned)origin;\n"
         "  if (old_ == 0xffffffffu) {")]),
    # thread 0's own progress through the proposals, from the frame's
    # start: its token's frontier entries loaded, its edge records loaded,
    # its proposals made (columns 0-2 of the cycles a frame; the rest as is)
    ("proposal sub-ticks", [
        ("  __shared__ long long s_cyc[5];", "  __shared__ long long s_cyc[5];\n  __shared__ long long s_sub[3];"),
        ("  if (tid < 5) s_cyc[tid] = 0;", "  if (tid < 5) s_cyc[tid] = 0;\n  if (tid < 3) s_sub[tid] = 0;"),
        ("        const float c = p.fcost[j];\n",
         "        const float c = p.fcost[j];\n"
         "        if (trace && n >= 0 && c == c && s >= 0 && off >= 0) s_sub[0] += clock64() - tick;\n"),
        ("#pragma unroll\n          for (int u = 0; u < 4; ++u)\n            if (e0 + u * g < n)\n",
         "          if (trace && ed[0].x >= -1 && ed[3].x >= -1) s_sub[1] += clock64() - tick;\n"
         "#pragma unroll\n          for (int u = 0; u < 4; ++u)\n            if (e0 + u * g < n)\n"),
        ("    __syncthreads();\n    BEAM_TICK(0);",
         "    if (trace) s_sub[2] += clock64() - tick;\n    __syncthreads();\n    BEAM_TICK(0);"),
        ("    for (int i = 0; i < 5; ++i) st[3 + i] = s_cyc[i];",
         "    for (int i = 0; i < 5; ++i) st[3 + i] = i < 3 ? s_sub[i] : s_cyc[i];"),
    ]),
]


# K26 (word_walk.cu) with one part changed, timed in its window form
WALK_PARTS = [
    ("as is", []),
    ("no walk (timing only)", [("      for (int t = hi; t >= max(lo, 1); --t, rp -= k) {",
                                "      for (int t = hi; t >= hi + 1; --t, rp -= k) {")]),
]


def _build_parts(src_name, variants):
    """Each variant of ``csrc/<src_name>`` compiled (with errors.cu) into a
    library of its own, nvcc processes in parallel: {name: path}."""
    import tempfile

    from speech_recognition_tpu_torch.utils import build

    with open(os.path.join(build.CSRC_DIR, src_name)) as f:
        base = f.read()
    tmp = tempfile.mkdtemp(prefix="parts_", dir=build.BUILD_DIR)
    jobs = {}
    for name, patches in variants:
        src = base
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"part {name!r}: the patch does not match the source")
            src = src.replace(old, new)
        path = os.path.join(tmp, f"{len(jobs)}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = path[:-3] + ".so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC_DIR, "-o", so, path,
               os.path.join(build.CSRC_DIR, "errors.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log[-3000:]}")
        out[name] = so
    return out


def _bind(so, entry, real):
    lib = ctypes.CDLL(so)
    getattr(lib, entry).argtypes = getattr(real(), entry).argtypes
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def parts(dev, x) -> dict:
    """K19 and K26 built from patched copies of their sources, timed at k =
    64 on the 1k trie through the wrappers (K19: its plan, shared tier; K26:
    its window form), K19 with its cycles a frame by phase."""
    import torch

    from chip_smoke import device_ms
    from speech_recognition_tpu_torch.ops import beam as tbeam
    from speech_recognition_tpu_torch.ops import beam_kernels as bk
    from speech_recognition_tpu_torch.utils import build

    tb = tbeam.beam_tables(x["lexg"].banded, leaf_word=x["lexg"].leaf_word, device=dev)
    nll, nf = x["nll"], x["nf"]
    want = tbeam.beam_search_ref(nll, tb, nf, 64)
    want_walk = tbeam.beam_backtrace_ref(want[0], want[1], want[4], want[5], tb, nf)
    real = build.load_library
    out = {"K19": {}, "K26": {}}
    k19 = _build_parts("token_beam.cu", PARTS)
    k26 = _build_parts("word_walk.cu", WALK_PARTS)
    try:
        for name, so in k19.items():
            lib = _bind(so, "token_beam_launch", real)
            build.load_library = lambda lib=lib: lib
            stats = torch.zeros((nll.shape[0], bk.STATS), dtype=torch.int64, device=dev)
            got = bk.launch_search(nll, tb, nf, 64, True, None, stats=stats)
            torch.cuda.synchronize()
            live = want[3] >= 0
            same = bool(torch.equal(got[3] >= 0, live)
                        and all(torch.equal(g_[live], w_[live]) for g_, w_ in zip(got[3:], want[3:])))
            st = stats.cpu()
            frames = float(st[:, 0].sum())

            def run():
                return bk.launch_search(nll, tb, nf, 64, True, None)

            out["K19"][name] = {"device": device_ms(run, what=f"K19 {name}"), "== plain": same,
                                "cycles a frame": {ph: float(st[:, 3 + i].sum()) / frames
                                                   for i, ph in enumerate(bk.PHASES)}}
            print(f"[exp_r25 parts] K19 {name}: {json.dumps(out['K19'][name])}",
                  file=sys.stderr, flush=True)
        for name, so in k26.items():
            lib = _bind(so, "token_walk_launch", real)
            build.load_library = lambda lib=lib: lib

            def walk():
                return bk.launch_walk(want[0], want[1], want[4], want[5], tb, nf, None, None,
                                      None)

            got = walk()
            torch.cuda.synchronize()
            same = bool(torch.equal(got[0], want_walk[0]) and torch.equal(got[1], want_walk[1]))
            out["K26"][name] = {"device": device_ms(walk, reps=20, what=f"K26 {name}"),
                                "== plain": same}
            print(f"[exp_r25 parts] K26 {name}: {json.dumps(out['K26'][name])}",
                  file=sys.stderr, flush=True)
    finally:
        build.load_library = real
    return out


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def setup(dev):
    """The inputs: the 1k trie and its planted batch, its bigram, the
    dictionary-shaped trie and its emissions."""
    import numpy as np
    import torch

    from chip_smoke import make_lex_pipeline, planted_features
    from speech_recognition_tpu_torch.data.lexicon import dict1_shaped_lexicon
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    bank, lexg, _, _, _ = make_lex_pipeline(dev, batch=1)
    units = [[ord(ch) - ord("a") for ch in wd] for wd in lexg.words]
    feats, nf = planted_features(bank, 32, 500, np.random.default_rng(23), units=units,
                                 dwell=(2, 4))
    lm = fit_bigram([[int(x) for x in np.random.default_rng(41).integers(0, len(lexg.words),
                                                                         12)]
                     for _ in range(200)], len(lexg.words))
    big = torch.from_numpy(np.concatenate([np.asarray(lm.cost, np.float32),
                                           np.asarray(lm.start_cost, np.float32)[None]])).to(dev)
    words, trans, ids, drng = dict1_shaped_lexicon()
    lexd = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    n_bank_d = int(lexd.banded.bank_state.max()) + 1
    nlld = torch.from_numpy(drng.uniform(0, 5, (n_bank_d, 500, 32)).astype(np.float32)).to(dev)
    nfd = torch.from_numpy(np.r_[500, 1, drng.integers(2, 501, 30)].astype(np.int32)).to(dev)
    nll = bank_nll_ubt(bank, feats, nf).permute(2, 1, 0).contiguous()
    return dict(bank=bank, lexg=lexg, feats=feats, nf=nf, lm=lm, big=big, lexd=lexd,
                nll=nll, nll_d=nlld.permute(2, 1, 0).contiguous(), nf_d=nfd)


def public_times(dev, x) -> dict:
    """Times through the gates only (any tree since PR 24)."""
    from chip_smoke import cuda_ms, device_ms
    from speech_recognition_tpu_torch.decode import lextree as lexdec
    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt
    from speech_recognition_tpu_torch.ops import beam as tbeam

    tb = tbeam.beam_tables(x["lexg"].banded, leaf_word=x["lexg"].leaf_word, device=dev)
    tb_d = tbeam.beam_tables(x["lexd"].banded, leaf_word=x["lexd"].leaf_word, device=dev)
    nll, nf = x["nll"], x["nf"]
    res = tbeam.beam_search(nll, tb, nf, 64)
    walk = tbeam.beam_backtrace(res[0], res[1], res[4], res[5], tb, nf, final_pred=res[2])

    def k19():
        return tbeam.beam_search(nll, tb, nf, 64)

    def k26():
        return tbeam.beam_backtrace(res[0], res[1], res[4], res[5], tb, nf)

    def route(lm_=None):
        return lexdec.beam_decode_lextree(x["bank"], x["lexg"], x["feats"], nf, 64, lm=lm_)

    def words():
        walk[0].cpu()
        rows = walk[1].cpu().numpy()
        return [[int(w) for w in row[:0:-1] if w >= 0] + [int(row[0])] for row in rows]

    out = {
        "K19 k=64": cuda_ms(k19, reps=10), "K19 k=64 device": device_ms(k19, what="K19"),
        "K19 k=64 bigram": cuda_ms(lambda: tbeam.beam_search(nll, tb, nf, 64,
                                                             bigram_cost=x["big"]), reps=10),
        "K19 dict1 k=64": cuda_ms(lambda: tbeam.beam_search(x["nll_d"], tb_d, x["nf_d"], 64),
                                  reps=3),
        "K19 dict1 k=64 device": device_ms(
            lambda: tbeam.beam_search(x["nll_d"], tb_d, x["nf_d"], 64), reps=2, what="K19 d"),
        "K19 k=S": cuda_ms(lambda: tbeam.beam_search(nll, tb, nf, tb.n_states), reps=1),
        "K26": cuda_ms(k26, reps=20), "K26 device": device_ms(k26, what="K26"),
        "route": cuda_ms(route, reps=5), "route bigram": cuda_ms(lambda: route(x["lm"]), reps=5),
        "route device": device_ms(route, what="route"),
        "stage beam_tables": cuda_ms(lambda: tbeam.beam_tables(
            x["lexg"].banded, leaf_word=x["lexg"].leaf_word, device=dev)),
        "stage bank_nll_ubt": cuda_ms(lambda: bank_nll_ubt(x["bank"], x["feats"], nf)),
        "stage word lists (loop a stream)": cuda_ms(words, reps=10)}
    if hasattr(lexdec, "_word_lists"):
        out["stage word lists (whole plane)"] = cuda_ms(
            lambda: (walk[0].cpu(), lexdec._word_lists(walk[1].cpu().numpy())), reps=10)
    out["route idle share"] = 1 - out["route device"] / out["route"]
    return out


def variants(dev, x) -> dict:
    """K19 under other plans and K26 in both forms (this tree), each held
    to the plain versions first; the survivor counter."""
    import torch

    from chip_smoke import cuda_ms, device_ms, token_beam_agrees
    from speech_recognition_tpu_torch.ops import beam as tbeam
    from speech_recognition_tpu_torch.ops import beam_kernels as bk

    tb = tbeam.beam_tables(x["lexg"].banded, leaf_word=x["lexg"].leaf_word, device=dev)
    nll, nf = x["nll"], x["nf"]
    r, l = tb.eps_block.shape
    pack = bk.beam_pack(tb)
    mmax = bk.beam_widest(pack, 64, tb.init_states.shape[0])
    base = bk.beam_plan(tb.n_states, 64, mmax, r, l, nll.shape[2])
    want = tbeam.beam_search_ref(nll, tb, nf, 64)
    want_walk = tbeam.beam_backtrace_ref(want[0], want[1], want[4], want[5], tb, nf)
    out = {"plan": base._asdict(), "mmax": mmax, "K19": {}, "K26": {}}
    for name, plan in (("shared 128", base._replace(threads=128)),
                       ("shared 256", base._replace(threads=256)),
                       ("shared 512", base._replace(threads=512)),
                       ("shared 1024", base._replace(threads=1024)),
                       ("device 256", base._replace(tier="device")),
                       ("device 512", base._replace(tier="device", threads=512))):
        got = bk.launch_search(nll, tb, nf, 64, True, None, plan=plan)
        walk = tbeam.beam_backtrace(got[0], got[1], got[4], got[5], tb, nf)
        torch.cuda.synchronize()
        token_beam_agrees(f"K19 {name}", got, want, walk, want_walk)

        def run(p=plan):
            return bk.launch_search(nll, tb, nf, 64, True, None, plan=p)

        out["K19"][name] = {"event": cuda_ms(run, reps=10),
                            "device": device_ms(run, what=f"K19 {name}")}
    for name, plan in (("window 32", bk.walk_plan(64, 500)), ("window 8", bk.WalkPlan("window", 8, 0)),
                       ("chain", bk.WalkPlan("chain", 0, 0))):
        def run(p=plan):
            return bk.launch_walk(want[0], want[1], want[4], want[5], tb, nf, None, None, None,
                                  plan=p)

        got = run()
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want_walk[0])
                and torch.equal(got[1][want_walk[0] < 5e29], want_walk[1][want_walk[0] < 5e29])):
            raise SystemExit(f"K26 {name} differs from the plain walk")
        out["K26"][name] = {"event": cuda_ms(run, reps=20),
                            "device": device_ms(run, what=f"K26 {name}")}
    for name, plan in (("shared 256", base), ("device 256", base._replace(tier="device"))):
        stats = torch.zeros((nll.shape[0], bk.STATS), dtype=torch.int64, device=dev)
        bk.launch_search(nll, tb, nf, 64, True, None, plan=plan, stats=stats)
        st = stats.cpu()
        frames = float(st[:, 0].sum())
        out[f"stats {name}"] = {
            "survivors mean": float(st[:, 1].sum()) / frames, "survivors max": int(st[:, 2].max()),
            "frames": int(st[:, 0].max()),
            "cycles a frame": {ph: float(st[:, 3 + i].sum()) / frames
                               for i, ph in enumerate(bk.PHASES)}}
    return out


def lab(dev) -> dict:
    """Step latencies in SM cycles, and ptxas's report for K19 and K26."""
    import numpy as np
    import torch

    from speech_recognition_tpu_torch.utils import build

    out_dir = os.path.join(build.BUILD_DIR, "exp_r25")
    os.makedirs(out_dir, exist_ok=True)
    src, so = os.path.join(out_dir, "lab.cu"), os.path.join(out_dir, "lab.so")
    with open(src, "w") as f:
        f.write(LAB)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lab_run.argtypes = [i, p, i, i, i, p]
    res = torch.zeros(2, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(0)

    def cycle(n):
        order = rng.permutation(n)
        perm = np.empty(n, np.int32)
        perm[order] = np.roll(order, -1)
        return torch.from_numpy(perm).to(dev)

    def run(which, perm, n, steps, threads=256):
        best = float("inf")
        for _ in range(3):
            if lib.lab_run(which, None if perm is None else perm.data_ptr(), n, steps, threads,
                           res.data_ptr()):
                raise SystemExit("lab launch failed")
            torch.cuda.synchronize()
            best = min(best, float(res[0]) / steps)
        return best

    small, big = cycle(4096), cycle(4 << 20)  # 16 KB in shared memory; 16 MB: past L1
    out = {"smem": run(0, small, 4096, 20000), "l2": run(1, big, 0, 20000),
           "shfl": run(2, None, 0, 20000),
           "barrier 256": run(3, None, 0, 20000, 256), "barrier 512": run(3, None, 0, 20000, 512)}
    with open(build.library_path() + ".log") as f:
        lines = f.read().splitlines()
    keep = [ln.strip() for j, ln in enumerate(lines)
            if ("token_beam" in ln or "token_walk" in ln) and "Compiling" in ln]
    for j, ln in enumerate(lines):
        if ("token_beam_kernel" in ln or "token_walk_window_kernel" in ln) and "Function" in ln:
            keep += [x.strip() for x in lines[j:j + 4]]
    out["ptxas"] = keep
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="change")
    ap.add_argument("--turns", default=None)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--lab", action="store_true")
    args = ap.parse_args()
    if args.turns:
        lines = []
        for root, tag in ((args.turns, "parent"), (HERE, "change"), (HERE, "change"),
                          (args.turns, "parent")):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root,
                                   "--tag", tag], capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-3000:])
            if proc.returncode:
                return proc.returncode
            lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({"turns": lines}))
        return 0
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("exp_r25: needs a CUDA device", file=sys.stderr)
        return 1
    import speech_recognition_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r25: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    x = setup(dev)
    out = {"tag": args.tag, "root": root, "card": card_name(), "ms": public_times(dev, x)}
    if args.variants:
        out["variants"] = variants(dev, x)
    if args.parts:
        out["parts"] = parts(dev, x)
    if args.lab:
        out["lab"] = lab(dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

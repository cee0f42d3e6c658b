#!/usr/bin/env python3
"""Where the bigram lattice rescorer K7 (csrc/lattice_rescore.cu, staged
mode) spends its time, on one GPU: the kernel as it is, and copies of
its source with one part taken out, each compiled by nvcc (with
csrc/errors.cu) into a library of its own and launched through the
bigram pipeline's wrapper, ``rescore_and_walk`` (the rescoring DP, the
per-frame minimum q, the truncation count and the word walk), at the
bigram path's shape (128 x 500 frames on the 1,000-word trie,
chip_smoke.py's add-k LM and uniform emissions, lattice planes from K6):

* ``as is``: the kernel (every output checked against the plain
  version), and at max_words 0 (the walk takes no step);
* ``gathers conflict-free``: the sparse candidates read D[j] instead of
  D[pidx[j, k]] (the pairs are still loaded);
* ``no sparse loop``: the K candidates per target taken out;
* ``no argmin``: both warp reductions of the backoff minimum taken out;
* ``no stores``: pred_w and the ring row written only where H < -1e38
  (never; later ring reads then read whatever the ring holds);
* ``no barrier``: the frame's one block barrier taken out (a race; for
  timing only);
* ``no row wait``: the cp.async wait for the lattice rows taken out (the
  frame reads whatever has landed; timing only);
* ``no start / base loads``: start_l and base_l read as 0;
* ``no ring reads``: the ring value replaced by a constant (the tau
  cache still applies);
* ``no walk``: the word walk at the end taken out (leaves and word
  counts not written; timing only);
* ``walk clock``: clock64 reads around the walk, for a trace of its
  cycles (timing only: they go into the last phase's column);
* the kernel as it is with 2 leaves per thread x 512 threads and 4 x 256
  (the plan takes 1 x 1,024 at L = 1,000).

Times are torch.profiler device times of the launch (``chip_smoke.device_ms``),
printed with the card's name and power limit, the cycles per frame by
phase of the kernel as it is (its clock64 trace), and ptxas' registers
and spills for the 1-leaf backoff instance.

    python3 scripts/exp_r9_k7_variants.py
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from speech_recognition_tpu_torch.data.lexicon import bench_lexicon  # noqa: E402
from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram  # noqa: E402
from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph  # noqa: E402
from speech_recognition_tpu_torch.ops import lattice_kernels as lt  # noqa: E402
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk  # noqa: E402
from speech_recognition_tpu_torch.ops.lattice import _ring_depth, lattice_lm  # noqa: E402
from speech_recognition_tpu_torch.utils import build  # noqa: E402

ARGMIN = """  const unsigned k = fkey(v), m = __reduce_min_sync(0xffffffffu, k);
  i = (int)__reduce_min_sync(0xffffffffu, k == m ? (unsigned)i : 0xffffffffu);
  v = fval(m);"""
PATCHES = {
    "as is": [],
    "gathers conflict-free": [("c[u] = d[e[u].x] + __int_as_float(e[u].y);",
                               "c[u] = d[j] + __int_as_float(e[u].y);"),
                              ("const float c = d[e.x] + __int_as_float(e.y);",
                               "const float c = d[j] + __int_as_float(e.y);")],
    "no sparse loop": [("for (; k + 4 <= K; k += 4) {", "for (; k + 4 <= 0; k += 4) {"),
                       ("for (; k < K; ++k) {", "for (; k < 0; ++k) {")],
    "no argmin": [(ARGMIN, "")],
    "no stores": [("        __stcs(p.pred_w + row + j, pj);",
                   "        if (h < -1e38f) __stcs(p.pred_w + row + j, pj);"),
                  ("        ring_row[j] = v;\n        newest[i] = v;",
                   "        if (h < -1e38f) ring_row[j] = v;\n        newest[i] = v;")],
    "no barrier": [("    __syncthreads();  // D and the partials of frame t are published", "")],
    "no row wait": [("    cp_async_wait<kDepth - 2>();", "")],
    "no start / base loads": [("s0 + __ldg(p.start_l + l) : s0 + hq", "s0 : s0 + hq"),
                              ("const float db = dl + __ldg(p.base_l + l);",
                               "const float db = dl;")],
    "no ring reads": [("hq_next[i] = ring[(size_t)(slot < 0 ? slot + dmax : slot) * L + l];",
                       "hq_next[i] = (float)slot;")],
    "no walk": [("    walk_tail(p, b, fi, nf, lane);\n  }\n  if (p.trace", "  }\n  if (p.trace")],
    "walk clock": [("    walk_tail(p, b, fi, nf, lane);\n  }\n  if (p.trace",
                    "    const long long w0 = p.trace ? clock64() : 0;\n"
                    "    walk_tail(p, b, fi, nf, lane);\n"
                    "    if (p.trace && lane == 0)\n"
                    "      p.trace[(size_t)b * kPhases + 3] += clock64() - w0;\n"
                    "  }\n  if (p.trace")],
}


def compile_variant(src, tmp):
    path = os.path.join(tmp, f"{len(os.listdir(tmp))}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", build.CSRC_DIR, "-o", so, path,
           os.path.join(build.CSRC_DIR, "errors.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(so):
    lib = ctypes.CDLL(so)
    i = ctypes.c_int
    lib.lattice_rescore_launch.argtypes = build.RESCORE_ARGTYPES
    lib.lattice_rescore_launch.restype = i
    lib.srt_smem_limit.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    with open(os.path.join(build.CSRC_DIR, "lattice_rescore.cu")) as f:
        base = f.read()
    tmp = tempfile.mkdtemp(prefix="k7_variants_")
    jobs = {}
    for name, patches in PATCHES.items():
        src = base
        for old, new in patches:
            if src.count(old) < 1:
                sys.exit(f"variant {name!r}: the patch does not match the source")
            src = src.replace(old, new)
        jobs[name] = compile_variant(src, tmp)
    libs = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        if name == "as is":
            lines = log.splitlines()
            for k, ln in enumerate(lines):
                if "staged_kernelILi1ELb0ELb1E" in ln:
                    print("ptxas as is, 1 leaf, backoff, tables: "
                          + " | ".join(x.strip() for x in lines[k + 1:k + 3]), flush=True)
        libs[name] = bind(so)

    dev = torch.device("cuda", 0)
    words, trans, ids, brng = bench_lexicon()
    lexg = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    g, topo = lexg.banded.to(dev), lk.lex_topology(lexg.banded)
    lm = fit_bigram([[int(x) for x in brng.integers(0, 1000, 12)] for _ in range(200)], 1000)
    t_len = 500
    e = brng.uniform(0, 5, (t_len, 24, 128)).astype(np.float32)
    nll = torch.from_numpy(np.ascontiguousarray(e.transpose(1, 0, 2))).to(dev)
    nf = torch.full((128,), t_len, dtype=torch.int32, device=dev)
    lm_l = lattice_lm(lm, lexg.leaf_word, dev)
    k6 = lt.viterbi_lattice(nll, g, topo, nf)
    max_words = min(t_len, t_len // (lexg.n_states // lexg.n_arcs) + 1)
    args = (k6[1], k6[2], lm_l[0], lm_l[1], nf, _ring_depth(t_len, 128), 128, max_words)
    want = lt.rescore_and_walk_ref(*args, backoff=lm_l[3])
    l, k = g.n_ends, lm_l[3][1].shape[1]
    plan = lt.rescore_plan(l, k, False, build.load_library().srt_smem_limit())
    real = build.load_library
    try:
        for name, lib in libs.items():
            build.load_library = lambda lib=lib: lib
            got = lt.rescore_and_walk(*args, backoff=lm_l[3])
            torch.cuda.synchronize()
            check = ""
            if name == "as is":
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    sys.exit("as is: disagrees with the plain version")
                check = ", == plain"
            ms = cs.device_ms(lambda: lt.rescore_and_walk(*args, backoff=lm_l[3]), reps=10)
            print(f"K7 {name}: {ms:.4f} ms device{check} ({card})", flush=True)
        build.load_library = lambda: libs["as is"]
        ms = cs.device_ms(lambda: lt.rescore_and_walk(*args[:-1], 0, backoff=lm_l[3]), reps=10)
        print(f"K7 as is, max_words 0 (no walk): {ms:.4f} ms device ({card})", flush=True)
        for leaves, threads in ((2, 512), (4, 256)):
            alt = plan._replace(leaves=leaves, threads=threads)
            ms = cs.device_ms(lambda: lt.rescore_and_walk(*args, backoff=lm_l[3], plan=alt),
                              reps=10)
            print(f"K7 as is, {leaves} leaves x {threads} threads: {ms:.4f} ms device ({card})",
                  flush=True)
        tr = torch.zeros((128, 4), dtype=torch.int64, device=dev)
        lt.rescore_and_walk(*args, backoff=lm_l[3], trace=tr)
        torch.cuda.synchronize()
        cyc = (tr.double().mean(0) / t_len).tolist()
        print("K7 as is, cycles per frame: " + ", ".join(
            f"{n} {c:.0f}" for n, c in zip(("row wait", "D + ring reads", "barrier",
                                            "recombination + stores"), cyc))
              + f"; total {sum(cyc):.0f} ({card})", flush=True)
    finally:
        build.load_library = real


if __name__ == "__main__":
    main()

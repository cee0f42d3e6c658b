#!/usr/bin/env python3
"""Time the bank emission kernel K13 (csrc/bank_emission.cu) and the
word-trace forward K10 (K13 + the word-trace mode of
csrc/banded_forward.cu) at the main-path shapes, on one GPU.

512 x 500 frames with chip_smoke.py's 11 x 5-state x 4-mixture x 39-dim
bank (seed 0) and its lengths (T, 1, 2..T), on the 385-state sausage:
K13, K1 and K10 with their CUDA-event medians beside their device times
(torch.profiler's CUPTI trace, summed over the kernels each call
launches), and torch.matmul of the same [U*M, A] x [A, T*B] product as
a yardstick for K13's product alone.  With ``--lab`` (the tree's own
kernels only) also: the DP alone in K1's and K10's modes with their
cycles per frame step by phase (the kernel's optional clock64 trace,
mean over streams), and the compiler's register and spill report for
both kernels (K13's launch shapes: scripts/exp_r8_k13_variants.py).  With ``--big``:
K1 and K10 on chip_smoke.py's 1,500-word loop (7,500 states) at 64 x 100
and K8 on its 2,000-word loop of 2-5-state words (7,000 states) at
32 x 100 (only public entry points, so the script also times an older
tree when copied into it).  Prints one line per case with the card's
name and power limit.

    python3 scripts/exp_r8_emission.py [--lab] [--big]
"""

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speech_recognition_tpu_torch.data.synthetic import random_gmm_hmm  # noqa: E402
from speech_recognition_tpu_torch.decode.connected import connected_graph_arrays  # noqa: E402
from speech_recognition_tpu_torch.models.hmm import HMMBank  # noqa: E402
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk  # noqa: E402
from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights  # noqa: E402
from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays  # noqa: E402
from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix  # noqa: E402

PHASES = ("emission wait", "band", "eps", "plane rows", "mask", "flush")


def bank(n_states, seed):
    rng = np.random.default_rng(seed)
    ps = [random_gmm_hmm(rng, n_states=n_states, n_mix=4, dim=39, sep=3.0) for _ in range(11)]
    return HMMBank.from_numpy(np.stack([p["means"] for p in ps]),
                              np.log(np.stack([p["variances"] for p in ps])),
                              np.log(np.stack([p["weights"] for p in ps])),
                              np.stack([to_cost_matrix(p["trans"]) for p in ps]))


def ms(fn, reps=9):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def device_ms(fn, reps=5):
    """Mean device time per call of each kernel ``fn`` launches (ms;
    torch.profiler's CUPTI trace) and their sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
           if e.self_device_time_total > 0}
    return per, sum(per.values())


def both(name, fn, card):
    per, tot = device_ms(fn)
    print(f"{name}: event {ms(fn):.4f} ms, device {tot:.4f} ms ("
          + ", ".join(f"{k[:48]} {v:.4f}" for k, v in per.items()) + f") ({card})",
          flush=True)


def lab(xa, w, lw, g, nf, card):
    """The DP's modes alone with their cycle traces, and the compiler's
    report."""
    from speech_recognition_tpu_torch.utils.build import build

    import re

    with open(build() + ".log") as f:
        name = None
        for line in f:
            if "Compiling entry function" in line:
                m = re.search(r"(bank_emission|banded_forward|wordtrace_forward)_kernelI([^E]*E[^E]*E[^E]*E?[^E]*E?)",
                              line)
                name = None if m is None else m.group(1) + " " + m.group(2)
            elif name and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {line.strip()}")
    nll = vk.bank_emission(xa, w, lw)
    t_len = nll.shape[1]
    for mode, wrapper in (("fused", vk.viterbi_banded_fused),
                          ("wordtrace", vk.viterbi_banded_wordtrace)):
        trace = torch.zeros((nll.shape[2], len(PHASES)), dtype=torch.int64, device=xa.device)
        vk._banded_forward(nll, g, nf, 1, mode, wrapper, trace=trace)
        frames = nf.clamp(min=1, max=t_len).double()
        per = (trace.double() / frames[:, None]).mean(0).tolist()
        both(f"DP alone, {mode} mode", lambda: vk._banded_forward(nll, g, nf, 1, mode, wrapper),
             card)
        print(f"DP {mode} cycles per frame step: " + ", ".join(
            f"{k} {v:.0f}" for k, v in zip(PHASES, per)) + f"; total {sum(per):.0f} ({card})",
            flush=True)


def big(xa, w, lw, nf, b5, card):
    """K1 and K10 on a 1,500-word loop of the bank's digits (word i is digit
    i % 11) and K8 on a 2,000-word loop of 2-5-state words, as chip_smoke.py
    builds them."""
    from speech_recognition_tpu_torch.models.graph import build_loop_graph

    trans11 = [b5.trans_cost[i].cpu().numpy() for i in range(11)]
    g = banded_arrays(build_loop_graph([trans11[i % 11] for i in range(1500)],
                                       word_insertion_cost=2.0), device=xa.device)
    g = g._replace(bank_state=g.bank_state % w.shape[0])
    topo = vk.banded_topology(g)
    xab, nfb = xa[:, :100, :64].contiguous(), nf[:64].clamp(max=100)
    for name, fn in (("K1", vk.viterbi_banded_fused), ("K10", vk.viterbi_banded_wordtrace)):
        try:
            t = f"{ms(lambda: fn(xab, w, lw, g, topo, nfb), reps=5):.3f} ms"
        except ValueError as e:  # an older tree's size limit
            t = f"refused ({e})"
        print(f"{name} on the {g.n_states}-state loop at 64 x 100: {t} ({card})", flush=True)
    b6 = bank(6, 10)
    tr6 = [b6.trans_cost[i].numpy() for i in range(11)]
    graph8 = build_loop_graph([tr6[i % 11][:k, :k] for i, k in
                               zip(range(2000), (3, 4, 5, 2) * 500)], word_insertion_cost=0.5)
    g8 = banded_arrays(graph8, device=xa.device)
    g8 = g8._replace(bank_state=g8.bank_state % 66)
    topo8 = vk.banded_topology(g8)
    rng = np.random.default_rng(11)
    nll8 = torch.from_numpy(rng.integers(0, 3, (66, 100, 32)).astype(np.float32)).to(xa.device)
    nf8 = torch.from_numpy(np.r_[100, 0, 1, 103, rng.integers(2, 101, 28)]
                           .astype(np.int32)).to(xa.device)
    print(f"K8 on the {g8.n_states}-state loop at 32 x 100: "
          f"{ms(lambda: vk.viterbi_banded_general(nll8, g8, topo8, nf8, graph8.eps_depth), reps=5):.3f}"
          f" ms "
          f"({card})", flush=True)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    b5 = bank(5, 0).to(dev)
    w, lw = gmm_emission_weights(*b5.flat_states())
    u, m, a = w.shape
    B, T = 512, 500
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal((B, T, 39))
                             .astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[T, 1, np.random.default_rng(2).integers(2, T + 1, B - 2)]
                          .astype(np.int32)).to(dev)
    xa = augment_dtb(feats)
    g = banded_arrays(connected_graph_arrays(b5, 7), device=dev)
    topo = vk.banded_topology(g)
    w2, x2 = w.reshape(u * m, a), xa.reshape(a, T * B)
    cases = {
        "K13 bank_emission": lambda: vk.bank_emission(xa, w, lw),
        "K1 viterbi_banded_fused": lambda: vk.viterbi_banded_fused(xa, w, lw, g, topo, nf),
        "K10 viterbi_banded_wordtrace": lambda: vk.viterbi_banded_wordtrace(xa, w, lw, g,
                                                                            topo, nf),
        "torch.matmul [U*M, A] x [A, T*B]": lambda: torch.matmul(w2, x2),
    }
    for name, fn in cases.items():
        both(f"{name} {B} x {T}", fn, card)
    if "--lab" in sys.argv:
        lab(xa, w, lw, g, nf, card)
    if "--big" in sys.argv:
        big(xa, w, lw, nf, b5, card)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the lexical-tree forward kernel (csrc/viterbi_lex.cu: K4, and K6
in its lattice mode) under launch-plan variants, and the MFCC kernels
(csrc/mfcc39.cu: K12, K3 = K12's kernel + K14), at the main-path shapes
on one GPU.

K4 at 128 x 500 on the 1,000-word trie (lengths T, 1 and 2..T, as
chip_smoke.py draws them) and K6 at 128 x 500 with every stream at T,
each with the plan ``lex_plan`` picks and with one placement changed at
a time (frontier in device memory, records and cross table through L1,
eps block through L1 or on chip, K6's tau frontier in device memory, the
leaf ends gathered per root); the general mode (one band entry
perturbed); K4 at 32 x 500 and K6 at 16 x 500 on the dictionary-shaped
trie.  K12, K3 and K14 at 256 x 5 s and K3 at 64 x 25 s.  Prints one
line per case: CUDA-event median ms with the card's name and power
limit, and for each plan the cycles per frame step by phase (band,
barrier A, eps scan, warp reduction and apply, barrier B; the kernel's optional
clock64 trace of thread 0, mean over streams of cycles / computed
frames).

    python3 scripts/exp_r7_lex_plan.py
"""

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speech_recognition_tpu_torch.data.lexicon import (  # noqa: E402
    bench_lexicon,
    dict1_shaped_lexicon,
)
from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph  # noqa: E402
from speech_recognition_tpu_torch.ops import lattice_kernels as lt  # noqa: E402
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk  # noqa: E402
from speech_recognition_tpu_torch.ops.frontend import (  # noqa: E402
    FrontendConfig,
    _stack39,
    padded_length,
)
from speech_recognition_tpu_torch.ops.frontend_kernel import (  # noqa: E402
    mfcc39_fused,
    mfcc_fused,
    mfcc_tail,
)
from speech_recognition_tpu_torch.utils.build import load_library  # noqa: E402

PHASES = ("band", "barrier A", "eps scan", "eps reduce", "eps apply", "barrier B")


def ms(fn, reps=7):
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


def device_us(fn, reps=5):
    """Mean device time per call of each kernel ``fn`` launches (us;
    torch.profiler's CUPTI trace) and their sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / reps for e in prof.key_averages()
           if e.self_device_time_total > 0}
    return per, sum(per.values())


def cycles(lattice, nll, g, topo, nf, plan):
    trace = torch.zeros((nll.shape[2], len(PHASES)), dtype=torch.int64, device=nll.device)
    lk.lex_forward(nll, g, topo, nf, lattice, lt.viterbi_lattice if lattice else lk.viterbi_lex,
                   plan=plan, trace=trace)
    frames = nf.clamp(min=1 if lattice else 0, max=nll.shape[1]).double()
    per = (trace.double()[frames > 0] / frames[frames > 0, None]).mean(0).tolist()
    return ", ".join(f"{k} {v:.0f}" for k, v in zip(PHASES, per)) + f"; total {sum(per):.0f}"


def main():
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    limit = load_library().srt_smem_limit()

    # MFCC: K12, K3 (= K12's kernel + K14), K14 alone
    cfg = FrontendConfig()
    rng = np.random.default_rng(0)
    for b, n in ((256, 80000), (64, 400000)):
        L = padded_length(cfg, n) + 8 * 160
        sig = torch.from_numpy((rng.standard_normal((b, L)) * 3000).astype(np.float32)).to(dev)
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        ceps, nf = mfcc_fused(sig, lens, cfg)
        for name, fn in (("K12", lambda: mfcc_fused(sig, lens, cfg)),
                         ("K3", lambda: mfcc39_fused(sig, lens, cfg)),
                         ("K14", lambda: mfcc_tail(ceps, nf))):
            per, tot = device_us(fn)
            print(f"MFCC {b} x {n / 16000:.0f} s {name} device time per call {tot:.1f} us: "
                  + ", ".join(f"{k[:40]} {v:.1f}" for k, v in per.items()) + f" ({card})",
                  flush=True)
        print(f"MFCC {b} x {n / 16000:.0f} s ({ceps.shape[1]} frames): K12 "
              f"{ms(lambda: mfcc_fused(sig, lens, cfg)):.3f} ms, K3 "
              f"{ms(lambda: mfcc39_fused(sig, lens, cfg)):.3f} ms, K14 alone "
              f"{ms(lambda: mfcc_tail(ceps, nf)):.3f} ms (plain _stack39 "
              f"{ms(lambda: _stack39(ceps, nf, 'utterance')):.3f} ms) ({card})", flush=True)

    # K4 / K6 on the 1k trie and the dictionary-shaped trie
    words, trans, ids, lrng = bench_lexicon()
    g1k = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded
    wd, td, idd, drng = dict1_shaped_lexicon()
    gd = build_lex_graph(wd, td, idd, word_insertion_cost=0.5).banded
    band = g1k.band.clone()
    band[1, int(torch.nonzero(band[1] < 1e29)[50])] += 0.125
    cases = {"1k trie": (g1k, 128), "1k trie, general mode": (g1k._replace(band=band), 128),
             "dict1-shaped trie": (gd, 32)}
    t_len = 500
    for name, (g, b) in cases.items():
        topo = lk.lex_topology(g)
        g = g.to(dev)
        n_rows = topo.pack.rows.shape[0]
        nll = torch.from_numpy(lrng.uniform(0, 5, (n_rows, t_len, b)).astype(np.float32)).to(dev)
        nf_mixed = torch.from_numpy(np.r_[t_len, 1, np.random.default_rng(3).integers(
            2, t_len + 1, b - 2)].astype(np.int32)).to(dev)
        nf_full = torch.full((b,), t_len, dtype=torch.int32, device=dev)
        for lattice in (False, True):
            if lattice and name.startswith("dict1"):
                b_l = 16
                nll_l, nf = nll[:, :, :b_l].contiguous(), nf_full[:b_l]
            else:
                nll_l, nf = nll, (nf_full if lattice else nf_mixed)
            base = lk.lex_plan(lattice, topo, limit)
            variants = {"plan": base}
            if name == "1k trie":
                variants.update({
                    "device frontier": base._replace(front=False),
                    "tables via L1": base._replace(tables=False),
                    "gather": base._replace(gather=True),
                    "rows once": base._replace(rep=1),
                })
                variants["eps via L1"] = base._replace(eps=False)
                if lattice:
                    variants["tau in device memory"] = base._replace(tau=False)
            wrapper = lt.viterbi_lattice if lattice else lk.viterbi_lex
            for vname, plan in variants.items():
                t = ms(lambda: lk.lex_forward(nll_l, g, topo, nf, lattice, wrapper, plan=plan))
                if vname == "plan":
                    per, tot = device_us(lambda: lk.lex_forward(nll_l, g, topo, nf, lattice,
                                                                wrapper, plan=plan), reps=3)
                    t = f"{t:.3f} ms (device {tot / 1e3:.3f} ms)"
                else:
                    t = f"{t:.3f} ms"
                line = (f"{'K6' if lattice else 'K4'} {name} {nll_l.shape[2]} x {t_len} {vname} "
                        f"(frontier {plan.frontier}, tau {int(plan.tau)}, tables "
                        f"{int(plan.tables)}, eps {int(plan.eps)}, gather {int(plan.gather)}): "
                        f"{t} | cycles/frame {cycles(lattice, nll_l, g, topo, nf, plan)}")
                print(f"{line} ({card})", flush=True)


if __name__ == "__main__":
    main()

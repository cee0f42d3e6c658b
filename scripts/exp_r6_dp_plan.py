#!/usr/bin/env python3
"""Time the banded DP kernel (csrc/banded_forward.cu) under launch-plan
variants at the main-path shapes, on one GPU.

K13 at 512 x 500; K1's DP on the 385-state sausage and K8 on the
77-state sausage of 1-state words, 512 x 500, with the plan
``banded_plan`` picks and with one field changed at a time: streams per
CTA, staged frames (0: each stream writes its plane rows itself), the
emission ring, the frontier in device memory, the tables through L1; at
T = 250, B = 128 and the lengths chip_smoke.py uses.  Prints one line
per variant: CUDA-event median ms with the card's name and power limit,
and for the plan itself the cycles per frame step by phase (the kernel's
optional trace).

    python3 scripts/exp_r6_dp_plan.py
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
from speech_recognition_tpu_torch.models.graph import build_word_graph  # noqa: E402
from speech_recognition_tpu_torch.models.hmm import HMMBank  # noqa: E402
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk  # noqa: E402
from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays  # noqa: E402
from speech_recognition_tpu_torch.utils.build import load_library  # noqa: E402
from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix  # noqa: E402


PHASES = ("emission wait", "band", "eps", "plane rows", "mask", "flush")


def bank(n_states, seed):
    rng = np.random.default_rng(seed)
    ps = [random_gmm_hmm(rng, n_states=n_states, n_mix=4, dim=39, sep=3.0) for _ in range(11)]
    return HMMBank.from_numpy(np.stack([p["means"] for p in ps]),
                              np.log(np.stack([p["variances"] for p in ps])),
                              np.log(np.stack([p["weights"] for p in ps])),
                              np.stack([to_cost_matrix(p["trans"]) for p in ps]))


def ms(fn, reps=5):
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


def launcher(nll, g, nf, depth, mode, plan):
    """A closure that launches the DP kernel in ``mode`` with ``plan``;
    ``run(True)`` also returns the per-stream cycle trace."""
    dev = nll.device
    trace = torch.zeros((nll.shape[2], 6), dtype=torch.int64, device=dev)
    wrapper = {"fused": vk.viterbi_banded_fused, "general": vk.viterbi_banded_general,
               "wordtrace": vk.viterbi_banded_wordtrace}[mode]

    def run(traced=False):
        vk._banded_forward(nll, g, nf, depth, mode, wrapper, plan=plan,
                           trace=trace if traced else None)
        return trace
    return run


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    lib = load_library()
    limit, n_sm = lib.srt_smem_limit(), torch.cuda.get_device_properties(dev).multi_processor_count
    b5, b1 = bank(5, 0), bank(1, 0)
    cases = {
        "K1 DP sausage7 385": (connected_graph_arrays(b5, 7), 55, "fused"),
        "K8 1-state sausage7 77": (build_word_graph([b1.trans_cost[i].numpy() for i in range(11)],
                                                    [list(range(11))] * 7), 11, "general"),
    }
    rng = np.random.default_rng(0)
    # K13 (K1's emission launch) at 512 x 500 with the 11 x 5 x 4-mixture bank
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights

    bank_d = b5.to(dev)
    w, lw = gmm_emission_weights(*bank_d.flat_states())
    xa = augment_dtb(torch.from_numpy(rng.standard_normal((512, 500, 39))
                                      .astype(np.float32)).to(dev))
    print(f"K13 bank emission 512 x 500: {ms(lambda: vk.bank_emission(xa, w, lw)):.3f} ms "
          f"({card})", flush=True)
    for name, (graph, u, mode) in cases.items():
        g = banded_arrays(graph, device=dev)
        for b, t in ((512, 500), (512, 250), (128, 500)):
            nll = torch.from_numpy(rng.uniform(0, 5, (u, t, b)).astype(np.float32)).to(dev)
            if mode == "fused":  # K13's [T, B, U] layout
                nll = nll.permute(1, 2, 0).contiguous().permute(2, 0, 1)
            nf = torch.full((b,), t, dtype=torch.int32, device=dev)
            base = vk.banded_plan(b, n_sm, g.n_states, g.n_words, g.n_ends, u, mode, limit)
            variants = {"plan": base}
            if (b, t) == (512, 500):  # chip_smoke's lengths: T, 1, 0 and 2..T
                nf_mixed = torch.from_numpy(np.r_[t, 1, 0, rng.integers(2, t + 1, b - 3)]
                                            .astype(np.int32)).to(dev)
                run = launcher(nll, g, nf_mixed, graph.eps_depth, mode, base)
                per = (run(True).double().mean(0) / t).tolist()
                print(f"{name} B={b} T={t} plan, lengths T, 1, 0, 2..T: {ms(run):.3f} ms | "
                      "cycles/frame " + ", ".join(f"{k} {v:.0f}" for k, v in zip(PHASES, per))
                      + f" ({card})", flush=True)
            if (b, t) == (512, 500):
                variants.update({
                    "kf=0": base._replace(kf=0),
                    "kf=1": base._replace(kf=1),
                    "ring=0": base._replace(ring=False),
                    "tile=1": base._replace(tile=1),
                    "tile=2": base._replace(tile=2),
                    "tile=4": base._replace(tile=4),
                    "tile=1,kf=0": base._replace(tile=1, kf=0),
                    "device frontier": base._replace(work_smem=False),
                    "tables via L1": base._replace(tables=False),
                })
            for vname, plan in variants.items():
                plan = plan._replace(smem=vk.banded_smem_bytes(
                    mode, u, g.n_states, g.n_words, g.n_ends, plan.tile, plan.work_smem,
                    plan.tables, plan.ring, plan.kf))
                run = launcher(nll, g, nf, graph.eps_depth, mode, plan)
                line = (f"{name} B={b} T={t} {vname} (tile {plan.tile}, frontier "
                        f"{plan.frontier}, tables {int(plan.tables)}, ring {int(plan.ring)}, "
                        f"kf {plan.kf}): "
                        f"{ms(run):.3f} ms")
                if vname == "plan":  # cycles per frame step by phase, mean over streams
                    per = (run(True).double().mean(0) / t).tolist()
                    line += " | cycles/frame " + ", ".join(
                        f"{k} {v:.0f}" for k, v in zip(PHASES, per))
                print(f"{line} ({card})", flush=True)


if __name__ == "__main__":
    main()

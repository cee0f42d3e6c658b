#!/usr/bin/env python3
"""Count the windows K9 (csrc/banded_backtrace.cu) takes per stream on
K8's planes, on the CPU, with the emulation of the kernel's walk in
``tests/k9_walk.py`` (its rules are set out there), checked state for
state and flag for flag against the plain version ``banded_backtrace_tb``.

The planes are K8's plain version's at chip_smoke.py's shapes and seeds
(its 7-slot sausages of 1-state words and of 3-6-state words, 512 x 500,
uniform(0, 5) emissions, lengths T, 1, 0 and 2..T), walked for the first
``--streams`` streams.  Prints per stream the windows that had to be
waited for (first, after an unwind into another word, or after a band
step out of the span), the windows loaded during the walk before them,
the unwind steps and the frames.  These are counts of the walk, not
device times.

    python3 scripts/exp_r10_k9_windows.py [--streams 64]
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=64)
    n_streams = ap.parse_args().streams
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch

    import chip_smoke as cs
    from k9_walk import graph_tables, walk
    from speech_recognition_tpu_torch.models.graph import build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    b_len, t_len = 512, 500
    bank1, bank6 = cs.random_bank(1), cs.random_bank(6, seed=10)
    sizes = (3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5)
    graphs = {
        "1-state sausage7": build_word_graph(
            [bank1.trans_cost[i].numpy() for i in range(11)], [list(range(11))] * 7),
        "3-6-state sausage7": build_word_graph(
            [bank6.trans_cost[i].numpy()[:k, :k] for i, k in enumerate(sizes)],
            [list(range(11))] * 7)}
    erng = np.random.default_rng(11)  # chip_smoke.py's draws, in its order
    nf = np.r_[t_len, 1, 0, erng.integers(2, t_len + 1, b_len - 3)].astype(np.int32)
    for name, graph in graphs.items():
        g = banded_arrays(graph)
        topo = vk.banded_topology(g)
        u = int(graph.bank_state.max()) + 1
        nll = torch.from_numpy(erng.uniform(0, 5, (u, t_len, b_len)).astype(np.float32))
        erng.integers(0, 3, (u, t_len, b_len))  # the tie batch chip_smoke.py draws next
        final, bp8, eps_u = vk.viterbi_banded_general_ref(nll, g, topo, torch.from_numpy(nf),
                                                          graph.eps_depth)
        ends = g.end_states[torch.argmin(final[g.end_states] + g.end_bonus[:, None], 0)]
        sl = slice(0, n_streams)
        sp, fp = vk.banded_backtrace_general_ref(bp8[:, :, sl].contiguous(),
                                                 eps_u[:, :, sl].contiguous(), g, ends[sl],
                                                 torch.from_numpy(nf[sl]), graph.eps_depth)
        s, f, waited, ahead, unwinds = walk(bp8[:, :, sl].numpy(), eps_u[:, :, sl].numpy(),
                                            *graph_tables(g), ends[sl].numpy(), nf[sl],
                                            graph.eps_depth)
        if not (np.array_equal(s, sp.numpy()) and np.array_equal(f, fp.numpy())):
            sys.exit(f"the emulated walk differs from the plain version on the {name}")
        n = len(nf[sl])
        print(f"{name} ({g.n_states} states, eps depth {graph.eps_depth}), {n} streams x "
              f"{t_len} frames (CPU): the emulated walk == plain; windows waited for "
              f"{waited / n:.2f} per stream, loaded during the walk before them "
              f"{ahead / n:.2f}; unwind steps {unwinds / n:.2f}, frames with an unwind "
              f"{float(fp.sum()) / n:.2f}, frames {float(nf[sl].clip(0, t_len).mean()):.1f} "
              f"per stream")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Count the windows K5 (csrc/lex_backtrace.cu) takes per stream on K4's
planes, on the CPU, with the emulation of the kernel's walk in
``tests/k5_walk.py`` (its rules are set out there), checked state for
state and flag for flag against the plain version ``lex_backtrace_val_ref``.

The planes are K4's plain version's at chip_smoke.py's shapes: the
1,000-word trie at 128 x 500 with its uniform(0, 5) emissions and
lengths T, 1, 2..T; the same trie with planted-word emissions (random
words, each state held 2 frames, 0.05 on the planted rows and 8.0
elsewhere; seed 5); and the dictionary-shaped trie at 32 x 500 with
uniform(0, 5) emissions (``--dict1``; its plain forward takes ~30 s).
The first ``--streams`` streams are walked at each window size of
``--win`` (entries a window holds; the kernel's is 256).  Prints per
stream the windows of a new chain (waited for), the windows loaded during
the walk before them, the walks that left their chain by a band or cross
step, the eps steps and the frames.  These are counts of the walk, not
device times.

    python3 scripts/exp_r11_k5_windows.py [--streams 32] [--win 128,256,512,1024] [--dict1]
"""

import argparse
import os
import sys

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=32)
    ap.add_argument("--win", default="128,256,512,1024")
    ap.add_argument("--dict1", action="store_true")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tests"))
    import torch

    from k5_walk import graph_tables, walk
    from speech_recognition_tpu_torch.data.lexicon import (
        bench_lexicon,
        dict1_shaped_lexicon,
        planted_emissions,
    )
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    t_len, sl = 500, slice(0, args.streams)
    words, trans, ids, lrng = bench_lexicon()
    lex1k = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    e = lrng.uniform(0, 5, (128, t_len, 24)).astype(np.float32)  # chip_smoke.py's draw
    nf1k = np.r_[t_len, 1, np.random.default_rng(3).integers(2, t_len + 1, 126)]
    ep, nfp, _ = planted_emissions(np.random.default_rng(5), words, ids, 3, 24, args.streams,
                                   t_len)
    cases = [("1k trie, uniform", lex1k, np.ascontiguousarray(e.transpose(2, 1, 0))[:, :, sl],
              nf1k[sl]),
             ("1k trie, planted words", lex1k, ep, nfp)]
    if args.dict1:
        words, trans, ids, drng = dict1_shaped_lexicon()
        lexd = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
        n_bank = int(lexd.banded.bank_state.max()) + 1
        nlld = drng.uniform(0, 5, (n_bank, t_len, 32)).astype(np.float32)
        nfd = np.r_[t_len, 1, drng.integers(2, t_len + 1, 30)]
        cases.append(("dict1-shaped trie, uniform", lexd, nlld[:, :, sl], nfd[sl]))
    for name, lexg, nll, nf in cases:
        g = lexg.banded
        topo = lk.lex_topology(g)
        nf = torch.from_numpy(np.asarray(nf, np.int32))
        final, bp8, _, eps_prev = lk.viterbi_lex_ref(
            torch.from_numpy(np.ascontiguousarray(nll)), g, topo, nf)
        ends = g.end_states[torch.argmin(final[:, g.end_states] + g.end_bonus, 1)]
        sp, fp = lk.lex_backtrace_val_ref(bp8, eps_prev, g, ends, nf)
        chains, heads = lk.lex_chains(g)
        n = len(nf)
        valid = np.arange(t_len)[:, None] < nf.numpy()[None, :]
        for k_win in (int(x) for x in args.win.split(",")):
            s, f, waited, ahead, left = walk(bp8.numpy(), eps_prev.numpy(), *graph_tables(g),
                                             chains, heads, ends.numpy(), nf.numpy(), k_win)
            if not (((s == sp.numpy()) & (f == fp.numpy())) | ~valid).all():
                sys.exit(f"the emulated walk differs from the plain version on the {name}")
            print(f"{name} ({g.n_states} states, mean chain {heads[:, 0].mean():.1f}), {n} "
                  f"streams x {t_len} frames, {k_win}-entry windows (CPU): the emulated walk "
                  f"== plain; windows waited for {waited / n:.2f} per stream, loaded during "
                  f"the walk {ahead / n:.2f}; chains left by a band or cross step "
                  f"{left / n:.2f}; eps steps {float((fp.numpy() & valid).sum()) / n:.2f}, "
                  f"frames {float(nf.numpy().clip(0, t_len).mean()):.1f} per stream")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the lexical-tree backtrace K5 (csrc/lex_backtrace.cu) and the trie
forward K4 / K6 (csrc/viterbi_lex.cu) at the main path's shapes, with the
lexical-tree pipeline around them, on one GPU.

    python3 scripts/exp_r11_lex_backtrace.py [--root DIR] [--tag NAME] [--lab]

``--root`` names the checkout whose ``speech_recognition_tpu_torch`` and
``chip_smoke.py`` (for its timers and pipeline set-up) are imported,
default this one, so that an older tree unpacked beside it is timed on
the same seeded inputs through the same public entry points; compare two
trees only inside one call, in turns (old, new, new, old).  Times are
CUDA-event medians (``chip_smoke.cuda_ms``), in ms, which include the
wrappers' host work; ``dev`` holds the device times of the kernels alone
(``chip_smoke.device_ms``: torch.profiler, summed over the kernels a call
launches).  Inputs are chip_smoke.py's:

  k5_1k          K5 at 128 x 500 on the 1,000-word trie, on the plain
                 forward's planes of uniform(0, 5) emissions, lengths T, 1,
                 2..T
  k5_dict1       K5 at 32 x 500 on the dictionary-shaped trie (86,520
                 states), the same kind of input
  k4_1k, k6_1k   K4 and K6 at 128 x 500 on the 1k trie (the plan on chip)
  k4_dict1       K4 at 32 x 500 on the dictionary-shaped trie
  k4_large_bank  K4 at 16 x 500 on the 8,000-bank-row trie (no row
                 tables; "refused" where the tree raises)
  lex_pipeline   128 x 5 s wav -> paths over the 1k trie (K3 +
                 bank_nll_ubt + K4 + argmin + K5)

``--lab`` (this tree's kernels only) adds K5's clock64 trace: lane 0's
cycles per stream fetching new chains' rows, waiting for windows,
stashing, issuing the next window, walking and writing out, and the
windows waited for and loaded during the walk (mean and the slowest
stream).  Prints one JSON
line, tagged ``--tag``, with the card's name and power limit.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--lab", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_r11: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import speech_recognition_tpu_torch as pkg
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon, dict1_shaped_lexicon
    from speech_recognition_tpu_torch.decode.lextree import _decode_lex_batch
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.ops.frontend import mfcc39_auto
    from speech_recognition_tpu_torch.utils.build import build

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r11: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build()
    ms, dv = cs.cuda_ms, cs.device_ms
    out = {"tag": args.tag, "root": root, "card": card, "dev": {}}
    takes_topo = "topo" in inspect.signature(lk.lex_backtrace_val).parameters

    def timed(name, fn, reps=10):
        out[name] = ms(fn, reps=reps)
        out["dev"][name] = dv(fn)

    t_len = 500
    words, trans, ids, lrng = bench_lexicon()
    g1k = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded.to(dev)
    e = lrng.uniform(0, 5, (128, t_len, 24)).astype(np.float32)
    nll1k = torch.from_numpy(np.ascontiguousarray(e.transpose(2, 1, 0))).to(dev)
    nf1k = torch.from_numpy(np.r_[t_len, 1, np.random.default_rng(3).integers(
        2, t_len + 1, 126)].astype(np.int32)).to(dev)
    words, trans, ids, drng = dict1_shaped_lexicon()
    gd = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded.to(dev)
    n_bank = int(gd.bank_state.max()) + 1
    nlld = torch.from_numpy(drng.uniform(0, 5, (n_bank, t_len, 32)).astype(np.float32)).to(dev)
    nfd = torch.from_numpy(np.r_[t_len, 1, drng.integers(2, t_len + 1, 30)]
                           .astype(np.int32)).to(dev)
    for name, g, nll, nf in (("1k", g1k, nll1k, nf1k), ("dict1", gd, nlld, nfd)):
        topo = lk.lex_topology(g)
        final, bp8, _, eps_prev = lk.viterbi_lex_ref(nll, g, topo, nf)
        ends = g.end_states[torch.argmin(final[:, g.end_states] + g.end_bonus, 1)]
        kw = {"topo": topo} if takes_topo else {}
        timed(f"k5_{name}", lambda: lk.lex_backtrace_val(bp8, eps_prev, g, ends, nf, **kw),
              reps=20)
        timed(f"k4_{name}", lambda: lk.viterbi_lex(nll, g, topo, nf))
        if name == "1k":
            timed("k6_1k", lambda: lt.viterbi_lattice(nll, g, topo, nf))
        if args.lab:
            tr = torch.zeros((nf.numel(), 9), dtype=torch.int64, device=dev)
            lk.lex_backtrace_val(bp8, eps_prev, g, ends, nf, topo=topo, trace=tr)
            torch.cuda.synchronize()
            tr = tr[tr[:, 8] > 0].double()
            slow = int(tr[:, :6].sum(1).argmax())
            out[f"k5_{name} trace"] = {
                "mean cycles: rows, wait, stash, issue, walk, write": tr[:, :6].mean(0).tolist(),
                "slowest stream": tr[slow].tolist(),
                "mean windows waited, ahead; frames": tr[:, 6:].mean(0).tolist()}
        del final, bp8, eps_prev
    try:
        from speech_recognition_tpu_torch.data.lexicon import large_bank_lexicon

        words, trans, ids, brng = large_bank_lexicon()
        gb = build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded.to(dev)
        nllb = torch.from_numpy(brng.uniform(0, 5, (8000, t_len, 16)).astype(np.float32)).to(dev)
        nfb = torch.from_numpy(np.r_[t_len, 1, brng.integers(2, t_len + 1, 14)]
                               .astype(np.int32)).to(dev)
        topob = lk.lex_topology(gb)
        timed("k4_large_bank", lambda: lk.viterbi_lex(nllb, gb, topob, nfb))
    except (ImportError, ValueError) as err:  # the parent refuses the bank
        out["k4_large_bank"] = f"refused: {err}"

    bank, lexp, cfg, sig, lens = cs.make_lex_pipeline(dev)
    gp, topop = lexp.banded.to(dev), lk.lex_topology(lexp.banded)

    def lex_pipeline():
        f, n = mfcc39_auto(sig, lens, cfg)
        return _decode_lex_batch(bank, f, n, gp, topop)

    timed("lex_pipeline", lex_pipeline, reps=10)
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(os.getcwd(), "chiprun_out"), exist_ok=True)
    with open(os.path.join(os.getcwd(), "chiprun_out", f"exp_r11_{args.tag}.json"), "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Kernels K15 (banded) and K16 (dense forward-backward) on the card:
each against its plain version, then (without ``--check``) timed with
CUDA events beside the plain version, and the K15 / K16 crossover on
padded transcript graphs.

Inputs are made from seeds with numpy: transcript graphs of 1-7 words
over 11 five-state left-to-right models plus an optional silence model
(``models.graph.transcript_graph``), the 11-word loop, the 7-slot
sausage (385 states), the 1,000-word trie of ``data.lexicon.bench_lexicon``
(9,588 states, cross edges), a sausage with 1-state words (eps depth 3),
and emission costs of 40-60 a frame, the size a 39-dimensional GMM
gives.  It prints each output's largest difference from the plain
version and, for gamma, where it sits (|alpha| there), then the timings.

Run from the repository root on a machine with one GPU:

    python3 scripts/exp_r13_forward_backward.py [--check]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from speech_recognition_tpu_torch.models.graph import (  # noqa: E402
    build_loop_graph,
    build_word_graph,
    pad_graphs,
    pad_graphs_banded,
    transcript_graph,
)
from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans  # noqa: E402
from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk  # noqa: E402
from speech_recognition_tpu_torch.ops.viterbi_banded import (  # noqa: E402
    BandedGraph,
    banded_arrays,
)
from speech_recognition_tpu_torch.utils import build  # noqa: E402

DEV = torch.device("cuda", 0)


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def emissions(rng, b, t_len, s):
    return torch.from_numpy(rng.uniform(40, 60, (b, t_len, s)).astype(np.float32)).to(DEV)


def lengths(rng, b, t_len):
    nf = rng.integers(max(t_len // 2, 1), t_len + 1, b)
    nf[0] = t_len
    if b > 3:
        nf[1], nf[2] = 0, 1
    return torch.from_numpy(nf.astype(np.int32)).to(DEV)


def transcripts(rng, b, sil=True):
    trans = [uniform_left_to_right_trans(5) for _ in range(12)]
    graphs = [transcript_graph(trans, list(rng.integers(0, 11, rng.integers(1, 8))),
                               sil=11 if sil else None) for _ in range(b)]
    return graphs


def dense_batch(graphs):
    gb, depth = pad_graphs(graphs)
    return {k: torch.as_tensor(gb[k]).to(DEV) for k in
            ("trans", "eps_trans", "init_cost", "end_scores")}, depth


def banded_batch(graphs):
    gb, depth = pad_graphs_banded(graphs)
    g = BandedGraph(band=gb["band"], init_cost=gb["init_cost"], word_starts=gb["word_starts"],
                    word_ends=gb["word_ends"], eps_block=gb["eps_block"],
                    start_pos=gb["start_pos"], is_start=gb["is_start"],
                    end_states=None, end_bonus=None, bank_state=gb["bank_state"])
    return BandedGraph(*[None if x is None else torch.as_tensor(x).to(DEV) for x in g]), \
        torch.as_tensor(gb["end_scores"]).to(DEV), depth


def compare(name, got, want, alpha_hint=None):
    err = {"log_z_rel": float(((got.log_z - want.log_z).abs()
                               / want.log_z.abs().clamp(min=1e-30)).max()),
           "gamma_abs": float((got.gamma - want.gamma).abs().max()),
           "xi_abs": float((got.xi_sum - want.xi_sum).abs().max()),
           "xi_rel": float(((got.xi_sum - want.xi_sum).abs()
                            / want.xi_sum.abs().clamp(min=1e-3)).max())}
    if got.xi_cross is not None:
        err["xi_cross_abs"] = float((got.xi_cross - want.xi_cross).abs().max())
    err["log_z_range"] = [float(want.log_z.min()), float(want.log_z.max())]
    finite = torch.isfinite(got.gamma).all() and torch.isfinite(got.xi_sum).all()
    print(f"[check] {name}: {json.dumps(err)} finite={bool(finite)}", flush=True)
    return err


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="checks only, no timings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__}", flush=True)
    lib_path = build.build()
    lib = build.load_library()
    with open(lib_path + ".log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "fb_" in line and ("Compiling" in line or "Function properties" in line):
            print("[build]", line.strip(), "|", " ".join(x.strip() for x in lines[i + 1:i + 3]))
    rng = np.random.default_rng(0)

    # ---- K16 ----
    cases16 = {}
    graphs = transcripts(rng, 419)
    g16, d16 = dense_batch(graphs)
    s16 = g16["trans"].shape[1]
    nll16 = emissions(rng, 419, 319, s16)
    nf16 = lengths(rng, 419, 319)
    cases16["transcripts 419x319"] = (nll16, g16, d16, nf16)
    g_small, d_small = dense_batch(transcripts(rng, 37))
    s_small = g_small["trans"].shape[1]
    cases16["transcripts 37x60"] = (emissions(rng, 37, 60, s_small), g_small, d_small,
                                    lengths(rng, 37, 60))
    # one S past the shared-memory tier: a loop of 34 five-state words
    trans5 = [uniform_left_to_right_trans(5) for _ in range(34)]
    loop34 = build_loop_graph(trans5)
    gl = {"trans": torch.as_tensor(loop34.trans).to(DEV),
          "eps_trans": torch.as_tensor(loop34.eps_trans).to(DEV),
          "init_cost": torch.as_tensor(loop34.init_cost).to(DEV),
          "end_scores": None}
    cases16[f"loop {loop34.n_states} states 8x60 (past the tier)"] = (
        emissions(rng, 8, 60, loop34.n_states), gl, 1, lengths(rng, 8, 60))
    for name, (nll, g, depth, nf) in cases16.items():
        for mode in ("band", "dense"):
            s = nll.shape[2]
            plan = fk.dense_plan(s, True, nll.shape[0],
                                 torch.cuda.get_device_properties(DEV).multi_processor_count,
                                 lib.fb_dense_smem_bytes, lib.srt_smem_limit())
            kw = dict(eps_trans=g["eps_trans"], eps_depth=depth, end_scores=g["end_scores"],
                      xi_mode=mode)
            got = fk.fb_dense(nll, g["trans"], g["init_cost"], nf, **kw)
            want = fk.fb_dense_ref(nll, g["trans"], g["init_cost"], nf, **kw)
            torch.cuda.synchronize()
            compare(f"K16 {name} xi {mode} ({plan})", got, want)

    # ---- K15 ----
    cases15 = {}
    trans11 = [uniform_left_to_right_trans(5) for _ in range(11)]
    loop = build_loop_graph(trans11)
    cases15["loop 100x200"] = (banded_arrays(loop, DEV), emissions(rng, 100, 200, loop.n_states),
                               lengths(rng, 100, 200), 1, None)
    saus = build_word_graph(trans11, [list(range(11))] * 7)
    cases15["sausage7 256x500"] = (banded_arrays(saus, DEV),
                                   emissions(rng, 256, 500, saus.n_states),
                                   lengths(rng, 256, 500), 1, None)
    one = build_word_graph([uniform_left_to_right_trans(1)] + trans11[:3], [[0, 1, 2, 3]] * 5)
    cases15[f"1-state words sausage (eps depth {one.eps_depth}) 32x100"] = (
        banded_arrays(one, DEV), emissions(rng, 32, 100, one.n_states),
        lengths(rng, 32, 100), one.eps_depth, None)
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    w, t, ids, _ = bench_lexicon()
    lex = build_lex_graph(w, t, ids, word_insertion_cost=0.5).banded.to(DEV)
    end_lex = torch.full((lex.n_states,), -float("inf"), device=DEV)
    end_lex[lex.end_states] = 0.0
    cases15["1k trie 16x200 (cross edges)"] = (lex, emissions(rng, 16, 200, lex.n_states),
                                              lengths(rng, 16, 200), 1, end_lex)
    gb15, end15, d15 = banded_batch(graphs)
    cases15["transcripts 419x319 (padded per-item banded dict)"] = (gb15, nll16, nf16, d15,
                                                                      end15)
    for name, (g, nll, nf, depth, end) in cases15.items():
        got = fk.fb_banded(nll, g, nf, depth, end)
        want = fk.fb_banded_ref(nll, g, nf, depth, end)
        torch.cuda.synchronize()
        plan = fk.banded_plan(g.band.shape[-1], g.word_starts.shape[-1], g.word_ends.shape[-1],
                              lib.fb_banded_smem_bytes, lib.srt_smem_limit())
        compare(f"K15 {name} ({plan})", got, want)
    if args.check:
        return 0

    # ---- timings ----
    t16 = cuda_ms(lambda: fk.fb_dense(nll16, g16["trans"], g16["init_cost"], nf16,
                                      g16["eps_trans"], d16, g16["end_scores"], "band"))
    p16 = cuda_ms(lambda: fk.fb_dense_ref(nll16, g16["trans"], g16["init_cost"], nf16,
                                          g16["eps_trans"], d16, g16["end_scores"], "band"),
                  reps=1)
    g_s, nll_s, nf_s, _, _ = cases15["sausage7 256x500"]
    t15 = cuda_ms(lambda: fk.fb_banded(nll_s, g_s, nf_s))
    p15 = cuda_ms(lambda: fk.fb_banded_ref(nll_s, g_s, nf_s), reps=1)
    t15t = cuda_ms(lambda: fk.fb_banded(nll16, gb15, nf16, d15, end15))
    print(f"[timing] K16 transcripts 419x319 S={s16} band xi: {t16:.3f} ms, plain {p16:.3f} ms; "
          f"K15 sausage7 256x500: {t15:.3f} ms, plain {p15:.3f} ms; K15 on the same "
          f"transcripts (banded dict): {t15t:.3f} ms ({card})", flush=True)
    # crossover: padded transcript graphs of ~30-400 states, 256 x 300
    sweep = []
    for n_words in (1, 2, 3, 5, 8, 12, 16, 24, 32, 40):
        gs = [transcript_graph(trans11 + [uniform_left_to_right_trans(5)],
                               list(rng.integers(0, 11, n_words)), sil=11)
              for _ in range(256)]
        gd, dd = dense_batch(gs)
        gbb, eb, db = banded_batch(gs)
        s = gd["trans"].shape[1]
        nll = emissions(rng, 256, 300, s)
        nf = torch.full((256,), 300, dtype=torch.int32, device=DEV)
        k16 = cuda_ms(lambda: fk.fb_dense(nll, gd["trans"], gd["init_cost"], nf, gd["eps_trans"],
                                          dd, gd["end_scores"], "band"), reps=3)
        k15 = cuda_ms(lambda: fk.fb_banded(nll, gbb, nf, db, eb), reps=3)
        sweep.append((s, k16, k15))
        print(f"[sweep] S={s}: K16 {k16:.3f} ms, K15 {k15:.3f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

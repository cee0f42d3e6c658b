#!/usr/bin/env python3
"""Time the forward-backward kernels K15 (banded) and K16 (dense),
``csrc/forward_backward.cu``, at the main paths' shapes on one GPU, and
check each against its plain version.

    python3 scripts/exp_r14_forward_backward.py [--root DIR] [--tag NAME]
        [--check] [--lab] [--save FILE] [--compare A B]

``--root`` names the checkout whose ``speech_recognition_tpu_torch`` and
``chip_smoke.py`` (for its timers) are imported, default this one, so
that an older tree unpacked beside it is timed on the same seeded inputs
through the same wrappers; compare two trees only inside one call, in
turns (old, new, new, old).  Shapes (inputs from seeds with numpy;
emission costs uniform(40, 60), the size a 39-dimensional GMM gives):

  k15_sausage    K15 at 256 x 500 on the 385-state 7-slot sausage
  k15_conf       K15 at 105 x 302 on the 60-state loop of 12 five-state
                 words, -inf end scores off the word ends (the confidence
                 call's shape)
  k15_tr         K15 on 419 padded transcript graphs (banded dict) 419 x 319
  k16_soft       K16 at 419 x 319 on padded transcript graphs with
                 silence arcs (75 states), bank_nll emissions of a seeded
                 12-model bank, xi band (the soft-EM call's shape)
  k16_synth      K16 on the same graphs with uniform emissions, xi band

Each gets its CUDA-event median (``chip_smoke.cuda_ms``: the wrapper's
host work included), its device time (``chip_smoke.device_ms``:
torch.profiler, summed over the kernels a call launches) and its host
time (the wrapper's enqueue: a host clock around the call, no
synchronisation, median of 20).  ``--check`` holds each against its
plain version first (log Z rtol 1e-5, gamma atol 1e-4, xi rtol 1e-4 /
atol 1e-3) and a second call against the first (bit for bit), and prints
the build log's ptxas lines (registers, spills) and the scan CTAs
resident an SM.  ``--lab`` (this tree's kernels only) adds each kernel's device time by
launch (scan, combine), also with the scan CTAs capped at 32 and 64
threads (the plan's ``fb_threads`` patched for the call), and the scan's
clock64 trace: thread 0's cycles
a frame by phase (setup, frame step, eps reduce or eps step, eps apply,
log Z), averaged over the forward CTAs and over the backward CTAs, at the
case's batch and at one scan CTA an SM (the first n_SM / 2 items: what
the frames cost without other CTAs on the SM).
``--save FILE`` writes each case's outputs (torch.save);
``--compare A B`` prints, for two such files (two trees on one card),
each output's largest difference and whether it is bit-identical.
Prints one JSON line, tagged ``--tag``, with the card's name and power
limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def compare(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    for case in a:
        line = []
        for k in a[case]:
            x, y = a[case][k], b[case][k]
            if x is None:
                continue
            same = torch.equal(x, y)
            d = float((x - y).abs().max()) if x.numel() else 0.0
            line.append(f"{k} {'bit-identical' if same else f'max |d| {d:.3g}'}")
        print(f"[compare] {case}: " + ", ".join(line), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--lab", action="store_true")
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_r14: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import speech_recognition_tpu_torch as pkg
    from speech_recognition_tpu_torch.models.graph import (
        build_loop_graph,
        build_word_graph,
        pad_graphs,
        pad_graphs_banded,
        transcript_graph,
    )
    from speech_recognition_tpu_torch.models.hmm import bank_nll, uniform_left_to_right_trans
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph, banded_arrays
    from speech_recognition_tpu_torch.utils import build

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r14: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    lib_path = build.build()
    lib = build.load_library()
    rng = np.random.default_rng(14)

    def emissions(b, t_len, s):
        return torch.from_numpy(rng.uniform(40, 60, (b, t_len, s)).astype(np.float32)).to(dev)

    def lengths(b, t_len):
        nf = rng.integers(max(t_len // 2, 1), t_len + 1, b)
        nf[0], nf[1], nf[2] = t_len, 0, 1
        return torch.from_numpy(nf.astype(np.int32)).to(dev)

    trans11 = [uniform_left_to_right_trans(5) for _ in range(12)]
    cases = {}
    saus = build_word_graph(trans11[:11], [list(range(11))] * 7)
    cases["k15_sausage"] = ("K15", (emissions(256, 500, saus.n_states), banded_arrays(saus, dev),
                                    lengths(256, 500)), {})
    loop = build_loop_graph(trans11)
    g_loop = banded_arrays(loop, dev)
    end_loop = torch.full((loop.n_states,), -float("inf"), device=dev)
    end_loop[g_loop.end_states] = 0.0
    cases["k15_conf"] = ("K15", (emissions(105, 302, loop.n_states), g_loop, lengths(105, 302)),
                         {"end_scores": end_loop})
    graphs = [transcript_graph(trans11, [int(x) for x in rng.integers(0, 11, rng.integers(1, 8))],
                               sil=11) for _ in range(419)]
    gb, db = pad_graphs_banded(graphs)
    g15t = BandedGraph(*[torch.as_tensor(gb[k], device=dev) for k in (
        "band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos", "is_start")],
        end_states=None, end_bonus=None, bank_state=None)
    gd, dd = pad_graphs(graphs)
    g16 = {k: torch.as_tensor(gd[k], device=dev) for k in
           ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")}
    s16 = g16["trans"].shape[1]
    nf16 = lengths(419, 319)
    bank = cs.random_bank(5, n_models=12).to(dev)
    feats = torch.from_numpy(rng.standard_normal((419, 319, 39)).astype(np.float32)).to(dev)
    nll_soft = bank_nll(bank, feats).gather(
        2, g16["bank_state"].long()[:, None, :].expand(419, 319, s16)).contiguous()
    cases["k15_tr"] = ("K15", (emissions(419, 319, g15t.band.shape[-1]), g15t, nf16),
                       {"eps_depth": db, "end_scores": torch.as_tensor(gb["end_scores"],
                                                                       device=dev)})
    k16_kw = {"eps_trans": g16["eps_trans"], "eps_depth": dd, "end_scores": g16["end_scores"],
              "xi_mode": "band"}
    cases["k16_soft"] = ("K16", (nll_soft, g16["trans"], g16["init_cost"], nf16), k16_kw)
    cases["k16_synth"] = ("K16", (emissions(419, 319, s16), g16["trans"], g16["init_cost"],
                                  nf16), k16_kw)
    kern = {"K15": (fk.fb_banded, fk.fb_banded_ref), "K16": (fk.fb_dense, fk.fb_dense_ref)}

    out = {"tag": args.tag, "root": root, "card": card, "torch": torch.__version__}
    if args.check:
        with open(lib_path + ".log") as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if "fb_" in line and "Compiling entry" in line:
                print("[ptxas]", line.strip(), "|",
                      " | ".join(x.strip() for x in lines[i + 1:i + 4]), flush=True)
        if hasattr(lib, "fb_scan_occupancy"):
            for name, (k, a_, kw) in cases.items():
                s = a_[0].shape[2]
                if k == "K15":
                    g = a_[1]
                    p = fk.banded_plan(s, g.word_starts.shape[-1], g.word_ends.shape[-1],
                                       lib.fb_banded_smem_bytes, lib.srt_smem_limit())
                else:
                    p = fk.dense_plan(s, True, a_[0].shape[0], torch.cuda.get_device_properties(
                        dev).multi_processor_count, lib.fb_dense_smem_bytes,
                        lib.srt_smem_limit())
                n = lib.fb_scan_occupancy(int(k == "K16"), p.threads, p.smem)
                print(f"[plan] {name}: {p}, scan CTAs resident an SM {n}, "
                      f"{2 * a_[0].shape[0]} scan CTAs", flush=True)
        for name, (k, a_, kw) in cases.items():
            fn, ref = kern[k]
            got = fn(*a_, **kw)
            again = fn(*a_, **kw)
            want = ref(*a_, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(got, again) if x is not None)
            fin = torch.isfinite(want.log_z)
            err = {"log_z_rel": float(((got.log_z - want.log_z).abs()
                                       / want.log_z.abs().clamp(min=1e-30))[fin].max()),
                   "gamma_abs": float((got.gamma - want.gamma).abs().max()),
                   "xi_abs": float((got.xi_sum - want.xi_sum).abs().max()),
                   "xi_rel_past_atol": float(((got.xi_sum - want.xi_sum).abs() - 1e-3).clamp(
                       min=0).div(want.xi_sum.abs().clamp(min=1e-30)).max()),
                   "repeat_bit_identical": same}
            ok = (err["log_z_rel"] <= 1e-5 and err["gamma_abs"] <= 1e-4
                  and err["xi_rel_past_atol"] <= 1e-4 and same
                  and bool(torch.isfinite(got.gamma).all()))
            print(f"[check] {name}: {json.dumps(err)} {'ok' if ok else 'FAILED'}", flush=True)
            out.setdefault("check", {})[name] = ok
    if args.save:
        saved = {}
        for name, (k, a_, kw) in cases.items():
            r = kern[k][0](*a_, **kw)
            saved[name] = {f: (None if x is None else x.cpu()) for f, x in zip(r._fields, r)}
        torch.save(saved, args.save)

    def host_ms(fn, reps=20):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    for name, (k, a_, kw) in cases.items():
        fn = kern[k][0]
        call = lambda: fn(*a_, **kw)  # noqa: E731
        out[name] = {"event_ms": cs.cuda_ms(call, reps=9),
                     "device_ms": cs.device_ms(call, reps=5, what=name),
                     "host_ms": host_ms(call)}
        print(f"[timing] {args.tag} {name}: {json.dumps(out[name])} ({card})", flush=True)
    if args.lab:
        lab(cases, fk, out, card)
    print(json.dumps(out), flush=True)
    return 0 if all(out.get("check", {}).values()) else 1


def by_kernel_ms(fn, reps=5):
    """Device ms a call by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0][:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def lab(cases, fk, out, card):
    import torch

    phases = ("setup", "frame step", "eps reduce / step", "eps apply", "log Z")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def traced(k, a_, kw, b):
        """Each scan CTA's phases over the first ``b`` items."""
        x = [a_[0][:b], a_[1] if a_[1].__class__.__name__ == "BandedGraph" and
             a_[1].band.dim() == 2 else _head(a_[1], b)] + [_head(y, b) for y in a_[2:]]
        kw = {n: _head(y, b) for n, y in kw.items()}
        t_len = x[0].shape[1]
        trace = torch.zeros((2 * b, 8), dtype=torch.int64, device=x[0].device)
        if k == "K15":
            fk._banded(x[0], x[1], x[2], kw.get("eps_depth", 1), kw.get("end_scores"),
                       trace=trace)
        else:
            fk._dense(*x, kw["eps_trans"], kw["eps_depth"], kw["end_scores"], kw["xi_mode"],
                      trace=trace)
        torch.cuda.synchronize()
        nf = (x[2] if k == "K15" else x[3]).clamp(min=1, max=t_len).double()
        tr = trace.double().cpu()
        rows = {}
        for d, label in ((0, "forward"), (1, "backward")):
            per = tr[d::2]
            frames = float(nf.sum()) if d == 0 else float((nf - 1).clamp(min=1).sum())
            rows[label] = {"setup cycles (mean)": float(per[:, 0].mean()),
                           **{f"{ph} cycles a frame": float(per[:, i].sum()) / frames
                              for i, ph in enumerate(phases) if i},
                           "total cycles (max CTA)": float(per[:, :5].sum(1).max())}
        return rows

    for name, (k, a_, kw) in cases.items():
        fn = fk.fb_banded if k == "K15" else fk.fb_dense
        out.setdefault("lab", {})[name] = {"device_ms_by_kernel": by_kernel_ms(
            lambda: fn(*a_, **kw))}
        # the same call with the scan CTAs capped at 32 and 64 threads
        orig = fk.fb_threads
        for cap in (32, 64):
            fk.fb_threads = lambda s_, c=cap: min(orig(s_), c)  # noqa: E731
            try:
                out["lab"][name][f"device_ms_by_kernel, {cap} threads"] = by_kernel_ms(
                    lambda: fn(*a_, **kw))
            finally:
                fk.fb_threads = orig
        b = a_[0].shape[0]
        out["lab"][name]["trace"] = traced(k, a_, kw, b)
        out["lab"][name]["trace, one CTA an SM"] = traced(k, a_, kw, min(b, n_sm // 2))
        print(f"[lab] {name}: {json.dumps(out['lab'][name])} ({card})", flush=True)


def _head(x, b):
    """The first ``b`` items of a per-item input (a BandedGraph's arrays
    too); shared inputs, numbers and None as they are."""
    import torch

    if isinstance(x, torch.Tensor):
        return x[:b] if x.dim() >= 1 and x.shape[0] > b else x
    if hasattr(x, "_fields"):  # a per-item BandedGraph
        return type(x)(*[None if y is None else (y[:b] if y.dim() >= 2 else y) for y in x])
    return x


if __name__ == "__main__":
    sys.exit(main())

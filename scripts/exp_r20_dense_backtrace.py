#!/usr/bin/env python3
"""Time the dense backtrace K21 (csrc/dense_backtrace.cu) in its two forms,
and the window form under other sizes, at the main paths' shapes on one
GPU.

    python3 scripts/exp_r20_dense_backtrace.py [--check] [--sweep] [--tag NAME]

Inputs are K11's planes of chip_smoke.py's dense cases (seeded):

  sausage       the 385-state 7-slot sausage at 64 x 500 (eps depth 1)
  isolated      5,632 items (512 x 11 models) of 5 states x 500 frames,
                end state the last, eps_bp all -1 (eps depth 1), as
                segmental K-means walks them
  transcripts   256 padded transcript graphs (per-item matrices, silence
                optional), each item's best end state
  ties          the integer tie batch (48 states, 64 x 200, eps depth 2,
                random transitions: the walk jumps both ways)

For each case the chain form (one thread a stream: the kernel before the
window form) is "parent" and the window form ``dense_backtrace_plan``
picks is "change", timed parent, change, change, parent (CUDA-event
medians, ms, with the wrapper's host work) beside their device times
(torch.profiler, ``chip_smoke.device_ms``), and the window form's
counters (``_backtrace(stats=)``): windows a stream, loads ahead taken
and dropped, bytes staged, the share of its cycles in window changes and
in waits for copies.  ``--check`` first holds every form timed to
``viterbi_backtrace_ref`` bit for bit.  ``--sweep`` adds the window form
at other frames x states a window and, where S < 32, other lanes a
stream (device times).  Prints one JSON line, tagged ``--tag``, with the
card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dense_walks(dev) -> dict:
    """K21's arguments ``(bp, eps_bp, end, n_frames, eps_depth)`` on K11's
    planes of chip_smoke.py's four dense cases (seeded), by name."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from speech_recognition_tpu_torch.decode.connected import connected_graph_arrays
    from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
    from speech_recognition_tpu_torch.models.hmm import bank_nll, linear_init_cost
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk

    B, T = 512, 500
    bank = cs.random_bank(5).to(dev)
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, 39)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[T, 1, np.random.default_rng(2).integers(
        2, T + 1, B - 2)].astype(np.int32)).to(dev)
    mask = torch.arange(T, device=dev)[None, :] < nf[:, None]
    nll_bank = bank_nll(bank, feats, mask)
    n_m, n_s = bank.n_models, bank.n_states
    g7 = connected_graph_arrays(bank, 7)
    bank_sil = cs.random_bank(5, n_models=12).to(dev)
    trng = np.random.default_rng(13)
    trans_sil = [bank_sil.trans_cost[i].cpu().numpy() for i in range(12)]
    gb, depth_tr = pad_graphs([transcript_graph(
        trans_sil, [int(x) for x in trng.integers(0, 11, trng.integers(2, 8))], sil=11)
        for _ in range(256)])
    bstate = torch.as_tensor(gb["bank_state"], device=dev).long()
    nll_sil = bank_nll(bank_sil, feats[:256], mask[:256])
    nll_sil = nll_sil.gather(2, bstate[:, None, :].expand(256, T, bstate.shape[1]))
    s_tie, t_tie = 48, 200
    trans_tie = trng.integers(0, 3, (2, s_tie, s_tie)).astype(np.float32)
    trans_tie[0][trng.uniform(size=(s_tie, s_tie)) < 0.5] = 1e30
    trans_tie[1][trng.uniform(size=(s_tie, s_tie)) < 0.8] = 1e30
    init_tie = np.where(np.arange(s_tie) < 12, trng.integers(0, 3, s_tie), 1e30)

    def on(x):
        return torch.as_tensor(x, device=dev)

    cases = {
        "isolated": dict(
            nll=nll_bank.reshape(B, T, n_m, n_s).permute(0, 2, 1, 3)
            .reshape(B * n_m, T, n_s).contiguous(),
            trans=bank.trans_cost[None].expand(B, n_m, n_s, n_s)
            .reshape(B * n_m, n_s, n_s).contiguous(),
            init_cost=on(linear_init_cost(n_s)), n_frames=nf.repeat_interleave(n_m),
            eps_trans=None, eps_depth=1),
        "sausage": dict(
            nll=nll_bank[:64][:, :, on(g7.bank_state).long()].contiguous(),
            trans=on(g7.trans), init_cost=on(g7.init_cost), n_frames=nf[:64],
            eps_trans=on(g7.eps_trans), eps_depth=g7.eps_depth),
        "transcripts": dict(
            nll=nll_sil.contiguous(), trans=on(gb["trans"]), init_cost=on(gb["init_cost"]),
            n_frames=nf[:256], eps_trans=on(gb["eps_trans"]), eps_depth=depth_tr),
        "ties": dict(
            nll=on(trng.integers(0, 3, (64, t_tie, s_tie)).astype(np.float32)),
            trans=on(trans_tie[0]), init_cost=on(init_tie.astype(np.float32)),
            n_frames=on(np.r_[t_tie, 0, 1, trng.integers(2, t_tie + 1, 61)].astype(np.int32)),
            eps_trans=on(trans_tie[1]), eps_depth=2)}
    walks = {}
    for name, kw in cases.items():
        fin, bp, ebp = dk.viterbi_dense(**kw)
        end = (torch.full((fin.shape[0],), fin.shape[1] - 1, device=dev)
               if kw["eps_trans"] is None else torch.argmin(fin, 1))
        walks[name] = (bp, ebp, end, kw["n_frames"], kw["eps_depth"])
    return walks


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="change")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("exp_r20: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk
    from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace_ref
    from speech_recognition_tpu_torch.utils.build import build, load_library

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build()
    lim = load_library().srt_smem_limit()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    cs.COUNTED[:] = [(dk.dense_backtrace, 1)]
    out = {"tag": args.tag, "card": card, "cases": {}}

    walks = dense_walks(dev)

    def with_lanes(p, b, lanes, depth):
        """``p`` for ``b`` streams with ``lanes`` lanes a stream (warps,
        grid, smem redone)."""
        groups = 32 // lanes
        warp_bytes = dk.window_smem(p.rows, p.states, p.states, lanes, 1, depth, p.block)
        n_warps = -(-b // groups)
        warps = max(1, min(dk.BACKTRACE_WARPS, n_warps // n_sm, lim // warp_bytes))
        return p._replace(lanes=lanes, warps=warps, grid=-(-n_warps // warps),
                          smem=warps * warp_bytes)

    for name, a in walks.items():
        b, t, s = a[0].shape
        plan = dk.dense_backtrace_plan(b, t, s, [a[0].stride()] * 2, lim, n_sm, a[4])
        chain = dk.BacktracePlan("chain", 0, 0, 1, 4, -(-b // 128), 0)
        res = {"shape": [b, t, s], "plan": plan._asdict()}
        variants = {"parent": chain, "change": plan}
        if args.sweep:
            for w in (16, 32, 64):
                for r in (32, 64, 128, 256, s):
                    p = dk.window_plan(b, t, s, a[4], w, r, lim, n_sm, block=True)
                    if p is not None and p.states == min(s, r) and p.rows == min(t, w):
                        variants.setdefault(f"window {p.rows}x{p.states}", p)
            if plan.states < 32:
                for lanes in (1, 2, 4, 8, 16):
                    if lanes <= plan.states and lanes != plan.lanes:
                        variants[f"window, {lanes} lanes a stream"] = with_lanes(plan, b, lanes,
                                                                                 a[4])
        want = viterbi_backtrace_ref(*a) if args.check else None
        for label, p in variants.items():
            if want is not None:
                got = dk._backtrace(*a, plan=p)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    print(f"exp_r20: {label} differs from viterbi_backtrace_ref on {name}",
                          file=sys.stderr)
                    return 1
        fns = {k: (lambda p=p, a=a: dk._backtrace(*a, plan=p)) for k, p in variants.items()}
        ev = {"parent": [], "change": []}
        for k in ("parent", "change", "change", "parent"):
            ev[k].append(cs.cuda_ms(fns[k], reps=10))
        res["event_ms"] = ev
        res["device_ms"] = {k: cs.device_ms(fn, what=f"{k} on {name}")
                            for k, fn in fns.items()}
        for label, p in variants.items():
            if p.form != "window":
                continue
            stats = torch.zeros((b, 7), dtype=torch.int64, device=dev)
            dk._backtrace(*a, plan=p, stats=stats)
            torch.cuda.synchronize()
            st = stats.double()
            res.setdefault("stats", {})[label] = {
                "windows a stream (mean, max)": [float(st[:, 0].mean()), int(st[:, 0].max())],
                "taken ahead": int(st[:, 1].sum()), "ahead dropped": int(st[:, 2].sum()),
                "bytes staged": 4 * int(st[:, 3].sum()),
                "wait share": float((st[:, 4] / st[:, 6].clamp(min=1)).mean()),
                "window change share": float((st[:, 5] / st[:, 6].clamp(min=1)).mean()),
                "cycles a stream (max)": int(st[:, 6].max())}
        out["cases"][name] = res
        dv = res["device_ms"]
        st = res["stats"]["change"]
        print(f"[exp_r20] {name} {b}x{t}x{s}: parent (chain) {ev['parent']} ms, change (window "
              f"{plan.rows}x{plan.states}, {32 // plan.lanes} a warp) {ev['change']} ms event; "
              f"device " + ", ".join(f"{k} {v:.4f}" for k, v in dv.items())
              + f" ms; change: {st['windows a stream (mean, max)']} windows a stream, "
              f"{st['taken ahead']} taken ahead, {st['ahead dropped']} dropped, "
              f"{st['bytes staged'] / 1e6:.2f} MB staged, window changes "
              f"{st['window change share']:.2f} of the cycles, waits {st['wait share']:.2f} "
              f"({card})", flush=True)
    # the wrapper's host time a call: 200 calls on one stream of 8 frames
    # (device work far below it), enqueue only, against the launch alone
    import time

    bp1, ep1 = walks["ties"][0][:1, :8].contiguous(), walks["ties"][1][:1, :8].contiguous()
    end1 = walks["ties"][2][:1]
    nf1 = torch.full((1,), 8, dtype=torch.int32, device=dev)
    for label, fn in (("dense_backtrace", lambda: dk.dense_backtrace(bp1, ep1, end1, nf1, 2)),):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        out[f"{label} host us a call"] = (t1 - t0) / 200 * 1e6
        print(f"[exp_r20] {label}: {out[f'{label} host us a call']:.1f} us of host time a call "
              f"(enqueue, one stream of 8 frames; {card})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

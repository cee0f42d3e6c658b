#!/usr/bin/env python3
"""Time the general backtrace K9 (csrc/banded_backtrace.cu) and the dense
Viterbi K11 (csrc/viterbi_dense.cu) at the main paths' shapes, with the
paths around them, on one GPU.

    python3 scripts/exp_r10_backtrace_dense.py [--root DIR] [--tag NAME] [--lab]

``--root`` names the checkout whose ``speech_recognition_tpu_torch`` and
``chip_smoke.py`` (for its bank helpers) are imported, default this one,
so that an older tree unpacked beside it is timed on the same seeded
inputs through the same public entry points; compare two trees only
inside one call, in turns (old, new, new, old).  Times are CUDA-event
medians (``chip_smoke.cuda_ms``), in ms, which include the wrappers' host
work; ``dev`` holds the device times of the kernels alone
(``chip_smoke.device_ms``: torch.profiler, summed over the kernels a call
launches).  Inputs are chip_smoke.py's:

  k9_1state, k9_mixed   K9 at 512 x 500 on K8's planes of the 7-slot
                        sausage of 1-state words (77 states, eps depth 6)
                        and of 3-6-state words (336 states), uniform(0, 5)
                        emissions, lengths T, 1, 0, 2..T
  k8_1state, k8_k9_1state  K8 alone, and K8 then K9 as one number
  k11_iso               K11 at the isolated shape (512 x 500 x 11 models
                        of 5 states, per-item matrices), no planes, as the
                        isolated path runs it; k11_iso_planes with planes
  k11_sausage           K11 at 64 x 500 on the 385-state sausage (one
                        matrix, eps depth 1), with planes
  k11_transcripts       K11 on 256 padded transcript graphs (per-item
                        matrices, silence optional), with planes
  k11_ties              K11 on the integer tie batch (48 states, 64 x 200)
  iso_pipeline          512 x 2 s wav -> digits (K3 + bank_nll + K11 +
                        argmin)

``--lab`` (this tree's kernels only) adds K9's clock64 trace (lane 0's
cycles per stream loading and stashing windows and walking, mean and the
slowest stream; windows waited for and loaded ahead), and
K11 under other plans: the
packed form at 2 and 8 warps per CTA, the row forms at neighbouring
cluster sizes and other lanes per row where they fit (with the clusters
the card holds at once per size), and the wide form (the first
port's) at each shape; K11's clock64 trace under the plan it picks
(cycles per frame: the packed form's frame loop, mean and slowest warp;
the row forms' scans, owners and publishing, barriers and total, thread 0
of each CTA, mean), beside the device time per frame; and the SM clock
nvidia-smi reads while ~1 s of isolated-shape launches run.
Prints one JSON line, tagged ``--tag``, with the card's name and power
limit.
"""

import argparse
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
        print("exp_r10: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import speech_recognition_tpu_torch as pkg
    from speech_recognition_tpu_torch.decode.isolated import classify_batch
    from speech_recognition_tpu_torch.models.graph import (
        build_word_graph,
        pad_graphs,
        transcript_graph,
    )
    from speech_recognition_tpu_torch.models.hmm import bank_nll, linear_init_cost
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk
    from speech_recognition_tpu_torch.ops.frontend import FrontendConfig, mfcc39_auto, padded_length
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.decode.connected import connected_graph_arrays
    from speech_recognition_tpu_torch.utils.build import build, load_library

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r10: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build()
    lib = load_library()
    ms, dv = cs.cuda_ms, cs.device_ms
    out = {"tag": args.tag, "root": root, "card": card, "dev": {}}

    def timed(name, fn, reps=10, device=True):
        out[name] = ms(fn, reps=reps)
        if device:
            out["dev"][name] = dv(fn)

    # ---- K8 / K9 (chip_smoke.py's general-graph inputs) ---------------------
    B, T = 512, 500
    bank1, bank6 = cs.random_bank(1).to(dev), cs.random_bank(6, seed=10).to(dev)
    sizes = (3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5)
    gen = {"1state": build_word_graph([bank1.trans_cost[i].cpu().numpy() for i in range(11)],
                                      [list(range(11))] * 7),
           "mixed": build_word_graph([bank6.trans_cost[i].cpu().numpy()[:k, :k]
                                      for i, k in enumerate(sizes)], [list(range(11))] * 7)}
    erng = np.random.default_rng(11)
    nf8 = torch.from_numpy(np.r_[T, 1, 0, erng.integers(2, T + 1, B - 3)]
                           .astype(np.int32)).to(dev)
    for name, graph in gen.items():
        bg = banded_arrays(graph, device=dev)
        topo = vk.banded_topology(bg)
        u = int(graph.bank_state.max()) + 1
        nll = torch.from_numpy(erng.uniform(0, 5, (u, T, B)).astype(np.float32)).to(dev)
        erng.integers(0, 3, (u, T, B))  # chip_smoke.py's tie batch, drawn next
        d = graph.eps_depth
        fin, bp8, eps_u = vk.viterbi_banded_general(nll, bg, topo, nf8, d)
        ends = bg.end_states[torch.argmin(fin[bg.end_states] + bg.end_bonus[:, None], 0)]
        timed(f"k9_{name}", lambda: vk.banded_backtrace_general(bp8, eps_u, bg, ends, nf8, d),
              reps=20)
        if name == "1state":
            timed("k8_1state", lambda: vk.viterbi_banded_general(nll, bg, topo, nf8, d))

            def k8_k9():
                p = vk.viterbi_banded_general(nll, bg, topo, nf8, d)
                return vk.banded_backtrace_general(p[1], p[2], bg, ends, nf8, d)

            timed("k8_k9_1state", k8_k9)
        if args.lab:  # K9's trace: cycles per stream by phase, windows
            tr = torch.zeros((B, 5), dtype=torch.int64, device=dev)
            vk.banded_backtrace_general(bp8, eps_u, bg, ends, nf8, d, trace=tr)
            torch.cuda.synchronize()
            tr = tr.double()
            slow = int(tr[:, :2].sum(1).argmax())
            out[f"k9_{name} trace"] = {
                "mean cycles: windows, walk": tr[:, :2].mean(0).tolist(),
                "slowest stream": tr[slow].tolist(),
                "mean windows waited, ahead": tr[:, 2:4].mean(0).tolist()}

    # ---- K11 (chip_smoke.py's dense inputs) -----------------------------------
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
        "k11_iso": dict(
            nll=nll_bank.reshape(B, T, n_m, n_s).permute(0, 2, 1, 3)
            .reshape(B * n_m, T, n_s).contiguous(),
            trans=bank.trans_cost[None].expand(B, n_m, n_s, n_s)
            .reshape(B * n_m, n_s, n_s).contiguous(),
            init_cost=on(linear_init_cost(n_s)), n_frames=nf.repeat_interleave(n_m),
            eps_trans=None, eps_depth=1),
        "k11_sausage": dict(
            nll=nll_bank[:64][:, :, on(g7.bank_state).long()].contiguous(),
            trans=on(g7.trans), init_cost=on(g7.init_cost), n_frames=nf[:64],
            eps_trans=on(g7.eps_trans), eps_depth=g7.eps_depth),
        "k11_transcripts": dict(
            nll=nll_sil.contiguous(), trans=on(gb["trans"]), init_cost=on(gb["init_cost"]),
            n_frames=nf[:256], eps_trans=on(gb["eps_trans"]), eps_depth=depth_tr),
        "k11_ties": dict(
            nll=on(trng.integers(0, 3, (64, t_tie, s_tie)).astype(np.float32)),
            trans=on(trans_tie[0]), init_cost=on(init_tie.astype(np.float32)),
            n_frames=on(np.r_[t_tie, 0, 1, trng.integers(2, t_tie + 1, 61)].astype(np.int32)),
            eps_trans=on(trans_tie[1]), eps_depth=2)}
    out["transcript_states"] = int(bstate.shape[1])
    timed("k11_iso", lambda: dk.viterbi_dense(**cases["k11_iso"], planes=False), reps=20)
    for name, kw in cases.items():
        timed(name if name != "k11_iso" else "k11_iso_planes",
              lambda kw=kw: dk.viterbi_dense(**kw), reps=10 if name != "k11_sausage" else 5)
    cfg = FrontendConfig()
    n2 = 32000  # 2 s at 16 kHz
    L2 = ((padded_length(cfg, n2) + 159) // 160 + 8) * 160
    sig2 = torch.from_numpy((np.random.default_rng(15).standard_normal((512, L2)) * 3000)
                            .astype(np.float32)).to(dev)
    lens2 = torch.full((512,), n2, dtype=torch.int32, device=dev)

    def iso_pipeline():
        f, n = mfcc39_auto(sig2, lens2, cfg)
        return classify_batch(bank, f, n)[0]

    timed("iso_pipeline", iso_pipeline, reps=10, device=False)

    if args.lab:
        limit = lib.srt_smem_limit()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        for name, kw in cases.items():
            b, _, s = kw["nll"].shape
            per_item, use_eps = kw["trans"].dim() == 3, kw["eps_trans"] is not None
            plan = dk.dense_plan(b, s, per_item, use_eps, limit, n_sm, dk._cluster_slots(dev))
            out[f"{name} plan"] = plan._asdict()
            variants = {}
            if plan.form == "packed":
                for w in (2, 8):
                    variants[f"packed {w} warps"] = plan._replace(
                        warps=w, grid=-(-b // (w * plan.items_per_warp)),
                        smem=dk.dense_smem_bytes("packed", s, per_item, use_eps, w))
            else:
                ki = plan.items
                for c in sorted({plan.cluster - 1, plan.cluster, plan.cluster + 1, 8}):
                    for k in (4, 8) if ki == 4 else (2, 4):
                        if (c, k) == (plan.cluster, plan.lanes) or not 1 <= c <= 8:
                            continue
                        r = -(-s // c)
                        warps = dk._rows_layout(s, r, k, ki)[0]
                        smem = dk.dense_smem_bytes(plan.form, s, per_item, use_eps, r, k, ki)
                        if smem <= limit and warps * 32 <= dk.ROWS_MAX_THREADS:
                            variants[f"{plan.form} C={c} K={k}"] = plan._replace(
                                warps=warps, cluster=c, rows=r, lanes=k,
                                grid=-(-b // ki) * c, smem=smem)

                out[f"{name} cluster slots"] = {
                    c: lib.viterbi_dense_cluster_slots(
                        c, dk._rows_layout(s, -(-s // c), plan.lanes, ki)[0] * 32,
                        dk.dense_smem_bytes(plan.form, s, per_item, use_eps, -(-s // c),
                                            plan.lanes, ki), ki)
                    for c in range(1, 9)}
            smem = dk.dense_smem_bytes("wide", s, per_item, use_eps)
            if smem <= limit:
                variants["wide"] = dk.DensePlan("wide", 0, 32, 1, 0, s, 0, b, smem)
            planes = name != "k11_iso"
            n_tr = plan.grid * (plan.warps * 2 if plan.form == "packed" else 5)
            if plan.form in ("packed", "cluster", "item"):
                tr = torch.zeros(n_tr, dtype=torch.int64, device=dev)
                dk._launch(**kw, planes=planes, trace=tr)
                torch.cuda.synchronize()
                if plan.form == "packed":
                    tr = tr.view(-1, 2).double()
                    per = tr[tr[:, 1] > 0, 0] / tr[tr[:, 1] > 0, 1]
                    out[f"{name} cycles per frame"] = {"mean": float(per.mean()),
                                                       "max": float(per.max())}
                else:
                    tr = tr.view(-1, 5).double()
                    tr = tr[tr[:, 4] > 0]
                    per = (tr[:, :4] / tr[:, 4:]).mean(0).tolist()
                    out[f"{name} cycles per frame"] = dict(zip(
                        ("scans", "owners + publish", "barriers", "total"), per))
                frames = T if name != "k11_ties" else t_tie
                out[f"{name} device ns per frame"] = out["dev"][name] * 1e6 / frames
            for vname, vplan in variants.items():
                fn = (lambda kw=kw, vplan=vplan: dk._launch(**kw, planes=planes, plan=vplan))
                want = dk.viterbi_dense(**kw, planes=planes)
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b_) for a, b_ in zip(got, want) if a is not None):
                    print(f"exp_r10: {name} under {vname} differs", file=sys.stderr)
                    return 1
                out["dev"][f"{name} {vname}"] = dv(fn)
    if args.lab:  # the SM clock under a second of back-to-back isolated-shape launches
        iso = cases["k11_iso"]
        for _ in range(int(1000 / max(out["dev"]["k11_iso"], 1e-3))):
            dk.viterbi_dense(**iso, planes=False)
        out["sm clock under load"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

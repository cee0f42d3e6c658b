#!/usr/bin/env python3
"""Time the streaming chunk kernels K17 (the banded chunk DP) and K18 (the
trie chunk DP) and the push API on one GPU, and sweep the banded DP's warp
form against its four-warp form.

    python3 scripts/exp_r16_chunk_dp.py [--root DIR] [--tag NAME] [--check]
        [--sweep] [--lex] [--regress]

``--root`` names the checkout whose ``speech_recognition_tpu_torch`` and
``chip_smoke.py`` (for its seeded banks, planted features and timers) are
imported, default this one, so that an older tree unpacked beside it is
timed on the same inputs through the same public wrappers; compare two
trees only inside one call, in turns (old, new, new, old).  Every run
times (``chip_smoke.py`` 7b's shapes):

  k17       K17 per push: ``viterbi_banded_chunk`` (K13 + the DP's uniform
            chunk mode) on the second 64-frame chunk of 256 planted streams
            over the CLI's 55-state loop graph; the DP alone; K13 alone
  k18       K18 per push: ``viterbi_lex_chunk`` on the second chunk of 128
            planted-word streams over the 1k trie
  push      ``StreamingDecoder.push`` over 256 x 500 frames on the loop
            (8 pushes of 64) and 128 x 500 on the 1k trie; ``finish``

each with its CUDA-event median (the wrappers' host work included), its
device time from events queued behind a sleep kernel (``queued_ms``: the
host has enqueued every launch before the first event fires, so the
reading is the device's, launch gaps included), its host time
(``host_ms``: the enqueue alone, the device kept busy) and, for a single
kernel, torch.profiler's (``chip_smoke.device_ms``).  ``--regress`` adds the DPs
that share K17's and K18's sources at their PERF.md shapes: K1's DP, K8
and K10's DP at 512 x 500, K4 and K6 at 128 x 500 on the 1k trie.

This tree only: ``--check`` holds the warp form against the plain DPs
(every mode it serves, chunks of 1 and 64 frames with ragged lengths,
stream counts off the warps per CTA) and prints ptxas's lines for it;
``--sweep`` times the DP alone in both forms on loop graphs of 5 to 80
words (25-400 states; the warp form takes up to 32) and on a 1-state and
a 3-6-state sausage at 256 x 64, the warp form at 1-8 warps per CTA (the
threshold
``BANDED_WARP_MAX_STATES`` and the tile rule come from it); ``--lex``
times K18 at chunks of 1, 8 and 64 frames and K4 on the same 64 frames,
with both kernels' clock64 traces by phase (per-launch cost against the
frame step).  Prints one JSON line, tagged ``--tag``, with the card's name
and power limit.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

CH, BS, BL, T = 64, 256, 128, 500


def queued_ms(fn, reps: int = 10) -> float:
    """Device ms per call of ``fn()``: a sleep kernel holds the stream
    while the host enqueues ``reps`` calls between two events, so their
    distance is the device's time for the calls (gaps between launches
    included), not the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms at 2 GHz: longer than the enqueue
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


def host_ms(fn, reps: int = 20) -> float:
    """The host's ms per call of ``fn()``: a host clock around the call
    while a sleep kernel keeps the device busy (no launch waits), median
    of ``reps``."""
    import statistics
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    torch.cuda._sleep(100_000_000)
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--lex", action="store_true")
    ap.add_argument("--regress", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import speech_recognition_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r16: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("exp_r16: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    from speech_recognition_tpu_torch.config import DecodeConfig
    from speech_recognition_tpu_torch.decode.streaming import StreamingDecoder
    from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.utils.build import build, load_library

    lib_path = build()
    load_library()
    out = {"tag": args.tag, "root": root, "card": card, "torch": torch.__version__}

    def say(k, msg):
        print(f"[{args.tag}] {k}: {msg}", flush=True)

    # the DP's private launcher takes the graph's topo in this tree (its
    # cached launch tables), not in older ones
    topo_kw = "topo" in inspect.signature(vk._banded_forward).parameters

    def dp(nll, g, topo, nv, mode, wrapper, depth=1, **kw):
        if topo_kw:
            kw["topo"] = topo
        return vk._banded_forward(nll, g, nv, depth, mode, wrapper, **kw)

    # ---- inputs: chip_smoke.py's bank, loop graph and planted features ------
    bank = cs.random_bank(5).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    loop = build_loop_graph([bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)],
                            word_insertion_cost=DecodeConfig().word_insertion_cost)
    bgl = banded_arrays(loop, device=dev)
    topol = vk.banded_topology(bgl)
    feats_s, nf_s = cs.planted_features(bank, BS, T, np.random.default_rng(21))
    xa_s = augment_dtb(feats_s)
    init_l = bgl.init_cost[:, None].expand(-1, BS).contiguous()
    fr_c = vk.viterbi_banded_chunk((xa_s[:, :CH].contiguous(), w, lw), bgl, topol, init_l,
                                   nf_s.clamp(max=CH).to(torch.int32), True, False,
                                   "fused")[0]
    nv_c = (nf_s - CH).clamp(0, CH).to(torch.int32)
    xa_c = xa_s[:, CH:2 * CH].contiguous()
    nll_c = vk.bank_emission(xa_c, w, lw)
    k17 = ((xa_c, w, lw), bgl, topol, fr_c, nv_c, False, False, "fused")

    def k17_dp():
        return dp(nll_c, bgl, topol, nv_c, "fused_chunk", vk.viterbi_banded_chunk,
                  frontier=fr_c)

    res = {"k17 event": cs.cuda_ms(lambda: vk.viterbi_banded_chunk(*k17), reps=20),
           "k17 queued": queued_ms(lambda: vk.viterbi_banded_chunk(*k17)),
           "k17 DP event": cs.cuda_ms(k17_dp, reps=20),
           "k17 DP queued": queued_ms(k17_dp),
           "k17 DP device": cs.device_ms(k17_dp, reps=10, what="the K17 DP"),
           "k17 host": host_ms(lambda: vk.viterbi_banded_chunk(*k17)),
           "k17 DP host": host_ms(k17_dp),
           "k13 host": host_ms(lambda: vk.bank_emission(xa_c, w, lw)),
           "k13 chunk device": cs.device_ms(lambda: vk.bank_emission(xa_c, w, lw), reps=10,
                                            what="K13 on a chunk")}

    # K18 on the 1k trie, planted words (chip_smoke 5b's emissions)
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon, planted_emissions
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    words, trans, ids, _ = bench_lexicon()
    lex1k = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    g1k = lex1k.banded.to(dev)
    topo1k = lk.lex_topology(g1k)
    ep, nfp, _ = planted_emissions(np.random.default_rng(5), words, ids, 3, 24, BL, T)
    nll_p = torch.from_numpy(ep).to(dev)
    nf_p = torch.from_numpy(nfp).to(dev)
    init_t = g1k.init_cost[None].expand(BL, -1).contiguous()
    fr_t = lk.viterbi_lex_chunk(nll_p[:, :CH].contiguous(), g1k, topo1k, init_t,
                                nf_p.clamp(max=CH).to(torch.int32), True, False)[0]
    nll_pc = nll_p[:, CH:2 * CH].contiguous()
    nv_t = (nf_p - CH).clamp(0, CH).to(torch.int32)
    k18 = (nll_pc, g1k, topo1k, fr_t, nv_t, False, False)
    res.update({"k18 event": cs.cuda_ms(lambda: lk.viterbi_lex_chunk(*k18), reps=20),
                "k18 queued": queued_ms(lambda: lk.viterbi_lex_chunk(*k18)),
                "k18 device": cs.device_ms(lambda: lk.viterbi_lex_chunk(*k18), reps=10,
                                           what="K18")})

    # the push API: 8 pushes of 64 frames, then finish
    def push_case(name, bank_, graph_, feats_, nf_):
        b_ = feats_.shape[0]
        nf_np = nf_.cpu().numpy()
        dec = StreamingDecoder(bank_, graph_, chunk_frames=CH, batch=b_)

        def pushes():
            dec.reset()
            for t0 in range(0, T, CH):
                dec.push(feats_[:, t0:t0 + CH],
                         n_valid=np.clip(nf_np - t0, 0, CH).astype(np.int32))

        n_push = -(-T // CH)
        ev = cs.cuda_ms(pushes, reps=5)
        # one stream of pushes: its n_valid slots never wait on a copy behind the sleep
        res[f"push {name} host"] = host_ms(pushes, reps=1) / n_push
        # one stream of pushes per reading: the decoder's pinned n_valid slots
        # then never wait on a copy queued behind the sleep
        q = queued_ms(pushes, reps=1)
        pushes()
        fin = cs.cuda_ms(dec.finish, reps=3)
        audio_s = float(nf_.sum()) / 100.0
        res.update({f"push {name} event": ev / n_push, f"push {name} queued": q / n_push,
                    f"push {name} idle": 1 - q / ev, f"finish {name}": fin,
                    f"push {name} audio-s/s": audio_s / (ev + fin) * 1e3})

    push_case("loop", bank, loop, feats_s, nf_s)
    lbank, lexp, _, _, _ = cs.make_lex_pipeline(dev)
    units_l = [[ord(ch) - ord("a") for ch in wd] for wd in lexp.words]
    feats_l, nf_l = cs.planted_features(lbank, BL, T, np.random.default_rng(23), units=units_l,
                                        dwell=(2, 4))
    push_case("lextree", lbank, lexp, feats_l, nf_l)

    if args.regress:
        # the DPs that share K17's and K18's sources, at PERF.md's shapes
        from speech_recognition_tpu_torch.decode.connected import connected_graph_arrays

        B = 512
        feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, T, 39)).astype(np.float32)).to(dev)
        nf = torch.from_numpy(np.r_[T, 1, np.random.default_rng(2).integers(
            2, T + 1, B - 2)].astype(np.int32)).to(dev)
        bg = banded_arrays(connected_graph_arrays(bank, 7), device=dev)
        topo = vk.banded_topology(bg)
        nll13 = vk.bank_emission(augment_dtb(feats), w, lw)
        bank1 = cs.random_bank(1).to(dev)
        g1s = build_word_graph([bank1.trans_cost[i].cpu().numpy() for i in range(11)],
                               [list(range(11))] * 7)
        bg1 = banded_arrays(g1s, device=dev)
        topo1 = vk.banded_topology(bg1)
        erng = np.random.default_rng(11)
        nf8 = torch.from_numpy(np.r_[T, 1, 0, erng.integers(2, T + 1, B - 3)]
                               .astype(np.int32)).to(dev)
        nll1 = torch.from_numpy(erng.uniform(0, 5, (11, T, B)).astype(np.float32)).to(dev)
        e = np.random.default_rng(12).uniform(0, 5, (128, T, 24)).astype(np.float32)
        nll1k = torch.from_numpy(np.ascontiguousarray(e.transpose(2, 1, 0))).to(dev)
        nf1k = torch.from_numpy(np.r_[T, 1, np.random.default_rng(3).integers(
            2, T + 1, 126)].astype(np.int32)).to(dev)
        cases = {
            "K1 DP": lambda: dp(nll13, bg, topo, nf, "fused", vk.viterbi_banded_fused),
            "K10 DP": lambda: dp(nll13, bg, topo, nf, "wordtrace", vk.viterbi_banded_wordtrace),
            "K8": lambda: vk.viterbi_banded_general(nll1, bg1, topo1, nf8, g1s.eps_depth),
            "K1 DP loop 256x500": lambda: dp(vk.bank_emission(xa_s, w, lw), bgl, topol,
                                             nf_s, "fused", vk.viterbi_banded_fused),
            "K4": lambda: lk.viterbi_lex(nll1k, g1k, topo1k, nf1k),
            "K6": lambda: lk.lex_forward(nll1k, g1k, topo1k, nf1k, True, lk.viterbi_lex),
            "K18 with the map": lambda: lk.viterbi_lex_chunk(*k18[:6], True),
        }
        for k, fn in cases.items():
            res[f"{k} device"] = cs.device_ms(fn, reps=5, what=k)
            res[f"{k} queued"] = queued_ms(fn, reps=5)

    for k, v in res.items():
        say(k, f"{v:.4f}" + ("" if "idle" in k or "audio" in k else " ms"))
    out["times"] = res

    if args.check:
        check(dev, vk, lib_path, say)
    if args.sweep:
        out["sweep"] = sweep(dev, vk, bank, dp, say, queued_ms)
    if args.trace:
        out["trace"] = trace_lab(dev, vk, bank, say, lib_path)
    if args.lex:
        out["lex"] = lex_lab(dev, lk, g1k, topo1k, nll_p, nf_p, fr_t, nv_t, say, cs)
    print(json.dumps(out), flush=True)
    return 0


def _loop(n_words, bank):
    """A loop graph of ``n_words`` five-state words over the bank's 11
    models (cycled), with the CLI's word insertion cost."""
    from speech_recognition_tpu_torch.config import DecodeConfig
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    trans = [bank.trans_cost[i % 11].cpu().numpy() for i in range(n_words)]
    graph = build_loop_graph(trans, word_insertion_cost=DecodeConfig().word_insertion_cost)
    g = banded_arrays(graph)
    return graph, g._replace(bank_state=g.bank_state % 55)


def check(dev, vk, lib_path, say):
    """The warp form bit-identical to the plain DPs, and its ptxas lines."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from speech_recognition_tpu_torch.models.graph import build_word_graph
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    with open(lib_path + ".log") as f:
        for line in f:
            if "banded_warp" in line or ("registers" in line and "warp" in line):
                say("ptxas", line.strip())
    bank = cs.random_bank(5)
    bank1 = cs.random_bank(1)
    bank6 = cs.random_bank(6, seed=10)
    sizes = (3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5)
    graphs = {"loop 11": _loop(11, bank), "loop 20": _loop(20, bank),
              "loop 32": _loop(32, bank),
              "1-state sausage3": (lambda gr: (gr, banded_arrays(gr)))(build_word_graph(
                  [bank1.trans_cost[i].numpy() for i in range(10)], [list(range(10))] * 3)),
              "3-6-state sausage2": (lambda gr: (gr, banded_arrays(gr)))(build_word_graph(
                  [bank6.trans_cost[i].numpy()[:k, :k] for i, k in enumerate(sizes)],
                  [list(range(11))] * 2))}
    from speech_recognition_tpu_torch.utils.build import load_library

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = vk._smem_limit()
    lib = load_library()
    for name, (graph, g) in graphs.items():
        g = g.to(dev)
        topo = vk.banded_topology(g)
        depth = graph.eps_depth
        base = vk.banded_route(topo, depth)
        u = int(g.bank_state.max()) + 1
        rng = np.random.default_rng(len(name))
        for b, t, chunk, ties in ((37, 70, 64, False), (5, 9, 1, True), (130, 20, 0, True)):
            e = rng.integers(0, 3, (u, t, b)) if ties else rng.uniform(0, 6, (u, t, b))
            nll = torch.from_numpy(e.astype(np.float32)).to(dev)
            nf = torch.from_numpy(np.r_[0, t, 1, rng.integers(1, t + 1, b)][:b]
                                  .astype(np.int32)).to(dev)
            for tile in (1, 3, 8):
                for org in (False, True):
                    mode = f"{base}_chunk" + ("_org" if org else "")
                    p = vk.banded_plan(b, n_sm, g.n_states, g.n_words, g.n_ends, u, mode,
                                       limit, form="warp")
                    p = p._replace(tile=tile, smem=vk.banded_warp_smem_bytes(mode, u, tile))
                    assert p.smem == lib.banded_warp_smem_bytes(vk.MODES[mode], u, tile), \
                        (name, mode)
                    fr = g.init_cost[:, None].expand(-1, b).contiguous()
                    ch = chunk or t
                    for t0 in range(0, t, ch):
                        c = min(ch, t - t0)
                        nv = (nf - t0).clamp(0, c).to(torch.int32)
                        x = nll[:, t0:t0 + c]
                        got = vk._banded_forward(x, g, nv, depth, mode, vk.viterbi_banded_chunk,
                                                 plan=p, frontier=fr, first=t0 == 0, topo=topo)
                        if base == "fused":
                            want = vk._fused_dp(x, g, nv, fr, fr, t0 == 0, org)
                        else:
                            want = vk.viterbi_banded_chunk_ref(x.contiguous(), g, topo, fr, nv,
                                                               t0 == 0, org, "general", depth)
                        for k, (a, w_) in enumerate(zip(got, want)):
                            if (a is None) != (w_ is None) or (
                                    a is not None and not torch.equal(a, w_)):
                                raise SystemExit(f"warp form {mode} on {name} b={b} tile={tile}"
                                                 f" chunk at {t0}: output {k} differs")
                        fr = got[0]
            # the monolithic modes
            mono = "fused" if base == "fused" else "general"
            p = vk.banded_plan(b, n_sm, g.n_states, g.n_words, g.n_ends, u, mono, limit,
                               form="warp")
            got = vk._banded_forward(nll, g, nf, depth, mono, vk.viterbi_banded_fused, plan=p,
                                     topo=topo)
            want = (vk.fused_dp_ref(nll, g, nf) if mono == "fused"
                    else vk.viterbi_banded_general_ref(nll, g, topo, nf, depth))
            for k, (a, w_) in enumerate(zip(got, want)):
                if not torch.equal(a, w_):
                    raise SystemExit(f"warp form {mono} on {name} b={b}: output {k} differs")
        say("check", f"warp form == plain on {name} ({g.n_states} states, eps depth {depth},"
                     f" {base}): chunk modes with and without the map, chunks of 64 / 1 / all "
                     f"frames, 1 / 3 / 8 warps a CTA, and the monolithic mode")


def sweep(dev, vk, bank, dp, say, queued_ms):
    """The DP alone at 256 x 64 (the chunk mode, second chunk), warp form
    (1-16 warps per CTA) against the four-warp form, device ms."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from speech_recognition_tpu_torch.models.graph import build_word_graph
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = vk._smem_limit()
    bank1 = cs.random_bank(1)
    bank6 = cs.random_bank(6, seed=10)
    sizes = (3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5)
    cases = {f"loop {n}": _loop(n, bank) for n in (5, 8, 11, 16, 20, 24, 28, 32, 40, 64, 80)}
    cases["1-state sausage3"] = (lambda gr: (gr, banded_arrays(gr)))(build_word_graph(
        [bank1.trans_cost[i].numpy() for i in range(10)], [list(range(10))] * 3))
    cases["3-6-state sausage2"] = (lambda gr: (gr, banded_arrays(gr)))(build_word_graph(
        [bank6.trans_cost[i].numpy()[:k, :k] for i, k in enumerate(sizes)],
        [list(range(11))] * 2))
    rows = {}
    rng = np.random.default_rng(0)
    for name, (graph, g) in cases.items():
        g = g.to(dev)
        topo = vk.banded_topology(g)
        depth = graph.eps_depth
        base = vk.banded_route(topo, depth)
        mode = f"{base}_chunk"
        u = int(g.bank_state.max()) + 1
        nll = torch.from_numpy(rng.uniform(0, 6, (u, 2 * CH, BS)).astype(np.float32)).to(dev)
        nf = torch.from_numpy(rng.integers(CH, 2 * CH + 1, BS).astype(np.int32)).to(dev)
        fr = dp(nll[:, :CH], g, topo, nf.clamp(max=CH), mode, vk.viterbi_banded_chunk,
                depth=depth, frontier=g.init_cost[:, None].expand(-1, BS).contiguous(),
                first=True)[0]
        x = nll[:, CH:]
        nv = (nf - CH).clamp(0, CH).to(torch.int32)
        row = {"states": g.n_states, "rows": g.n_words}
        four = vk.banded_plan(BS, n_sm, g.n_states, g.n_words, g.n_ends, u, mode, limit,
                              form="four")
        plans = {"four": four}
        if g.n_words <= vk.WARP_MAX_ROWS and g.n_states <= 256:
            warp = vk.banded_plan(BS, n_sm, g.n_states, g.n_words, g.n_ends, u, mode, limit,
                                  form="warp")
            for tile in (1, 2, 4, 8):
                plans[f"warp x{tile}"] = warp._replace(
                    tile=tile, smem=vk.banded_warp_smem_bytes(mode, u, tile))
        for k, p in plans.items():
            row[k] = queued_ms(lambda: dp(x, g, topo, nv, mode, vk.viterbi_banded_chunk,
                                          depth=depth, plan=p, frontier=fr), reps=20)
        rows[name] = row
        warps = [(v, k) for k, v in row.items() if k.startswith("warp")]
        best = (f"; best warp {min(warps)[1]} = {min(warps)[0] / row['four']:.2f}x the "
                f"four-warp form" if warps else "; past the warp form's 32 rows")
        say("sweep", f"{name} ({g.n_states} states, {g.n_words} rows, {base}): four-warp "
                     f"{row['four']:.4f} ms; " + ", ".join(
                         f"{k} {v:.4f}" for k, v in row.items() if k.startswith("warp"))
            + best)
    return rows


def trace_lab(dev, vk, bank, say, lib_path):
    """The DP's clock64 trace by phase (emission wait, band, eps passes,
    plane rows, mask, flush), cycles a frame, warp form (2 warps a CTA)
    against the four-warp form, at 256 streams and at 2 (one CTA: no
    other work on its SM), on loop graphs of 5, 11 and 32 words."""
    import numpy as np
    import torch

    with open(lib_path + ".log") as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "banded_warp_kernel" in line:
            say("ptxas", line.split("'")[1][-40:] + " | " + " | ".join(
                x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = vk._smem_limit()
    names = ("emission wait", "band", "eps", "planes", "mask", "flush")
    res = {}
    rng = np.random.default_rng(0)
    for n in (5, 11, 32):
        graph, g = _loop(n, bank)
        g = g.to(dev)
        topo = vk.banded_topology(g)
        u = 55
        for b in (256, 2):
            nll = torch.from_numpy(rng.uniform(0, 6, (u, CH, b)).astype(np.float32)).to(dev)
            nv = torch.full((b,), CH, dtype=torch.int32, device=dev)
            fr = g.init_cost[:, None].expand(-1, b).contiguous()
            for form in ("warp", "four"):
                p = vk.banded_plan(b, n_sm, g.n_states, g.n_words, g.n_ends, u, "fused_chunk",
                                   limit, form=form)
                if form == "warp":
                    p = p._replace(tile=2, smem=vk.banded_warp_smem_bytes("fused_chunk", u, 2))
                tr = torch.zeros((b, 6), dtype=torch.int64, device=dev)
                vk._banded_forward(nll, g, nv, 1, "fused_chunk", vk.viterbi_banded_chunk,
                                   plan=p, trace=tr, frontier=fr, topo=topo)
                torch.cuda.synchronize()
                per = (tr.double().mean(0) / CH).tolist()
                res[f"loop {n} b={b} {form}"] = dict(zip(names, per))
                say("trace", f"loop {n} ({g.n_states} states) b={b} {form} form: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in zip(names, per)) + f" (sum {sum(per):.0f})")
    return res


def lex_lab(dev, lk, g1k, topo1k, nll_p, nf_p, fr_t, nv_t, say, cs):
    """K18 at chunks of 1, 8 and 64 frames (per-launch cost against the
    frame step), K4 on the same 64 frames, and both kernels' clock64
    traces by phase."""
    import torch

    res = {}
    for c in (1, 8, 64):
        x = nll_p[:, CH:CH + c].contiguous()
        nv = nv_t.clamp(max=c)
        res[f"K18 C={c}"] = cs.device_ms(lambda: lk.viterbi_lex_chunk(
            x, g1k, topo1k, fr_t, nv, False, False), reps=10, what=f"K18 C={c}")
    x = nll_p[:, CH:2 * CH].contiguous()
    full = torch.full_like(nv_t, CH)
    res["K4 64 frames"] = cs.device_ms(lambda: lk.viterbi_lex(x, g1k, topo1k, full), reps=10,
                                       what="K4 64 frames")
    b = x.shape[2]
    names = ("band", "barrier A", "eps scan", "reduction", "apply", "barrier B")
    for name, fn in (("K18", lambda tr: lk.lex_forward(x, g1k, topo1k, full, False,
                                                        lk.viterbi_lex_chunk, trace=tr,
                                                        frontier=fr_t)),
                     ("K4", lambda tr: lk.lex_forward(x, g1k, topo1k, full, False,
                                                      lk.viterbi_lex, trace=tr))):
        tr = torch.zeros((b, 6), dtype=torch.int64, device=dev)
        fn(tr)
        torch.cuda.synchronize()
        per = (tr.double().mean(0) / CH).tolist()
        res[f"{name} cycles a frame"] = dict(zip(names, per))
        say("lex", f"{name} cycles a frame by phase: " + ", ".join(
            f"{k} {v:.0f}" for k, v in zip(names, per)) + f" (sum {sum(per):.0f})")
    for k, v in res.items():
        if not isinstance(v, dict):
            say("lex", f"{k}: {v:.4f} ms device")
    return res


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the value backtrace K2 (csrc/banded_backtrace.cu) and the bigram
lattice rescorer K7 (csrc/lattice_rescore.cu) at the main paths' shapes,
with the paths around them, on one GPU.

    python3 scripts/exp_r9_backtrace_rescore.py [--root DIR] [--tag NAME] [--lab]

``--root`` names the checkout whose ``speech_recognition_tpu_torch`` and
``chip_smoke.py`` (for its bank and pipeline helpers) are imported,
default this one, so that an older tree unpacked beside it is timed on
the same seeded inputs through the same public entry points; compare two
trees only inside one call, in turns (old, new, new, old).  Times are
CUDA-event medians (``chip_smoke.cuda_ms``), in ms, which include the
wrappers' host work; ``dev`` holds the device times of the kernels alone
(``chip_smoke.device_ms``: torch.profiler, summed over the kernels a call
launches) for the K1, K2 and K7 rows:

  k2_512, k2_256   K2 at 512 and 256 x 500 on the 385-state sausage, on
                   K1's planes (random 11 x 5-state bank, lengths T, 1,
                   2..T as chip_smoke.py draws them)
  k1_512, k1_k2_512  K1 alone, and K1 then K2 as one number
  k7_1k            K7 at 128 x 500 on the 1,000-word trie (every stream
                   500 frames, uniform emissions, the add-k LM: backoff),
                   through ``rescore_lattice`` (in trees that have
                   ``rescore_and_walk``, the same launch with q, the
                   truncation count and a walk of no rows)
  k7w_1k           the same through ``rescore_and_walk`` with the bigram
                   path's max_words, where the tree has it
  k7_1k_dense      the same with a dense [L, L] LM
  k7_dict          K7 at 16 x 500 on the dictionary-shaped trie (6,250 leaves)
  pipeline         256 x 5 s wav -> word ids (K3 + K1 + K2 + word ids)
  bigram           128 x 5 s wav -> words over the 1k trie (K3 +
                   bank_nll_ubt + K6 + K7 and the word walk: one launch,
                   or, in older trees, the tensor-op truncation count,
                   the amin, K7 and K22)
  states_decode    decode_connected at 512 x 500 on the sausage (K1 + K2
                   + states_to_words_device and the host work around them)

``--lab`` (this tree's kernels only) adds K7 in each of its plans, K7's cycles per frame by phase (the kernel's optional clock64
trace, thread 0, mean over streams), and what K7's ring reads touch: the
mean number of distinct ring rows among a warp's 32 leaves per frame,
the share of live lookups that read the newest row (tau = t - 1), and
the share that repeat the leaf's lookup of the frame before (no read).
Prints one JSON line, tagged ``--tag``, with the card's name and power
limit.
"""

import argparse
import json
import os
import subprocess
import sys
import types


def ring_stats(et, dmax):
    """``(mean distinct live ring rows per warp of 32 leaves and frame,
    share of live lookups at tau = t - 1, share of live lookups whose tau
    the leaf looked up the frame before)`` over ``ends_tau [T, B, L]``."""
    import torch

    t_len, b, l = et.shape
    pad = (-l) % 32
    tau = torch.nn.functional.pad(et, (0, pad), value=0).view(t_len, b, -1, 32).long()
    t = torch.arange(t_len, device=et.device)[:, None, None, None]
    live = (tau > 0) & (tau < t) & (t - tau <= dmax)
    key = torch.where(live, tau, -1).sort(-1).values
    new = (key[..., 1:] != key[..., :-1]) & (key[..., 1:] >= 0)
    distinct = new.sum(-1) + (key[..., 0] >= 0)
    same = live[1:] & live[:-1] & (tau[1:] == tau[:-1])
    n_live = max(1, int(live.sum()))
    return (float(distinct.float().mean()), float((live & (tau == t - 1)).sum()) / n_live,
            float(same.sum()) / n_live)


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
        print("exp_r9: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon, dict1_shaped_lexicon
    from speech_recognition_tpu_torch.decode.connected import (
        _decode_banded_batch,
        connected_graph_arrays,
        decode_connected,
        states_to_words_device,
    )
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.ops.frontend import FrontendConfig, mfcc39_auto, padded_length
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.lattice import _decode_lattice_batch, _ring_depth, lattice_lm
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
    from speech_recognition_tpu_torch.utils.build import build, load_library

    import speech_recognition_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        print(f"exp_r9: imported {pkg.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    build()
    lib = load_library()
    ms = cs.cuda_ms
    out = {"tag": args.tag, "root": root, "card": card}

    # ---- K2 and the connected paths (chip_smoke.py's inputs) ----------------
    bank = cs.random_bank(5).to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    graph7 = connected_graph_arrays(bank, 7)
    bg = banded_arrays(graph7, device=dev)
    topo = vk.banded_topology(bg)
    B, T = 512, 500
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, 39)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[T, 1, np.random.default_rng(2).integers(
        2, T + 1, B - 2)].astype(np.int32)).to(dev)
    xa = augment_dtb(feats)
    k1 = vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)
    ends = bg.end_states[torch.argmin(k1[0][bg.end_states], 0)]

    planes256 = (k1[1][:, :, :256].contiguous(), k1[3][:, :, :256].contiguous())
    out["k2_512"] = ms(lambda: vk.banded_backtrace_val(k1[1], k1[3], ends, nf, topo.uniform_w),
                       reps=20)
    out["k2_256"] = ms(lambda: vk.banded_backtrace_val(*planes256, ends[:256], nf[:256],
                                                       topo.uniform_w), reps=20)
    out["k1_512"] = ms(lambda: vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf), reps=10)

    def k1_k2():
        p = vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)
        return vk.banded_backtrace_val(p[1], p[3], ends, nf, topo.uniform_w)

    out["k1_k2_512"] = ms(k1_k2, reps=10)
    cfg = FrontendConfig()
    n_samp = 80000
    L = ((padded_length(cfg, n_samp) + 159) // 160 + 8) * 160
    sig = torch.from_numpy((np.random.default_rng(0).standard_normal((256, L)) * 3000)
                           .astype(np.float32)).to(dev)
    lens = torch.full((256,), n_samp, dtype=torch.int32, device=dev)
    slot7 = torch.as_tensor(graph7.slot, device=dev)
    label7 = torch.as_tensor(graph7.slot_label, device=dev)

    def pipeline():
        f, n = mfcc39_auto(sig, lens, cfg)
        s, e, _ = _decode_banded_batch(bank, f, n, bg, topo=topo)
        return states_to_words_device(slot7, label7, s, e, n, max_words=f.shape[1],
                                      uniform_w=topo.uniform_w)

    out["pipeline"] = ms(pipeline, reps=10)
    out["states_decode"] = ms(lambda: decode_connected(bank, graph7, feats, nf), reps=5)

    # ---- K7 and the bigram path (chip_smoke.py's inputs) ---------------------
    words1k, trans1k, ids1k, brng = bench_lexicon()
    lex1k = build_lex_graph(words1k, trans1k, ids1k, word_insertion_cost=0.5)
    g1k, topo1k = lex1k.banded.to(dev), lk.lex_topology(lex1k.banded)
    lm1k = fit_bigram([[int(x) for x in brng.integers(0, 1000, 12)] for _ in range(200)], 1000)
    TL = 500
    e = brng.uniform(0, 5, (TL, 24, 128)).astype(np.float32)
    nll_b = torch.from_numpy(np.ascontiguousarray(e.transpose(1, 0, 2))).to(dev)
    nf_full = torch.full((128,), TL, dtype=torch.int32, device=dev)
    lm_l1k = lattice_lm(lm1k, lex1k.leaf_word, dev)
    dmax = _ring_depth(TL, 128)
    k6 = lt.viterbi_lattice(nll_b, g1k, topo1k, nf_full)
    k7_args = (k6[1], k6[2], k6[1].amin(2), lm_l1k[0], lm_l1k[1], nf_full, dmax)
    out["k7_1k"] = ms(lambda: lt.rescore_lattice(*k7_args, backoff=lm_l1k[3]), reps=10)
    rnd = np.random.default_rng(6)
    lm_dense = types.SimpleNamespace(cost=rnd.uniform(0.1, 3.0, (1000, 1000)),
                                     start_cost=rnd.uniform(0.1, 2.0, 1000),
                                     end_cost=rnd.uniform(0.1, 2.0, 1000))
    lm_ld = lattice_lm(lm_dense, lex1k.leaf_word, dev)
    out["k7_1k_dense"] = ms(lambda: lt.rescore_lattice(*k7_args[:-1], dmax, big_ll=lm_ld[2]),
                            reps=3)
    wordsd, transd, idsd, _ = dict1_shaped_lexicon()
    lexd = build_lex_graph(wordsd, transd, idsd, word_insertion_cost=0.5)
    gd, topod = lexd.banded.to(dev), lk.lex_topology(lexd.banded)
    n_bank_d = int(lexd.banded.bank_state.max()) + 1
    _, _, _, drng2 = dict1_shaped_lexicon()
    lmd = fit_bigram([[int(x) for x in drng2.integers(0, len(wordsd), 20)]
                      for _ in range(400)], len(wordsd))
    lm_ldd = lattice_lm(lmd, lexd.leaf_word, dev)
    nll_bd = torch.from_numpy(drng2.uniform(0, 5, (n_bank_d, TL, 16)).astype(np.float32)).to(dev)
    nf_d16 = torch.full((16,), TL, dtype=torch.int32, device=dev)
    kd = lt.viterbi_lattice(nll_bd, gd, topod, nf_d16)
    kd_args = (kd[1], kd[2], kd[1].amin(2), lm_ldd[0], lm_ldd[1], nf_d16, dmax)
    out["k7_dict"] = ms(lambda: lt.rescore_lattice(*kd_args, backoff=lm_ldd[3]), reps=5)
    out["k7_dict_k"] = int(lm_ldd[3][1].shape[1])
    lbank, lexp, lcfg, lsig, llens = cs.make_lex_pipeline(dev)
    gp, topop = lexp.banded.to(dev), lk.lex_topology(lexp.banded)
    prng = np.random.default_rng(9)
    lm_p = fit_bigram([[int(x) for x in prng.integers(0, len(lexp.words), 12)]
                       for _ in range(200)], len(lexp.words))
    lm_lp = lattice_lm(lm_p, lexp.leaf_word, dev)
    su_p = lexp.n_states // lexp.n_arcs

    def bigram():
        f, n = mfcc39_auto(lsig, llens, lcfg)
        return _decode_lattice_batch(lbank, f, n, gp, topop, lm_lp, su_p)

    out["bigram"] = ms(bigram, reps=5)
    dv = cs.device_ms
    out["dev"] = {
        "k2_512": dv(lambda: vk.banded_backtrace_val(k1[1], k1[3], ends, nf, topo.uniform_w)),
        "k2_256": dv(lambda: vk.banded_backtrace_val(*planes256, ends[:256], nf[:256],
                                                     topo.uniform_w)),
        "k1_512": dv(lambda: vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)),
        "k1_k2_512": dv(k1_k2),
        "k7_1k": dv(lambda: lt.rescore_lattice(*k7_args, backoff=lm_l1k[3])),
        "k7_dict": dv(lambda: lt.rescore_lattice(*kd_args, backoff=lm_ldd[3]))}
    if hasattr(lt, "rescore_and_walk"):
        mw = min(TL, TL // (lex1k.n_states // lex1k.n_arcs) + 1)
        k7w_args = (*k7_args[:2], *k7_args[3:], 128, mw)
        out["k7w_1k"] = ms(lambda: lt.rescore_and_walk(*k7w_args, backoff=lm_l1k[3]), reps=10)
        out["dev"]["k7w_1k"] = dv(lambda: lt.rescore_and_walk(*k7w_args, backoff=lm_l1k[3]))

    if args.lab:
        limit = lib.srt_smem_limit()
        l1k, kk = g1k.n_ends, lm_l1k[3][1].shape[1]
        auto7 = lt.rescore_plan(l1k, kk, False, limit)
        out["k7_plan_1k"] = auto7.mode
        for name, plan in (("no tables", auto7._replace(
                               tables=False, smem=lt.rescore_smem_bytes(l1k, kk, False))),
                           ("direct", lt.RescorePlan(0, 1024, False, False, 8 * l1k))):
            fn = (lambda plan=plan: lt.rescore_lattice(*k7_args, backoff=lm_l1k[3],
                                                       plan=plan))
            out[f"k7_1k {name}"] = ms(fn, reps=10)
            out["dev"][f"k7_1k {name}"] = dv(fn)
        ld = gd.n_ends
        out["k7_plan_dict"] = lt.rescore_plan(ld, out["k7_dict_k"], False, limit).mode
        out["k7_dict direct"] = ms(lambda: lt.rescore_lattice(
            *kd_args, backoff=lm_ldd[3], plan=lt.RescorePlan(0, 1024, False, False, 8 * ld)),
            reps=5)
        phases = ("row wait", "D + ring reads", "barrier", "recombination + stores")
        for name, a, bo in (("1k", k7_args, lm_l1k[3]), ("dict", kd_args, lm_ldd[3])):
            tr = torch.zeros((a[0].shape[1], 4), dtype=torch.int64, device=dev)
            lt.rescore_lattice(*a, backoff=bo, trace=tr)
            torch.cuda.synchronize()
            cyc = (tr.double().mean(0) / TL).tolist()
            out[f"k7_{name} cycles per frame"] = dict(zip(phases, cyc), total=sum(cyc))
            out[f"k7_{name} ring rows per warp, newest share"] = ring_stats(a[1], dmax)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

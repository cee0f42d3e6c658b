"""Command-line interface of the port: the ``connected_test``,
``isolated_test`` and ``align`` actions.

Counterpart of ``speech_recognition_tpu/cli.py`` ``connected_test``:
wavs -> MFCC-39 (kernel K3 on CUDA) -> banded connected decode (kernels
K1 + K2 on CUDA; K8 + K9 for graphs the fused kernels refuse, such as a
sausage of 1-state words), or with ``--graph lextree`` the lexical-tree
decode (kernels K4 + K5 on CUDA) -> word ids, scored against the
Aurora-style transcripts in the file names.  Output lines match the
reference CLI.

``--lm bigram`` fits an add-k bigram on the transcripts of ``--lm-train``
(default: the test transcripts, with a warning), scales it by
``--lm-weight`` and makes silence LM-transparent.  ``loop`` and
``sausage`` compose it onto the graph (K1 + K2); ``lextree`` composes
it onto the trie (``--decoder compose``, flat vocabularies: K4 + K5) or
rescores the pass-1 word lattice (``--decoder lattice``, and ``auto``
on multi-unit words: K6 + K7).

``isolated_test`` classifies the single-digit wavs ``<SPEAKER>_<digit>
[AB].wav`` of a directory (the silence model, if the bank has one, is
left out): MFCC-39 (K3 on CUDA) -> one emission GEMM -> dense Viterbi per
(utterance, model) (kernel K11 on CUDA) -> argmin; it prints each wrong
file and the accuracy.  ``align`` force-aligns every Aurora-named wav to
its transcript (optional silence between and around the words, when the
bank has a silence model): padded transcript graphs -> K11 with
per-utterance matrices -> backtrace, and writes one JSON line per file
with its word segments, their times and the path cost.

Run:  python -m speech_recognition_tpu_torch.cli connected_test \
          -i bank.npz -d wav_dir [--graph loop|sausage|lextree] \
          [--lm none|bigram] [--decoder auto|compose|lattice] [--device cuda|cpu]
      python -m speech_recognition_tpu_torch.cli isolated_test -i bank.npz -d wav_dir
      python -m speech_recognition_tpu_torch.cli align -i bank.npz -d wav_dir \
          -o alignments.jsonl

The device is explicit (default ``cuda``); asking for CUDA on a host
without it is an error, never a silent CPU run.  Other actions are not
ported yet (ROADMAP queue A).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import sys

import numpy as np
import torch

from speech_recognition_tpu_torch.config import DIGIT_NAMES, DecodeConfig, FrontendConfig

__all__ = ["main", "cmd_connected_test", "cmd_isolated_test", "cmd_align"]


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return dev


def _featurize_files(paths, cfg: FrontendConfig, cap_samples: int, device,
                     norm: str = "utterance", cmvn=None):
    """Wavs -> ``(feats [N, F, 39], n_frames [N])`` on ``device``.

    The frontend adapts to the files' sample rate; ``norm`` is
    'utterance' (per-utterance z-norm) or 'cmvn' (raw features, then the
    corpus statistics ``cmvn = (mean, std)``)."""
    from speech_recognition_tpu_torch.data.wav import load_wav_batch
    from speech_recognition_tpu_torch.ops.frontend import (
        apply_cmvn,
        mfcc39_auto,
        padded_length,
    )

    samples, lengths, rates = load_wav_batch(list(paths), cap_samples)
    b = samples.shape[0]
    rate = int(rates[0]) if len(rates) else cfg.sample_rate
    if np.any(rates[:b] != rate):
        raise ValueError(f"mixed sample rates in batch: {sorted(set(rates.tolist()))}")
    if rate != cfg.sample_rate:
        cfg = dataclasses.replace(cfg, sample_rate=rate)
    L = padded_length(cfg, cap_samples)
    if L > samples.shape[1]:
        samples = np.pad(samples, ((0, 0), (0, L - samples.shape[1])))
    else:
        samples = samples[:, :L]
    sig = torch.from_numpy(np.ascontiguousarray(samples, np.float32)).to(device)
    lens = torch.from_numpy(np.minimum(lengths, cap_samples).astype(np.int32)).to(device)
    feats, nf = mfcc39_auto(sig, lens, cfg, None,
                            "utterance" if norm == "utterance" else "none")
    if norm == "cmvn" and cmvn is not None:
        feats = apply_cmvn(feats, nf, torch.as_tensor(cmvn[0], device=device),
                           torch.as_tensor(cmvn[1], device=device))
    return feats, nf


def _norm_from_meta(meta):
    """(norm, cmvn) from a bank's metadata."""
    norm = meta.get("norm", "utterance")
    cmvn = None
    if norm == "cmvn":
        arrs = meta.get("arrays", {})
        cmvn = (arrs["cmvn_mean"], arrs["cmvn_std"])
    return norm, cmvn


def _bigram(args, refs, n_models, sil):
    """The ``--lm bigram`` model: fitted on ``--lm-train``'s transcripts
    (or the test transcripts), scaled, silence LM-transparent."""
    from speech_recognition_tpu_torch.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram, scale

    if args.lm_train:
        names = [os.path.basename(f)
                 for f in sorted(glob.glob(os.path.join(args.lm_train, "*.wav")))]
        seqs = [labels_from_transcript(transcript_from_filename(n))
                for n in names if transcript_from_filename(n)]
    else:
        print("WARNING: --lm-train not given; fitting the bigram on the "
              "test transcripts themselves (evaluation is optimistic)")
        seqs = refs
    lm = scale(fit_bigram(seqs, n_models), args.lm_weight)
    if sil is not None:
        # entering or leaving silence spends no word-transition probability
        lm.cost[sil, :] = 0.0
        lm.cost[:, sil] = 0.0
        lm.start_cost[sil] = 0.0
        lm.end_cost[sil] = 0.0
    return lm


def cmd_connected_test(args):
    from speech_recognition_tpu_torch.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_tpu_torch.decode.connected import decode_connected
    from speech_recognition_tpu_torch.models.graph import (
        build_loop_graph,
        build_word_graph,
    )
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank
    from speech_recognition_tpu_torch.utils.metrics import (
        positional_digit_accuracy,
        sequence_accuracy,
        wer,
    )

    dev = _device(args.device)
    bank, meta = load_bank(args.input)
    bank = bank.to(dev)
    norm, cmvn = _norm_from_meta(meta)
    sil = meta.get("silence_index")
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    files = [f for f in files if transcript_from_filename(os.path.basename(f))]
    refs = [labels_from_transcript(transcript_from_filename(os.path.basename(f)))
            for f in files]
    feats, nf = _featurize_files(files, FrontendConfig(), args.max_samples, dev,
                                 norm=norm, cmvn=cmvn)
    feats = feats[:, : int(nf.max())]  # trim to the longest utterance

    trans_np = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    drop = {sil} if sil is not None else None
    lm = _bigram(args, refs, bank.n_models, sil) if args.lm == "bigram" else None
    if args.graph == "loop":
        graph = build_loop_graph(trans_np, lm=lm, word_insertion_cost=args.word_insertion_cost)
        hyps, _ = decode_connected(bank, graph, feats, nf, drop_labels=drop)
    elif args.graph == "lextree":
        # the large-vocabulary decoder; on the flat digit vocabulary it
        # gives the loop graph's words
        from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

        symbols = [chr(ord("0") + i) if i < 10 else chr(ord("A") + i - 10)
                   for i in range(bank.n_models)]
        ids = {s: i for i, s in enumerate(symbols)}
        if args.decoder == "lattice" and lm is None:
            sys.exit("--decoder lattice needs --lm bigram")
        use_lattice = lm is not None and (
            args.decoder == "lattice"
            or (args.decoder == "auto" and any(len(s) > 1 for s in symbols)))
        if use_lattice:
            # the deep-tree path: no-LM pass-1 lattice + exact bigram
            # rescoring (composing the bigram onto a trie is exact only
            # on flat vocabularies)
            from speech_recognition_tpu_torch.ops.lattice import decode_lextree_bigram

            lexg = build_lex_graph(symbols, trans_np, ids,
                                   word_insertion_cost=args.word_insertion_cost)
            hyps, _ = decode_lextree_bigram(bank, lexg, lm, feats, nf)
        else:
            from speech_recognition_tpu_torch.decode.lextree import decode_lextree

            lexg = build_lex_graph(symbols, trans_np, ids, lm=lm,
                                   word_insertion_cost=args.word_insertion_cost)
            hyps, _ = decode_lextree(bank, lexg, feats, nf)
        if sil is not None:
            hyps = [[w for w in h if w != sil] for h in hyps]
    else:
        # one graph + one batched decode per distinct slot count
        vocab = [i for i in range(bank.n_models) if i != sil]
        by_slots = {}
        for i, r in enumerate(refs):
            by_slots.setdefault(args.n_slots or len(r), []).append(i)
        hyps = [None] * len(refs)
        for n_slots, idxs in sorted(by_slots.items()):
            graph = build_word_graph(trans_np, [vocab] * n_slots, lm=lm)
            sel = torch.as_tensor(idxs, device=dev)
            hs, _ = decode_connected(bank, graph, feats[sel], nf[sel], drop_labels=drop)
            for i, h in zip(idxs, hs):
                hyps[i] = h

    for h, r in zip(hyps, refs):
        tag = "Correct" if h == r else "Incorrect"
        print(f"{tag}: {[DIGIT_NAMES[x] for x in h]} ref {[DIGIT_NAMES[x] for x in r]}")
    print("Sequence accuracy:", sequence_accuracy(hyps, refs))
    print("Digit accuracy:", positional_digit_accuracy(hyps, refs))
    print("WER:", wer(hyps, refs))
    return hyps, refs


def cmd_isolated_test(args):
    from speech_recognition_tpu_torch.decode.isolated import classify_batch
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank

    dev = _device(args.device)
    bank, meta = load_bank(args.input)
    norm, cmvn = _norm_from_meta(meta)
    sil = meta.get("silence_index")
    if sil is not None:  # classify over the digits only
        bank = HMMBank(*[getattr(bank, f)[:sil]
                         for f in ("means", "log_vars", "log_weights", "trans_cost")])
    bank = bank.to(dev)
    files, labels = [], []
    for d, name in enumerate(DIGIT_NAMES):
        pattern = re.compile("[A-Z]+_" + name + "[AB].wav")
        for f in sorted(glob.glob(os.path.join(args.data, "*.wav"))):
            if pattern.match(os.path.basename(f)):
                files.append(f)
                labels.append(d)
    feats, nf = _featurize_files(files, FrontendConfig(), args.max_samples, dev,
                                 norm=norm, cmvn=cmvn)
    pred, _ = classify_batch(bank, feats[:, : int(nf.max())].contiguous(), nf)
    pred = pred.cpu().numpy()
    for f, p, l in zip(files, pred, labels):
        if p != l:
            print(f"Digit: {DIGIT_NAMES[l]} is wrong ({os.path.basename(f)} -> {DIGIT_NAMES[p]})")
    acc = float(np.mean(pred == np.asarray(labels)))
    print(acc)


def cmd_align(args):
    """Forced alignment: per-utterance word segments with times."""
    from speech_recognition_tpu_torch.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
    from speech_recognition_tpu_torch.train.continuous import align_batch
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank

    dev = _device(args.device)
    cfg = FrontendConfig()
    bank, meta = load_bank(args.input)
    bank = bank.to(dev)
    norm, cmvn = _norm_from_meta(meta)
    sil = meta.get("silence_index")
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    files = [f for f in files if transcript_from_filename(os.path.basename(f))]
    labels = [labels_from_transcript(transcript_from_filename(os.path.basename(f)))
              for f in files]
    feats, nf = _featurize_files(files, cfg, args.max_samples, dev, norm=norm, cmvn=cmvn)
    feats = feats[:, : int(nf.max())].contiguous()

    trans_np = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    gb, eps_depth = pad_graphs([transcript_graph(trans_np, ls, sil=sil) for ls in labels])
    g = {k: torch.as_tensor(gb[k], device=dev) for k in
         ("trans", "eps_trans", "init_cost", "end_states", "bank_state")}
    ids, costs = align_batch(bank, feats, nf, g["trans"], g["eps_trans"], g["init_cost"],
                             g["end_states"], g["bank_state"], eps_depth=eps_depth)
    ids, costs, nb = ids.cpu().numpy(), costs.cpu().numpy(), nf.cpu().numpy()
    step_s, s_per_model = cfg.frame_step_s, bank.n_states
    with open(args.output, "w") as out:
        for i, f in enumerate(files):
            # runs of one model id are word segments; a repeated word
            # ("44") shows as the state index dropping within the model
            valid = ids[i, : int(nb[i])]
            mids, sids = valid // s_per_model, valid % s_per_model
            segs, start = [], 0
            for t in range(1, len(mids) + 1):
                if t == len(mids) or mids[t] != mids[start] or sids[t] < sids[t - 1]:
                    m = int(mids[start])
                    segs.append({"word": DIGIT_NAMES[m] if m < len(DIGIT_NAMES) else "sil",
                                 "start_s": round(start * step_s, 3),
                                 "end_s": round(t * step_s, 3)})
                    start = t
            out.write(json.dumps({"file": os.path.basename(f), "cost": float(costs[i]),
                                  "segments": segs}) + "\n")
    print(f"wrote alignments for {len(files)} files to {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Digit ASR (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="action", required=True)
    _dc = DecodeConfig()
    device_help = "torch device to run on (default cuda; never falls back)"
    p = sub.add_parser("connected_test")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--graph", choices=["loop", "sausage", "lextree"], default="loop")
    p.add_argument("--lm", choices=["none", "bigram"], default="none")
    p.add_argument("--n-slots", type=int, default=0,
                   help=f"sausage slots (0 = per-utterance ref length; "
                        f"reference uses {_dc.n_slots})")
    p.add_argument("--word-insertion-cost", type=float,
                   default=_dc.word_insertion_cost)
    p.add_argument("--lm-weight", type=float, default=_dc.lm_weight)
    p.add_argument("--lm-train", default=None,
                   help="wav dir whose filenames provide bigram training "
                        "transcripts (default: test transcripts, with warning)")
    p.add_argument("--decoder", choices=["auto", "compose", "lattice"], default="auto",
                   help="lextree+bigram strategy: compose the LM onto the graph "
                        "(flat vocabularies only) or rescore the word lattice "
                        "(the deep-tree path); auto picks lattice for multi-unit words")
    p.add_argument("--max-samples", type=int, default=120000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_connected_test)

    p = sub.add_parser("isolated_test")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--max-samples", type=int, default=64000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_isolated_test)

    p = sub.add_parser("align", help="forced alignment -> word segments")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir (Aurora names)")
    p.add_argument("-o", "--output", default="alignments.jsonl")
    p.add_argument("--max-samples", type=int, default=120000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_align)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

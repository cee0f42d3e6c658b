"""Command-line interface of the port: ``synth``, ``isolated_train``,
``isolated_test``, ``continuous_train``, ``connected_test``, ``stream``,
``align``, ``spellcheck`` and ``record``.

Counterpart of ``speech_recognition_tpu/cli.py``.  ``synth`` writes the
deterministic synthetic Aurora-style corpus (the same wavs, byte for
byte, as the JAX CLI for the same seed).  ``isolated_train`` trains one
word model per digit from ``<SPEAKER>_<digit>[AB].wav`` files: MFCC-39
(K3 on CUDA) -> segmental K-means (kernel K11 aligns every template of
a word in one launch) -> mixture splitting with k-means and EM
(``--no-gmm``: single-Gaussian segmental K-means templates; ``--no-em``:
k-means only; ``--norm cmvn``: corpus CMVN; ``--silence``: a silence
model from the non-speech regions).  ``continuous_train`` runs embedded
training iterations on connected-digit strings and writes
``bank_NNNNN.npz`` each iteration, resuming from the newest: ``--algo
hard`` Viterbi-EM (per-utterance transcript graphs, K11 with
per-utterance matrices, one bank of statistics GEMMs), ``--algo soft``
Baum-Welch (the same graphs, the dense forward-backward K16, gamma-
weighted statistics GEMMs).

``connected_test``: wavs -> MFCC-39 (kernel K3 on CUDA) -> banded
connected decode (kernels K1 + K2 on CUDA; K8 + K9 for graphs the fused
kernels refuse, such as a sausage of 1-state words), or with ``--graph
lextree`` the lexical-tree decode (kernels K4 + K5 on CUDA) -> word ids,
scored against the Aurora-style transcripts in the file names.  Output
lines match the reference CLI.  ``--confidence`` (``--graph loop``)
re-derives each path (K1 + K2), runs the banded forward-backward over
the loop graph (K15) and prints each word's mean frame posterior.

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

``stream`` decodes every wav of a directory chunk by chunk through
``decode.streaming.StreamingDecoder`` (the long-audio serving path):
MFCC-39 (K3 on CUDA) -> per chunk the chunk step K17 (K13 + K1's DP from
the carried frontier; ``--graph loop``) or K18 (K4 from the carry;
``--graph lextree``) -> one backtrace at the end (K2 or K5) -> words,
printed with the path cost.  ``--incremental`` streams each file alone
and prints words as they become immortal (their paths backtraced
mid-stream, their planes dropped), with the count emitted before the
end.

Run:  python -m speech_recognition_tpu_torch.cli synth -o data
      python -m speech_recognition_tpu_torch.cli isolated_train -i data/train \
          -o bank.npz [--silence] [--device cuda|cpu]
      python -m speech_recognition_tpu_torch.cli continuous_train -i bank.npz \
          -d data/train -o models-continuous --algo hard|soft
      python -m speech_recognition_tpu_torch.cli connected_test \
          -i bank.npz -d wav_dir [--graph loop|sausage|lextree] \
          [--lm none|bigram] [--decoder auto|compose|lattice] [--confidence] \
          [--device cuda|cpu]
      python -m speech_recognition_tpu_torch.cli isolated_test -i bank.npz -d wav_dir
      python -m speech_recognition_tpu_torch.cli stream -i bank.npz -d wav_dir \
          [--graph loop|lextree] [--chunk-frames 64] [--incremental]
      python -m speech_recognition_tpu_torch.cli align -i bank.npz -d wav_dir \
          -o alignments.jsonl
      python -m speech_recognition_tpu_torch.cli spellcheck -d dict.txt \
          [-t text | -f file] [--device cuda|cpu]

``spellcheck`` corrects each line of ``-t`` text, a ``-f`` file or
stdin against a dictionary file (one word per line, or a CSV whose first
line is ``words``) and prints whole dictionary words; the text Viterbi
runs on the device.  ``record`` captures one endpointed utterance from
the microphone (it needs pyaudio and raises without it), writes it and,
with ``-i``, classifies it.

Wavs are read by the native batched loader (``runtime.loader``); a
corpus of more than 512 files streams through it 512 files at a time,
each batch read while the one before it featurizes.

The device is explicit (default ``cuda``); asking for CUDA on a host
without it is an error, never a silent CPU run.
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

from speech_recognition_tpu_torch.config import (
    DIGIT_NAMES,
    DecodeConfig,
    FrontendConfig,
    HMMConfig,
    TrainConfig,
)

__all__ = ["main", "cmd_synth", "cmd_isolated_train", "cmd_continuous_train",
           "cmd_connected_test", "cmd_isolated_test", "cmd_align", "cmd_stream",
           "cmd_spellcheck", "cmd_record"]


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    return dev


def _featurize_files(paths, cfg: FrontendConfig, cap_samples: int, device,
                     norm: str = "utterance", cmvn=None, chunk: int = 512):
    """Wavs -> ``(feats [N, F, 39], n_frames [N])`` on ``device``.

    The files are read by the native loader (``runtime.loader``); more
    than ``chunk`` of them stream through ``PrefetchWavBatches`` in
    batches of ``chunk`` (the next batch read from disk while this one
    featurizes; the tail batch pads with the first file and its extra
    rows are dropped), each featurized alone.  The frontend adapts to
    the files' sample rate; ``norm`` is 'utterance' (per-utterance
    z-norm) or 'cmvn' (raw features, then the corpus statistics ``cmvn =
    (mean, std)``)."""
    from speech_recognition_tpu_torch.runtime.loader import PrefetchWavBatches, load_wav_batch

    paths = list(paths)
    if len(paths) > chunk:
        padded = paths + [paths[0]] * ((-len(paths)) % chunk)
        parts = [_featurize_loaded(samples, lengths, rates, cfg, cap_samples, device, norm,
                                   cmvn)
                 for _, samples, lengths, rates in PrefetchWavBatches(padded, chunk,
                                                                      cap_samples)]
        return (torch.cat([f for f, _ in parts])[: len(paths)],
                torch.cat([n for _, n in parts])[: len(paths)])
    return _featurize_loaded(*load_wav_batch(paths, cap_samples), cfg, cap_samples, device,
                             norm, cmvn)


def _featurize_loaded(samples, lengths, rates, cfg: FrontendConfig, cap_samples: int, device,
                      norm: str, cmvn):
    """One loaded batch -> features, at the batch's sample rate."""
    b = samples.shape[0]
    rate = int(rates[0]) if len(rates) else cfg.sample_rate
    if np.any(rates[:b] != rate):
        raise ValueError(f"mixed sample rates in batch: {sorted(set(rates.tolist()))}")
    if rate != cfg.sample_rate:
        cfg = dataclasses.replace(cfg, sample_rate=rate)
    return _featurize_samples(samples, np.minimum(lengths, cap_samples), cfg, cap_samples,
                              device, norm, cmvn)


def _featurize_samples(samples, lengths, cfg: FrontendConfig, cap_samples: int, device,
                       norm: str = "utterance", cmvn=None):
    """Zero-padded ``samples [N, W]`` (at the config's sample rate) with
    their ``lengths`` -> features, as :func:`_featurize_files`."""
    from speech_recognition_tpu_torch.ops.frontend import (
        apply_cmvn,
        mfcc39_auto,
        padded_length,
    )

    L = padded_length(cfg, cap_samples)
    if L > samples.shape[1]:
        samples = np.pad(samples, ((0, 0), (0, L - samples.shape[1])))
    else:
        samples = samples[:, :L]
    sig = torch.from_numpy(np.ascontiguousarray(samples, np.float32)).to(device)
    lens = torch.from_numpy(np.minimum(lengths, L).astype(np.int32)).to(device)
    feats, nf = mfcc39_auto(sig, lens, cfg, None,
                            "utterance" if norm == "utterance" else "none")
    if norm == "cmvn" and cmvn is not None:
        feats = apply_cmvn(feats, nf, torch.as_tensor(cmvn[0], device=device),
                           torch.as_tensor(cmvn[1], device=device))
    return feats, nf


def _digit_files(wav_dir: str):
    """``{digit index: sorted files <SPEAKER>_<digit>[AB].wav}``."""
    out = {}
    for d, name in enumerate(DIGIT_NAMES):
        pattern = re.compile("[A-Z]+_" + name + "[AB].wav")
        out[d] = sorted(f for f in glob.glob(os.path.join(wav_dir, "*.wav"))
                        if pattern.match(os.path.basename(f)))
    return out


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


def cmd_synth(args):
    from speech_recognition_tpu_torch.data.synthetic import SyntheticDigits
    from speech_recognition_tpu_torch.data.wav import write_wav

    gen = SyntheticDigits(seed=args.seed)
    for sub in ("train", "test"):
        os.makedirs(os.path.join(args.output, sub), exist_ok=True)
    corpora = (("train", gen.isolated_corpus(args.n_train, tag="train")),
               ("test", gen.isolated_corpus(args.n_test, tag="test")),
               ("train", gen.continuous_corpus(args.n_continuous, tag="cont")),
               ("test", gen.continuous_corpus(max(args.n_continuous // 4, 1), tag="ctest")))
    for sub, utts in corpora:
        for u in utts:
            write_wav(os.path.join(args.output, sub, u.name), u.samples)
    print(f"wrote corpus under {args.output}/")


def cmd_isolated_train(args):
    from speech_recognition_tpu_torch.models.hmm import GMMHMM, HMMBank
    from speech_recognition_tpu_torch.train.isolated import fit_hmm
    from speech_recognition_tpu_torch.train.kmeans import random_assign
    from speech_recognition_tpu_torch.utils.checkpoint import save_bank

    dev = _device(args.device)
    cfg = FrontendConfig()
    hmm_cfg = HMMConfig(n_states=args.n_states, n_mix=args.n_gaussians)
    train_cfg = TrainConfig()
    by_digit = _digit_files(args.input)
    for d, files in by_digit.items():
        if not files:
            sys.exit(f"no training files for digit {DIGIT_NAMES[d]} under {args.input}")
    all_files = [f for fs in by_digit.values() for f in fs]

    cmvn = None
    if args.norm == "cmvn":
        from speech_recognition_tpu_torch.ops.frontend import cmvn_stats

        raw, nf = _featurize_files(all_files, cfg, args.max_samples, dev, norm="cmvn")
        cmvn = tuple(x.cpu().numpy() for x in cmvn_stats(raw, nf))
    # the features of a file do not depend on its batch: featurize once
    feats, nf = _featurize_files(all_files, cfg, args.max_samples, dev, norm=args.norm,
                                 cmvn=cmvn)
    nf_np = nf.cpu().numpy()
    temps, i = {}, 0
    for d, files in by_digit.items():
        temps[d] = [feats[j, : nf_np[j]] for j in range(i, i + len(files))]
        i += len(files)
    pad_to = int(nf_np.max())
    models = []
    for d, name in enumerate(DIGIT_NAMES):
        print(f"training {name} on {len(temps[d])} files")
        if args.gmm:
            draw = random_assign(torch.Generator().manual_seed(train_cfg.seed + d))
            models.append(fit_hmm(temps[d], use_em=args.em, train_cfg=train_cfg,
                                  hmm_cfg=hmm_cfg, pad_to=pad_to, draw_assign=draw))
        else:
            # single-Gaussian segmental K-means templates scored by
            # Mahalanobis DTW == a one-mixture bank
            from speech_recognition_tpu_torch.decode.dtw import fit_template

            m, v, t = fit_template(temps[d], hmm_cfg.n_states, pad_to=pad_to)
            models.append(GMMHMM(m[:, None, :], torch.log(v[:, None, :]),
                                 torch.zeros((hmm_cfg.n_states, 1), device=dev), t))

    meta = {"kind": "isolated" if args.gmm else "template",
            "n_mix": args.n_gaussians if args.gmm else 1, "norm": args.norm}
    arrays = {} if cmvn is None else {"cmvn_mean": cmvn[0], "cmvn_std": cmvn[1]}
    if args.silence:
        from speech_recognition_tpu_torch.ops.frontend import padded_length
        from speech_recognition_tpu_torch.runtime.loader import load_wav_batch
        from speech_recognition_tpu_torch.train.silence import (
            fit_silence_hmm,
            harvest_silence_samples,
            pad_mixtures,
        )

        samples, lengths, _ = load_wav_batch(all_files, padded_length(cfg, args.max_samples))
        segs = harvest_silence_samples([samples[i, : lengths[i]]
                                        for i in range(len(all_files))])
        if segs:
            seg_lens = np.array([len(seg) for seg in segs])
            buf = np.zeros((len(segs), int(seg_lens.max())), np.float32)
            for i, seg in enumerate(segs):
                buf[i, : len(seg)] = seg
            sf, snf = _featurize_samples(buf, seg_lens, cfg, args.max_samples, dev,
                                         norm=args.norm, cmvn=cmvn)
            snf = snf.cpu().numpy()
            frames = torch.cat([sf[i, : snf[i]] for i in range(len(segs))])
            # at most 2 mixtures, and no more than the digits' (1 with --no-gmm)
            sil = fit_silence_hmm(frames, n_states=args.n_states,
                                  n_mix=min(args.n_gaussians, 2, models[0].n_mix),
                                  hmm_cfg=hmm_cfg,
                                  draw_assign=random_assign(
                                      torch.Generator().manual_seed(4242)))
            models.append(pad_mixtures(sil, models[0].n_mix))
            meta["silence_index"] = len(models) - 1
            print(f"trained silence model from {len(segs)} segments")

    save_bank(args.output, HMMBank.stack(models), meta, arrays=arrays)
    print(f"saved bank to {args.output}")


def cmd_continuous_train(args):
    from speech_recognition_tpu_torch.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_tpu_torch.train.embedded_step import (
        compose_graphs,
        embedded_step,
        embedded_step_soft,
    )
    from speech_recognition_tpu_torch.utils.checkpoint import (
        latest_iteration,
        load_bank,
        save_iteration,
    )

    dev = _device(args.device)
    start_it = 0
    it_found, ckpt = latest_iteration(args.output)
    if ckpt:
        print(f"resuming from {ckpt}")
        bank, meta = load_bank(ckpt)
        start_it = it_found + 1
    else:
        bank, meta = load_bank(args.input)
    bank = bank.to(dev)
    norm, cmvn = _norm_from_meta(meta)
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    files = [f for f in files if transcript_from_filename(os.path.basename(f))]
    labels = [labels_from_transcript(transcript_from_filename(os.path.basename(f)))
              for f in files]
    feats, nf = _featurize_files(files, FrontendConfig(), args.max_samples, dev, norm=norm,
                                 cmvn=cmvn)
    feats = feats[:, : int(nf.max())].contiguous()

    sil = meta.get("silence_index")
    if sil is not None:
        print(f"using optional silence arcs (model {sil}) in alignment graphs")
    keep = {k: v for k, v in meta.items() if k != "arrays"}
    soft = args.algo == "soft"
    step = embedded_step_soft if soft else embedded_step
    for it in range(start_it, start_it + args.iterations):
        g, eps_depth = compose_graphs(bank, labels, sil, end_scores=soft)
        new_bank, stats = step(bank, feats, nf, g, eps_depth=eps_depth)
        cost = float(stats.total_cost)
        print(f"iteration {it}: total alignment cost {cost:.1f}")
        save_iteration(args.output, it, new_bank, {**keep, "cost": cost},
                       arrays=meta.get("arrays", {}))
        converged = all(torch.allclose(getattr(new_bank, f), getattr(bank, f), rtol=1e-5,
                                       atol=1e-8)
                        for f in ("means", "log_vars", "log_weights"))
        bank = new_bank
        if converged:
            print("continuous training converged")
            break


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
    if args.confidence and args.graph == "loop":
        _print_confidence(bank, graph, feats, nf, files)
    print("Sequence accuracy:", sequence_accuracy(hyps, refs))
    print("Digit accuracy:", positional_digit_accuracy(hyps, refs))
    print("WER:", wer(hyps, refs))
    return hyps, refs


def _print_confidence(bank, graph, feats, nf, files):
    """``confidence <file>: word:c ...`` lines: each path re-derived by the
    banded decode (K1 + K2), its frame posteriors from the banded
    forward-backward (K15), averaged over each word's frames."""
    from speech_recognition_tpu_torch.decode.confidence import path_posteriors, word_confidence
    from speech_recognition_tpu_torch.decode.connected import _decode_banded_batch
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    bg = banded_arrays(graph, feats.device)
    feats = feats.contiguous()
    states, eps_flags, _ = _decode_banded_batch(bank, feats, nf, bg, eps_depth=graph.eps_depth)
    post = path_posteriors(bank, bg, feats, nf, states, eps_depth=graph.eps_depth).cpu().numpy()
    states, eps_flags, nb = states.cpu().numpy(), eps_flags.cpu().numpy(), nf.cpu().numpy()
    for i, f in enumerate(files):
        wc = word_confidence(graph, states[i], eps_flags[i], post[i], int(nb[i]))
        pretty = " ".join(f"{_digit_name(w)}:{c:.3f}" for w, c in wc)
        print(f"confidence {os.path.basename(f)}: {pretty}")


def _digit_name(w: int) -> str:
    return DIGIT_NAMES[w] if w < len(DIGIT_NAMES) else "sil"


def cmd_stream(args):
    """Streaming decode: push fixed-size feature chunks of every wav
    through the carried-frontier ``StreamingDecoder`` instead of decoding
    utterances whole.  ``--incremental`` turns on bounded-memory
    mid-stream word emission; each file then streams alone (incremental
    emission needs full-width pushes per stream)."""
    from speech_recognition_tpu_torch.decode.streaming import StreamingDecoder
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank

    dev = _device(args.device)
    bank, meta = load_bank(args.input)
    bank = bank.to(dev)
    norm, cmvn = _norm_from_meta(meta)
    files = sorted(glob.glob(os.path.join(args.data, "*.wav")))
    if not files:
        sys.exit(f"no wavs under {args.data}")
    feats, nf = _featurize_files(files, FrontendConfig(), args.max_samples, dev, norm=norm,
                                 cmvn=cmvn)
    nb = nf.cpu().numpy()
    t_max = int(nb.max())
    feats = feats[:, :t_max]  # rows past a file's length are pushed as frozen frames

    trans_np = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    if args.graph == "lextree":
        from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

        symbols = [chr(ord("0") + i) if i < 10 else chr(ord("A") + i - 10)
                   for i in range(bank.n_models)]
        graph = build_lex_graph(symbols, trans_np, {s: i for i, s in enumerate(symbols)},
                                word_insertion_cost=args.word_insertion_cost)
    else:
        graph = build_loop_graph(trans_np, word_insertion_cost=args.word_insertion_cost)

    chunk = args.chunk_frames
    d = feats.shape[2]
    if args.incremental:
        for i, f in enumerate(files):
            dec = StreamingDecoder(bank, graph, chunk_frames=chunk, emit_incremental=True,
                                   window_chunks=args.window_chunks)
            early = []
            t, n = 0, int(nb[i])
            while t < n:
                c = min(chunk, n - t)
                buf = torch.zeros((chunk, d), dtype=torch.float32, device=dev)
                buf[:c] = feats[i, t:t + c]
                early.extend(dec.push(buf, n_valid=c)[0])
                t += c
            words, _, cost = dec.finish()
            print(f"{os.path.basename(f)}: {[_digit_name(w) for w in words]} "
                  f"({len(early)}/{len(words)} words emitted mid-stream, cost {cost:.1f})")
        return
    dec = StreamingDecoder(bank, graph, chunk_frames=chunk, batch=len(files))
    t = 0
    while t < t_max:
        nv = np.clip(nb - t, 0, chunk).astype(np.int32)
        c = min(chunk, t_max - t)
        buf = torch.zeros((len(files), chunk, d), dtype=torch.float32, device=dev)
        buf[:, :c] = feats[:, t:t + c]
        dec.push(buf, n_valid=nv)
        t += chunk
    results = dec.finish()
    if len(files) == 1:
        results = [results]
    for f, (words, _, cost) in zip(files, results):
        print(f"{os.path.basename(f)}: {[_digit_name(w) for w in words]} (cost {cost:.1f})")


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
    by_digit = _digit_files(args.data)
    files = [f for fs in by_digit.values() for f in fs]
    labels = [d for d, fs in by_digit.items() for _ in fs]
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


def cmd_spellcheck(args):
    """Correct text against a dictionary: each non-empty line, lowercased,
    becomes whole dictionary words (``langmodel.spellcheck``)."""
    from speech_recognition_tpu_torch.langmodel.spellcheck import SpellChecker

    dev = _device(args.device)
    with open(args.dict) as f:
        words = [ln.strip().lower() for ln in f if ln.strip()]
    # the CSV-with-header format ("words" on the first line) is accepted
    if words and words[0] == "words":
        words = words[1:]
    if not words:
        sys.exit(f"dictionary {args.dict} contains no words")
    sc = SpellChecker(device=dev).fit(words)
    if args.text is not None:
        text = args.text
    elif args.file:
        with open(args.file) as f:
            text = f.read()
    else:
        text = sys.stdin.read()
    for line in text.splitlines():
        line = line.strip().lower()
        if line:
            print(sc.spell_check(line))


def cmd_record(args):
    """Record one endpointed utterance from the microphone (needs
    pyaudio), write it, and with ``-i`` classify it as a digit."""
    from speech_recognition_tpu_torch.data.capture import record

    dev = _device(args.device)
    record(args.output_wav)
    print(f"wrote {args.output_wav}")
    if args.input:
        from speech_recognition_tpu_torch.decode.isolated import classify_batch
        from speech_recognition_tpu_torch.utils.checkpoint import load_bank

        bank, _ = load_bank(args.input)
        feats, nf = _featurize_files([args.output_wav], FrontendConfig(), args.max_samples,
                                     dev)
        pred, _ = classify_batch(bank.to(dev), feats[:, : int(nf.max())].contiguous(), nf)
        print("recognized:", DIGIT_NAMES[int(pred[0])])


def main(argv=None):
    ap = argparse.ArgumentParser(description="Digit ASR (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="action", required=True)
    _dc = DecodeConfig()
    device_help = "torch device to run on (default cuda; never falls back)"
    p = sub.add_parser("synth", help="generate the synthetic Aurora-style corpus")
    p.add_argument("-o", "--output", default="data")
    p.add_argument("--n-train", type=int, default=6)
    p.add_argument("--n-test", type=int, default=3)
    p.add_argument("--n-continuous", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser("isolated_train")
    p.add_argument("-i", "--input", required=True, help="wav dir")
    p.add_argument("-o", "--output", default="models/bank.npz")
    p.add_argument("-g", "--gmm", action=argparse.BooleanOptionalAction, default=True,
                   help="GMM-HMM models (--no-gmm: single-Gaussian segmental "
                        "K-means templates, the DTW path)")
    p.add_argument("-e", "--em", action=argparse.BooleanOptionalAction, default=True,
                   help="refine mixtures with EM (--no-em: k-means only)")
    p.add_argument("--n-states", type=int, default=5)
    p.add_argument("--n-gaussians", type=int, default=4)
    p.add_argument("--max-samples", type=int, default=64000)
    p.add_argument("--norm", choices=["utterance", "cmvn"], default="utterance",
                   help="per-utterance z-norm or corpus CMVN")
    p.add_argument("--silence", action="store_true",
                   help="train a silence model from non-speech regions")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_isolated_train)

    p = sub.add_parser("continuous_train")
    p.add_argument("-i", "--input", required=True, help="initial bank .npz")
    p.add_argument("-o", "--output", default="models-continuous")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--algo", choices=["hard", "soft"], default="hard",
                   help="hard = Viterbi-EM; soft = forward-backward Baum-Welch")
    p.add_argument("--max-samples", type=int, default=120000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_continuous_train)

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
    p.add_argument("--confidence", action="store_true",
                   help="print per-word frame-posterior confidence (loop graph)")
    p.add_argument("--max-samples", type=int, default=120000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_connected_test)

    p = sub.add_parser("isolated_test")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--max-samples", type=int, default=64000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_isolated_test)

    p = sub.add_parser("stream", help="streaming (chunked) connected decode")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir")
    p.add_argument("--graph", choices=["loop", "lextree"], default="loop")
    p.add_argument("--chunk-frames", type=int, default=64)
    p.add_argument("--incremental", action="store_true",
                   help="bounded-memory mid-stream word emission")
    p.add_argument("--window-chunks", type=int, default=4)
    p.add_argument("--word-insertion-cost", type=float, default=_dc.word_insertion_cost)
    p.add_argument("--max-samples", type=int, default=120000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("align", help="forced alignment -> word segments")
    p.add_argument("-i", "--input", required=True, help="bank .npz")
    p.add_argument("-d", "--data", required=True, help="wav dir (Aurora names)")
    p.add_argument("-o", "--output", default="alignments.jsonl")
    p.add_argument("--max-samples", type=int, default=120000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("spellcheck", help="correct text against a dictionary")
    p.add_argument("-d", "--dict", required=True,
                   help="dictionary file (one word per line, or a 'words' CSV)")
    p.add_argument("-t", "--text", default=None, help="text to correct")
    p.add_argument("-f", "--file", default=None,
                   help="file of text to correct (default: stdin)")
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_spellcheck)

    p = sub.add_parser("record")
    p.add_argument("-i", "--input", default=None, help="bank .npz for classify")
    p.add_argument("-o", "--output-wav", default="test.wav")
    p.add_argument("--max-samples", type=int, default=64000)
    p.add_argument("--device", default="cuda", help=device_help)
    p.set_defaults(fn=cmd_record)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the token beam's route spends its time, on one GPU.

    python3 scripts/exp_r24_token_beam.py

On ``chip_smoke.py``'s 1k trie (``make_lex_pipeline``) at 32 x 500
planted frames, k = 64: ``beam_decode_lextree`` with the hand kernels
(K19 + K26) and with the plain versions in their place (the route as it
was before K19), in turns (plain, kernel, kernel, plain), with and
without a bigram; then the route's stages alone: ``beam_tables`` (built
on the host and copied each call), the bigram tensors, ``bank_nll_ubt``,
K19, K26 and the host's word lists; the route's device time
(torch.profiler) and idle share.  CUDA-event medians in ms.  Prints one
JSON line with the card's name and power limit.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, device_ms, make_lex_pipeline, planted_features

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from speech_recognition_tpu_torch.decode import lextree as lexdec
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt
    from speech_recognition_tpu_torch.ops import beam as tbeam

    dev = torch.device("cuda", 0)
    bank, lexg, _, _, _ = make_lex_pipeline(dev, batch=1)
    units = [[ord(ch) - ord("a") for ch in wd] for wd in lexg.words]
    feats, nf = planted_features(bank, 32, 500, np.random.default_rng(23), units=units,
                                 dwell=(2, 4))
    lm = fit_bigram([[int(x) for x in np.random.default_rng(41).integers(0, len(lexg.words),
                                                                         12)]
                     for _ in range(200)], len(lexg.words))
    k = 64

    def route(lm_=None):
        return lexdec.beam_decode_lextree(bank, lexg, feats, nf, k, lm=lm_)

    def plain(fn):
        saved = (lexdec.beam_search, lexdec.beam_backtrace)
        lexdec.beam_search, lexdec.beam_backtrace = tbeam.beam_search_ref, tbeam.beam_backtrace_ref
        try:
            return fn()
        finally:
            lexdec.beam_search, lexdec.beam_backtrace = saved

    out = {"turns": {}}
    for lm_on in (False, True):
        lm_ = lm if lm_on else None
        name = "with the bigram" if lm_on else "without a bigram"
        out["turns"][name] = [
            plain(lambda: cuda_ms(lambda: route(lm_), reps=1)),
            cuda_ms(lambda: route(lm_), reps=5),
            cuda_ms(lambda: route(lm_), reps=5),
            plain(lambda: cuda_ms(lambda: route(lm_), reps=1))]
    if plain(route)[0] != route()[0]:
        print("the kernel route decodes other words than the plain one", file=sys.stderr)
        return 1

    tb = tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word, device=dev)
    nll = bank_nll_ubt(bank, feats, nf).permute(2, 1, 0)
    res = tbeam.beam_search(nll, tb, nf, k)
    walk = tbeam.beam_backtrace(res[0], res[1], res[4], res[5], tb, nf, final_pred=res[2])

    def words():
        rows = walk[1].cpu().numpy()
        walk[0].cpu()
        return [[int(w) for w in row[:0:-1] if w >= 0] + [int(row[0])] for row in rows]

    def big_tensors():
        return (torch.as_tensor(np.concatenate([np.asarray(lm.cost, np.float32),
                                                np.asarray(lm.start_cost, np.float32)[None]]),
                                device=dev),
                torch.as_tensor(np.asarray(lm.end_cost, np.float32), device=dev))

    out["stages"] = {
        "beam_tables (host build + copy)": cuda_ms(
            lambda: tbeam.beam_tables(lexg.banded, leaf_word=lexg.leaf_word, device=dev)),
        "bigram tensors": cuda_ms(big_tensors),
        "bank_nll_ubt": cuda_ms(lambda: bank_nll_ubt(bank, feats, nf)),
        "K19 beam_search": cuda_ms(lambda: tbeam.beam_search(nll, tb, nf, k), reps=10),
        "K19 with the bigram": cuda_ms(lambda: tbeam.beam_search(nll, tb, nf, k,
                                                                 bigram_cost=big_tensors()[0]),
                                       reps=10),
        "K26 beam_backtrace": cuda_ms(lambda: tbeam.beam_backtrace(
            res[0], res[1], res[4], res[5], tb, nf, final_pred=res[2]), reps=10),
        "host word lists": cuda_ms(words, reps=10)}
    out["device"] = {
        "K19 device": device_ms(lambda: tbeam.beam_search(nll, tb, nf, k), what="K19"),
        "route event": cuda_ms(route, reps=5),
        "route device": device_ms(route, what="route")}
    out["device"]["route idle share"] = 1 - out["device"]["route device"] / \
        out["device"]["route event"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

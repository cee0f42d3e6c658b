#!/usr/bin/env python3
"""What the launch scratch of the mixture fits K24 (k-means) and K25 (EM)
costs beside a whole call, on one GPU.

    python3 scripts/exp_r22_gmm_scratch.py

At ``fit_hmm``'s shape (a word's 5 states over one buffer of ~1,260
frames, planted mixtures, D = 39, k = M = 4, ``disjoint=True`` as
``fit_gmm_states`` passes it), CUDA-event medians of: the whole
``kmeans_batch`` and ``em_fit_batch`` calls, and ``_scratch`` alone for
each (the scratch buffers; each CTA counts its fit's row offset itself).
Prints one JSON line with the card's name and power limit.
"""

import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    from chip_smoke import cuda_ms, planted_fits

    gfk = importlib.import_module("speech_recognition_tpu_torch.ops.gmm_fit_kernels")
    tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")
    tem = importlib.import_module("speech_recognition_tpu_torch.train.em")
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    x, masks, c0, init = planted_fits(40, (260, 240, 300, 180, 220), dev)
    _, m0, v0, counts = tkm.kmeans_batch_ref(x, masks, c0, 4, init)
    w0 = counts / masks.sum(1, keepdim=True).float()
    km_plan = gfk.gmm_fit_plan(x.shape[0], 39, 4, em=False)
    em_plan = gfk.gmm_fit_plan(x.shape[0], 39, 4, em=True)
    f, n = masks.shape
    out = {}
    for rnd in range(2):  # two rounds, to see the spread
        out[f"round {rnd}"] = {
            "kmeans_batch": cuda_ms(lambda: tkm.kmeans_batch(x, masks, c0, 4, init,
                                                            disjoint=True), reps=20),
            "kmeans scratch": cuda_ms(lambda: gfk._scratch(km_plan, f, n, 1, 4, 39, True, dev),
                                      reps=20),
            "em_fit_batch": cuda_ms(lambda: tem.em_fit_batch(x, masks, m0, v0, w0,
                                                            disjoint=True), reps=20),
            "em scratch": cuda_ms(lambda: gfk._scratch(em_plan, f, n, 4, 4, 39, True, dev),
                                  reps=20),
        }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Count the windows K2 (csrc/banded_backtrace.cu) takes per stream on
K1's planes, on the CPU: a Python emulation of the kernel's walk (one
window = F frames x the states [lo, st] the band can reach, F = 128 /
(states + 1); the next window of the same word and span loaded while
the walk runs), checked state for state against the plain version
``banded_backtrace_val_ref``.

The planes are K1's plain version's at chip_smoke.py's shapes and seeds
(its random 11 x 5-state bank, the 385-state sausage, its features and
lengths), cut to the first ``--streams`` streams.  Prints the windows
per stream that had to be waited for (after a word change, or first),
the windows per stream that the emulation loads during the walk before
them, eps steps (word changes) per stream and frames per stream.  These
are counts of the walk, not device times.

    python3 scripts/exp_r9_k2_windows.py [--streams 32]
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from speech_recognition_tpu_torch.decode.connected import connected_graph_arrays  # noqa: E402
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk  # noqa: E402
from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights  # noqa: E402
from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays  # noqa: E402

K_WIN = 128  # the kernel's kWin


def walk(bp8, eps_prev, end_state, nf, w):
    """The kernel's walk over numpy planes: ``(states, flags, waited,
    ahead)``, the last two summed over streams."""
    t_len, _, b_len = bp8.shape
    states = np.zeros((t_len, b_len), np.int64)
    flags = np.zeros((t_len, b_len), bool)
    waited = ahead_n = 0
    for b in range(b_len):
        n = min(max(int(nf[b]), 0), t_len)
        st = int(end_state[b])
        states[n:, b] = st
        t, ahead = n - 1, False
        while t >= 0:
            if ahead:
                ahead_n += 1
            else:
                waited += 1
                v, hi = st // w, st
                lo = max(v * w, st - 31)
            nfr = min(t + 1, K_WIN // (hi - lo + 2))
            f = 0
            while f < nfr:
                tt = t - f
                code = int(bp8[tt, st, b])
                m = code == 4
                states[tt, b], flags[tt, b] = st, m
                f += 1
                if tt > 0:
                    st = int(eps_prev[tt, v, b]) if m else st - min(code, 2)
                if m or st < lo or st > hi:
                    break
            ahead = f == nfr and t - nfr >= 0 and lo <= st <= hi
            t -= f
    return states, flags, waited, ahead_n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=32)
    b = ap.parse_args().streams
    bank = cs.random_bank(5)
    w, lw = gmm_emission_weights(*bank.flat_states())
    bg = banded_arrays(connected_graph_arrays(bank, 7))
    topo = vk.banded_topology(bg)
    t_len = 500
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (512, t_len, 39)).astype(np.float32))[:b]
    nf = torch.from_numpy(np.r_[t_len, 1, np.random.default_rng(2).integers(
        2, t_len + 1, 510)].astype(np.int32))[:b]
    final, bp8, _, eps_prev = vk.viterbi_banded_fused_ref(augment_dtb(feats), w, lw, bg,
                                                          topo, nf)
    ends = bg.end_states[torch.argmin(final[bg.end_states], 0)]
    sp, fp = vk.banded_backtrace_val_ref(bp8, eps_prev, ends, nf, topo.uniform_w)
    s, f, waited, ahead = walk(bp8.numpy(), eps_prev.numpy(), ends.numpy(), nf.numpy(),
                               topo.uniform_w)
    valid = np.arange(t_len)[:, None] < nf.numpy()[None, :]
    if not ((s == sp.numpy()) & (f == fp.numpy()) | ~valid).all():
        sys.exit("the emulated walk differs from the plain version")
    print(f"{b} streams x {t_len} frames on the {bg.n_states}-state sausage (CPU): the "
          f"emulated walk == plain; windows waited for {waited / b:.2f} per stream, "
          f"loaded during the walk before them {ahead / b:.2f}; eps steps "
          f"{float(fp.sum()) / b:.2f} per stream; frames {float(nf.float().mean()):.1f} "
          f"per stream")


if __name__ == "__main__":
    main()

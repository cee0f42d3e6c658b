#!/usr/bin/env python3
"""How far float32 soft EM and word confidence sit from float64, on the
CPU: the numbers behind the tolerances of ``tests/test_torch_soft_em.py``
and ``tests/test_torch_confidence.py``.

For each case the JAX package's float32 result is compared with the same
JAX computation in float64 (its own rounding error) and with the port's
float32 result (the port's distance from the reference):

* one ``embedded_step_soft`` on ``tests/embedded_case`` (16 x 120, 4
  words), the unit tests' case;
* one ``embedded_step_soft`` on a synth corpus's training wavs (``synth
  --n-train 3 --n-continuous 8 --seed 4``, JAX features, a JAX
  ``isolated_train --silence`` bank): the whole training directory and
  its 8 digit strings alone, then two ``continuous_train --algo soft``
  iterations through both CLIs on the strings;
* ``path_posteriors`` and ``word_confidence`` on the loop graph over the
  test wavs of ``synth --n-test 2 --n-continuous 12 --seed 6`` (the
  confidence CLI test's corpus).

Run from the repository root (no GPU needed; imports both packages):

    python scripts/exp_r13_float32_noise.py
"""

from __future__ import annotations

import contextlib
import glob
import io
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

FIELDS = ("means", "log_vars", "log_weights", "trans_cost")


def f64(tree):
    """A JAX pytree of float32 arrays in float64 (ints kept)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x), jnp.float64)
        if np.asarray(x).dtype == np.float32 else jnp.asarray(np.asarray(x)), tree)


def maxdiff(a, b):
    a, b = np.asarray(a, np.float64), np.minimum(np.asarray(b, np.float64), 1e30)
    return float(np.abs(np.minimum(a, 1e30) - b).max())


def quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a)


def soft_case(name, bank, feats, nf, graph_batch, depth):
    """JAX float32 vs float64 and port vs JAX float32, one soft step."""
    from speech_recognition_tpu.train.embedded_step import embedded_step_soft as jsoft
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.train.embedded_step import embedded_step_soft as tsoft

    with jax.enable_x64(False):
        j32, s32 = jsoft(bank, jnp.asarray(feats), jnp.asarray(nf),
                         {k: jnp.asarray(v) for k, v in graph_batch.items()}, eps_depth=depth)
    with jax.enable_x64(True):
        j64, _ = jsoft(f64(bank), jnp.asarray(feats, jnp.float64), jnp.asarray(nf),
                       f64(graph_batch), eps_depth=depth)
    tb = HMMBank.from_numpy(*(np.asarray(getattr(bank, f)) for f in FIELDS))
    t32, _ = tsoft(tb, torch.from_numpy(np.asarray(feats, np.float32)), torch.from_numpy(nf),
                   {k: torch.as_tensor(np.asarray(v)) for k, v in graph_batch.items()},
                   eps_depth=depth)
    print(f"[soft step] {name}: {feats.shape[0]} x {feats.shape[1]}, -sum log Z "
          f"{float(s32.total_cost):.1f}")
    for f in FIELDS[:3]:
        print(f"  {f}: JAX float32 vs float64 {maxdiff(getattr(j32, f), getattr(j64, f)):.3g}, "
              f"port vs JAX float32 {maxdiff(getattr(t32, f).numpy(), getattr(j32, f)):.3g}")


def main() -> int:
    from speech_recognition_tpu.cli import _featurize_files, _stack
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu.config import FrontendConfig
    from speech_recognition_tpu.data.aurora import labels_from_transcript, transcript_from_filename
    from speech_recognition_tpu.models.graph import pad_graphs, transcript_graph
    from speech_recognition_tpu.utils.checkpoint import load_bank as jload
    from speech_recognition_tpu_torch.cli import main as tmain
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank as tload
    from tests.embedded_case import make_embedded_case

    keys = ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")
    with jax.enable_x64(False):
        jb, feats, nf, _, _, labels = make_embedded_case()
    trans = [np.asarray(jb.trans_cost[i]) for i in range(jb.n_models)]
    gb, depth = pad_graphs([transcript_graph(trans, ls) for ls in labels])
    soft_case("tests/embedded_case", jb, feats, nf, {k: gb[k] for k in keys}, depth)

    root = tempfile.mkdtemp(prefix="f32_noise_")
    try:
        with jax.enable_x64(False):
            quiet(tmain, ["synth", "-o", root, "--n-train", "3", "--n-test", "2",
                          "--n-continuous", "8", "--seed", "4"])
            quiet(jmain, ["isolated_train", "-i", os.path.join(root, "train"), "-o",
                          os.path.join(root, "bank.npz"), "--n-gaussians", "2", "--silence"])
        os.makedirs(os.path.join(root, "strings"))
        for n in os.listdir(os.path.join(root, "train")):
            if len(n.split("_")[1]) > len("1A.wav"):
                shutil.copy(os.path.join(root, "train", n), os.path.join(root, "strings"))
        bank, _ = jload(os.path.join(root, "bank.npz"))
        trans = [np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)]
        for sub in ("train", "strings"):
            files = [f for f in sorted(glob.glob(os.path.join(root, sub, "*.wav")))
                     if transcript_from_filename(os.path.basename(f))]
            labs = [labels_from_transcript(transcript_from_filename(os.path.basename(f)))
                    for f in files]
            with jax.enable_x64(False):
                fs, ls = _featurize_files(files, FrontendConfig(), 120000, norm="utterance",
                                          cmvn=None)
            fb, nb = _stack(fs, ls)
            gb, depth = pad_graphs([transcript_graph(trans, x, sil=11) for x in labs])
            soft_case(f"synth corpus {sub}/", bank, fb, nb, {k: gb[k] for k in keys}, depth)
        argv = ["continuous_train", "-i", os.path.join(root, "bank.npz"), "-d",
                os.path.join(root, "strings"), "--iterations", "2", "--algo", "soft"]
        with jax.enable_x64(False):
            quiet(jmain, argv + ["-o", os.path.join(root, "j")])
        quiet(tmain, argv + ["-o", os.path.join(root, "t"), "--device", "cpu"])
        for ck in ("bank_00000.npz", "bank_00001.npz"):
            bt, _ = tload(os.path.join(root, "t", ck))
            bj, _ = jload(os.path.join(root, "j", ck))
            print(f"[soft CLI] strings/ {ck}, port vs JAX: " + ", ".join(
                f"{f} {maxdiff(getattr(bt, f).numpy(), getattr(bj, f)):.3g}" for f in FIELDS))
    finally:
        shutil.rmtree(root, True)

    root = tempfile.mkdtemp(prefix="f32_noise_")
    try:
        from speech_recognition_tpu.decode.confidence import path_posteriors, word_confidence
        from speech_recognition_tpu.decode.connected import _decode_banded_batch
        from speech_recognition_tpu.models.graph import build_loop_graph
        from speech_recognition_tpu.ops.viterbi_banded import banded_arrays

        with jax.enable_x64(False):
            quiet(tmain, ["synth", "-o", root, "--n-train", "3", "--n-test", "2",
                          "--n-continuous", "12", "--seed", "6"])
            quiet(jmain, ["isolated_train", "-i", os.path.join(root, "train"), "-o",
                          os.path.join(root, "bank.npz"), "--n-gaussians", "2", "--silence"])
            bank, _ = jload(os.path.join(root, "bank.npz"))
            files = [f for f in sorted(glob.glob(os.path.join(root, "test", "*.wav")))
                     if transcript_from_filename(os.path.basename(f))]
            fs, ls = _featurize_files(files, FrontendConfig(), 120000, norm="utterance",
                                      cmvn=None)
            fb, nb = _stack(fs, ls)
            g = build_loop_graph([np.asarray(bank.trans_cost[i]) for i in range(bank.n_models)])
            bg = banded_arrays(g)
            states, flags, costs = _decode_banded_batch(bank, jnp.asarray(fb), jnp.asarray(nb),
                                                        bg, eps_depth=g.eps_depth)
            p32 = np.asarray(path_posteriors(bank, bg, jnp.asarray(fb), jnp.asarray(nb), states,
                                             eps_depth=g.eps_depth))
        with jax.enable_x64(True):
            p64 = np.asarray(path_posteriors(f64(bank), f64(bg), jnp.asarray(fb, jnp.float64),
                                             jnp.asarray(nb), states, eps_depth=g.eps_depth))
        st, fl = np.asarray(states), np.asarray(flags)
        wd = max(abs(a[1] - b[1]) for i in range(len(files)) for a, b in zip(
            word_confidence(g, st[i], fl[i], p32[i], int(nb[i])),
            word_confidence(g, st[i], fl[i], p64[i], int(nb[i]))))
        print(f"[confidence] {len(files)} test wavs, path cost up to "
              f"{float(np.asarray(costs).max()):.1f}: JAX float32 vs float64 frame "
              f"posteriors {float(np.abs(p32 - p64).max()):.3g}, word confidences {wd:.3g}")
    finally:
        shutil.rmtree(root, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

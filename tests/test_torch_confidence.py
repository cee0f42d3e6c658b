"""Port vs reference: word confidence from forward-backward posteriors
(``decode/confidence.py``: ``path_posteriors`` on the banded pass,
kernel K15's plain version on the CPU, and ``word_confidence``) and
``connected_test --graph loop --confidence`` through both CLIs, the port
with ``--device cpu``.

The JAX side runs with x64 off (float32).  Tolerances: decoded states
and words exactly.  Posteriors are exp(alpha + beta - log Z) with alpha,
beta and log Z of the size of log Z, where two float32 passes whose exp /
log round apart (XLA's and PyTorch's CPU kernels) differ by an ulp of
log Z: frame posteriors and word confidences (means over a word's
frames, which shift together) at atol 2.5e-4 (|log Z| < 2,048 in the
unit case: an ulp is 2.4e-4; measured 1.2e-4 for both).  The CLI's printed confidences at atol
5e-3: there |log Z| reaches 1.7e4 (an ulp of 2e-3) and the two
frontends' features differ by ~3e-5; the JAX CLI's own float32
confidences are 9.6e-3 from the same pass in float64 on this corpus
(``scripts/exp_r13_float32_noise.py``), the port's 2e-3 from JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import confidence as jconf
from speech_recognition_tpu.decode.connected import _decode_banded_batch as jdecode
from speech_recognition_tpu.models.graph import build_loop_graph as jloop
from speech_recognition_tpu.ops.viterbi_banded import banded_arrays as jbanded_arrays
from speech_recognition_tpu_torch.decode import confidence as tconf
from speech_recognition_tpu_torch.decode.connected import _decode_banded_batch as tdecode
from speech_recognition_tpu_torch.models.graph import build_loop_graph as tloop
from speech_recognition_tpu_torch.models.hmm import HMMBank
from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays as tbanded_arrays
from tests.embedded_case import make_embedded_case

FIELDS = ("means", "log_vars", "log_weights", "trans_cost")


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def test_path_posteriors_and_word_confidence_match_reference():
    """On the loop graph of ``tests/embedded_case``'s 4-word bank: the
    same paths, the same frame posteriors and word confidences."""
    jb, feats, nf, _, _, _ = make_embedded_case(seed=7, B=8, T=90)
    nf[1], nf[2] = 1, 40  # a one-frame stream and a short one
    tb = HMMBank.from_numpy(*(np.asarray(getattr(jb, f)) for f in FIELDS))
    trans = [np.asarray(jb.trans_cost[i]) for i in range(jb.n_models)]
    jg, tg = jloop(trans, word_insertion_cost=0.5), tloop(trans, word_insertion_cost=0.5)
    jbg, tbg = jbanded_arrays(jg), tbanded_arrays(tg)
    jstates, jflags, _ = jdecode(jb, jnp.asarray(feats), jnp.asarray(nf), jbg,
                                 eps_depth=jg.eps_depth)
    x, n = torch.from_numpy(feats), torch.from_numpy(nf)
    tstates, tflags, _ = tdecode(tb, x, n, tbg, eps_depth=tg.eps_depth)
    np.testing.assert_array_equal(tstates.numpy(), np.asarray(jstates))
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    jpost = np.asarray(jconf.path_posteriors(jb, jbg, jnp.asarray(feats), jnp.asarray(nf),
                                             jstates, eps_depth=jg.eps_depth))
    tpost = tconf.path_posteriors(tb, tbg, x, n, tstates, eps_depth=tg.eps_depth).numpy()
    np.testing.assert_allclose(tpost, jpost, atol=2.5e-4)
    assert not tpost[1, 1:].any() and not tpost[2, 40:].any()
    assert (tpost >= 0).all() and (tpost <= 1).all() and tpost[:, 0].min() > 0
    for i in range(len(nf)):
        want = jconf.word_confidence(jg, np.asarray(jstates)[i], np.asarray(jflags)[i],
                                     jpost[i], int(nf[i]))
        got = tconf.word_confidence(tg, tstates[i].numpy(), tflags[i].numpy(), tpost[i],
                                    int(nf[i]))
        assert [w for w, _ in got] == [w for w, _ in want] and got
        np.testing.assert_allclose([c for _, c in got], [c for _, c in want], atol=2.5e-4)


def test_word_confidence_segments():
    """Word segments by slot changes and eps flags: a repeated word
    re-entered by an eps hop is two words."""
    class G:
        slot = np.array([0, 0, 1, 1])
        slot_label = np.array([7, 3])

    states = np.array([0, 1, 1, 2, 3, 2, 0])
    flags = np.array([0, 0, 0, 0, 0, 1, 0], bool)
    post = np.array([1.0, 0.5, 0.5, 0.2, 0.4, 0.9, 0.0])
    got = tconf.word_confidence(G, states, flags, post, 6)
    want = jconf.word_confidence(G, states, flags, post, 6)
    assert got == want
    assert [w for w, _ in got] == [7, 3, 3]
    np.testing.assert_allclose([c for _, c in got], [2.0 / 3, 0.3, 0.9])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny corpus from the port's ``synth`` and a 2-mixture bank with
    a silence model from the JAX CLI."""
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    root = str(tmp_path_factory.mktemp("conf"))
    with jax.enable_x64(False):
        tmain(["synth", "-o", root, "--n-train", "3", "--n-test", "2", "--n-continuous", "12",
               "--seed", "6"])
        jmain(["isolated_train", "-i", os.path.join(root, "train"), "-o",
               os.path.join(root, "bank.npz"), "--n-gaussians", "2", "--silence"])
    return root


def conf_lines(out):
    rows = {}
    for line in out.splitlines():
        if line.startswith("confidence "):
            name, rest = line[len("confidence "):].split(": ", 1)
            rows[name] = [(w, float(c)) for w, c in (x.rsplit(":", 1) for x in rest.split())]
    return rows


def test_connected_test_confidence_matches_reference_cli(corpus, capsys):
    """``connected_test --graph loop --confidence``: the JAX CLI's lines,
    words equal and confidences within 5e-3."""
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    argv = ["connected_test", "-i", os.path.join(corpus, "bank.npz"), "-d",
            os.path.join(corpus, "test"), "--graph", "loop", "--confidence"]
    capsys.readouterr()
    jmain(argv)
    out_j = capsys.readouterr().out
    tmain(argv + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    rest_j = [l for l in out_j.splitlines() if not l.startswith("confidence ")]
    rest_t = [l for l in out_t.splitlines() if not l.startswith("confidence ")]
    assert rest_t == rest_j
    cj, ct = conf_lines(out_j), conf_lines(out_t)
    n_wavs = sum(1 for l in rest_j if l.startswith(("Correct:", "Incorrect:")))
    assert sorted(ct) == sorted(cj) and len(ct) == n_wavs >= 5
    for name in cj:
        assert [w for w, _ in ct[name]] == [w for w, _ in cj[name]], name
        np.testing.assert_allclose([c for _, c in ct[name]], [c for _, c in cj[name]],
                                   atol=5e-3, err_msg=name)
    # the confidence lines sit between the word lines and the scores
    lines = out_t.splitlines()
    first = min(i for i, l in enumerate(lines) if l.startswith("confidence "))
    assert lines[first - 1].startswith(("Correct:", "Incorrect:"))
    assert lines[first + n_wavs].startswith("Sequence accuracy:")

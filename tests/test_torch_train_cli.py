"""Port CLI vs reference CLI: ``synth``, ``isolated_train`` and
``continuous_train --algo hard``, the port with ``--device cpu``.

The JAX CLI runs with x64 off (float32, as it runs in production;
conftest turns x64 on, and then the JAX EM loop of ``--n-gaussians 1``
refuses its own carry).  The two CLIs draw k-means' initial assignments
from different generators (JAX keys, a torch CPU generator), so banks
are compared only where training makes no draw (``--no-gmm``,
``--n-gaussians 1``, and embedded Viterbi-EM); the default 4-mixture
bank is compared by its ``isolated_test`` accuracy.

Tolerances: every bank field at rtol 1e-4 / atol 1e-4 (the two
frontends' f32 features differ before training starts; the largest
difference seen is 3.4e-5, in a log-variance), CMVN statistics at rtol
1e-4 / atol 1e-4, alignment costs at rtol 1e-5.
"""

import os

import jax
import numpy as np
import pytest

from speech_recognition_tpu.cli import main as jmain
from speech_recognition_tpu.utils.checkpoint import load_bank as jload
from speech_recognition_tpu_torch.cli import main as tmain
from speech_recognition_tpu_torch.utils.checkpoint import latest_iteration, save_iteration
from speech_recognition_tpu_torch.utils.checkpoint import load_bank as tload

FIELDS = ("means", "log_vars", "log_weights", "trans_cost")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny corpus from the port's ``synth``: 3 training and 2 test
    utterances per digit, 8 training and 2 test strings."""
    root = str(tmp_path_factory.mktemp("corpus"))
    with jax.enable_x64(False):
        tmain(["synth", "-o", root, "--n-train", "3", "--n-test", "2", "--n-continuous", "8",
               "--seed", "3"])
    return root


def banks_close(path_t, path_j, tol=TOL):
    bt, mt = tload(path_t)
    bj, mj = jload(path_j)
    at, aj = mt.pop("arrays", {}), mj.pop("arrays", {})
    np.testing.assert_allclose(mt.pop("cost", 0.0), mj.pop("cost", 0.0), rtol=1e-5)
    assert mt == mj and sorted(at) == sorted(aj)
    for k in at:  # corpus CMVN statistics
        np.testing.assert_allclose(at[k], aj[k], rtol=1e-4, atol=1e-4)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(bt, f).numpy(), np.asarray(getattr(bj, f)),
                                   **tol, err_msg=f)


def test_synth_writes_the_reference_wavs(tmp_path, capsys):
    argv = ["--n-train", "2", "--n-test", "1", "--n-continuous", "5", "--seed", "7"]
    jmain(["synth", "-o", str(tmp_path / "j"), *argv])
    tmain(["synth", "-o", str(tmp_path / "t"), *argv])
    out = capsys.readouterr().out.splitlines()
    assert out[1] == out[0].replace(str(tmp_path / "j"), str(tmp_path / "t"))
    for sub in ("train", "test"):
        names = sorted(os.listdir(tmp_path / "j" / sub))
        assert names == sorted(os.listdir(tmp_path / "t" / sub)) and len(names) > 5
        for n in names:
            assert (tmp_path / "j" / sub / n).read_bytes() == \
                (tmp_path / "t" / sub / n).read_bytes(), n


@pytest.mark.parametrize("flags", [["--no-gmm"], ["--n-gaussians", "1"],
                                   ["--n-gaussians", "1", "--no-em", "--norm", "cmvn"]])
def test_isolated_train_without_draws_matches_reference(corpus, tmp_path, capsys, flags):
    train = os.path.join(corpus, "train")
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jmain(["isolated_train", "-i", train, "-o", pj, *flags])
    tmain(["isolated_train", "-i", train, "-o", pt, *flags, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half - 1] == out[half:-1]  # "training <digit> on <n> files"
    banks_close(pt, pj)
    assert ("cmvn_mean" in tload(pt)[1].get("arrays", {})) == ("cmvn" in flags)


def test_isolated_train_then_test_reaches_reference_accuracy(corpus, tmp_path, capsys):
    """The default 4-mixture bank: its accuracy on the held-out digits is
    the JAX CLI's within one file; with ``--silence`` (which the JAX CLI
    refuses above 2 mixtures) the port adds a 12th model of 4 mixtures
    and classifies as well."""
    train, test = (os.path.join(corpus, s) for s in ("train", "test"))
    pj, pt, ps = (str(tmp_path / f"{n}.npz") for n in ("j", "t", "s"))
    jmain(["isolated_train", "-i", train, "-o", pj])
    tmain(["isolated_train", "-i", train, "-o", pt, "--device", "cpu"])
    tmain(["isolated_train", "-i", train, "-o", ps, "--silence", "--device", "cpu"])
    capsys.readouterr()
    jmain(["isolated_test", "-i", pj, "-d", test])
    acc_j = float(capsys.readouterr().out.splitlines()[-1])
    acc = {}
    for p in (pt, ps):
        tmain(["isolated_test", "-i", p, "-d", test, "--device", "cpu"])
        acc[p] = float(capsys.readouterr().out.splitlines()[-1])
    n_files = len([f for f in os.listdir(test) if len(f.split("_")[1]) == 6])
    assert n_files == 22
    assert abs(acc[pt] - acc_j) <= 1.0 / n_files + 1e-9 and acc[pt] >= 0.8
    assert acc[ps] >= 0.8
    bt, mt = tload(ps)
    assert mt["silence_index"] == 11 and bt.means.shape == (12, 5, 4, 39)


def test_continuous_train_matches_reference_and_resumes(corpus, tmp_path, capsys):
    """Two embedded Viterbi-EM iterations from one JAX-trained bank (with
    a silence model): the same checkpoints, then a resumed third."""
    train = os.path.join(corpus, "train")
    bank = str(tmp_path / "bank.npz")
    jmain(["isolated_train", "-i", train, "-o", bank, "--n-gaussians", "2", "--silence"])
    oj, ot = str(tmp_path / "cj"), str(tmp_path / "ct")
    capsys.readouterr()
    jmain(["continuous_train", "-i", bank, "-d", train, "-o", oj, "--iterations", "2"])
    out_j = capsys.readouterr().out.splitlines()
    tmain(["continuous_train", "-i", bank, "-d", train, "-o", ot, "--iterations", "2",
           "--device", "cpu"])
    out_t = capsys.readouterr().out.splitlines()
    assert out_t[0] == out_j[0] == "using optional silence arcs (model 11) in alignment graphs"
    for lt, lj in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(float(lt.split()[-1]), float(lj.split()[-1]), rtol=1e-5)
    assert sorted(os.listdir(ot)) == sorted(os.listdir(oj)) == ["bank_00000.npz",
                                                                 "bank_00001.npz"]
    for f in ("bank_00000.npz", "bank_00001.npz"):
        banks_close(os.path.join(ot, f), os.path.join(oj, f))
    tmain(["continuous_train", "-i", bank, "-d", train, "-o", ot, "--iterations", "1",
           "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"resuming from {os.path.join(ot, 'bank_00001.npz')}" in out
    assert "iteration 2:" in out and tload(os.path.join(ot, "bank_00002.npz"))[1]["iteration"] == 2


def test_save_iteration_and_latest(tmp_path, corpus):
    """Iteration checkpoints: the newest is found, its meta carries the
    iteration (over a stale one in ``meta``) and its arrays, and the JAX
    package loads it to the same bank."""
    out = str(tmp_path / "ckpt")
    assert latest_iteration(out) == (None, None)
    bank = str(tmp_path / "bank.npz")
    tmain(["isolated_train", "-i", os.path.join(corpus, "train"), "-o", bank, "--no-gmm",
           "--device", "cpu"])
    b, _ = tload(bank)
    arrays = {"cmvn_mean": np.arange(3, dtype=np.float32)}
    for it in (2, 10, 7):
        save_iteration(out, it, b, {"norm": "cmvn", "iteration": 0}, arrays=arrays)
    it, path = latest_iteration(out)
    assert (it, os.path.basename(path)) == (10, "bank_00010.npz")
    bt, mt = tload(path)
    bj, mj = jload(path)
    np.testing.assert_array_equal(mt.pop("arrays")["cmvn_mean"], arrays["cmvn_mean"])
    assert mt == {k: v for k, v in mj.items() if k != "arrays"} == {"norm": "cmvn",
                                                                    "iteration": 10}
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(bt, f).numpy(), np.asarray(getattr(bj, f)))
        assert np.array_equal(getattr(bt, f).numpy(), getattr(b, f).numpy())

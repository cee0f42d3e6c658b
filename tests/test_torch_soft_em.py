"""Port vs reference: soft EM (Baum-Welch) — the banded graph batches,
``embedded_step_soft`` with the dense and the banded dict, and
``continuous_train --algo soft`` through both CLIs, the port with
``--device cpu``.

The JAX side runs with x64 off (float32, as the JAX CLI trains).
Soft EM is sensitive to float32 rounding: alpha and beta reach |log Z|
~ 1e3-2e4, where a float32 ulp is 1e-4-2e-3, so two implementations
whose exp / log round apart (XLA's and PyTorch's CPU kernels) give
posteriors that differ by up to ~1e-3 of themselves.  The tolerances
sit at or below the JAX step's own float32 error (its distance from the
same step in float64), measured on the same inputs by
``scripts/exp_r13_float32_noise.py``:

* the step (``tests/embedded_case``): total cost (-sum log Z) at rtol
  1e-5; bank fields at rtol 1e-4 / atol 2e-4 (JAX float32 vs float64:
  means 1.7e-4, log-variances 2.3e-4, log-weights 1.1e-4; the port vs
  JAX float32: 9.4e-5, 1.3e-4, 3.1e-5); the statistics at atol 2e-4 x
  their largest entry (rx / rxx sum ~2,000 posteriors with cancelling
  signs: 0.06 of rx's largest entry 681);
* the CLI (the corpus's 8 digit strings, |log Z| ~ 1.25e4 each):
  per-iteration costs at rtol 1e-4; the first checkpoint's bank at atol
  1e-2 (JAX float32 vs float64 on this corpus: means 2.7e-2,
  log-variances 3.2e-2, log-weights 1.5e-2; the port vs JAX, whose
  features also differ by ~3e-5: 3.7e-3, 5.1e-3, 4.5e-3, transitions
  3.6e-3), the second at atol 5e-2 (one more iteration compounds it:
  up to 2.3e-2).
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.models.hmm import HMMBank
from tests.embedded_case import make_embedded_case

jes, tes = (importlib.import_module(f"{pkg}.train.embedded_step")
            for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch"))

TOL = dict(rtol=1e-4, atol=2e-4)
FIELDS = ("means", "log_vars", "log_weights", "trans_cost")
DENSE_KEYS = ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), **(tol or TOL))


def case(seed=5, b=16, sil=None):
    jb, feats, nf, _, _, labels = make_embedded_case(seed=seed, B=b)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(jb.n_models)]
    graphs = [jgraph.transcript_graph(trans, ls, sil=sil) for ls in labels]
    tb = HMMBank.from_numpy(*(np.asarray(getattr(jb, f)) for f in FIELDS))
    return jb, tb, feats, nf, graphs, labels


@pytest.mark.parametrize("sil", [None, 3])
def test_pad_graphs_banded_and_auto_match_reference(sil):
    """The banded batch equals JAX's array for array (values and dtypes),
    and ``pad_graphs_auto`` picks by ``BANDED_FB_MIN_STATES``."""
    _, tb, _, _, graphs, labels = case(sil=sil)
    trans = [tb.trans_cost[i].numpy() for i in range(tb.n_models)]
    tgraphs = [tgraph.transcript_graph(trans, ls, sil=sil) for ls in labels]
    jb_, jd = jgraph.pad_graphs_banded(graphs)
    tb_, td = tgraph.pad_graphs_banded(tgraphs)
    assert td == jd and sorted(tb_) == sorted(jb_)
    for k in jb_:
        assert tb_[k].dtype == np.asarray(jb_[k]).dtype, k
        np.testing.assert_array_equal(tb_[k], np.asarray(jb_[k]), err_msg=k)
    smax = max(g.n_states for g in tgraphs)
    for floor, banded in ((smax, True), (smax + 1, False)):
        old = tgraph.BANDED_FB_MIN_STATES
        tgraph.BANDED_FB_MIN_STATES = floor
        try:
            batch, _ = tgraph.pad_graphs_auto(tgraphs)
        finally:
            tgraph.BANDED_FB_MIN_STATES = old
        assert ("band" in batch) == banded


def test_compose_graphs_with_end_scores():
    """The soft step's dense batch: the JAX CLI's ``pad_graphs`` keys,
    ``end_scores`` included, array for array."""
    jb, tb, _, _, graphs, labels = case(sil=3)
    gb, depth = jgraph.pad_graphs(graphs)
    g, tdepth = tes.compose_graphs(tb, labels, 3, end_scores=True)
    assert tdepth == depth and "end_scores" in g
    for k in DENSE_KEYS:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(gb[k]), err_msg=k)
    assert "end_scores" not in tes.compose_graphs(tb, labels, 3)[0]


def soft_pair(jb, tb, feats, nf, jg, tg, depth, **kw):
    jnew, jst = jes.embedded_step_soft(jb, jnp.asarray(feats), jnp.asarray(nf),
                                       {k: jnp.asarray(v) for k, v in jg.items()},
                                       eps_depth=depth, **kw)
    tnew, tst = tes.embedded_step_soft(tb, torch.from_numpy(feats), torch.from_numpy(nf),
                                       {k: torch.as_tensor(np.asarray(v)) for k, v in tg.items()},
                                       eps_depth=depth, **kw)
    return jnew, jst, tnew, tst


@pytest.mark.parametrize("form,frame_chunk", [("dense", 65536), ("dense", 700),
                                              ("banded", 65536)])
def test_embedded_step_soft_matches_reference(form, frame_chunk):
    """One Baum-Welch step on the dense dict (one chunk and several) and
    on the banded dict, against JAX's on the same dict."""
    jb, tb, feats, nf, graphs, _ = case()
    if form == "dense":
        gb, depth = jgraph.pad_graphs(graphs)
        g = {k: np.asarray(gb[k]) for k in DENSE_KEYS}
    else:
        gb, depth = jgraph.pad_graphs_banded(graphs)
        g = {k: np.asarray(v) for k, v in gb.items()}
    jnew, jst, tnew, tst = soft_pair(jb, tb, feats, nf, g, g, depth, frame_chunk=frame_chunk)
    np.testing.assert_allclose(float(tst.total_cost), float(jst.total_cost), rtol=1e-5)
    for f in ("r_sum", "rx", "rxx", "frame_counts", "run_counts"):
        want = np.asarray(getattr(jst, f))
        close(getattr(tst, f), want, rtol=0, atol=2e-4 * float(np.abs(want).max()))
    for f in FIELDS:
        close(getattr(tnew, f), getattr(jnew, f))


def test_embedded_step_soft_dense_equals_banded():
    """The port's two dicts give the same step (JAX
    ``test_soft_step_banded_matches_dense``'s tolerances)."""
    _, tb, feats, nf, graphs, _ = case(seed=9, b=6)
    dense, depth = jgraph.pad_graphs(graphs)
    banded, _ = jgraph.pad_graphs_banded(graphs)
    x, n = torch.from_numpy(feats), torch.from_numpy(nf)
    b1, s1 = tes.embedded_step_soft(tb, x, n, {k: torch.as_tensor(np.asarray(dense[k]))
                                               for k in DENSE_KEYS}, eps_depth=depth)
    b2, s2 = tes.embedded_step_soft(tb, x, n, {k: torch.as_tensor(np.asarray(v))
                                               for k, v in banded.items()}, eps_depth=depth)
    np.testing.assert_allclose(float(s1.total_cost), float(s2.total_cost), rtol=1e-5)
    close(b1.means, b2.means.numpy(), rtol=1e-4, atol=1e-5)
    for f in ("log_vars", "trans_cost"):
        close(getattr(b1, f), getattr(b2, f).numpy())


def test_soft_em_lowers_the_nll_over_five_steps():
    """Baum-Welch never raises the total NLL: five steps from the
    perturbed initial bank, each on graphs of its own transitions."""
    _, tb, feats, nf, _, labels = case()
    x, n = torch.from_numpy(feats), torch.from_numpy(nf)
    costs = []
    for _ in range(5):
        g, depth = tes.compose_graphs(tb, labels, end_scores=True)
        tb, st = tes.embedded_step_soft(tb, x, n, g, eps_depth=depth)
        costs.append(float(st.total_cost))
    assert all(b <= a + 1e-3 * abs(a) for a, b in zip(costs, costs[1:])), costs
    assert costs[-1] < costs[0]
    assert all(torch.isfinite(getattr(tb, f)).all() for f in FIELDS)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny corpus from the port's ``synth``, a 2-mixture bank with a
    silence model from the JAX CLI, and ``strings/``: the training wavs of
    two digits or more alone (soft EM's dense pass over every isolated
    digit too would only make the test slower)."""
    import shutil

    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    root = str(tmp_path_factory.mktemp("soft"))
    with jax.enable_x64(False):
        tmain(["synth", "-o", root, "--n-train", "3", "--n-test", "2", "--n-continuous", "8",
               "--seed", "4"])
        jmain(["isolated_train", "-i", os.path.join(root, "train"), "-o",
               os.path.join(root, "bank.npz"), "--n-gaussians", "2", "--silence"])
    os.makedirs(os.path.join(root, "strings"))
    for name in os.listdir(os.path.join(root, "train")):
        if len(name.split("_")[1]) > len("1A.wav"):
            shutil.copy(os.path.join(root, "train", name), os.path.join(root, "strings"))
    assert len(os.listdir(os.path.join(root, "strings"))) >= 5
    return root


def test_continuous_train_soft_matches_reference_cli(corpus, tmp_path, capsys):
    """``continuous_train --algo soft`` for two iterations: the JAX CLI's
    lines and checkpoints, then a resumed third iteration."""
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu.utils.checkpoint import load_bank as jload
    from speech_recognition_tpu_torch.cli import main as tmain
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank as tload

    train, bank = os.path.join(corpus, "strings"), os.path.join(corpus, "bank.npz")
    oj, ot = str(tmp_path / "j"), str(tmp_path / "t")
    capsys.readouterr()
    jmain(["continuous_train", "-i", bank, "-d", train, "-o", oj, "--iterations", "2",
           "--algo", "soft"])
    out_j = capsys.readouterr().out.splitlines()
    tmain(["continuous_train", "-i", bank, "-d", train, "-o", ot, "--iterations", "2",
           "--algo", "soft", "--device", "cpu"])
    out_t = capsys.readouterr().out.splitlines()
    assert out_t[0] == out_j[0] == "using optional silence arcs (model 11) in alignment graphs"
    assert len(out_t) == len(out_j) == 3
    for lt, lj in zip(out_t[1:], out_j[1:]):
        assert lt.rsplit(" ", 1)[0] == lj.rsplit(" ", 1)[0]
        np.testing.assert_allclose(float(lt.split()[-1]), float(lj.split()[-1]), rtol=1e-4)
    for f, atol in (("bank_00000.npz", 1e-2), ("bank_00001.npz", 5e-2)):
        bt, mt = tload(os.path.join(ot, f))
        bj, mj = jload(os.path.join(oj, f))
        np.testing.assert_allclose(mt.pop("cost"), mj.pop("cost"), rtol=1e-4)
        mt.pop("arrays", None), mj.pop("arrays", None)
        assert mt == mj
        for fld in FIELDS:
            np.testing.assert_allclose(getattr(bt, fld).numpy(), np.asarray(getattr(bj, fld)),
                                       rtol=1e-4, atol=atol, err_msg=fld)
    tmain(["continuous_train", "-i", bank, "-d", train, "-o", ot, "--iterations", "1",
           "--algo", "soft", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"resuming from {os.path.join(ot, 'bank_00001.npz')}" in out
    assert "iteration 2:" in out and tload(os.path.join(ot, "bank_00002.npz"))[1]["iteration"] == 2

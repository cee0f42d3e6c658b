"""Port vs reference: the whole connected-digit slice (wav -> word ids).

* ``decode_connected`` and ``_decode_banded_batch`` against the
  reference decoder (its XLA path, and its Pallas path in interpret
  mode): words identical, costs at rtol 1e-5 (emission GEMMs sum in
  different orders);
* ``states_to_words_device`` against the reference, and on a skip-arc
  bank against the reference's host ``states_to_words``;
* the port imports no jax;
* end to end: reference CLI ``synth`` + ``isolated_train``, then the
  reference and the port ``connected_test`` on the same wavs print the
  same per-utterance lines and WER.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import connected as jconn
from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.ops.viterbi_banded_pallas import banded_topology as j_topology
from speech_recognition_tpu_torch.decode import connected as tconn
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from tests.test_torch_banded import build_graphs, jvb
from tests.test_torch_gmm_hmm import both_banks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(seed, b, t, nf):
    feats = np.random.default_rng(seed).standard_normal((b, t, 6)).astype(np.float32)
    return feats, np.asarray(nf, np.int32)


@pytest.mark.parametrize("kind", ["loop", "sausage", "loop_lm"])
def test_decode_connected_matches_reference(kind):
    jb, tb = both_banks(12, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs(kind, trans)
    feats, nf = _inputs(13, 5, 18, [18, 1, 9, 17, 12])
    for drop in (None, {1}):
        w_j, c_j = jconn.decode_connected(jb, gj, feats, nf, drop_labels=drop)
        w_t, c_t = tconn.decode_connected(tb, gt, torch.from_numpy(feats),
                                          torch.from_numpy(nf), drop_labels=drop)
        assert w_t == w_j
        np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-5)


@pytest.mark.parametrize("kind", ["loop", "sausage_lm"])
def test_decode_banded_batch_matches_pallas_path(kind):
    jb, tb = both_banks(14, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs(kind, trans)
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    feats, nf = _inputs(15, 6, 16, [16, 3, 1, 16, 10, 7])
    s_j, e_j, c_j = jconn._decode_banded_batch(
        jb, jnp.asarray(feats), jnp.asarray(nf), bj, eps_depth=gj.eps_depth,
        pallas_topo=j_topology(bj), pallas_interpret=True)
    s_t, e_t, c_t = tconn._decode_banded_batch(
        tb, torch.from_numpy(feats), torch.from_numpy(nf), bt, eps_depth=gt.eps_depth)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)
    for i, n in enumerate(nf):
        np.testing.assert_array_equal(s_t.numpy()[i, :n], np.asarray(s_j)[i, :n])
        np.testing.assert_array_equal(e_t.numpy()[i, :n], np.asarray(e_j)[i, :n])
        assert tconn.states_to_words(gt, s_t.numpy()[i], n, e_t.numpy()[i]) == \
            jconn.states_to_words(gj, np.asarray(s_j)[i], n, np.asarray(e_j)[i])


def test_states_to_words_device_matches_reference():
    rng = np.random.default_rng(16)
    jb, _ = both_banks(16, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs("sausage", trans)
    b, t = 4, 20
    states = np.sort(rng.integers(0, gt.n_states, (b, t)), axis=1).astype(np.int32)
    flags = rng.uniform(size=(b, t)) < 0.2
    nf = np.array([20, 7, 1, 15], np.int32)
    slot = gt.slot.astype(np.int32)
    for uw, labels in ((0, gt.slot_label[gt.slot]), (3, gt.slot_label)):
        w_j, n_j = jconn.states_to_words_device(
            jnp.asarray(slot), jnp.asarray(labels.astype(np.int32)), jnp.asarray(states),
            jnp.asarray(flags), jnp.asarray(nf), max_words=t, uniform_w=uw)
        w_t, n_t = tconn.states_to_words_device(
            torch.from_numpy(slot), torch.from_numpy(labels.astype(np.int32)),
            torch.from_numpy(states), torch.from_numpy(flags), torch.from_numpy(nf),
            max_words=t, uniform_w=uw)
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        for i in range(b):
            host = jconn.states_to_words(gj, states[i], int(nf[i]), flags[i])
            assert w_t.numpy()[i, : n_t[i]].tolist() == host


def test_skip_arc_bank_keeps_every_word():
    """Skip arcs let a 5-state word pass in 3 frames, so a 12-frame
    utterance can hold 4 words; the reference sizes its word plane as
    12 // 5 + 1 = 3 and drops the rest.  The port sizes the plane from
    the batch's own boundary count and agrees with the host walk."""
    jb, tb = both_banks(17, n_models=3, n_states=5, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]).copy() for i in range(3)]
    for tr in trans:
        for i in range(3):
            tr[i + 2, i] = 0.05  # cheap skip arcs
    gj = jgraph.build_loop_graph(trans, word_insertion_cost=-1000.0)
    gt = tgraph.build_loop_graph(trans, word_insertion_cost=-1000.0)
    tb.trans_cost.copy_(torch.from_numpy(np.stack(trans)))
    feats, nf = _inputs(18, 3, 12, [12, 12, 9])
    words, _ = tconn.decode_connected(tb, gt, torch.from_numpy(feats), torch.from_numpy(nf))
    s_t, e_t, _ = tconn._decode_banded_batch(tb, torch.from_numpy(feats),
                                             torch.from_numpy(nf), tvb.banded_arrays(gt))
    for i in range(3):
        host = jconn.states_to_words(gj, s_t.numpy()[i], int(nf[i]), e_t.numpy()[i])
        assert words[i] == host
    assert max(len(w) for w in words) > 12 // 5 + 1


def _port_modules():
    """Every module of the port package, by dotted name."""
    pkg = os.path.join(REPO, "speech_recognition_tpu_torch")
    mods = []
    for root, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].split(os.sep)
                mods.append(".".join(rel[:-1] if rel[-1] == "__init__" else rel))
    return sorted(mods)


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax and no module of
    the reference package, and leaves TF32 off."""
    mods = _port_modules()
    assert "speech_recognition_tpu_torch.ops.lattice_kernels" in mods and len(mods) > 30
    assert {f"speech_recognition_tpu_torch.{m}" for m in (
        "parallel", "parallel.mesh", "parallel.trainer", "parallel.sharded_decode",
        "utils.profiling", "utils.roofline")} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'speech_recognition_tpu'\n"
            "             or m.startswith('speech_recognition_tpu.'))\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_port_sources_name_no_reference_import():
    """No import statement of the port's sources or of ``chip_smoke.py``
    names jax or the reference package."""
    import re

    pat = re.compile(r"^\s*(from|import)\s+(jax|speech_recognition_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, *m.split(".")) + (".py" if not os.path.isdir(
            os.path.join(REPO, *m.split("."))) else os.sep + "__init__.py")
        for m in _port_modules()]
    for path in paths:
        with open(path) as f:
            hits = [m.group(0).strip() for m in pat.finditer(f.read())]
        assert not hits, (path, hits)


def test_cli_connected_test_matches_reference(tmp_path, capsys, monkeypatch):
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    monkeypatch.chdir(tmp_path)
    jmain(["synth", "-o", "data", "--n-train", "3", "--n-test", "1",
           "--n-continuous", "8"])
    jmain(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
           "--n-gaussians", "2"])
    capsys.readouterr()

    def lines(out):
        return [l for l in out.splitlines()
                if l.startswith(("Correct:", "Incorrect:", "WER:", "WARNING:"))]

    # the bigram composed onto the graph: fitted on the test transcripts
    # (with the warning), or on the training transcripts, at a weight
    lms = ([], ["--lm", "bigram"],
           ["--lm", "bigram", "--lm-train", "data/train", "--lm-weight", "2.5"])
    for graph in ("loop", "sausage"):
        for lm in lms:
            cmd = ["connected_test", "-i", "models/bank.npz", "-d", "data/test",
                   "--graph", graph, *lm]
            jmain(cmd)
            ref = lines(capsys.readouterr().out)
            tmain(cmd + ["--device", "cpu"])
            got = lines(capsys.readouterr().out)
            assert got == ref and len(ref) > 10, (graph, lm)
            assert any(l.startswith("WARNING:") for l in got) == (lm == lms[1])

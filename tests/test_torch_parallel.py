"""Port vs reference: the sharded training step and classifier
(``speech_recognition_tpu_torch.parallel``) in one gloo world of 4 CPU
processes, against the JAX single-device ``embedded_step`` /
``embedded_step_soft`` / ``classify_batch`` and the port's own
single-process functions.

Mirrors ``tests/test_parallel.py`` (the sharded step against the single
device) and ``tests/test_multiprocess.py`` (a real multi-process world):
on ``tests/embedded_case.make_embedded_case()`` (4 models, 16
utterances) the hard step on the grids (4, 1) and (2, 2), the latter
with 12 models sharded over 'model'; the soft step with the dense and
the banded dict; the classifier.  The world starts once for the module
(``tests/torch_world.py``); the JAX side runs in this process with x64
off, and the inputs go to the workers as numpy arrays.

Tolerances are JAX's: means and log_vars rtol / atol 1e-4, total_cost
rtol 1e-5 (sums over shards in another order), predictions identical;
for the soft step against JAX, atol 2e-4, the tolerance the port's own
single-process soft step is held to against JAX's
(``tests/test_torch_soft_em.py``: measured up to 1.5e-4 on these cases,
float32 posteriors summed in other orders; the sharded step is within
4.2e-5 of the port's single-process one).  Against the port's
single-process step every re-estimated field is held at rtol / atol 1e-4
and the statistics at 1e-4 of their largest entry; every rank's outputs
are the same bit for bit (replicated).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models.graph import build_word_graph, pad_graphs, pad_graphs_banded
from speech_recognition_tpu_torch.models.hmm import HMMBank
from tests.embedded_case import make_embedded_case
from tests.torch_parallel_worker import BANK_FIELDS, CLASSIFY_RUNS, TRAIN_RUNS
from tests.torch_world import run_world

jes, tes = (importlib.import_module(f"{pkg}.train.embedded_step")
            for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch"))
jiso, tiso = (importlib.import_module(f"{pkg}.decode.isolated")
              for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch"))

HARD_KEYS = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")
DENSE_KEYS = ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")


def _inputs():
    """The cases (a: 4 models, b: 12 models) and their graph dicts as
    plain arrays, with the JAX references of every run."""
    inp, refs, jbanks = {}, {}, {}
    for case, n_words in (("a", 4), ("b", 12)):
        jb, feats, nf, _, _, labels = make_embedded_case(n_words=n_words)
        jbanks[case] = jb
        for f in BANK_FIELDS:
            inp[f"{case}_bank_{f}"] = np.asarray(getattr(jb, f))
        inp[f"{case}_feats"], inp[f"{case}_nf"] = feats, nf
        trans = [np.asarray(jb.trans_cost[i]) for i in range(n_words)]
        graphs = [build_word_graph(trans, [[w] for w in ls]) for ls in labels]
        dense, depth = pad_graphs(graphs)
        banded, depth_b = pad_graphs_banded(graphs)
        dicts = {f"{case}_hard": ({k: dense[k] for k in HARD_KEYS}, depth),
                 f"{case}_dense": ({k: dense[k] for k in DENSE_KEYS}, depth),
                 f"{case}_band": (dict(banded), depth_b)}
        for name, (g, d) in dicts.items():
            inp[f"{name}_depth"] = np.int32(d)
            for k, v in g.items():
                inp[f"{name}_g_{k}"] = np.asarray(v)
    for name, (case, gname, _, _, soft) in TRAIN_RUNS.items():
        g = {k[len(gname) + 3:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(f"{gname}_g_")}
        fn = jes.embedded_step_soft if soft else jes.embedded_step
        refs[name] = fn(jbanks[case], jnp.asarray(inp[f"{case}_feats"]),
                        jnp.asarray(inp[f"{case}_nf"]), g, eps_depth=int(inp[f"{gname}_depth"]))
    for name, (case, _) in CLASSIFY_RUNS.items():
        refs[name] = jiso.classify_batch(jbanks[case], jnp.asarray(inp[f"{case}_feats"]),
                                         jnp.asarray(inp[f"{case}_nf"]))
    return inp, refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel")
    with jax.enable_x64(False):
        inp, refs = _inputs()
    np.savez(d / "inputs.npz", **inp)
    outs = run_world("train", d, world=4, timeout=400)
    return inp, refs, outs


def _replicated(outs, prefix):
    """Rank 0's outputs whose key starts with ``prefix``, after checking
    that every rank holds the same bits."""
    got = {k: v for k, v in outs[0].items() if k.startswith(prefix)}
    assert got
    for o in outs[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(o[k], v, err_msg=f"{k} differs between ranks")
    return {k[len(prefix):]: v for k, v in got.items()}


def _port_single(inp, name):
    case, gname, _, _, soft = TRAIN_RUNS[name]
    bank = HMMBank.from_numpy(*(inp[f"{case}_bank_{f}"] for f in BANK_FIELDS))
    g = {k[len(gname) + 3:]: torch.as_tensor(v) for k, v in inp.items()
         if k.startswith(f"{gname}_g_")}
    fn = tes.embedded_step_soft if soft else tes.embedded_step
    return fn(bank, torch.from_numpy(inp[f"{case}_feats"]), torch.from_numpy(inp[f"{case}_nf"]),
              g, eps_depth=int(inp[f"{gname}_depth"]))


@pytest.mark.parametrize("name", list(TRAIN_RUNS))
def test_sharded_step_matches_single_device(world, name):
    """The hard step on (4, 1) and on (2, 2) with 12 models over 'model',
    the soft step with the dense dict (K16's) and the banded dict (K15's)
    on (4, 1) and the banded on (2, 2) with 12 models: against JAX's
    single-device step and the port's single-process step."""
    inp, refs, outs = world
    got = _replicated(outs, f"{name}_")
    jnew, jst = refs[name]
    atol = 2e-4 if TRAIN_RUNS[name][4] else 1e-4
    for f in ("means", "log_vars"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(jnew, f)), rtol=1e-4, atol=atol,
                                   err_msg=f)
    np.testing.assert_allclose(got["total_cost"], float(jst.total_cost), rtol=1e-5)
    tnew, tst = _port_single(inp, name)
    for f in BANK_FIELDS:
        np.testing.assert_allclose(got[f], getattr(tnew, f).numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f)
    for f in ("r_sum", "rx", "rxx", "frame_counts", "run_counts"):
        want = getattr(tst, f).numpy()
        np.testing.assert_allclose(got[f], want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f)
        if f.endswith("counts") and not TRAIN_RUNS[name][4]:  # hard counts are integers
            np.testing.assert_array_equal(got[f], want, err_msg=f)
    np.testing.assert_allclose(got["total_cost"], float(tst.total_cost), rtol=1e-5)


@pytest.mark.parametrize("name", list(CLASSIFY_RUNS))
def test_sharded_classifier_matches_single_device(world, name):
    """The data-parallel classifier: predictions identical to JAX's and
    the port's ``classify_batch``, costs within rtol 1e-5."""
    inp, refs, outs = world
    got = _replicated(outs, f"{name}_")
    jpred, jcosts = refs[name]
    case = CLASSIFY_RUNS[name][0]
    tpred, tcosts = tiso.classify_batch(
        HMMBank.from_numpy(*(inp[f"{case}_bank_{f}"] for f in BANK_FIELDS)),
        torch.from_numpy(inp[f"{case}_feats"]), torch.from_numpy(inp[f"{case}_nf"]))
    np.testing.assert_array_equal(got["pred"], np.asarray(jpred))
    np.testing.assert_array_equal(got["pred"], tpred.numpy())
    np.testing.assert_allclose(got["costs"], np.asarray(jcosts), rtol=1e-5)
    np.testing.assert_allclose(got["costs"], tcosts.numpy(), rtol=1e-5)


@pytest.mark.parametrize("check", ["err_shape_too_large", "err_cuda_without_nccl",
                                   "err_batch_does_not_divide", "err_models_do_not_divide"])
def test_mesh_errors(world, check):
    """``make_mesh`` raises for a shape larger than the world and for a
    cuda mesh over gloo (no fallback); ``batch_shard`` / ``bank_shard``
    raise where the batch or the model count does not divide the axis,
    as JAX's ``device_put`` does; on every rank."""
    _, _, outs = world
    assert [int(o[check]) for o in outs] == [1] * len(outs)


def test_init_twice_and_sub_meshes(world):
    """``init_distributed`` on an initialized world is a no-op (the
    world of 4 answers the next all_reduce); a (2, 1) mesh holds ranks 0
    and 1, and the others are outside it."""
    _, _, outs = world
    assert [int(o["init_twice_world"]) for o in outs] == [4] * 4
    assert [int(o["sub_mesh_member"]) for o in outs] == [1, 1, 0, 0]

"""Port vs reference: the embedded Viterbi-EM step and the from-scratch
embedded re-estimation, on ``tests/embedded_case.make_embedded_case``.

The JAX side runs with x64 off (float32, as the JAX CLI trains); the
replayed k-means draws of ``continuous_train`` are made in the same mode
(``tests.test_torch_train.JaxDraws``).

Tolerances: state ids, frame and run counts exactly; parameters,
statistics and costs at rtol 1e-4 / atol 1e-4 (f32 GEMMs in different
summation orders; rx / rxx sum up to ~2,000 frames of magnitude ~10).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import HMMConfig as JHMMConfig
from speech_recognition_tpu.config import TrainConfig as JTrainConfig
from speech_recognition_tpu.models.graph import build_word_graph, pad_graphs, transcript_graph
from speech_recognition_tpu.models.hmm import HMMBank as JHMMBank
from speech_recognition_tpu_torch.config import HMMConfig, TrainConfig
from speech_recognition_tpu_torch.models.hmm import HMMBank
from tests.embedded_case import make_embedded_case
from tests.test_torch_train import JaxDraws

jes, jcont, tes, tcont = (importlib.import_module(f"{pkg}.train.{m}")
                          for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch")
                          for m in ("embedded_step", "continuous"))

TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("means", "log_vars", "log_weights", "trans_cost")
KEYS = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), **(tol or TOL))


def port_bank(jb):
    return HMMBank.from_numpy(*(np.asarray(getattr(jb, f)) for f in FIELDS))


def case(unused_model: bool = False):
    """The shared case; ``unused_model`` appends a fifth word (a copy of
    word 0) that no transcript names, so it aligns no frame."""
    jb, feats, nf, g, depth, labels = make_embedded_case()
    if unused_model:
        jb = JHMMBank(*(jnp.concatenate([getattr(jb, f), getattr(jb, f)[:1] + 0.25])
                        for f in FIELDS))
        trans = [np.asarray(jb.trans_cost[i]) for i in range(jb.n_models)]
        gb, depth = pad_graphs([build_word_graph(trans, [[w] for w in ls]) for ls in labels])
        g = {k: np.asarray(gb[k]) for k in KEYS}
    return jb, feats, nf, g, depth, labels


@pytest.mark.parametrize("frame_chunk,lr,unused_model", [
    (65536, 1.0, False),   # one chunk
    (500, 0.5, False),     # four chunks of B*T = 1,920, the last one short
    (700, 1.0, True),      # a model with no aligned frames keeps its parameters
])
def test_embedded_step_matches_reference(frame_chunk, lr, unused_model):
    jb, feats, nf, g, depth, _ = case(unused_model)
    tb = port_bank(jb)
    kw = dict(eps_depth=depth, lr=lr, frame_chunk=frame_chunk)
    jnew, jst = jes.embedded_step(jb, jnp.asarray(feats), jnp.asarray(nf),
                                  {k: jnp.asarray(v) for k, v in g.items()}, **kw)
    tnew, tst = tes.embedded_step(tb, torch.from_numpy(feats), torch.from_numpy(nf),
                                  {k: torch.from_numpy(v) for k, v in g.items()}, **kw)
    # the alignment the step trains on
    jids, _ = jes._align_ids(jb, jnp.asarray(feats), jnp.asarray(nf),
                             {k: jnp.asarray(v) for k, v in g.items()}, depth)
    tids, _ = tcont.align_batch(tb, torch.from_numpy(feats), torch.from_numpy(nf),
                                *(torch.from_numpy(g[k]) for k in KEYS), eps_depth=depth)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tst.frame_counts.numpy(), np.asarray(jst.frame_counts))
    np.testing.assert_array_equal(tst.run_counts.numpy(), np.asarray(jst.run_counts))
    for f in ("r_sum", "rx", "rxx", "total_cost"):
        close(getattr(tst, f), getattr(jst, f))
    for f in FIELDS:
        close(getattr(tnew, f), getattr(jnew, f))
    if unused_model:
        assert not tst.frame_counts[20:].any()
        for f in FIELDS:
            assert torch.equal(getattr(tnew, f)[4], getattr(tb, f)[4])


def test_continuous_train_matches_reference():
    """Two from-scratch iterations with JAX's draws; the checkpoint
    callback sees each iteration's bank."""
    jb, feats, nf, _, _, labels = case()
    m = jb.n_mix
    key = jax.random.PRNGKey(21)
    seen_j, seen_t = [], []
    jout = jcont.continuous_train(
        key, jb, jnp.asarray(feats), jnp.asarray(nf), labels, hmm_cfg=JHMMConfig(n_mix=m),
        train_cfg=JTrainConfig(continuous_max_iters=2),
        checkpoint_cb=lambda it, b: seen_j.append((it, b)))
    draws = JaxDraws(key)
    tout = tcont.continuous_train(
        port_bank(jb), torch.from_numpy(feats), torch.from_numpy(nf), labels,
        hmm_cfg=HMMConfig(n_mix=m), train_cfg=TrainConfig(continuous_max_iters=2),
        checkpoint_cb=lambda it, b: seen_t.append((it, b)), draw_assign=draws)
    assert [it for it, _ in seen_t] == [it for it, _ in seen_j] == [0, 1]
    assert len(draws.calls) > 0 and all(k == 2 for _, k in draws.calls)
    for (_, bt), (_, bj) in zip(seen_t, seen_j):
        for f in FIELDS:
            close(getattr(bt, f), getattr(bj, f))
    for f in FIELDS:
        close(getattr(tout, f), getattr(jout, f))
    assert torch.equal(tout.means, seen_t[-1][1].means)


@pytest.mark.parametrize("sil", [None, 3])
def test_compose_graphs_matches_reference(sil):
    """The graph batch ``continuous_train`` aligns to: the JAX CLI's
    ``pad_graphs`` over ``transcript_graph`` (word 3 standing in for the
    silence model), equal array for array."""
    jb, _, _, _, _, labels = case()
    trans = [np.asarray(jb.trans_cost[i]) for i in range(jb.n_models)]
    gb, depth = pad_graphs([transcript_graph(trans, ls, sil=sil) for ls in labels])
    g, tdepth = tes.compose_graphs(port_bank(jb), labels, sil)
    assert tdepth == depth and sorted(g) == sorted(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(gb[k]), err_msg=k)

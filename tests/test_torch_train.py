"""Port vs reference: hard-EM training on the CPU.

k-means' random initial assignments are JAX's own draws, replayed
through the port's injected ``init_assign`` / ``draw_assign`` in the
order of the JAX ``jax.random.split`` chains (``JaxDraws``), so both
packages train from the same draws.

The JAX side runs with x64 off, in float32 as the JAX CLI trains
(conftest turns x64 on, and then the JAX EM loop of ``n_mix`` 1 refuses
its own carry: its weights start as a float64 ``ones``); the draws are
made in the same mode.

Tolerances: alignments, states, counts and ``calc_transition_costs``
are compared exactly; trained parameters at rtol 1e-4 / atol 1e-5 (f32
GEMMs summed in different orders).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import HMMConfig as JHMMConfig
from speech_recognition_tpu.config import TrainConfig as JTrainConfig
from speech_recognition_tpu.data.synthetic import random_gmm_hmm, sample_hmm_features
from speech_recognition_tpu.decode import dtw as jdtw
from speech_recognition_tpu_torch.config import HMMConfig, TrainConfig
from speech_recognition_tpu_torch.decode import dtw as tdtw
from speech_recognition_tpu_torch.models.hmm import GMMHMM

# the packages' train/__init__ exports functions named like the modules
jem, jiso, jkm, jsk, tem, tiso, tkm, tsk = (
    importlib.import_module(f"{pkg}.train.{m}")
    for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch")
    for m in ("em", "isolated", "kmeans", "skmeans"))

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j), **(tol or TOL))


def equal(t, j):
    np.testing.assert_array_equal(t.detach().cpu().numpy(), np.asarray(j))


class JaxDraws:
    """``draw_assign(n, k)`` replaying JAX's ``randint`` draws of k-means.

    With ``per_state`` (``fit_hmm``, ``continuous_train``) each state's
    fit starts with ``key, sub = split(key)`` and every mixture split of
    that state then splits ``sub``; a state's first draw is the one with
    k == 2.  Without it (``fit_gmm_state`` alone) the splits chain from
    ``key`` itself."""

    def __init__(self, key, per_state: bool = True):
        self.outer, self.inner, self.per_state = key, key, per_state
        self.calls = []

    def __call__(self, n, k):
        if self.per_state and k == 2:
            self.outer, self.inner = jax.random.split(self.outer)
        self.inner, sub = jax.random.split(self.inner)
        self.calls.append((n, k))
        return torch.from_numpy(np.array(jax.random.randint(sub, (n,), 0, k), np.int64))


def blobs(seed, n=120, d=8, k=4, sep=4.0):
    rng = np.random.default_rng(seed)
    centers = sep * rng.standard_normal((k, d))
    lab = rng.integers(0, k, n)
    x = (centers[lab] + rng.standard_normal((n, d)) * rng.uniform(0.5, 1.5, (k, d))[lab])
    mask = rng.uniform(size=n) < 0.8
    return x.astype(np.float32), mask


def templates(seed, n=6, d=10, n_states=5, n_mix=2):
    """``n`` feature sequences sampled from one random GMM-HMM."""
    rng = np.random.default_rng(seed)
    p = random_gmm_hmm(rng, n_states, n_mix, d, sep=3.0)
    return [sample_hmm_features(p, rng, min_frames_per_state=3)[0][:110].astype(np.float32)
            for _ in range(n)]


def test_cluster_stats_matches_reference():
    x, mask = blobs(0)
    assign = np.random.default_rng(1).integers(0, 5, len(x))
    got = tkm.cluster_stats(torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(assign), 5, 1e-6)
    want = jkm.cluster_stats(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(assign), 5, 1e-6)
    equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        close(a, b)


@pytest.mark.parametrize("quirk", [False, True])
def test_kmeans_matches_reference_with_an_empty_cluster(quirk):
    """Cluster 3 starts far from every frame: it ends empty and keeps its
    centroid."""
    x, mask = blobs(2)
    c0 = np.concatenate([x[:3], np.full((1, x.shape[1]), 50.0, np.float32)])
    key = jax.random.PRNGKey(7)
    init = np.array(jax.random.randint(key, (len(x),), 0, 4))
    ja, jc, jv, jn = jkm.kmeans(key, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(c0), 4,
                                shared_cov_quirk=quirk)
    ta, tc, tv, tn = tkm.kmeans(torch.from_numpy(x), torch.from_numpy(mask),
                                torch.from_numpy(c0), 4, torch.from_numpy(init),
                                shared_cov_quirk=quirk)
    assert float(tn[3]) == 0.0 and np.all(tc[3].numpy() == 50.0)
    equal(ta, ja)
    equal(tn, jn)
    close(tc, jc)
    close(tv, jv)


def test_em_fit_matches_reference():
    """Masked frames, three components, the iteration count."""
    x, mask = blobs(3, k=3)
    rng = np.random.default_rng(4)
    m0 = x[rng.choice(len(x), 3, replace=False)]
    v0 = np.ones((3, x.shape[1]), np.float32)
    w0 = np.full((3,), 1 / 3, np.float32)
    jm, jv, jw, ji = jem.em_fit(*(jnp.asarray(a) for a in (x, mask, m0, v0, w0)),
                                var_floor=1e-2)
    tm, tv, tw, ti = tem.em_fit(*(torch.from_numpy(a) for a in (x, mask, m0, v0, w0)),
                                var_floor=1e-2)
    assert ti == int(ji) and 1 < ti < 100
    close(tm, jm)
    close(tv, jv)
    close(tw, jw)
    # masked frames add nothing
    x2 = x.copy()
    x2[~mask] = 1e3
    tm2 = tem.em_fit(*(torch.from_numpy(a) for a in (x2, mask, m0, v0, w0)), var_floor=1e-2)[0]
    np.testing.assert_array_equal(tm2.numpy(), tm.numpy())


@pytest.mark.parametrize("seg_lens", [
    [[4, 3, 5, 2, 6], [3, 3, 3, 3, 3]],
    [[4, 0, 5, 0, 6], [3, 0, 3, 2, 3]],   # empty segments: jumps of 2
    [[4, 0, 0, 5, 6], [3, 0, 0, 3, 3]],   # past the jump limit
    [[4, 3, 0, 2, 6], [3, 2, 0, 0, 3]],   # a segment no template reached
    [[0, 3, 5, 2, 6], [0, 3, 3, 3, 3]],   # ... the first
])
def test_calc_transition_costs_equal(seg_lens):
    seg_lens = np.asarray(seg_lens, np.int64)
    for mj in (1, 2, 3):
        got = tsk.calc_transition_costs(2, seg_lens, max_jump_dist=mj)
        want = jsk.calc_transition_costs(2, seg_lens, max_jump_dist=mj)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


def test_segment_stats_matches_reference():
    x, nf = jsk.pad_templates(templates(5))
    rng = np.random.default_rng(6)
    states = np.sort(rng.integers(0, 5, x.shape[:2]), axis=1).astype(np.int32)
    got = tsk.segment_stats(torch.from_numpy(x), torch.from_numpy(nf),
                            torch.from_numpy(states), 5)
    want = jsk.segment_stats(jnp.asarray(x), jnp.asarray(nf), jnp.asarray(states), 5)
    equal(got[0], want[0])
    equal(got[3], want[3])
    close(got[1], want[1])
    close(got[2], want[2])
    tx, tn = tsk.pad_templates([torch.from_numpy(t) for t in templates(5)])
    np.testing.assert_array_equal(tx.numpy(), x)
    np.testing.assert_array_equal(tn.numpy(), nf)


@pytest.mark.parametrize("update_seg_lens", [True, False])
def test_skmeans_matches_reference(update_seg_lens):
    temps = templates(8)
    jm, jv, jt, js, _ = jsk.skmeans(temps, 5, update_seg_lens=update_seg_lens, pad_to=120)
    tm, tv, tt, ts, (x, nf) = tsk.skmeans([torch.from_numpy(t) for t in temps], 5,
                                          update_seg_lens=update_seg_lens, pad_to=120)
    assert x.shape == (6, 120, 10)
    equal(ts, js)
    np.testing.assert_array_equal(tt, jt)
    close(tm, jm)
    close(tv, jv)
    with pytest.raises(ValueError, match="too small"):
        tsk.skmeans([torch.zeros((4, 10))], 5)


def test_fit_template_matches_reference():
    temps = templates(9)
    jm, jv, jt = jdtw.fit_template(temps, 5)
    tm, tv, tt = tdtw.fit_template([torch.from_numpy(t) for t in temps], 5)
    close(tm, jm)
    close(tv, jv)
    equal(tt, jt)


@pytest.mark.parametrize("n_mix,ref_compat,use_em", [
    (1, False, True), (1, False, False), (2, False, True), (4, False, True),
    (4, False, False), (4, True, True), (2, True, True)])
def test_fit_gmm_state_matches_reference(n_mix, ref_compat, use_em):
    x, mask = blobs(10, n=150, d=9, k=4)
    mu0 = x[mask].mean(0)
    hmm_j = JHMMConfig(n_mix=n_mix, ref_compat_splits=ref_compat)
    hmm_t = HMMConfig(n_mix=n_mix, ref_compat_splits=ref_compat)
    key = jax.random.PRNGKey(11)
    want = jiso.fit_gmm_state(key, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(mu0), n_mix,
                              use_em=use_em, hmm_cfg=hmm_j)
    draws = JaxDraws(key, per_state=False)
    got = tiso.fit_gmm_state(torch.from_numpy(x), torch.from_numpy(mask),
                             torch.from_numpy(mu0), n_mix, use_em=use_em, hmm_cfg=hmm_t,
                             draw_assign=draws)
    assert [k for _, k in draws.calls] == [2 ** (i + 1) for i in range(hmm_t.n_splits)]
    for a, b in zip(got, want):
        assert a.shape == b.shape == (n_mix,) + b.shape[1:]
        close(a, b)


def port_hmm_cfg(jcfg):
    """The port's ``HMMConfig`` with the reference config's values (the
    port carries no ``feature_dim``: the features give it)."""
    return HMMConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(HMMConfig)})


def _fit_both(temps, seed, **kw):
    key = jax.random.PRNGKey(seed)
    jm = jiso.fit_hmm(key, temps, pad_to=120, **kw)
    draws = JaxDraws(key)
    tkw = {k: (port_hmm_cfg(v) if k == "hmm_cfg" else v) for k, v in kw.items()}
    tm = tiso.fit_hmm([torch.from_numpy(t) for t in temps], pad_to=120, draw_assign=draws,
                      **tkw)
    return jm, tm, draws


@pytest.mark.parametrize("n_mix,use_em", [(2, True), (4, False)])
def test_fit_hmm_matches_reference(n_mix, use_em):
    temps = templates(12, n=8, d=12, n_mix=2)
    jm, tm, draws = _fit_both(temps, 13, use_em=use_em, hmm_cfg=JHMMConfig(n_mix=n_mix))
    assert len(draws.calls) == 5 * int(np.log2(n_mix))
    for f in ("means", "log_vars", "log_weights"):
        close(getattr(tm, f), getattr(jm, f))
    equal(tm.trans_cost, jm.trans_cost)


def test_align_states_matches_reference():
    temps = templates(14, n=5, d=8)
    jm, tm, _ = _fit_both(temps, 15, hmm_cfg=JHMMConfig(n_mix=2))
    x, nf = jsk.pad_templates(templates(16, n=5, d=8), 120)
    want = jiso.align_states(jm, x, nf)
    got = tiso.align_states(tm, torch.from_numpy(x), torch.from_numpy(nf))
    equal(got, want)
    # and on the reference's own parameters
    tm2 = GMMHMM(*(torch.from_numpy(np.array(getattr(jm, f))) for f in
                   ("means", "log_vars", "log_weights", "trans_cost")))
    equal(tiso.align_states(tm2, torch.from_numpy(x), torch.from_numpy(nf)), want)


def test_random_assign_is_seeded_and_on_the_cpu():
    a = tkm.random_assign(torch.Generator().manual_seed(3))(50, 4)
    b = tkm.random_assign(torch.Generator().manual_seed(3))(50, 4)
    assert a.device.type == "cpu" and a.dtype == torch.int64
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 4
    # the default draw of fit_hmm is TrainConfig.seed's generator
    temps = [torch.from_numpy(t) for t in templates(17, n=4, d=8)]
    m1 = tiso.fit_hmm(temps, hmm_cfg=HMMConfig(n_mix=2), pad_to=120)
    m2 = tiso.fit_hmm(temps, hmm_cfg=HMMConfig(n_mix=2), pad_to=120,
                      draw_assign=tkm.random_assign(
                          torch.Generator().manual_seed(TrainConfig().seed)))
    assert torch.equal(m1.means, m2.means)
    assert JTrainConfig().seed == TrainConfig().seed

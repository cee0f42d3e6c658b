"""Port vs reference: the batched mixture fits (k-means K24 and EM K25) on
the CPU, where their wrappers run the plain versions fit by fit.

``fit_gmm_states`` fits a batch of states of one frame buffer with one
``kmeans_batch`` and one ``em_fit_batch`` a split level; each state is
held to the JAX ``fit_gmm_state`` run on its own, from JAX's own k-means
draws replayed through ``draw_assign`` (``JaxDraws`` of
``tests/test_torch_train.py``), with the JAX side in float32 (x64 off) as
the JAX CLI trains.  Tolerance ``TOL``: rtol 1e-4 / atol 1e-5 (f32 GEMMs
summed in other orders), as there.  A batch of one, and each fit of a
batch, equal the state-by-state path (``kmeans_ref`` / ``em_fit_ref``)
bit for bit.  The kernels themselves are held to these plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GMM_AS_ACCURATE, planted_fits
from speech_recognition_tpu.config import HMMConfig as JHMMConfig
from speech_recognition_tpu_torch.config import HMMConfig, TrainConfig
from speech_recognition_tpu_torch.ops import gmm_fit_kernels as gfk
from speech_recognition_tpu_torch.utils import build
from speech_recognition_tpu_torch.utils.roofline import gmm_fit_work
from tests import k24_k25_fit as emu
from tests.test_torch_train import JaxDraws, blobs, templates

jiso, tem, tiso, tkm, tcont, jkm, jem = (
    importlib.import_module(m) for m in (
        "speech_recognition_tpu.train.isolated", "speech_recognition_tpu_torch.train.em",
        "speech_recognition_tpu_torch.train.isolated", "speech_recognition_tpu_torch.train.kmeans",
        "speech_recognition_tpu_torch.train.continuous", "speech_recognition_tpu.train.kmeans",
        "speech_recognition_tpu.train.em"))

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def state_masks(seed, n=160, d=9, f=4):
    """A frame buffer and ``f`` disjoint masks over it (the last state
    small), as a word's states split one buffer."""
    x, valid = blobs(seed, n=n, d=d, k=4)
    rng = np.random.default_rng(seed + 1)
    owner = np.minimum(rng.integers(0, f, n), f - 1)
    owner[rng.uniform(size=n) < 0.1] = f - 1
    masks = np.stack([(owner == i) & valid for i in range(f)])
    masks[f - 1, np.flatnonzero(masks[f - 1])[6:]] = False  # 6 frames at most
    return x, masks


def old_fit_gmm_state(x, mask, mu0, n_mix, use_em, train_cfg, hmm_cfg, draw_assign):
    """The state-by-state splitting the batch replaces, on ``kmeans_ref``
    and ``em_fit_ref``."""
    n_splits = hmm_cfg.n_splits
    n_valid = mask.to(x.dtype).sum()
    denom = torch.clamp(n_valid, min=1.0)

    def masked_var():
        mu = torch.where(mask[:, None], x, 0.0).sum(0) / denom
        sq = torch.where(mask[:, None], (x - mu) ** 2, 0.0).sum(0)
        return torch.clamp(sq / denom, min=hmm_cfg.var_floor)

    em_kw = dict(max_iters=train_cfg.em_max_iters, rtol=train_cfg.rtol, atol=train_cfg.atol,
                 var_floor=hmm_cfg.var_floor)
    centroids = mu0[None, :]
    variances = masked_var()[None, :]
    weights = torch.ones((1,), dtype=x.dtype)
    if n_splits == 0 and use_em:
        centroids, variances, weights, _ = tem.em_fit_ref(x, mask, centroids, variances,
                                                          weights, **em_kw)
    pert = train_cfg.split_perturbation
    for i in range(n_splits):
        k = 2 ** (i + 1)
        centroids = torch.cat([centroids * (1.0 - pert), centroids * (1.0 + pert)], dim=0)
        _, centroids, variances, counts = tkm.kmeans_ref(
            x, mask, centroids, k, draw_assign(x.shape[0], k),
            max_iters=train_cfg.kmeans_max_iters)
        weights = counts / denom
        if use_em:
            centroids, variances, weights, _ = tem.em_fit_ref(x, mask, centroids, variances,
                                                              weights, **em_kw)
    if 2 ** n_splits < n_mix:
        extra = n_mix - 2 ** n_splits
        centroids = torch.cat([centroids, mu0[None, :].expand(extra, -1)])
        variances = torch.cat([variances, masked_var()[None, :].expand(extra, -1)])
        weights = torch.cat([weights, (1.0 / denom).expand(extra)])
    return centroids, variances, weights


CASES = [(1, False, True), (1, False, False), (2, False, True), (4, False, True),
         (4, False, False), (4, True, True), (2, True, True)]


@pytest.mark.parametrize("n_mix,ref_compat,use_em", CASES)
def test_fit_gmm_states_matches_reference_state_by_state(n_mix, ref_compat, use_em):
    """A batch of four states (one of at most 6 frames) against JAX
    ``fit_gmm_state`` on each state, the draws of each state's key."""
    x, masks = state_masks(20)
    mu0 = np.stack([x[m].mean(0) for m in masks])
    hmm_j = JHMMConfig(n_mix=n_mix, ref_compat_splits=ref_compat)
    hmm_t = HMMConfig(n_mix=n_mix, ref_compat_splits=ref_compat)
    key = jax.random.PRNGKey(21)
    draws = JaxDraws(key)
    got = tiso.fit_gmm_states(torch.from_numpy(x), torch.from_numpy(masks),
                              torch.from_numpy(mu0), n_mix, use_em=use_em, hmm_cfg=hmm_t,
                              draw_assign=draws)
    outer = key
    for i, mask in enumerate(masks):
        outer, sub = jax.random.split(outer)
        want = jiso.fit_gmm_state(sub, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(mu0[i]),
                                  n_mix, use_em=use_em, hmm_cfg=hmm_j)
        for a, b in zip(got, want):
            assert a.shape[1:] == b.shape == (n_mix,) + b.shape[1:]
            np.testing.assert_allclose(a[i].numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("n_mix,ref_compat,use_em", CASES)
def test_batch_equals_the_state_by_state_path_bit_for_bit(n_mix, ref_compat, use_em):
    """``fit_gmm_state`` (a batch of one) and every fit of a batch equal the
    old single-fit loop on ``kmeans_ref`` / ``em_fit_ref`` from the same
    generator, drawn in the same order: state by state, split by split."""
    x, masks = (torch.from_numpy(a) for a in state_masks(22))
    mu0 = torch.stack([x[m].mean(0) for m in masks])
    hmm = HMMConfig(n_mix=n_mix, ref_compat_splits=ref_compat)
    cfg = TrainConfig()
    old_draw = tkm.random_assign(torch.Generator().manual_seed(5))
    want = [old_fit_gmm_state(x, m, mu, n_mix, use_em, cfg, hmm, old_draw)
            for m, mu in zip(masks, mu0)]
    got = tiso.fit_gmm_states(x, masks, mu0, n_mix, use_em=use_em, hmm_cfg=hmm,
                              draw_assign=tkm.random_assign(torch.Generator().manual_seed(5)))
    one = tiso.fit_gmm_state(x, masks[0], mu0[0], n_mix, use_em=use_em, hmm_cfg=hmm,
                             draw_assign=tkm.random_assign(torch.Generator().manual_seed(5)))
    for i, w in enumerate(want):
        for a, b in zip(got, w):
            assert torch.equal(a[i], b)
    for a, b in zip(one, want[0]):
        assert torch.equal(a, b)


def test_draw_order_is_the_state_by_state_order():
    """Every draw is taken before the first fit, fit-major then split, and
    ``fit_hmm`` launches one k-means and one EM batch a split level."""
    x, masks = (torch.from_numpy(a) for a in state_masks(23))
    calls = []

    def draw(n, k):
        calls.append((n, k))
        return torch.zeros((n,), dtype=torch.int64)

    tiso.fit_gmm_states(x, masks, x[:4].clone(), 4, draw_assign=draw)
    assert calls == [(x.shape[0], 2), (x.shape[0], 4)] * masks.shape[0]
    temps = [torch.from_numpy(t) for t in templates(24, n=5, d=8)]
    draws = JaxDraws(jax.random.PRNGKey(3))
    seen = {"kmeans": [], "em": []}
    real_km, real_em = tiso.kmeans_batch, tiso.em_fit_batch

    def km(*a, **kw):
        seen["kmeans"].append(a[1].shape[0])
        return real_km(*a, **kw)

    def em(*a, **kw):
        seen["em"].append(a[1].shape[0])
        return real_em(*a, **kw)

    tiso.kmeans_batch, tiso.em_fit_batch = km, em
    try:
        tiso.fit_hmm(temps, hmm_cfg=HMMConfig(n_mix=4), pad_to=120, draw_assign=draws)
    finally:
        tiso.kmeans_batch, tiso.em_fit_batch = real_km, real_em
    assert seen == {"kmeans": [5, 5], "em": [5, 5]}
    assert [k for _, k in draws.calls] == [2, 4] * 5


@pytest.mark.parametrize("quirk", [False, True])
def test_kmeans_batch_equals_kmeans_ref_fit_by_fit(quirk):
    """Four fits of one buffer: one with a far-away cluster that ends empty
    (it keeps its centroid), one of a single frame and one of none."""
    x, masks = (torch.from_numpy(a) for a in state_masks(25))
    masks[2] = False
    masks[2, 7] = True
    masks[3] = False
    rng = np.random.default_rng(26)
    c0 = torch.from_numpy(rng.standard_normal((4, 4, x.shape[1])).astype(np.float32))
    c0[0, 3] = 50.0
    init = torch.from_numpy(rng.integers(0, 4, (4, x.shape[0])))
    got = tkm.kmeans_batch(x, masks, c0, 4, init, shared_cov_quirk=quirk)
    assert float(got[3][0, 3]) == 0.0 and torch.all(got[1][0, 3] == 50.0)
    assert float(got[3][2].sum()) == 1.0 and float(got[3][3].sum()) == 0.0
    for i in range(4):
        want = tkm.kmeans_ref(x, masks[i], c0[i], 4, init[i], shared_cov_quirk=quirk)
        for a, b in zip(got, want):
            assert torch.equal(a[i], b)
    one = tkm.kmeans(x, masks[1], c0[1], 4, init[1], shared_cov_quirk=quirk)
    for a, b in zip(one, got):
        assert torch.equal(a, b[1])
    # no iteration: the draws and their statistics
    zero = tkm.kmeans_batch(x, masks, c0, 4, init, max_iters=0, shared_cov_quirk=quirk)
    assert torch.equal(zero[0], init) and torch.equal(zero[1], c0)


def test_em_fit_batch_equals_em_fit_ref_fit_by_fit():
    """Three components over four fits (one of a single frame, one of none),
    with the iteration counts as an int32 tensor; ``em_fit`` is a batch of
    one and returns a 0-d count."""
    x, masks = (torch.from_numpy(a) for a in state_masks(27))
    masks[2] = False
    masks[2, 3] = True
    masks[3] = False
    rng = np.random.default_rng(28)
    m0 = torch.from_numpy(rng.standard_normal((4, 3, x.shape[1])).astype(np.float32))
    v0 = torch.ones((4, 3, x.shape[1]))
    w0 = torch.full((4, 3), 1 / 3)
    got = tem.em_fit_batch(x, masks, m0, v0, w0, var_floor=1e-2)
    assert got[3].dtype == torch.int32 and got[3].shape == (4,)
    for i in range(4):
        want = tem.em_fit_ref(x, masks[i], m0[i], v0[i], w0[i], var_floor=1e-2)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a[i], b)
        assert int(got[3][i]) == want[3]
    assert int(got[3][0]) > 1 and int(got[3][3]) == 2
    one = tem.em_fit(x, masks[0], m0[0], v0[0], w0[0], var_floor=1e-2)
    assert one[3].dim() == 0 and int(one[3]) == int(got[3][0])
    assert torch.equal(one[0], got[0][0])


def test_continuous_train_refits_the_states_as_one_batch(monkeypatch):
    """One ``fit_gmm_states`` a continuous iteration, over the states that
    got frames: a model no transcript names is left out."""
    from tests.test_torch_embedded import case, port_bank

    jb, feats, nf, _, _, labels = case(unused_model=True)
    bank = port_bank(jb)
    seen = []
    real = tiso.fit_gmm_states

    def spy(x, masks, *a, **kw):
        seen.append(masks.shape[0])
        return real(x, masks, *a, **kw)

    monkeypatch.setattr(tiso, "fit_gmm_states", spy)
    cfg = TrainConfig(continuous_max_iters=2)
    out = tcont.continuous_train(bank, torch.from_numpy(feats), torch.from_numpy(nf), labels,
                                 hmm_cfg=HMMConfig(n_mix=bank.n_mix), train_cfg=cfg)
    assert len(seen) == 2 and all(0 < f <= (bank.n_models - 1) * bank.n_states for f in seen)
    assert torch.equal(out.means[-1], bank.means[-1])


# (n, d, m, em) -> what the plan must say: the instance, where the
# parameters live, whether every fit is staged, and the ring
PLAN_CASES = {
    "staged, d39m4": (900, 39, 4, True),
    "ring, the 8,000-frame fit": (8404, 39, 4, True),
    "ring, k-means": (8404, 39, 4, False),
    "d39m1": (500, 39, 1, True),
    "d39m2, continuous_train's buffer": (133661, 39, 2, False),
    "generic, even D at an odd float4 stride": (10, 40, 2, False),
    "generic, the ring's tile halved": (5000, 900, 1, True),
    "device, wide parameters": (312, 3000, 4, True),
    "device, more owners than threads": (100, 1100, 4, True),
    "no frames": (0, 39, 4, True),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_tiers(case):
    """Every fit staged while the frames fit; past ~1,100 frames at D = 39
    a fit streams through a ring of 2-4 tiles of up to 256 frames; D = 39
    at M = 1, 2 and 4 take the compile-time instances; parameters past the
    shared memory, or more (mixture, 4-dim block) owners than the 256
    threads, take the device instance."""
    n, d, m, em = PLAN_CASES[case]
    lim = gfk.SMEM_LIMIT
    p = gfk.gmm_fit_plan(n, d, m, em=em)
    fixed = 4 * gfk._param_floats(m, d)
    dq, v = gfk._row_stride(d), (m if em else 1)
    if case.startswith("device"):
        assert p == ("device", "device", "device", 0, 0, 0, 0)
        assert fixed > lim or -(-m // 4) * ((d + 3) // 4) > gfk.THREADS
        return
    assert p.instance == (f"d39m{m}" if d == 39 else "generic") and p.params == "shared"
    assert dq % 4 == 0 and (dq // 4) % 2 == 1 and d <= dq < d + 8
    if p.frames == "shared":
        assert case.startswith(("staged", "d39m1", "generic, even", "no frames"))
        assert (p.cap, p.tile, p.stages) == (n, 0, 0) and p.smem == fixed + 4 * n * (dq + v)
        return
    ring = 4 * (p.stages * p.tile * dq + 2 * p.tile * v)
    assert p.cap < n and 2 <= p.stages <= gfk.MAX_STAGES and 1 <= p.tile <= gfk.TILE
    assert p.smem == fixed + max(4 * p.cap * (dq + v), ring) <= lim
    assert lim < fixed + 4 * (p.cap + 1) * (dq + v)  # cap is all that fits
    assert (p.tile < gfk.TILE) == case.endswith("halved")
    if d == 39:
        assert (p.tile, p.stages) == (256, 4) and 950 < p.cap < 1200
        assert (gfk.gmm_fit_plan(n, d, m, em=False).cap > p.cap) == em


def test_param_floats():
    """The parameter area: two buffers of weights ([M, Dq] twice and M
    constants), means, their start and variances, weights and logs, cluster 0's
    variances, and the groups' partials (2 M Dq + M rounded to 4 a group:
    at D = 39 10 owners of 25 groups each; 32 groups at most; one where
    the owners pass the 256 threads)."""
    assert gfk._row_stride(39) == 44 and gfk._row_stride(40) == 44 and gfk._row_stride(5) == 12
    assert gfk._param_floats(4, 39) == 2 * (2 * 4 * 44 + 4) + 3 * 156 + 2 * 4 + 40 + 25 * 356
    assert gfk._param_floats(1, 39) == 2 * (2 * 44 + 4) + 3 * 40 + 2 * 4 + 40 + 25 * 92
    assert gfk._param_floats(8, 13) == (2 * (2 * 8 * 20 + 8) + 3 * 104 + 2 * 8 + 16
                                        + 32 * 328)
    assert gfk._param_floats(2, 3000) == (2 * (2 * 2 * 3004 + 4) + 3 * 6000 + 2 * 4 + 3000
                                         + 12020)


def _no_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(build, "load_library", refuse)


def _args(kernel, bad):
    x, masks = (torch.from_numpy(a) for a in state_masks(29, n=40, d=5, f=2))
    if kernel == "K24":
        args = dict(x=x, masks=masks, centroids0=torch.zeros((2, 2, 5)), k=2,
                    init_assign=torch.zeros((2, 40), dtype=torch.int64))
    else:
        args = dict(x=x, masks=masks, means0=torch.zeros((2, 2, 5)),
                    variances0=torch.ones((2, 2, 5)), weights0=torch.full((2, 2), 0.5))
    if bad == "dtype":
        args["x"] = x.double()
    elif bad == "rank":
        args["masks"] = masks[0]
    elif bad == "no fit":
        args = {k_: v[:0] if k_ != "x" and torch.is_tensor(v) else v for k_, v in args.items()}
    elif bad == "device":
        args["masks"] = torch.empty(masks.shape, dtype=torch.bool, device="meta")
    elif bad == "mask dtype":
        args["masks"] = masks.to(torch.uint8)
    elif bad == "shape":
        args["centroids0" if kernel == "K24" else "weights0"] = torch.zeros((2, 3))
    elif bad == "draws":
        if kernel == "K24":
            args["init_assign"] = args["init_assign"].int()
        else:
            args["variances0"] = torch.ones((2, 2, 4))
    elif bad == "iterations":
        args["max_iters"] = -1
    elif bad == "shared frame":
        args["masks"] = masks.clone()
        args["masks"][1, 0] = args["masks"][0, 0] = True
        args["disjoint"] = True
    return args


@pytest.mark.parametrize("kernel", ["K24", "K25"])
@pytest.mark.parametrize("bad", [None, "dtype", "rank", "no fit", "device", "mask dtype",
                                 "shape", "draws", "iterations", "shared frame"])
def test_wrappers_gate_on_the_device_and_refuse_bad_inputs(kernel, bad, monkeypatch):
    _no_library(monkeypatch)
    wrapper = tkm.kmeans_batch if kernel == "K24" else tem.em_fit_batch
    args = _args(kernel, bad)
    before = wrapper.launches
    if bad is None:
        wrapper(**args)  # CPU tensors: the plain version, no library
    else:
        with pytest.raises(ValueError):
            wrapper(**args)
    assert wrapper.launches == before


def test_callers_route_through_the_wrappers(monkeypatch):
    """``kmeans_batch`` / ``em_fit_batch`` are K24's and K25's wrappers;
    ``kmeans``, ``em_fit`` and ``fit_gmm_state`` reach them."""
    assert tiso.kmeans_batch is tkm.kmeans_batch and tiso.em_fit_batch is tem.em_fit_batch
    x, masks = (torch.from_numpy(a) for a in state_masks(30, n=60, d=4, f=2))
    seen = []
    for mod, name in ((tkm, "kmeans_batch"), (tem, "em_fit_batch"), (tiso, "kmeans_batch"),
                      (tiso, "em_fit_batch")):
        def spy(*a, _real=getattr(mod, name), _tag=f"{mod.__name__[29:]}.{name}", **kw):
            seen.append(_tag)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    tiso.fit_gmm_state(x, masks[0], x[masks[0]].mean(0), 2, hmm_cfg=HMMConfig(n_mix=2))
    tkm.kmeans(x, masks[1], x[:2].clone(), 2, torch.zeros(60, dtype=torch.int64))
    tem.em_fit(x, masks[1], x[:2].clone(), torch.ones((2, 4)), torch.full((2,), 0.5))
    assert seen == ["train.isolated.kmeans_batch", "train.isolated.em_fit_batch",
                    "train.kmeans.kmeans_batch", "train.em.em_fit_batch"]


def test_gmm_fit_work():
    """The bound model: two staged EM fits of 100 and 50 frames, 3 and 5
    iterations, D = 4, M = 2; then the same fits read from device memory;
    then K24's launch over a 200-frame buffer."""
    n_b, ops, sfu = gmm_fit_work([100, 50], 4, 2, [3, 5], staged=True, n=200)
    steps = 100 * 3 + 50 * 5
    assert ops == steps * (2 * 2 * 9 + 4 * 2 * 4 + 2) and sfu == steps * 5
    assert n_b == 4 * 4 * 150 + 2 * 200 + 8 * 2 * (2 * 2 * 4 + 2) + 4 * 2
    n_dev = gmm_fit_work([100, 50], 4, 2, [3, 5], staged=False, n=200)[0]
    assert n_dev - n_b == 4 * 4 * (steps - 150)
    kb, kops, ksfu = gmm_fit_work([100, 50], 4, 2, [3, 5], n=200, kmeans=True)
    assert ksfu == 0.0
    assert kops == steps * (2 * 2 * 9 + 3 * 4 + 1) + 150 * (3 * 4 + 1) + (100 + 150) * 2 * 2 * 9
    assert kb == 4 * 4 * 200 + 2 * 200 + 4 * 2 * (3 * 2 * 4 + 2) + 16 * 2 * 200


def test_gmm_fit_work_counts_a_hard_assignment():
    """K24's statistics add a frame's x and x^2 to its one cluster, 3 D + 1
    operations, in each iteration and in the initial assignment's pass;
    K25's dense responsibilities cost 4 M D + M.  At D = 39, M = 4 a
    (frame, iteration) is 632 + 118 = 750 operations for K24 and 632 +
    628 = 1,260 for K25."""
    dist = 2 * 4 * (2 * 39 + 1)
    assert dist == 632
    one = gmm_fit_work([1], 39, 4, [1], n=1, kmeans=True)[1]
    assert one == dist + 2 * (3 * 39 + 1)
    ten = gmm_fit_work([1], 39, 4, [10], n=1, kmeans=True)[1]
    assert ten - one == 9 * 750
    em = gmm_fit_work([1], 39, 4, [10], n=1)[1] - gmm_fit_work([1], 39, 4, [1], n=1)[1]
    assert em == 9 * 1260


def test_scratch_takes_one_row_a_frame_where_fits_are_disjoint():
    """The launch's scratch: N rows where no frame is in two fits, else
    F N; the compact frame rows only where a fit may pass ``cap``, the
    per-frame values and parameter areas only on the device tier."""
    cpu = torch.device("cpu")
    plan = gfk.gmm_fit_plan(50, 5, 2, em=True)
    idx, frames, vals, params = gfk._scratch(plan, 3, 50, 2, 2, 5, True, cpu)
    assert idx.numel() == 50 and frames.numel() == vals.numel() == params.numel() == 1
    ring = gfk.gmm_fit_plan(8404, 39, 4, em=True)
    idx, frames, vals, params = gfk._scratch(ring, 3, 8404, 4, 4, 39, False, cpu)
    assert idx.numel() == 3 * 8404 and frames.numel() == 3 * 8404 * 44
    assert vals.numel() == params.numel() == 1
    dev = gfk.gmm_fit_plan(50, 3000, 2, em=True)
    idx, frames, vals, params = gfk._scratch(dev, 3, 50, 2, 2, 3000, True, cpu)
    assert idx.numel() == 50 and frames.numel() == 50 * 3004 and vals.numel() == 100
    assert params.numel() == 3 * gfk._param_floats(2, 3000)


def test_gmm_fit_floor():
    """The serial floor: a pass over a staged fit is a tile's steps less
    the ring's wait and an iteration's end, at ``STEP_CYCLES``; the fit of
    most passes sets it (K24: one more, the initial assignment's); a
    streamed fit takes its 256-frame tiles' steps or its rows' refills at
    one SM's bulk-copy rate, the larger."""
    from speech_recognition_tpu_torch.utils.roofline import (
        GMM_ITER_STEPS,
        GMM_TILE_STEPS,
        SM_BULK_BYTES_PER_CYCLE,
        SM_CLOCK_HZ,
        STEP_CYCLES,
        gmm_fit_floor,
    )

    def cyc(steps):
        return sum(n * STEP_CYCLES[k] for k, n in steps.items())

    tile, end = cyc(GMM_TILE_STEPS), cyc(GMM_ITER_STEPS)
    staged = tile - STEP_CYCLES["smem"] + end
    # digit 0's second split level: 5 fits, the slowest EM fit 100 iterations
    sizes = [134, 216, 236, 219, 112]
    got = gmm_fit_floor(sizes, [16, 76, 32, 100, 36], 39, 4, True)
    assert got == pytest.approx(100 * staged / SM_CLOCK_HZ)
    got = gmm_fit_floor(sizes, [12, 19, 11, 9, 6], 39, 4, True, kmeans=True)
    assert got == pytest.approx(20 * staged / SM_CLOCK_HZ)
    # the planted fits: 8,000 frames streamed (32 tiles), two staged
    ring = max(32 * tile, 8000 * 176 / SM_BULK_BYTES_PER_CYCLE) + end
    got = gmm_fit_floor([8000, 300, 40], [2, 2, 2], 39, 4, [False, True, True])
    assert got == pytest.approx(2 * ring / SM_CLOCK_HZ)
    # a 3,000-frame fit: 12 tiles, the rest staged and short
    one = gmm_fit_floor([3000, 200], [30, 30], 39, 4, [False, True])
    assert one == pytest.approx(30 * (max(12 * tile, 3000 * 176 / SM_BULK_BYTES_PER_CYCLE)
                                      + end) / SM_CLOCK_HZ)
    assert gmm_fit_floor([3000], [30], 39, 4, True) < one


# the kernels' order of summation, emulated (tests/k24_k25_fit.py): fits of
# fit_hmm's shape (a word's 5 states, staged) and one of 3,000 frames (past
# cap: 12 tiles of the ring), planted mixtures of 4 at D = 39
EMU_CASES = {"fit_hmm shape": (260, 240, 300, 180, 220), "3,000-frame fit": (3000,)}


def _emu_case(case):
    x, masks, c0, init = (t.numpy() for t in planted_fits(60, EMU_CASES[case],
                                                          torch.device("cpu")))
    plans = {em: gfk.gmm_fit_plan(x.shape[0], 39, 4, em=em) for em in (False, True)}
    ring = {em: dict(cap=p.cap, tile=p.tile or gfk.TILE) for em, p in plans.items()}
    assert (max(EMU_CASES[case]) > plans[True].cap) == (case != "fit_hmm shape")
    return x, masks, c0, init, ring


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_order_is_as_accurate_as_the_plain_version(case):
    """One iteration of K24 and of K25 in the kernels' order against the
    plain version run in float64: the emulation's largest difference in the
    centroids, means, variances and weights at most GMM_AS_ACCURATE times
    the float32 plain version's (blocks of 32 frames summed plainly, the
    blocks with Kahan's compensation, the groups in order: the accuracy of
    a short sum over thousands of frames); assignments and counts equal."""
    x, masks, c0, init, ring = _emu_case(case)
    xt = torch.from_numpy(x)
    for i, mask in enumerate(masks):
        mt, ct, it_ = torch.from_numpy(mask), torch.from_numpy(c0[i]), torch.from_numpy(init[i])
        got = emu.kmeans_fit(x, mask, c0[i], 4, init[i], max_iters=1, **ring[False])
        f32 = tkm.kmeans_ref(xt, mt, ct, 4, it_, max_iters=1)
        f64 = tkm.kmeans_ref(xt.double(), mt, ct.double(), 4, it_, max_iters=1)
        assert np.array_equal(got[0], f64[0].numpy()) and np.array_equal(got[3], f64[3].numpy())
        for j in (1, 2):
            err, plain = (float(np.abs(np.asarray(a, np.float64) - f64[j].numpy()).max())
                          for a in (got[j], f32[j].numpy()))
            assert err <= GMM_AS_ACCURATE * max(plain, 1e-7), (i, j, err, plain)
        w0 = f32[3] / mt.sum().float()
        args = (f32[1], f32[2], w0)
        got = emu.em_fit(x, mask, *(a.numpy() for a in args), max_iters=1, **ring[True])
        f32 = tem.em_fit_ref(xt, mt, *args, max_iters=1)
        f64 = tem.em_fit_ref(xt.double(), mt, *(a.double() for a in args), max_iters=1)
        for j in (0, 1, 2):
            err, plain = (float(np.abs(np.asarray(a, np.float64) - f64[j].numpy()).max())
                          for a in (got[j], f32[j].numpy()))
            assert err <= GMM_AS_ACCURATE * max(plain, 1e-7), (i, j, err, plain)


def _near_ties_only(x, got, want, centroids, variances):
    """Fail unless every frame assigned otherwise is at a near-tie: its
    two least NLLs under the final clusters (float64) within 1e-4 of
    each other, relatively (as ``chip_smoke.py`` 6d takes them)."""
    diff = np.flatnonzero(got != want)
    if diff.size:
        mu, var = (np.asarray(a, np.float64) for a in (centroids, variances))
        nll = 0.5 * ((x[diff, None, :] - mu[None]) ** 2 / var[None] + np.log(var)[None]).sum(2)
        top = np.sort(nll, axis=1)[:, :2]
        assert bool(((top[:, 1] - top[:, 0]) <= 1e-4 * np.abs(top[:, 0])).all()), diff


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_emulated_fits_match_jax(case):
    """Whole fits in the kernels' order against the JAX package: K24
    against ``train/kmeans.kmeans`` (its draws from the key replayed) with
    the same assignment of every frame of the buffer away from near-ties,
    K25 against ``train/em.em_fit`` from the same start with the same
    iteration count; the parameters at TOL."""
    x, masks, c0, init, ring = _emu_case(case)
    for i, mask in enumerate(masks):
        key = jax.random.PRNGKey(70 + i)
        draws = np.asarray(jax.random.randint(key, (x.shape[0],), 0, 4))
        want = jkm.kmeans(key, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(c0[i]), 4)
        got = emu.kmeans_fit(x, mask, c0[i], 4, draws, **ring[False])
        assert got[4] >= 2
        _near_ties_only(x, got[0], np.asarray(want[0]), want[1], want[2])
        for a, b in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)
        w0 = np.asarray(want[3]) / np.float32(mask.sum())
        start = (np.asarray(want[1]), np.asarray(want[2]), w0)
        want = jem.em_fit(jnp.asarray(x), jnp.asarray(mask), *(jnp.asarray(a) for a in start))
        got = emu.em_fit(x, mask, *start, **ring[True])
        assert got[3] == int(want[3]) and got[3] >= 2
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_emulated_em_keeps_the_plain_mean_of_a_component_of_no_weight():
    """A component far from every frame gets no responsibility, so EM
    clamps its denominator at 1e-10: in the kernels' order (sums about the
    start means) its mean and variance are still the plain version's (r x
    / den, floored), one iteration and whole fits."""
    x, masks, c0, init, ring = _emu_case("fit_hmm shape")
    xt = torch.from_numpy(x)
    mask = masks[0]
    mt = torch.from_numpy(mask)
    _, m0, v0, counts = tkm.kmeans_ref(xt, mt, torch.from_numpy(c0[0]), 4,
                                       torch.from_numpy(init[0]))
    m0[3] = 50.0
    w0 = counts / mt.sum().float()
    for iters in (1, 100):
        got = emu.em_fit(x, mask, m0.numpy(), v0.numpy(), w0.numpy(), max_iters=iters,
                         **ring[True])
        want = tem.em_fit_ref(xt, mt, m0, v0, w0, max_iters=iters)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a, b.numpy(), **TOL)
    assert float(np.abs(got[0][3]).max()) == 0.0 and float(got[2][3]) == 0.0

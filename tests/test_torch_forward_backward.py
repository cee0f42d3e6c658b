"""Port vs reference: the log-space forward-backward, dense
(``forward_backward``, kernel K16's plain version) and banded
(``forward_backward_banded``, kernel K15's plain version), on CPU tensors.

The same float32 inputs, made with numpy, go through the JAX functions
(one utterance at a time, with x64 off) and through the port's batched
functions.  Tolerances: log Z at rtol 1e-5, gamma at atol 1e-5, xi at
rtol 1e-5 / atol 1e-5 (float32 logsumexps summed in other orders: the
sums over the ``from`` axis are reductions of up to ~60 terms); against
the brute-force path enumeration (float64) at JAX's own 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models.graph import build_loop_graph, build_word_graph
from speech_recognition_tpu.models.lexgraph import build_lex_graph
from speech_recognition_tpu.ops.viterbi_banded import banded_arrays as jbanded_arrays
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.utils.numerics import POS_INF
from tests.test_forward_backward import brute_force, brute_force_eps
from tests.test_lextree_decode import ltr as lex_ltr
from tests.test_lextree_decode import unit_emissions

jfb, tfb = (importlib.import_module(f"{pkg}.ops.forward_backward")
            for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch"))

Z_TOL = dict(rtol=1e-5)
G_TOL = dict(atol=1e-5)
XI_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def ltr(rng, s, skip=True):
    t = np.full((s, s), POS_INF, np.float32)
    for i in range(s):
        t[i, i] = rng.uniform(0.1, 1)
        if i + 1 < s:
            t[i + 1, i] = rng.uniform(0.1, 1)
        if skip and i + 2 < s:
            t[i + 2, i] = rng.uniform(0.5, 2)
    return t


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def jax_dense(nll, trans, init, nf, eps=None, depth=1, end=None, xi_mode="dense"):
    """The JAX dense pass over each item: numpy ``(gamma, xi, log_z)``."""
    out = []
    for i in range(nll.shape[0]):
        kw = {} if end is None else {"end_scores": jnp.asarray(end[i] if end.ndim == 2 else end)}
        r = jfb.forward_backward(
            jnp.asarray(nll[i]), jnp.asarray(trans[i] if trans.ndim == 3 else trans),
            jnp.asarray(init[i] if init.ndim == 2 else init), jnp.int32(nf[i]),
            eps_trans=None if eps is None else jnp.asarray(eps[i] if eps.ndim == 3 else eps),
            eps_depth=depth, xi_mode=xi_mode, **kw)
        out.append((np.asarray(r.gamma), np.asarray(r.xi_sum), float(r.log_z)))
    return [np.stack([o[k] for o in out]) for k in range(3)]


def check_dense(nll, trans, init, nf, eps=None, depth=1, end=None, xi_mode="dense"):
    want = jax_dense(nll, trans, init, nf, eps, depth, end, xi_mode)
    got = tfb.forward_backward(t32(nll), t32(trans), t32(init), torch.as_tensor(nf),
                               None if eps is None else t32(eps), depth,
                               None if end is None else t32(end), xi_mode)
    np.testing.assert_allclose(got.log_z.numpy(), want[2], **Z_TOL)
    np.testing.assert_allclose(got.gamma.numpy(), want[0], **G_TOL)
    np.testing.assert_allclose(got.xi_sum.numpy(), want[1], **XI_TOL)
    return got


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("xi_mode", ["dense", "band"])
def test_dense_matches_reference_and_brute_force(seed, xi_mode):
    """JAX's brute-force cases (T = 5, S = 3, end mass on the last state)."""
    rng = np.random.default_rng(seed)
    t_len, s = 5, 3
    nll = rng.uniform(0.2, 2.0, (1, t_len, s)).astype(np.float32)
    trans = ltr(rng, s, skip=False)
    init = np.full((s,), POS_INF, np.float32)
    init[0] = 0.0
    end = np.full((s,), -1e30, np.float32)
    end[s - 1] = 0.0
    got = check_dense(nll, trans, init, [t_len], end=end, xi_mode=xi_mode)
    ref_z, ref_gamma, ref_xi = brute_force(nll[0].astype(np.float64), trans, init,
                                           np.where(end > -1e29, end, -np.inf))
    np.testing.assert_allclose(float(got.log_z[0]), ref_z, rtol=1e-4)
    np.testing.assert_allclose(got.gamma[0].numpy(), ref_gamma, atol=1e-4)
    if xi_mode == "dense":
        np.testing.assert_allclose(got.xi_sum[0].numpy(), ref_xi, atol=1e-4)


@pytest.mark.parametrize("xi_mode", ["dense", "band"])
def test_dense_masked_frames_and_batch(rng, xi_mode):
    """A batch of lengths T, 5, 1 and 0 with per-item matrices: frames
    past n_frames are frozen, gamma is 0 there; each item equals JAX's."""
    b, t_len, s = 4, 8, 3
    nll = rng.uniform(0.2, 2.0, (b, t_len, s)).astype(np.float32)
    trans = np.stack([ltr(rng, s) for _ in range(b)])
    init = np.full((b, s), POS_INF, np.float32)
    init[:, 0] = 0.0
    nf = np.array([t_len, 5, 1, 0], np.int32)
    got = check_dense(nll, trans, init, nf, xi_mode=xi_mode)
    assert not got.gamma[1, 5:].any() and not got.gamma[3].any()
    assert not got.xi_sum[2:].any()
    full = check_dense(nll[1:2, :5], trans[1:2], init[1:2], [5], xi_mode=xi_mode)
    np.testing.assert_allclose(full.log_z.numpy(), got.log_z[1:2].numpy(), rtol=1e-6)
    np.testing.assert_allclose(full.gamma[0].numpy(), got.gamma[1, :5].numpy(), atol=1e-6)


def test_dense_with_epsilon_matches_brute_force(rng):
    """Two 2-state words joined by an eps edge (JAX's brute-force case);
    JAX's pass also at eps depth 2 (a second pass re-adds the hop, so
    only depth 1 is a path sum)."""
    s, t_len = 4, 4
    nll = rng.uniform(0.2, 1.5, (1, t_len, s)).astype(np.float32)
    trans = np.full((s, s), POS_INF, np.float32)
    for i in (0, 2):
        trans[i, i] = 0.4
        trans[i + 1, i] = 0.6
        trans[i + 1, i + 1] = 0.4
    eps = np.full((s, s), POS_INF, np.float32)
    eps[2, 1] = 0.3
    init = np.asarray([0.0, POS_INF, POS_INF, POS_INF], np.float32)
    end = np.full((s,), -1e30, np.float32)
    end[3] = 0.0
    for depth in (1, 2):
        got = check_dense(nll, trans, init, [t_len], eps=eps, depth=depth, end=end)
    ref_z = brute_force_eps(nll[0].astype(np.float64), trans, eps, init, end, 1)
    got = check_dense(nll, trans, init, [t_len], eps=eps, depth=1, end=end)
    np.testing.assert_allclose(float(got.log_z[0]), ref_z, rtol=1e-4)


@pytest.mark.parametrize("xi_mode", ["dense", "band"])
def test_dense_on_word_graph(rng, xi_mode):
    """A transcript graph of three 4-state words (skips, eps edges), full
    and masked lengths, uniform end scores (the default)."""
    g = build_word_graph([ltr(rng, 4) for _ in range(3)], [[0], [2], [1]])
    t_len = 21
    nll = rng.uniform(0, 3, (2, t_len, g.n_states)).astype(np.float32)
    check_dense(nll, np.asarray(g.trans), np.asarray(g.init_cost), [t_len, 11],
                eps=np.asarray(g.eps_trans), depth=g.eps_depth, xi_mode=xi_mode)


def port_graph(jbg):
    """A JAX ``BandedGraph`` as the port's, on the CPU."""
    return BandedGraph(*[None if x is None else torch.as_tensor(np.array(x)) for x in jbg])


def check_banded(jbg, nll, nf, depth=1, end=None, per_item=False):
    """The port's batched banded pass (shared graph, or the graph stacked
    per item) against JAX's per utterance."""
    want = []
    for i in range(nll.shape[0]):
        kw = {} if end is None else {"end_scores": jnp.asarray(end)}
        r = jfb.forward_backward_banded(jnp.asarray(nll[i]), jbg, jnp.int32(nf[i]),
                                        eps_depth=depth, **kw)
        want.append(r)
    g = port_graph(jbg)
    if per_item:
        b = nll.shape[0]
        g = BandedGraph(*[None if x is None else x.expand((b,) + tuple(x.shape)).clone()
                          for x in g])
    got = tfb.forward_backward_banded(t32(nll), g, torch.as_tensor(nf), depth,
                                      None if end is None else t32(end))
    np.testing.assert_allclose(got.log_z.numpy(), [float(r.log_z) for r in want], **Z_TOL)
    np.testing.assert_allclose(got.gamma.numpy(), np.stack([np.asarray(r.gamma) for r in want]),
                               **G_TOL)
    np.testing.assert_allclose(got.xi_sum.numpy(),
                               np.stack([np.asarray(r.xi_sum) for r in want]), **XI_TOL)
    if want[0].xi_cross is None:
        assert got.xi_cross is None
    else:
        np.testing.assert_allclose(got.xi_cross.numpy(),
                                   np.stack([np.asarray(r.xi_cross) for r in want]), **XI_TOL)
    return got


@pytest.mark.parametrize("kind", ["sausage", "linear", "loop"])
@pytest.mark.parametrize("per_item", [False, True])
def test_banded_on_word_graphs(rng, kind, per_item):
    """JAX's banded word-graph cases, lengths T, 13, 1 and 0 in one batch."""
    mats = [ltr(rng, 5) for _ in range(4)]
    g = {"sausage": lambda: build_word_graph(mats, [list(range(4))] * 3),
         "linear": lambda: build_word_graph(mats, [[2], [0], [3]]),
         "loop": lambda: build_loop_graph(mats)}[kind]()
    t_len = 23
    nll = rng.uniform(0, 3, (4, t_len, g.n_states)).astype(np.float32)
    got = check_banded(jbanded_arrays(g), nll, np.array([t_len, 13, 1, 0], np.int32),
                       per_item=per_item)
    assert not got.gamma[3].any() and not got.xi_sum[2:].any()


def test_banded_eps_depth_2(rng):
    """A sausage of 1-state and 3-state words: eps chains through the
    1-state words need a second eps pass."""
    mats = [ltr(rng, 1), ltr(rng, 3), ltr(rng, 1)]
    g = build_word_graph(mats, [[0, 1, 2]] * 3)
    assert g.eps_depth >= 2
    t_len = 15
    nll = rng.uniform(0, 3, (3, t_len, g.n_states)).astype(np.float32)
    end = np.full((g.n_states,), -np.inf, np.float32)
    end[np.asarray(g.end_states)] = -np.asarray(g.end_bonus)
    check_banded(jbanded_arrays(g), nll, np.array([t_len, 9, 1], np.int32),
                 depth=g.eps_depth, end=end)


def test_banded_on_lexgraph_with_cross_edges(rng):
    """A lexical tree (cross edges parent end -> child start) with the
    terminal mass on the word ends (-inf elsewhere, as confidence uses)."""
    words = ["ab", "abc", "ad", "b", "ba"]
    units = sorted(set("".join(words)))
    unit_trans = [lex_ltr(3, rng) for _ in units]
    lexg = build_lex_graph(words, unit_trans, {ch: i for i, ch in enumerate(units)},
                           word_insertion_cost=0.3)
    jbg = lexg.banded
    t_len = 19
    e, _ = unit_emissions(rng, t_len, unit_trans)
    nll = np.stack([e[:, np.asarray(jbg.bank_state)], e[::-1][:, np.asarray(jbg.bank_state)],
                    e[:, np.asarray(jbg.bank_state)]])
    end = np.full((lexg.n_states,), -np.inf, np.float32)
    end[np.asarray(jbg.end_states)] = 0.0
    got = check_banded(jbg, nll, np.array([t_len, t_len, 9], np.int32), end=end)
    assert got.xi_cross is not None and float(got.xi_cross.sum()) > 0


def test_cross_inverse_and_end_positions():
    """The host-built inverse index lists each origin's real cross edges
    in ascending order; end positions keep the last duplicate."""
    src = torch.tensor([0, 0, 3, 0, 1, 3])
    cost = torch.tensor([POS_INF, 0.5, 0.1, 0.2, POS_INF, 0.3])
    off, dst = tfb.cross_inverse(src, cost)
    assert off.tolist() == [0, 2, 2, 2, 4, 4, 4]
    assert dst[:4].tolist() == [1, 3, 2, 5]
    ends = torch.tensor([[4, 0, 2, 0], [1, 1, 3, 0]])
    assert tfb.end_positions(ends, 5).tolist() == [[3, -1, 2, -1, 0], [3, 1, -1, 2, -1]]


def test_cuda_tensors_never_take_the_plain_version():
    """The public functions route CPU tensors to the plain versions; the
    kernel wrappers refuse anything else than a CUDA tensor at launch."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk

    nll = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fk._nll_checks(nll, torch.tensor([2]))
    before = (fk.fb_dense.launches, fk.fb_banded.launches)
    tfb.forward_backward(nll, torch.zeros((3, 3)), torch.zeros(3), torch.tensor([2]))
    assert (fk.fb_dense.launches, fk.fb_banded.launches) == before


# the kernels' shared-memory layouts (csrc/forward_backward.cu
# banded_smem_floats / dense_smem_floats), in bytes, and an H100's room;
# with the rows in device memory (rows_smem 0), the block scratch alone
def _banded_bytes(s, r, l, ring, rows_smem):
    m = max(r, l)
    if not rows_smem:
        return 4 * 64
    return 4 * ((((64 + m + 8 * s + 1) & ~1) + 24 * m) if ring else 64 + m + 2 * s)


def _dense_bytes(s, use_eps, cap, lists_smem, ring, rows_smem):
    if not rows_smem:
        return 4 * 64
    rows = (64 + (3 + 3 * ring) * s + 1) & ~1
    return 4 * (rows + lists_smem * (1 + use_eps) * (((s + 2) & ~1) + 2 * cap))


H100_SMEM = 227 * 1024
H100_SMS = 132


@pytest.mark.parametrize("kernel, shape, want", [
    ("K15", (385, 77, 77), ("none", 0, 20280, True)),   # the sausage
    ("K15", (9588, 1000, 1000), ("none", 0, 80960, False)),  # the 1k trie: no ring
    ("K15", (30000, 10, 10), ("none", 0, 256, False, "device")),  # rows in device memory
    # the soft-EM graphs, 419 items: lists sized so 7 CTAs share an SM
    ("K16", (75, True, 419), ("shared", 1849, 32248, True)),
    ("K16", (200, False, 8), ("shared", 28323, 232448, True)),  # rows past 28,323 entries: dense loop
    ("K16", (170, True, 8), ("shared", 14171, 232448, True)),   # the 34-word loop
    ("K16", (20000, False, 1), ("device", 320000, 256, False, "device")),  # device rows
    ("K16", (5000, True, 1), ("device", 80000, 120256, True)),  # lists in device memory
])
def test_fb_plans_pick_tiers_and_refuse_past_shared_memory(kernel, shape, want):
    """``banded_plan`` sizes K15's scan CTA; ``dense_plan`` gives K16's
    finite-entry lists the shared memory left when the 2B scan CTAs share
    the SMs (device memory where that is too little); both stage the
    emission rows in a ring where it fits; a graph whose alpha / beta rows
    alone do not fit takes the device-row tier (nothing is refused)."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk

    if kernel == "K15":
        plan = lambda: fk.banded_plan(*shape, _banded_bytes, H100_SMEM)  # noqa: E731
    else:
        plan = lambda: fk.dense_plan(*shape, H100_SMS, _dense_bytes, H100_SMEM)  # noqa: E731
    p = plan()
    assert (p.lists, p.cap, p.smem, p.ring, p.rows) == (want + ("shared",))[:5] \
        and p.smem <= H100_SMEM
    per = -(-shape[0] // 224)
    assert p.threads == -(-(-(-shape[0] // per)) // 32) * 32 <= 224


@pytest.mark.parametrize("kernel", ["K15", "K16"])
def test_fb_plans_take_any_size(kernel):
    """Neither plan refuses a size: past the rows' room in shared memory
    (K15 ~29,000 states, K16 ~19,000) both take the device-row tier (the
    block scratch alone in shared memory, no ring; K16's lists in device
    memory with min(S^2, 16 S) entries), and below it the plans are
    the shared-memory tiers they were."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk

    tiers = set()
    for s in (1, 385, 18000, 19500, 28000, 29500, 30000, 60000, 100000):
        if kernel == "K15":
            for r, l in ((1, 1), (300, 300), (6000, 6000), (3, s)):
                p = fk.banded_plan(s, r, l, _banded_bytes, H100_SMEM)
                shared = _banded_bytes(s, r, l, 0, 1) <= H100_SMEM
                assert p.rows == ("shared" if shared else "device") and p.smem <= H100_SMEM
                assert p.ring or not shared or _banded_bytes(s, r, l, 1, 1) > H100_SMEM
                tiers.add(p.rows)
        else:
            for use_eps in (False, True):
                for b in (1, 419):
                    p = fk.dense_plan(s, use_eps, b, H100_SMS, _dense_bytes, H100_SMEM)
                    shared = _dense_bytes(s, use_eps, 0, 0, 0, 1) <= H100_SMEM
                    assert p.rows == ("shared" if shared else "device")
                    assert p.smem <= H100_SMEM and p.cap >= 1
                    if not shared:
                        assert (p.lists, p.cap, p.ring, p.smem) == (
                            "device", min(s * s, 16 * s), False, 4 * 64)
                    tiers.add(p.rows)
    assert tiers == {"shared", "device"}

"""The forward-backward kernels' layout on the CPU, through the emulation
in ``tests/fb_split.py`` (no card needed).

* K16's finite-entry logsumexp equals, bit for bit, the dense loop it
  replaced (a serial ascending-index max pass and sum pass) on padded
  transcript graphs with silence (every LSE of whole forward and backward
  scans), an ergodic matrix, rows with no finite entry, a fully
  unreachable x, x holding -inf, and lists cut short by their capacity.
* The split layout (forward and backward scans, then the combine pass
  summing xi over ascending frames) matches the plain versions and the
  JAX functions on the same numpy inputs, with n_frames 0, 1 and T, at
  the kernels' tolerances: log Z rtol 1e-5, gamma atol 1e-4, xi rtol
  1e-4 / atol 1e-3 (float32 sums in other orders).
* The list builder equals the dense matrices' finite entries, and the
  plans refuse no graph the layouts before the split took.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops.viterbi_banded import BandedGraph as JBandedGraph
from speech_recognition_tpu.ops.viterbi_banded import banded_arrays as jbanded_arrays
from speech_recognition_tpu_torch.models.graph import (
    build_loop_graph,
    build_word_graph,
    pad_graphs,
    pad_graphs_banded,
    transcript_graph,
)
from speech_recognition_tpu_torch.models.hmm import uniform_left_to_right_trans
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from tests import fb_split as em
from tests.test_torch_forward_backward import jax_dense, ltr, port_graph, t32

jfb, tfb = (importlib.import_module(f"{pkg}.ops.forward_backward")
            for pkg in ("speech_recognition_tpu", "speech_recognition_tpu_torch"))

Z_RTOL = 1e-5
G_ATOL = 1e-4
XI_TOL = dict(rtol=1e-4, atol=1e-3)
POS_INF = em.POS_INF


@pytest.fixture(autouse=True)
def jax_f32():
    with jax.enable_x64(False):
        yield


def transcripts(rng, b, sil=True):
    trans = [uniform_left_to_right_trans(5) for _ in range(12)]
    return [transcript_graph(trans, [int(x) for x in rng.integers(0, 11, rng.integers(1, 5))],
                             sil=11 if sil else None) for _ in range(b)]


def close(got, want, xi_tol=XI_TOL):
    """``(gamma, xi, log_z)`` numpy / torch triples at the kernels'
    tolerances."""
    g, x, z = (np.asarray(v) for v in got)
    wg, wx, wz = (np.asarray(v) for v in want)
    np.testing.assert_allclose(z, wz, rtol=Z_RTOL)
    np.testing.assert_allclose(g, wg, rtol=0, atol=G_ATOL)
    np.testing.assert_allclose(x, wx, **xi_tol)


# ---- the lists -----------------------------------------------------------------

@pytest.mark.parametrize("cols", [False, True])
@pytest.mark.parametrize("cap", [None, 7])
def test_list_builder_matches_the_dense_matrix(cols, cap):
    """Each row's (column's) list holds its finite entries in ascending
    order with their scores; rows past the capacity hold none."""
    rng = np.random.default_rng(3)
    s = 9
    cost = np.where(rng.random((s, s)) < 0.3, rng.uniform(0, 5, (s, s)), POS_INF)
    cost[4] = POS_INF  # a row with no finite entry
    cost = torch.from_numpy(cost.astype(np.float32))
    cap = s * s if cap is None else cap
    off, idx, sc = em.build_lists(cost, cols, cap)
    m = (cost.t() if cols else cost).numpy()
    assert off.tolist() == [0] + np.cumsum((m < POS_INF / 2).sum(1)).tolist()
    for i in range(s):
        if off[i + 1] > cap:
            continue
        js = np.flatnonzero(m[i] < POS_INF / 2)
        assert idx[off[i]:off[i + 1]].tolist() == js.tolist()
        assert np.array_equal(sc[off[i]:off[i + 1]].numpy(), -m[i, js])
    if cap == 7:
        assert int(off[-1]) > cap  # some rows run the dense loop


# ---- the finite-entry LSE, bit for bit -----------------------------------------

def test_fin_lse_equals_the_dense_loop_on_transcript_scans():
    """Every LSE of the forward and backward scans of padded transcript
    graphs with silence arcs (per-item matrices, eps passes, unreachable
    padding states, lengths T, 1 and 0), at full and at cut capacity."""
    rng = np.random.default_rng(4)
    gb, depth = pad_graphs(transcripts(rng, 5))
    g = {k: torch.as_tensor(gb[k]) for k in ("trans", "eps_trans", "init_cost", "end_scores")}
    s = g["trans"].shape[-1]
    nll = torch.from_numpy(rng.uniform(40, 60, (5, 30, s)).astype(np.float32))
    nf = [30, 1, 0, 17, 25]
    for cap in (None, 24):
        stats = {}
        em.dense_split(nll, g["trans"], g["init_cost"], nf, g["eps_trans"], depth,
                       g["end_scores"], cap=cap, check=True, stats=stats)
        assert stats["sum"] > 0 and stats["max"] > 0, stats
        if cap is not None:
            assert stats["dense"] > 0, stats


@pytest.mark.parametrize("case", ["ergodic", "no finite entry", "unreachable x", "-inf in x",
                                  "huge x", "mixed"])
@pytest.mark.parametrize("cols", [False, True])
def test_fin_lse_equals_the_dense_loop(case, cols):
    """One LSE over hand-made matrices and vectors: every branch of the
    rule, and the dense loop where it cannot decide."""
    rng = np.random.default_rng(5)
    s = 40
    cost = np.where(rng.random((s, s)) < 0.08, rng.uniform(0, 5, (s, s)), POS_INF)
    x = rng.uniform(-3e3, -1e3, s)
    if case == "ergodic":
        cost = rng.uniform(0, 5, (s, s))
    elif case == "no finite entry":
        cost[::3] = POS_INF
        cost[:, ::3] = POS_INF
    elif case == "unreachable x":
        x = np.where(rng.random(s) < 0.5, -1e30, -2e30)
    elif case == "-inf in x":
        x[rng.random(s) < 0.5] = -np.inf
        x[:4] = -1e30
    elif case == "huge x":
        x[3] = 8e29  # pulls fl(NEG_INF + max x) above -5e29: the dense loop decides
    else:
        x = np.where(rng.random(s) < 0.3, -1e30, x)
        x[5] = -np.inf
    cost = torch.from_numpy(cost.astype(np.float32))
    x = torch.from_numpy(x.astype(np.float32))
    stats = {}
    got = em.fin_lse(em.build_lists(cost, cols, s * s), cost, x, cols, s * s, stats)
    assert torch.equal(got, em.dense_lse(cost, x, cols)), stats
    if case == "ergodic":
        assert stats["sum"] == s
    if case == "huge x":
        assert stats["dense"] > 0
    if case in ("no finite entry", "unreachable x"):
        assert stats["max"] > 0


# ---- the split layout against the plain versions and JAX -----------------------

@pytest.mark.parametrize("xi_mode", ["band", "dense"])
def test_dense_split_matches_plain_and_jax(xi_mode):
    """K16's layout on padded transcript graphs with lengths T, 1, 0 and
    mixed, against ``forward_backward_plain`` and the JAX pass."""
    rng = np.random.default_rng(6)
    gb, depth = pad_graphs(transcripts(rng, 4))
    s = gb["trans"].shape[-1]
    t_len = 24
    nll = rng.uniform(0, 3, (4, t_len, s)).astype(np.float32)
    nf = np.array([t_len, 1, 0, 13], np.int32)
    args = [gb["trans"], gb["init_cost"], nf, gb["eps_trans"], depth, gb["end_scores"]]
    got = em.dense_split(t32(nll), t32(gb["trans"]), t32(gb["init_cost"]), nf,
                         t32(gb["eps_trans"]), depth, t32(gb["end_scores"]), xi_mode)
    plain = tfb.forward_backward_plain(t32(nll), t32(gb["trans"]), t32(gb["init_cost"]),
                                       torch.as_tensor(nf), t32(gb["eps_trans"]), depth,
                                       t32(gb["end_scores"]), xi_mode)
    close(got, (plain.gamma, plain.xi_sum, plain.log_z))
    want = jax_dense(nll, *args[:2], nf, eps=args[3], depth=depth, end=args[5], xi_mode=xi_mode)
    close(got, want)
    assert not got[0][2].any() and not got[0][1, 1:].any() and not got[1][1:3].any()


def test_dense_split_on_an_ergodic_hmm():
    """Every matrix entry finite: the lists are the whole matrix."""
    rng = np.random.default_rng(7)
    s, t_len = 12, 20
    trans = rng.uniform(0.5, 4, (s, s)).astype(np.float32)
    init = rng.uniform(0, 2, s).astype(np.float32)
    nll = rng.uniform(0, 3, (3, t_len, s)).astype(np.float32)
    nf = np.array([t_len, 1, 0], np.int32)
    for xi_mode in ("band", "dense"):
        got = em.dense_split(t32(nll), t32(trans), t32(init), nf, xi_mode=xi_mode, check=True)
        close(got, jax_dense(nll, trans, init, nf, xi_mode=xi_mode))


def _jax_banded_items(gb, b):
    """The per-item JAX ``BandedGraph`` of a padded banded dict."""
    return [JBandedGraph(*[jnp.asarray(gb[k][i]) for k in (
        "band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos", "is_start")],
        end_states=jnp.zeros(1, jnp.int32), end_bonus=jnp.zeros(1, jnp.float32),
        bank_state=jnp.asarray(gb["bank_state"][i])) for i in range(b)]


def _jax_banded(nll, graphs, nf, depth, end):
    out = []
    for i in range(nll.shape[0]):
        kw = {} if end is None else {"end_scores": jnp.asarray(end[i] if end.ndim == 2 else end)}
        r = jfb.forward_backward_banded(jnp.asarray(nll[i]), graphs[i], jnp.int32(nf[i]),
                                        eps_depth=depth, **kw)
        out.append(r)
    return out


@pytest.mark.parametrize("graph", ["sausage", "eps depth 2", "padded transcripts", "lexgraph"])
def test_banded_split_matches_plain_and_jax(graph):
    """K15's layout (thread-per-row eps sums, the combine over ascending
    frames) on a sausage, 1-state words (eps depth 2), padded per-item
    transcript graphs and a lexical tree with cross edges and -inf end
    scores, lengths T, 1, 0 and mixed."""
    from speech_recognition_tpu.models.lexgraph import build_lex_graph
    from tests.test_lextree_decode import ltr as lex_ltr

    rng = np.random.default_rng(8)
    t_len, end, depth, per_item = 21, None, 1, False
    if graph == "sausage":
        jg = jbanded_arrays(build_word_graph([ltr(rng, 4) for _ in range(3)],
                                             [[0, 1, 2]] * 3))
    elif graph == "eps depth 2":
        wg = build_word_graph([ltr(rng, 1), ltr(rng, 3), ltr(rng, 1)], [[0, 1, 2]] * 3)
        jg, depth = jbanded_arrays(wg), wg.eps_depth
        assert depth >= 2
    elif graph == "padded transcripts":
        gb, depth = pad_graphs_banded(transcripts(rng, 4))
        end = gb["end_scores"]
        per_item = True
    else:
        words = ["ab", "abc", "ad", "b", "ba"]
        units = sorted(set("".join(words)))
        lexg = build_lex_graph(words, [lex_ltr(3, rng) for _ in units],
                               {ch: i for i, ch in enumerate(units)}, word_insertion_cost=0.3)
        jg = lexg.banded
        end = np.full((lexg.n_states,), -np.inf, np.float32)
        end[np.asarray(jg.end_states)] = 0.0
    if per_item:
        s = gb["band"].shape[-1]
        g = BandedGraph(*[torch.as_tensor(gb[k]) for k in (
            "band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos",
            "is_start")], end_states=None, end_bonus=None, bank_state=None)
        jgs = _jax_banded_items(gb, 4)
    else:
        g = port_graph(jg)
        s = g.band.shape[-1]
        jgs = [jg] * 4
    nll = rng.uniform(0, 3, (4, t_len, s)).astype(np.float32)
    nf = np.array([t_len, 1, 0, 12], np.int32)
    end_t = None if end is None else t32(end)
    got = em.banded_split(t32(nll), g, nf, depth, end_t)
    plain = tfb.forward_backward_banded_plain(t32(nll), g, torch.as_tensor(nf), depth, end_t)
    close(got[:3], (plain.gamma, plain.xi_sum, plain.log_z))
    want = _jax_banded(nll, jgs, nf, depth, end)
    close(got[:3], [np.stack([np.asarray(getattr(r, k)) for r in want])
                    for k in ("gamma", "xi_sum", "log_z")])
    if graph == "lexgraph":
        np.testing.assert_allclose(got[3].numpy(), plain.xi_cross.numpy(), **XI_TOL)
        np.testing.assert_allclose(got[3].numpy(),
                                   np.stack([np.asarray(r.xi_cross) for r in want]), **XI_TOL)
        assert float(got[3].sum()) > 0
    assert not got[0][2].any() and not got[0][1, 1:].any() and not got[1][1:3].any()


def test_banded_split_takes_wide_spans_serially():
    """A loop graph whose eps rows span more than FB_WIDE_SPAN ends (the
    kernel gives such rows a warp; summed here serially): same answer at
    the tolerances."""
    rng = np.random.default_rng(9)
    lg = build_loop_graph([uniform_left_to_right_trans(2) for _ in range(70)])
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    g = banded_arrays(lg)
    lo, hi = em.spans(g.eps_block, False)
    assert int((hi - lo).max()) > em.WIDE_SPAN
    nll = torch.from_numpy(rng.uniform(0, 3, (2, 12, lg.n_states)).astype(np.float32))
    nf = np.array([12, 7], np.int32)
    got = em.banded_split(nll, g, nf)
    plain = tfb.forward_backward_banded_plain(nll, g, torch.as_tensor(nf))
    close(got[:3], (plain.gamma, plain.xi_sum, plain.log_z))


# ---- the plans refuse nothing the earlier layouts took -------------------------

def _parent_banded_fits(s, r, l, limit):
    return 4 * (64 + r + l + 2 * s) <= limit


def _parent_dense_fits(s, limit):
    return 4 * (64 + 3 * s) <= limit


@pytest.mark.parametrize("kernel", ["K15", "K16"])
def test_plans_refuse_no_graph_the_earlier_layouts_took(kernel):
    """The layouts before the split (rows, eps vectors and nothing else
    in shared memory at their smallest) against the plans, over state
    counts up to the limit and eps blocks of many shapes."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fk
    from tests.test_torch_forward_backward import H100_SMEM, H100_SMS, _banded_bytes, _dense_bytes

    checked = 0
    for s in list(range(1, 400, 7)) + list(range(18000, 29100, 97)):
        if kernel == "K15":
            for r, l in ((1, 1), (10, 10), (77, 77), (8, 1000), (1000, 8), (s, s), (3, s)):
                if _parent_banded_fits(s, r, l, H100_SMEM):
                    fk.banded_plan(s, r, l, _banded_bytes, H100_SMEM)
                    checked += 1
        elif _parent_dense_fits(s, H100_SMEM):
            for use_eps in (False, True):
                for b in (1, 419, 5632):
                    p = fk.dense_plan(s, use_eps, b, H100_SMS, _dense_bytes, H100_SMEM)
                    assert p.smem <= H100_SMEM and p.cap >= 1
                    checked += 1
    assert checked > 100

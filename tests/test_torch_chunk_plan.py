"""Host-side parts of the streaming chunk kernels K17 and K18: the banded
DP's plan tiers (the warp form for small graphs, the four-warp form above
``BANDED_WARP_MAX_STATES``), the warp form's byte model, the launch
tables a ``BandedTopo`` keeps per device, and the per-push buffers of
``StreamingDecoder``.  CPU only: the kernels themselves are held to
their plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` 5c)."""

import numpy as np
import pytest
import torch

from speech_recognition_tpu_torch.data.lexicon import bench_lexicon
from speech_recognition_tpu_torch.data.synthetic import random_gmm_hmm
from speech_recognition_tpu_torch.decode.streaming import StreamingDecoder
from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph
from speech_recognition_tpu_torch.models.hmm import HMMBank
from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
from speech_recognition_tpu_torch.ops.gmm import augment_dtb
from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

LIMIT = 227 * 1024  # the H100's shared memory per CTA
N_SM = 132


def _r16(n):
    return -(-n // 16) * 16


def _bank(n_states, n_models=11, seed=0):
    rng = np.random.default_rng(seed)
    ps = [random_gmm_hmm(rng, n_states=n_states, n_mix=2, dim=6, sep=3.0)
          for _ in range(n_models)]
    return HMMBank.from_numpy(
        np.stack([p["means"] for p in ps]), np.log(np.stack([p["variances"] for p in ps])),
        np.log(np.stack([p["weights"] for p in ps])),
        np.stack([to_cost_matrix(p["trans"]) for p in ps]))


def _trans(bank, n=None):
    n = bank.n_models if n is None else n
    return [bank.trans_cost[i % bank.n_models].numpy() for i in range(n)]


def _graph(kind):
    """``(WordGraph, BandedGraph)``: the CLI's 55-state loop, loops of
    other sizes, the 385-state and 1-state sausages."""
    if kind == "loop":
        graph = build_loop_graph(_trans(_bank(5)), word_insertion_cost=0.5)
    elif kind.startswith("loop "):
        graph = build_loop_graph(_trans(_bank(5), int(kind.split()[1])),
                                 word_insertion_cost=0.5)
    elif kind == "sausage7":
        graph = build_word_graph(_trans(_bank(5)), [list(range(11))] * 7)
    else:  # the 1-state sausage
        graph = build_word_graph(_trans(_bank(1)), [list(range(11))] * 7)
    return graph, banded_arrays(graph)


# ---------------------------------------------------------------------------
# the plan tiers
# ---------------------------------------------------------------------------


def test_plan_picks_the_warp_form_for_the_cli_loop():
    """The CLI's 55-state loop at 256 streams takes the warp form (one
    warp a stream, two states a lane, its frontier in registers), in
    every mode the stream path and the monolithic K1 run."""
    _, g = _graph("loop")
    assert g.n_states == 55 <= vk.BANDED_WARP_MAX_STATES
    for mode in ("fused", "fused_chunk", "fused_chunk_org", "general_chunk"):
        plan = vk.banded_plan(256, N_SM, g.n_states, g.n_words, g.n_ends, 55, mode, LIMIT)
        assert plan.form == "warp" and plan.per == 2 and plan.frontier == "registers"
        assert plan.kf == 0 and not plan.tables and plan.smem <= LIMIT
        assert -(-256 // plan.tile) <= N_SM


def test_plan_keeps_the_four_warp_form_for_the_sausage():
    """The 385-state sausage (K1's, K10's and K8's PERF.md shapes) keeps
    the four-warp form, and K10's word-trace mode keeps it at any size."""
    _, g = _graph("sausage7")
    assert g.n_states == 385 > vk.BANDED_WARP_MAX_STATES
    for mode in ("fused", "fused_chunk", "general", "wordtrace"):
        plan = vk.banded_plan(512, N_SM, g.n_states, g.n_words, g.n_ends, 55, mode, LIMIT)
        assert plan.form == "four" and plan.per == 0
    _, g = _graph("loop")
    plan = vk.banded_plan(256, N_SM, g.n_states, g.n_words, g.n_ends, 55, "wordtrace", LIMIT)
    assert plan.form == "four"
    with pytest.raises(ValueError, match="warp form"):
        vk.banded_plan(256, N_SM, g.n_states, g.n_words, g.n_ends, 55, "wordtrace", LIMIT,
                       form="warp")


@pytest.mark.parametrize("s", [25, 64, 65, 128, 129, 256])
def test_warp_form_states_per_lane(s):
    """States a lane: the fewest of 2, 4, 8 that hold the graph; past 256
    states, 32 words or 32 word ends the warp form refuses and the auto
    plan takes the four-warp form."""
    plan = vk.banded_plan(256, N_SM, s, 8, 8, 55, "fused_chunk", LIMIT, form="warp")
    assert plan.per == next(k for k in (2, 4, 8) if 32 * k >= s)
    auto = vk.banded_plan(256, N_SM, s, 8, 8, 55, "fused_chunk", LIMIT)
    assert auto.form == ("warp" if s <= vk.BANDED_WARP_MAX_STATES else "four")
    for s_, r, l in ((257, 8, 8), (s, 33, 8), (s, 8, 33)):
        with pytest.raises(ValueError, match="warp form"):
            vk.banded_plan(256, N_SM, s_, r, l, 55, "fused_chunk", LIMIT, form="warp")
        assert vk.banded_plan(256, N_SM, s_, r, l, 55, "fused_chunk", LIMIT).form == "four"


@pytest.mark.parametrize("b", [1, 7, 130, 256, 512, 4000])
def test_warp_tile_rule(b):
    """Warps per CTA: the fewest of 2, 4, 8 that keep the grid within one
    CTA per SM (8 past that), so a stream count off the tile leaves
    padding warps in the last CTA."""
    plan = vk.banded_plan(b, N_SM, 55, 11, 11, 55, "fused_chunk", LIMIT, form="warp")
    assert plan.tile == next((t for t in (2, 4, 8) if -(-b // t) <= N_SM), 8)


def test_warp_form_byte_model():
    """The warp form's shared memory, per warp: the emission ring of 8
    frames of U floats and the eps pass's 32-entry snapshot rows (the
    ends' costs, the starts' costs, K1's eps_prev entries, the ends'
    ancestors with the map); the frontier and the tables are in
    registers, nothing is staged."""
    u = 55
    ring = _r16(4 * 8 * u)
    for mode, rows in (("general", 2), ("general_chunk", 2), ("fused", 3), ("fused_chunk", 3),
                       ("fused_chunk_org", 4), ("general_chunk_org", 3)):
        for tile in (1, 2, 8):
            assert vk.banded_warp_smem_bytes(mode, u, tile) == tile * (ring + 128 * rows)
    plan = vk.banded_plan(256, N_SM, 55, 11, 11, u, "fused_chunk_org", LIMIT)
    assert plan.work == ring + 128 * 4 and not plan.tables and plan.kf == 0
    assert plan.smem == vk.banded_warp_smem_bytes("fused_chunk_org", u, plan.tile)


@pytest.mark.parametrize("u,tile", [(55, 2), (2000, 2), (4000, 1), (20000, 0)])
def test_warp_plan_fits_the_emission_rings(u, tile):
    """The warps' emission rings of a large bank take fewer warps per CTA
    where 2 do not fit; where one warp's ring alone passes the shared
    memory the plan takes the four-warp form (no size is refused)."""
    if tile:
        plan = vk.banded_plan(256, N_SM, 55, 11, 11, u, "general_chunk", LIMIT)
        assert plan.form == "warp" and plan.tile == tile and plan.smem <= LIMIT
        return
    with pytest.raises(ValueError, match="warp form"):
        vk.banded_plan(256, N_SM, 55, 11, 11, u, "general_chunk", LIMIT, form="warp")
    assert vk.banded_plan(256, N_SM, 55, 11, 11, u, "general_chunk", LIMIT).form == "four"


# ---------------------------------------------------------------------------
# the launch tables a topo keeps per device
# ---------------------------------------------------------------------------


def _old_tables(g):
    """What the DP's wrapper built on every call before the tables were
    kept on the topo."""
    band4 = torch.empty((g.n_states, 4), dtype=torch.float32)
    band4[:, :3] = g.band.T
    band4[:, 3] = g.bank_state.to(torch.int32).contiguous().view(torch.float32)
    lo, hi = vk.eps_row_spans(g)
    return {"band4": band4, "starts": g.word_starts.to(torch.int32), "lo": lo, "hi": hi,
            "ends": g.word_ends.to(torch.int32), "eps_t": g.eps_block.T.contiguous()}


@pytest.mark.parametrize("kind", ["loop", "sausage7", "1-state", "loop 40", "loop 32"])
def test_launch_tables_equal_the_per_call_build(kind):
    """The cached tables built on CPU tensors are what the old per-call
    code built, bit for bit; the row spans equal ``BandedTopo.row_spans``
    too; a second launch gets the same dict."""
    _, g = _graph(kind)
    topo = vk.banded_topology(g)
    tabs = vk.launch_tables(g, topo, g.band.device)
    want = _old_tables(g)
    for k, v in want.items():
        assert tabs[k].dtype == v.dtype and torch.equal(tabs[k], v), k
    lo, hi = topo.row_spans(g.n_words)
    assert np.array_equal(tabs["lo"].numpy(), lo) and np.array_equal(tabs["hi"].numpy(), hi)
    assert tabs["warp_ok"] == (g.n_words <= 32 and g.n_ends <= 32)
    assert tabs["eps_t"].is_contiguous() and tabs["eps_t"].shape == (g.n_ends, g.n_words)
    assert vk.launch_tables(g, topo, g.band.device) is tabs
    assert topo.on_device["cpu"] is tabs


def test_each_topo_keeps_its_own_tables():
    """Two graphs of one shape with different costs, each with its own
    topo, get their own tables (no cache is shared between topos)."""
    _, g = _graph("loop")
    g2 = g._replace(band=g.band + 1.0, eps_block=g.eps_block * 2.0)
    t1, t2 = vk.banded_topology(g), vk.banded_topology(g2)
    assert t1.on_device is not t2.on_device
    a = vk.launch_tables(g, t1, "cpu")
    b = vk.launch_tables(g2, t2, "cpu")
    assert torch.equal(a["band4"][:, :3], g.band.T)
    assert torch.equal(b["band4"][:, :3], g2.band.T)
    assert not torch.equal(a["eps_t"], b["eps_t"])
    assert vk.launch_tables(g, t1, "cpu") is a


def test_launch_tables_follow_the_graph_tensors():
    """A topo handed the same graph moved again (new tensors) or changed
    in place rebuilds its tables instead of raising or reusing stale
    ones."""
    _, g = _graph("loop")
    topo = vk.banded_topology(g)
    a = vk.launch_tables(g, topo, "cpu")
    moved = g.to("cpu")._replace(band=g.band.clone())
    b = vk.launch_tables(moved, topo, "cpu")
    assert b is not a and torch.equal(b["band4"], a["band4"])
    moved.eps_block.mul_(2.0)  # in place: the tensor's version moves on
    c = vk.launch_tables(moved, topo, "cpu")
    assert c is not b and torch.equal(c["eps_t"], moved.eps_block.T)


@pytest.mark.parametrize("kind", ["loop", "loop 32", "1-state3"])
def test_warp_tables(kind):
    """The warp form's tables: per state its word-end slot + 1 in the low
    16 bits and its word-start row + 1 above; per row its eps entries over
    the row's finite span, +inf elsewhere and past L, so the first
    minimum over all 32 entries is the plain scan's over the span."""
    if kind == "1-state3":
        graph = build_word_graph(_trans(_bank(1), 10), [list(range(10))] * 3)
        g = banded_arrays(graph)
    else:
        _, g = _graph(kind)
    tabs = vk.launch_tables(g, vk.banded_topology(g), "cpu")
    assert tabs["warp_ok"]
    info = tabs["info"].numpy()
    ends, starts = g.word_ends.numpy(), g.word_starts.numpy()
    want = np.zeros(g.n_states, np.int64)
    want[ends] += np.arange(1, g.n_ends + 1)
    want[starts] += np.arange(1, g.n_words + 1) << 16
    assert np.array_equal(info, want)
    lo, hi = tabs["lo"].numpy(), tabs["hi"].numpy()
    eps = g.eps_block.numpy()
    em = tabs["eps_m"].numpy()
    assert em.shape == (g.n_words, 32)
    rng = np.random.default_rng(len(kind))
    for r in range(g.n_words):
        assert np.array_equal(em[r, lo[r]:hi[r]], eps[r, lo[r]:hi[r]])
        assert np.isinf(np.r_[em[r, :lo[r]], em[r, hi[r]:]]).all()
        ends_cost = rng.uniform(0, 50, 32).astype(np.float32)
        ends_cost[g.n_ends:] = 0.0
        full = em[r] + ends_cost
        span = eps[r, lo[r]:hi[r]] + ends_cost[lo[r]:hi[r]]
        if len(span):
            assert int(np.argmin(full)) == lo[r] + int(np.argmin(span))
            assert full.min() == span.min()


def test_warp_tables_refuse_large_graphs():
    """More than 32 words: no warp tables, and the plan keeps the four-warp
    form."""
    _, g = _graph("1-state")
    tabs = vk.launch_tables(g, vk.banded_topology(g), "cpu")
    assert not tabs["warp_ok"] and "info" not in tabs


def test_launch_tables_refuse_a_graph_of_another_size():
    """A topo used with a graph of another size raises, here and in the
    wrappers' checks."""
    _, g = _graph("loop")
    _, other = _graph("loop 12")
    topo = vk.banded_topology(g)
    with pytest.raises(ValueError, match="topology/graph mismatch"):
        vk.launch_tables(other, topo, "cpu")
    with pytest.raises(ValueError, match="topology/graph mismatch"):
        vk.viterbi_banded_chunk_ref(torch.zeros((55, 3, 2)), other, topo,
                                    torch.zeros((other.n_states, 2)),
                                    torch.zeros(2, dtype=torch.int32), True, False, "general")


def test_launch_tables_check_the_graph_devices_once():
    """Building the tables checks every graph tensor's device (here: a
    meta tensor among CPU ones)."""
    _, g = _graph("loop")
    bad = g._replace(eps_block=g.eps_block.to("meta"))
    with pytest.raises(ValueError, match="eps_block is on meta"):
        vk.launch_tables(bad, vk.banded_topology(g), torch.device("cpu"))


def test_lex_graph_checks_run_once_per_topo():
    """K4 / K6 / K18's graph checks: once per topo, device and graph
    tensors; another graph with this topo is checked again (and refused
    where it is not the topo's)."""
    words, trans, ids, _ = bench_lexicon()
    g = build_lex_graph(words[:40], trans, ids).banded
    topo = lk.lex_topology(g)
    lk._check_graph(g, topo, torch.device("cpu"), "test")
    assert topo.on_device[("checked", "cpu")]
    lk._check_graph(g, topo, torch.device("cpu"), "test")
    other = build_lex_graph(words[:41], trans, ids).banded
    with pytest.raises(ValueError, match="LexTopo"):
        lk._check_graph(other, topo, torch.device("cpu"), "test")


# ---------------------------------------------------------------------------
# the decoder's per-push buffers
# ---------------------------------------------------------------------------


def test_augment_into_a_buffer_equals_augment_dtb():
    """``augment_dtb(x, out=)`` writes the ``[x^2, x]`` rows of a buffer
    whose last row holds the ones, bit for bit as the allocating form."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 7, 6))
                         .astype(np.float32))
    out = torch.full((13, 7, 5), float("nan"))
    out[12].fill_(1.0)
    got = augment_dtb(x, out=out)
    assert got is out and torch.equal(got, augment_dtb(x))


def test_decoder_reuses_its_k13_input_buffer():
    """The fused route's K13 input: one buffer per chunk width, refilled
    every push (its contents are the push's own features)."""
    bank = _bank(5)
    graph = build_loop_graph(_trans(bank), word_insertion_cost=0.5)
    dec = StreamingDecoder(bank, graph, chunk_frames=8, batch=3)
    assert dec.mode == "fused"
    rng = np.random.default_rng(1)
    x1 = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    x2 = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    a = dec._augmented(x1)
    assert torch.equal(a, augment_dtb(x1))
    b = dec._augmented(x2)
    assert b is a and torch.equal(b, augment_dtb(x2))
    c = dec._augmented(x2[:, :5].contiguous())
    assert c is not a and torch.equal(c, augment_dtb(x2[:, :5]))
    nv = np.array([8, 3, 0], np.int32)
    assert torch.equal(dec._n_valid_on_device(nv), torch.from_numpy(nv))

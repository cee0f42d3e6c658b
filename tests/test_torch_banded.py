"""Port vs reference: graph composition, banded arrays, and the plain
versions of kernels K1 (fused emission + banded Viterbi forward) and
K2 (value backtrace).

The reference kernels run as the JAX suite runs them on the CPU: the
Pallas kernels in interpret mode.  K1's final costs are compared at
rtol 1e-5 (the emission GEMMs sum in different orders); its planes and
K2's outputs must be equal below each utterance's length.  K2 is fed
the SAME planes on both sides, so its comparison is exact.
"""

import functools
import importlib
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.ops.gmm import augment_dtb, gmm_emission_weights
from speech_recognition_tpu.ops.viterbi_banded_pallas import (
    banded_backtrace_tb_pallas,
    banded_topology as j_banded_topology,
    viterbi_banded_tb_pallas,
)
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
    banded_backtrace_val,
    banded_backtrace_val_ref,
    banded_topology,
    use_kernels,
    viterbi_banded_fused,
    viterbi_banded_fused_ref,
)
from tests.test_torch_gmm_hmm import bank_params, both_banks

# the reference ``ops`` package exports a function named like this module
jvb = importlib.import_module("speech_recognition_tpu.ops.viterbi_banded")


def random_lm(seed, n):
    """A bigram-shaped namespace (cost / start_cost / end_cost) that
    makes the eps block non-row-constant."""
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(
        cost=rng.uniform(0.1, 3.0, (n, n)).astype(np.float32),
        start_cost=rng.uniform(0.1, 2.0, n).astype(np.float32),
        end_cost=rng.uniform(0.1, 2.0, n).astype(np.float32))


def build_graphs(kind, trans):
    """The same composed graph from both packages."""
    n = len(trans)
    if kind == "loop":
        kw = dict(word_insertion_cost=0.7)
        return jgraph.build_loop_graph(trans, **kw), tgraph.build_loop_graph(trans, **kw)
    if kind == "loop_lm":
        kw = dict(lm=random_lm(1, n), word_insertion_cost=0.3)
        return jgraph.build_loop_graph(trans, **kw), tgraph.build_loop_graph(trans, **kw)
    if kind == "sausage":
        layers = [list(range(n))] * 3
        return (jgraph.build_word_graph(trans, layers),
                tgraph.build_word_graph(trans, layers))
    if kind == "sausage_lm":
        layers = [list(range(n))] * 3
        kw = dict(lm=random_lm(2, n), word_insertion_cost=0.2, allow_early_exit=True)
        return (jgraph.build_word_graph(trans, layers, **kw),
                tgraph.build_word_graph(trans, layers, **kw))
    raise ValueError(kind)


GRAPH_KINDS = ["loop", "loop_lm", "sausage", "sausage_lm"]


@pytest.mark.parametrize("kind", GRAPH_KINDS + ["transcript"])
def test_graph_builders_and_banded_arrays_match(kind):
    trans = list(bank_params(0)[3])
    if kind == "transcript":
        layers = [[2], [0, 1], [3]]
        gj = jgraph.build_word_graph(trans, layers, optional_layers=[1],
                                     end_layers=[1, 2])
        gt = tgraph.build_word_graph(trans, layers, optional_layers=[1],
                                     end_layers=[1, 2])
    else:
        gj, gt = build_graphs(kind, trans)
    for f in ("trans", "eps_trans", "init_cost", "end_states", "end_bonus",
              "bank_state", "slot", "slot_label", "slot_layer", "state_in_word"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f), err_msg=f)
    assert gt.eps_depth == gj.eps_depth
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    for f in bt._fields:
        if getattr(bj, f) is None:  # cross edges: lexical trees only
            assert getattr(bt, f) is None, f
            continue
        np.testing.assert_array_equal(getattr(bt, f).numpy(), np.asarray(getattr(bj, f)),
                                      err_msg=f)
    assert tvb.eps_ranges(bt) == jvb.eps_ranges(bj)
    topo = banded_topology(bt)
    assert topo.uniform_w == j_banded_topology(bj).uniform_w
    assert topo.ranges == j_banded_topology(bj).ranges


CASES = {  # name -> (graph kind, batch, frames, n_frames)
    "b3_mixed_nf": ("loop", 3, 17, [17, 9, 1]),
    "b11_tile_tail": ("sausage", 11, 15, [15, 15, 14, 1, 7, 9, 15, 12, 3, 15, 2]),
    "lm_rows_b5": ("loop_lm", 5, 16, [16, 1, 11, 16, 6]),
    "sausage_lm_b6": ("sausage_lm", 6, 13, [13, 5, 13, 1, 10, 8]),
}


@functools.lru_cache(maxsize=None)
def k1_case(name):
    """Shared inputs and the reference Pallas outputs of one case."""
    kind, b, t, nf = CASES[name]
    jb, tb = both_banks(3, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs(kind, trans)
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    feats = np.random.default_rng(zlib.crc32(name.encode())).standard_normal(
        (b, t, 6)).astype(np.float32)
    nf = np.asarray(nf, np.int32)
    w, lw = gmm_emission_weights(*jb.flat_states())
    ref = viterbi_banded_tb_pallas(
        augment_dtb(jnp.asarray(feats)), bj, jnp.asarray(nf), j_banded_topology(bj),
        eps_depth=gj.eps_depth, input_ubt=True, emit_eps_prev=True,
        fuse_emission=True, bank_gemm=(w, lw), interpret=True)
    return dict(tb=tb, gt=gt, bj=bj, bt=bt, feats=feats, nf=nf,
                ref=[np.array(x) for x in ref])


def port_k1(c):
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb as t_augment
    from speech_recognition_tpu_torch.ops.gmm import gmm_emission_weights as t_weights

    w, lw = t_weights(*c["tb"].flat_states())
    out = viterbi_banded_fused_ref(t_augment(torch.from_numpy(c["feats"])), w, lw,
                                   c["bt"], banded_topology(c["bt"]),
                                   torch.from_numpy(c["nf"]))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_plain_matches_pallas_reference(name):
    c = k1_case(name)
    final, bp8, eps_u, eps_prev = port_k1(c)
    r_final, r_bp8, r_eps_u, r_eps_prev = c["ref"]
    assert bp8.dtype == np.int8 and eps_u.dtype == np.int8 and eps_prev.dtype == np.int32
    np.testing.assert_allclose(final, r_final, rtol=1e-5)
    for i, n in enumerate(c["nf"]):
        np.testing.assert_array_equal(bp8[:n, :, i], r_bp8[:n, :, i])
        np.testing.assert_array_equal(eps_u[:n, :, i], r_eps_u[:n, :, i])
        np.testing.assert_array_equal(eps_prev[:n, :, i], r_eps_prev[:n, :, i])


@pytest.mark.parametrize("name", sorted(CASES))
def test_k2_plain_matches_pallas_reference(name):
    c = k1_case(name)
    r_final, r_bp8, r_eps_u, r_eps_prev = c["ref"]
    bj = c["bj"]
    ends = np.asarray(bj.end_states)[np.argmin(r_final[np.asarray(bj.end_states)], axis=0)]
    s_j, f_j = banded_backtrace_tb_pallas(
        jnp.asarray(r_bp8), jnp.asarray(r_eps_u), bj, jnp.asarray(ends),
        jnp.asarray(c["nf"]), j_banded_topology(bj), eps_prev=jnp.asarray(r_eps_prev),
        interpret=True)
    s_t, f_t = banded_backtrace_val_ref(
        torch.from_numpy(r_bp8), torch.from_numpy(r_eps_prev), torch.from_numpy(ends),
        torch.from_numpy(c["nf"]), banded_topology(c["bt"]).uniform_w)
    assert s_t.dtype == torch.int32 and f_t.dtype == torch.bool
    for i, n in enumerate(c["nf"]):
        np.testing.assert_array_equal(s_t.numpy()[:n, i], np.asarray(s_j)[:n, i])
        np.testing.assert_array_equal(f_t.numpy()[:n, i], np.asarray(f_j)[:n, i])
    # the wrappers take the plain versions for CPU tensors
    assert not use_kernels(torch.from_numpy(r_bp8))
    before = banded_backtrace_val.launches
    s_w, f_w = banded_backtrace_val(
        torch.from_numpy(r_bp8), torch.from_numpy(r_eps_prev), torch.from_numpy(ends),
        torch.from_numpy(c["nf"]), banded_topology(c["bt"]).uniform_w)
    assert torch.equal(s_w, s_t) and torch.equal(f_w, f_t)
    assert banded_backtrace_val.launches == before


# (B, T, words, W): random planes whose walks change words often (an
# eps code at every word start with probability 1/2, and at t = 1), with
# B off a multiple of 16 and words longer than K2's 32-state window
K2_EDGE_CASES = {"b37_w5": (37, 40, 11, 5), "b1_w5": (1, 25, 11, 5),
                 "b36_w3": (36, 33, 20, 3), "b9_w40": (9, 30, 6, 40)}


@pytest.mark.parametrize("name", sorted(K2_EDGE_CASES))
def test_k2_plain_matches_pallas_reference_on_edge_planes(name):
    """The planes the card tests give K2 (``tests/test_torch_cuda.py``),
    through the reference's value backtrace (interpret mode) and K2's
    plain version: states and flags equal for t < nf, with nf = T, 0, 1
    and T + 2 side by side."""
    from tests.test_torch_cuda import _k2_planes

    b, t, r, w = K2_EDGE_CASES[name]
    bp8, eps_prev, end = _k2_planes(b + t, t, w, r, b, torch.device("cpu"))
    nf = np.r_[t, 0, 1, t + 2, np.random.default_rng(b).integers(0, t + 1, b)][:b]
    nf = nf.astype(np.int32)
    jb, _ = both_banks(3, n_models=r, n_states=w, n_mix=1, dim=2)
    gj = jgraph.build_loop_graph([np.asarray(jb.trans_cost[i]) for i in range(r)])
    bj = jvb.banded_arrays(gj)
    topo = j_banded_topology(bj)
    assert topo.uniform_w == w and gj.n_states == r * w
    s_j, f_j = banded_backtrace_tb_pallas(
        jnp.asarray(bp8.numpy()), jnp.zeros((t, r, b), jnp.int8), bj, jnp.asarray(end.numpy()),
        jnp.asarray(nf), topo, eps_prev=jnp.asarray(eps_prev.numpy()), interpret=True)
    s_t, f_t = banded_backtrace_val_ref(bp8, eps_prev, end, torch.from_numpy(nf), w)
    valid = np.arange(t)[:, None] < nf[None, :]
    np.testing.assert_array_equal(np.where(valid, s_t.numpy(), 0),
                                  np.where(valid, np.asarray(s_j), 0))
    np.testing.assert_array_equal(np.where(valid, f_t.numpy(), 0),
                                  np.where(valid, np.asarray(f_j), 0))


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_plain_oracles_match_reference_scan(kind):
    """viterbi_banded_tb / banded_backtrace_tb vs the reference XLA scan
    on identical emissions: bit-identical planes, states and flags."""
    jb, _ = both_banks(8, n_models=4, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    gj, gt = build_graphs(kind, trans)
    bj, bt = jvb.banded_arrays(gj), tvb.banded_arrays(gt)
    rng = np.random.default_rng(9)
    t, b = 14, 4
    nll = rng.uniform(0.0, 6.0, (t, gt.n_states, b)).astype(np.float32)
    nf = np.array([14, 1, 8, 13], np.int32)
    fj, pj, uj = jvb.viterbi_banded_tb(jnp.asarray(nll), bj, jnp.asarray(nf),
                                       eps_depth=gj.eps_depth)
    ft, pt, ut = tvb.viterbi_banded_tb(torch.from_numpy(nll), bt, torch.from_numpy(nf),
                                       eps_depth=gt.eps_depth)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    ends = np.asarray(bj.end_states)[np.argmin(np.asarray(fj)[np.asarray(bj.end_states)], 0)]
    sj, ej = jvb.banded_backtrace_tb(pj, uj, bj, jnp.asarray(ends), jnp.asarray(nf),
                                     eps_depth=gj.eps_depth)
    st, et = tvb.banded_backtrace_tb(pt, ut, bt, torch.from_numpy(ends),
                                     torch.from_numpy(nf), eps_depth=gt.eps_depth)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_fused_wrapper_cpu_path_and_guards():
    c = k1_case("b3_mixed_nf")
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb as t_augment
    from speech_recognition_tpu_torch.ops.gmm import gmm_emission_weights as t_weights

    w, lw = t_weights(*c["tb"].flat_states())
    xa = t_augment(torch.from_numpy(c["feats"]))
    nf = torch.from_numpy(c["nf"])
    before = viterbi_banded_fused.launches
    got = viterbi_banded_fused(xa, w, lw, c["bt"], banded_topology(c["bt"]), nf)
    want = viterbi_banded_fused_ref(xa, w, lw, c["bt"], banded_topology(c["bt"]), nf)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert viterbi_banded_fused.launches == before
    # a non-uniform graph (words of different lengths) is refused
    trans = [np.asarray(c["tb"].trans_cost[i].numpy()) for i in range(4)]
    trans[1] = trans[1][:2, :2]
    g = tvb.banded_arrays(tgraph.build_loop_graph(trans))
    topo = banded_topology(g)
    assert topo.uniform_w == 0 and not topo.fused_ok
    with pytest.raises(ValueError, match="uniform"):
        viterbi_banded_fused_ref(xa, w, lw, g, topo, nf)


LIMIT = 227 * 1024  # the H100's shared memory per CTA
# (B, S, R, L, U, mode) -> (streams per CTA, where the frontier lives,
# graph tables in shared memory, emission ring, frames staged): the main
# paths' shapes, each tier, no refusal
PLAN_CASES = {
    "k1_main_512": ((512, 385, 77, 77, 55, "fused"), (4, "shared", True, True, 8)),
    "k1_b130": ((130, 385, 77, 77, 55, "fused"), (1, "shared", True, True, 8)),
    "k1_b200": ((200, 385, 77, 77, 55, "fused"), (2, "shared", True, True, 8)),
    "k1_b5000": ((5000, 385, 77, 77, 55, "fused"), (4, "shared", True, True, 8)),
    "k8_1state_77": ((512, 77, 77, 77, 11, "general"), (4, "shared", True, True, 8)),
    "k8_mixed_336": ((512, 336, 77, 77, 66, "general"), (4, "shared", True, True, 8)),
    "k1_loop_7500_b5": ((5, 7500, 1500, 1500, 55, "fused"), (1, "shared", False, True, 2)),
    "k1_loop_7500_b512": ((512, 7500, 1500, 1500, 55, "fused"),
                          (4, "device", False, True, 1)),
    "k8_50000": ((512, 50000, 10000, 10000, 500, "general"), (4, "device", False, True, 0)),
    "big_bank_no_ring": ((512, 385, 77, 77, 20000, "fused"), (4, "shared", True, False, 8)),
    "k10_main_512": ((512, 385, 77, 77, 55, "wordtrace"), (4, "shared", True, True, 8)),
    "k10_loop_7500_b5": ((5, 7500, 1500, 1500, 55, "wordtrace"),
                         (1, "shared", False, True, 2)),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_banded_plan_tiers(name):
    """The DP kernel's launch plan (host-side, no card needed): streams per
    CTA by B, the frontier tier by size (each warp's work area in shared
    memory, else in device memory), the emission ring and the staged
    frames by what fits, and a plan at any size (S = 50,000 included)."""
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
        banded_plan,
        banded_smem_bytes,
        banded_work_bytes,
    )

    (b, s, r, l, u, mode), want = PLAN_CASES[name]
    plan = banded_plan(b, 132, s, r, l, u, mode, LIMIT)
    assert (plan.tile, plan.frontier, plan.tables, plan.ring, plan.kf) == want
    assert plan.smem <= LIMIT and plan.work == banded_work_bytes(mode, s, r, l)
    assert plan.smem == banded_smem_bytes(mode, u, s, r, l, plan.tile, plan.work_smem,
                                          plan.tables, plan.ring, plan.kf)
    assert -(-b // plan.tile) <= 132 or plan.tile == 4


@pytest.mark.parametrize("b", [512, 200])
def test_wordtrace_plan_puts_large_work_area_in_device_scratch(b):
    """K10's DP at 7,500 states (a 1,500-word loop of 5-state words): the
    work area (cost and entry-time frontiers) goes to the device scratch
    instead of being refused, as K1's does; the planes still stage."""
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
        banded_plan,
        banded_work_bytes,
    )

    s, r = 7500, 1500
    plan = banded_plan(b, 132, s, r, r, 55, "wordtrace", LIMIT)
    work = banded_work_bytes("wordtrace", s, r, r)
    assert work * plan.tile > LIMIT and not plan.work_smem and plan.frontier == "device"
    assert plan.kf > 0 and plan.ring and plan.smem <= LIMIT
    assert work > banded_work_bytes("fused", s, r, r)  # two tau rows replace the codes


# (S, R, L, tile): K10's byte model term by term
WT_BYTES_CASES = [(385, 77, 77, 4), (7, 1, 1, 1), (33, 11, 9, 2), (7500, 1500, 1500, 4),
                  (1, 1, 1, 3)]


@pytest.mark.parametrize("s,r,l,tile", WT_BYTES_CASES)
def test_wordtrace_byte_model_case_by_case(s, r, l, tile):
    """The word-trace mode's Python byte model (which the card tests hold
    equal to the kernel's): per stream four padded [S + 4] int32/f32
    rows (two cost, two entry-time), the word-end costs and taus and the
    rows' origins; per staged frame the eps_u and eps_tau rows and no
    bp8 rows; the CTA total with each placement switched on alone."""
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
        banded_smem_bytes,
        banded_stage_bytes,
        banded_table_bytes,
        banded_work_bytes,
    )

    def r16(n):
        return -(-n // 16) * 16

    work = 4 * r16(4 * (s + 4)) + 2 * r16(4 * l) + r16(4 * r)
    frame = 2 * r16(4 * r * tile)
    assert banded_work_bytes("wordtrace", s, r, l) == work
    assert banded_stage_bytes("wordtrace", s, r, tile) == frame
    assert banded_stage_bytes("fused", s, r, tile) == frame + r16(s * tile)
    ring, u = r16(4 * 4 * 55), 55
    assert banded_smem_bytes("wordtrace", u, s, r, l, tile, False, False, False, 0) == 0
    assert banded_smem_bytes("wordtrace", u, s, r, l, tile, True, False, False, 0) == \
        work * tile
    assert banded_smem_bytes("wordtrace", u, s, r, l, tile, False, True, False, 0) == \
        banded_table_bytes(s, r, l)
    assert banded_smem_bytes("wordtrace", u, s, r, l, tile, False, False, True, 0) == \
        ring * tile
    assert banded_smem_bytes("wordtrace", u, s, r, l, tile, False, False, False, 3) == \
        3 * 2 * frame
    with pytest.raises(ValueError, match="mode"):
        banded_work_bytes("tau", s, r, l)


@pytest.mark.parametrize("kind", GRAPH_KINDS + ["transcript"])
def test_eps_row_spans_match_topology(kind):
    """The DP's eps row spans, computed with tensor ops on the graph's
    device, equal the host topology's (empty rows (0, 0))."""
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import eps_row_spans

    trans = list(bank_params(3)[3])
    if kind == "transcript":
        g = tvb.banded_arrays(tgraph.build_word_graph(trans, [[2], [0, 1], [3]],
                                                      optional_layers=[1], end_layers=[1, 2]))
    else:
        g = tvb.banded_arrays(build_graphs(kind, trans)[1])
    lo, hi = eps_row_spans(g)
    want_lo, want_hi = banded_topology(g).row_spans(g.n_words)
    assert lo.dtype == hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(hi.numpy(), want_hi)


@pytest.mark.parametrize("u,warps", [(55, 7), (11, 4), (110, 7), (1, 4), (64, 8)])
def test_emission_launch_shape(u, warps):
    """K13's warps per CTA: the count of 4-8 whose passes over a tile's
    items (a pair of bank states and 8 columns) leave the fewest lanes
    idle; its shared memory (staged weights and log weights, two feature
    tiles) at the main path's shape fits two CTAs per SM."""
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
        _emission_smem,
        _emission_warps,
    )

    assert _emission_warps(u) == warps
    items = 8 * -(-u // 2)
    assert -(-items // (32 * warps)) * 32 * warps - items < 32 * 4
    a = 2 * 39 + 1
    assert _emission_smem(a, 55, 4, True) == 4 * (80 * 55 * 4 + 2 * a * 64)
    assert 2 * (_emission_smem(a, 55, 4, True) + 1024) <= 228 * 1024
    assert _emission_smem(a, 55, 4, False) == 4 * 2 * a * 64


@pytest.mark.parametrize("a, u, m, want", [
    (79, 55, 4, "staged"),     # the CLI's bank
    (79, 110, 8, "l1"),        # weights past shared memory: read through L1
    (450, 11, 1, "l1"),        # the widest the unchunked form takes (~453)
    (455, 1, 1, "chunked"),    # two [A][64] feature tiles past shared memory
    (512, 55, 4, "chunked"),
    (1024, 55, 4, "chunked"),
    (100000, 55, 4, "chunked"),
])
def test_emission_plan_takes_any_feature_width(a, u, m, want):
    """K13's plan never refuses a feature width: past the two feature
    tiles' room (A above ~450) it takes the chunked form, whose shared
    memory (two [64][64] chunks) does not grow with A."""
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
        _emission_smem,
        emission_plan,
    )

    limit = 227 * 1024
    assert emission_plan(a, u, m, limit) == want
    stage = {"l1": 0, "staged": 1, "chunked": 2}[want]
    assert _emission_smem(a, u, m, stage) <= limit
    assert _emission_smem(a, u, m, 2) == 4 * 2 * 64 * 64


@pytest.mark.parametrize("n_mix,n_states", [(2, 3), (4, 5), (11, 2)])
def test_bank_emission_plain_matches_reference(n_mix, n_states):
    """The emission kernel's plain version (K1's factored GMM GEMM +
    logsumexp) against the reference ``models/hmm.bank_nll_ubt`` on every
    frame below each stream's length, within rtol 1e-5; the wrapper runs
    it for a CPU tensor."""
    from speech_recognition_tpu.models.hmm import bank_nll_ubt as j_bank_nll_ubt
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb as t_augment
    from speech_recognition_tpu_torch.ops.gmm import gmm_emission_weights as t_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
        bank_emission,
        bank_emission_ref,
    )

    jb, tb = both_banks(5, n_models=4, n_states=n_states, n_mix=n_mix, dim=6)
    b, t = 5, 13
    rng = np.random.default_rng(n_mix)
    feats = rng.standard_normal((b, t, 6)).astype(np.float32)
    nf = np.array([13, 1, 0, 7, 12], np.int32)
    want = np.asarray(j_bank_nll_ubt(jb, jnp.asarray(feats), jnp.asarray(nf)))
    w, lw = t_weights(*tb.flat_states())
    xa = t_augment(torch.from_numpy(feats))
    got = bank_emission_ref(xa, w, lw)
    assert got.shape == (4 * n_states, t, b)
    valid = np.arange(t)[None, :, None] < nf[None, None, :]
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0.0), want, rtol=1e-5)
    before = bank_emission.launches
    assert torch.equal(bank_emission(xa, w, lw), got)
    assert bank_emission.launches == before

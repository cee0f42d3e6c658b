"""Port vs reference: the state-sharded banded Viterbi
(``speech_recognition_tpu_torch.parallel.sharded_decode``) in one gloo
world of 4 CPU processes.

Mirrors ``tests/test_sharded_decode.py``: the sausage and the loop (S not
divisible by 4, so the graph is padded), the 8-word lexgraph with cross
edges, beams 7 and 20 (20 is wider than one shard's 8 states), a
sausage of 1-state words (eps depth > 1) and a sausage whose state 0
turns unreachable (its band select reads shard 0's halo), each with two
streams, one at
``n_frames`` = T and one shorter.  ``pad_banded_for_sharding`` equals
JAX's array for array; the final costs, every frame of ``bp8`` (the
padding states' too, against the single-device DP on the padded graph)
and ``eps_u`` are bit-identical to the port's ``viterbi_banded_tb`` and
to the JAX ``viterbi_banded`` of each stream; the backtrace through the
gathered planes equals the single-device one.  The world starts once
for the module (``tests/torch_world.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.models import lexgraph as jlg
from speech_recognition_tpu.parallel.sharded_decode import (
    pad_banded_for_sharding as j_pad_banded_for_sharding,
)
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.models import lexgraph as tlg
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.utils.numerics import POS_INF
from tests.torch_parallel_worker import DECODE_CASES, GRAPH_FIELDS
from tests.torch_world import run_world

jvb = importlib.import_module("speech_recognition_tpu.ops.viterbi_banded")
WORLD = 4


def ltr(s, rng, skip=True):
    """``tests/test_sharded_decode.py``'s left-to-right word: self, step
    and (with ``skip``) skip costs."""
    t = np.full((s, s), np.inf)
    for i in range(s):
        t[i, i] = rng.uniform(0.1, 1)
        if i + 1 < s:
            t[i + 1, i] = rng.uniform(0.1, 1)
        if skip and i + 2 < s:
            t[i + 2, i] = rng.uniform(0.5, 2)
    return t


def _graphs(name, rng):
    """``(JAX BandedGraph, port BandedGraph, eps_depth, T, n_units)``."""
    if name == "lexgraph":
        words = ["aa", "ab", "abb", "ba", "b", "cab", "ca", "c"]
        units = sorted(set("".join(words)))
        ids = {ch: i for i, ch in enumerate(units)}
        trans = [ltr(3, rng, skip=(i % 2 == 0)) for i in range(len(units))]
        uni = rng.uniform(0.5, 3.0, len(words)).astype(np.float32)
        kw = dict(unigram_cost=uni, word_insertion_cost=0.4)
        jg = jlg.build_lex_graph(words, trans, ids, **kw)
        tg = tlg.build_lex_graph(words, trans, ids, **kw)
        return jg.banded, tg.banded, jg.eps_depth, 37, len(units) * 3
    if name == "dead_head":
        # 60 states (no padding): state 0 loses its self loop, so from frame
        # 2 on it is unreachable and its band select reads the halo, which
        # shard 0 fills with POS_INF as the single-device shift does (the
        # last shard's tail, finite here, would change its code)
        trans = [ltr(5, rng) for _ in range(4)]
        layers = [list(range(4))] * 3
        jg, tg = jgraph.build_word_graph(trans, layers), tgraph.build_word_graph(trans, layers)
        jb, tb = jvb.banded_arrays(jg), tvb.banded_arrays(tg)
        band = tb.band.clone()
        band[0, 0] = POS_INF
        return (jb._replace(band=jb.band.at[0, 0].set(POS_INF)), tb._replace(band=band),
                jg.eps_depth, 41, 0)
    if name == "one_state_sausage":
        trans = [ltr(1, rng), ltr(3, rng), ltr(1, rng), ltr(4, rng)]
        layers = [[0, 1, 2, 3]] * 5
        jg, tg = jgraph.build_word_graph(trans, layers), tgraph.build_word_graph(trans, layers)
    else:
        trans = [ltr(5, rng) for _ in range(6)]
        if name == "sausage":
            layers = [list(range(6))] * 3
            jg, tg = (jgraph.build_word_graph(trans, layers),
                      tgraph.build_word_graph(trans, layers))
        else:
            jg, tg = jgraph.build_loop_graph(trans), tgraph.build_loop_graph(trans)
    t_len = 29 if name.startswith("beam") else 41
    return jvb.banded_arrays(jg), tvb.banded_arrays(tg), jg.eps_depth, t_len, 0


def _cases():
    rng = np.random.default_rng(0)
    inp, meta = {}, {}
    for name, (beam, _) in DECODE_CASES.items():
        jg, tg, depth, t_len, n_units = _graphs(name, rng)
        s = tg.n_states
        if n_units:  # unit emissions read through the trie's bank states
            e = rng.uniform(0, 5, (t_len, n_units, 2)).astype(np.float32)
            nll = e[:, tg.bank_state.numpy()]
        else:
            nll = rng.uniform(0, 5, (t_len, s, 2)).astype(np.float32)
        nf = np.array([t_len, t_len // 2 + 2], np.int32)
        for k in GRAPH_FIELDS:
            if getattr(tg, k) is not None:
                inp[f"{name}_g_{k}"] = getattr(tg, k).numpy()
        inp[f"{name}_nll"], inp[f"{name}_nf"] = nll, nf
        inp[f"{name}_depth"] = np.int32(depth)
        meta[name] = (jg, tg, depth, beam, nll, nf)
    return inp, meta


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sharded_decode")
    inp, meta = _cases()
    np.savez(d / "inputs.npz", **inp)
    outs = run_world("decode", d, world=WORLD, timeout=400)
    return meta, outs


def _rank0(outs, name, what):
    for o in outs[1:]:
        np.testing.assert_array_equal(o[f"{name}_{what}"], outs[0][f"{name}_{what}"],
                                      err_msg=f"{name} {what} differs between ranks")
    return outs[0][f"{name}_{what}"]


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_pad_banded_for_sharding_matches_reference(world, name):
    """Padded to a multiple of 4 states: every array equals JAX's."""
    meta, outs = world
    jg = meta[name][0]
    jp, s = j_pad_banded_for_sharding(jg, WORLD)
    assert s == jg.band.shape[1]
    for k in GRAPH_FIELDS:
        want = getattr(jp, k)
        if want is None:
            assert f"{name}_pad_{k}" not in outs[0]
            continue
        np.testing.assert_array_equal(outs[0][f"{name}_pad_{k}"], np.asarray(want), err_msg=k)


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_sharded_viterbi_matches_single_device(world, name):
    """Final costs, bp8 and eps_u bit for bit against the port's
    ``viterbi_banded_tb`` and JAX's ``viterbi_banded`` of each stream (at
    n_frames = T and shorter), bp8 over every padded state against the
    single-device DP on the padded graph, and the backtrace through the
    gathered planes."""
    meta, outs = world
    jg, tg, depth, beam, nll, nf = meta[name]
    s = tg.n_states
    final, bp8 = _rank0(outs, name, "final"), _rank0(outs, name, "bp8")
    eps_u = _rank0(outs, name, "eps_u")
    assert final.shape[0] == bp8.shape[1] == -(-s // WORLD) * WORLD
    assert int(outs[0][f"{name}_collectives"]) == 1 + depth + int(bool(beam))
    t_nll, t_nf = torch.from_numpy(nll), torch.from_numpy(nf)
    w_fin, w_bp, w_eu = tvb.viterbi_banded_tb(t_nll, tg, t_nf, depth, beam_width=beam)
    np.testing.assert_array_equal(final[:s], w_fin.numpy())
    np.testing.assert_array_equal(bp8[:, :s], w_bp.numpy())
    np.testing.assert_array_equal(eps_u, w_eu.numpy())
    # every state of the padded graph (padding emissions as the workers pad)
    gp = tg._replace(**{k: torch.from_numpy(outs[0][f"{name}_pad_{k}"]) for k in GRAPH_FIELDS
                        if f"{name}_pad_{k}" in outs[0]})
    pad = np.full((nll.shape[0], gp.n_states - s, nll.shape[2]), POS_INF if beam else 0.0,
                  np.float32)
    p_fin, p_bp, p_eu = tvb.viterbi_banded_tb(torch.from_numpy(np.concatenate([nll, pad], 1)),
                                             gp, t_nf, depth, beam_width=beam)
    np.testing.assert_array_equal(bp8, p_bp.numpy())
    np.testing.assert_array_equal(final, p_fin.numpy())
    np.testing.assert_array_equal(eps_u, p_eu.numpy())
    for i in range(nll.shape[2]):
        r_fin, r_bp, r_eu = jvb.viterbi_banded(jnp.asarray(nll[:, :, i]), jg, jnp.int32(nf[i]),
                                               eps_depth=depth, beam_width=beam)
        np.testing.assert_array_equal(final[:s, i], np.asarray(r_fin))
        np.testing.assert_array_equal(bp8[:, :s, i], np.asarray(r_bp))
        np.testing.assert_array_equal(eps_u[:, :, i].astype(np.int32),
                                      np.asarray(r_eu).astype(np.int32))
    ends = tg.end_states
    best = ends[torch.argmin(w_fin[ends], 0)]
    st, fl = tvb.banded_backtrace_tb(torch.from_numpy(bp8[:, :s]), torch.from_numpy(eps_u),
                                     tg, best, t_nf, depth)
    w_st, w_fl = tvb.banded_backtrace_tb(w_bp, w_eu, tg, best, t_nf, depth)
    valid = torch.arange(nll.shape[0])[:, None] < t_nf[None, :]
    assert torch.equal(st[valid], w_st[valid]) and torch.equal(fl, w_fl)

"""Port vs reference: streaming decode (``decode/streaming.py``) and the
plain versions of the chunk-step kernels K17 (banded) and K18 (trie).

* the plain chunk DPs (``viterbi_banded_chunk_tb``, K17's uniform-mode
  DP, ``viterbi_lex_chunk_ref``), fed identical emissions chunk by chunk
  (chunks of 1, 7 and longer than the batch), equal the port's monolithic
  plain DPs bit for bit: final costs, every plane, states;
* a stream with no valid frame keeps its frontier and its ancestor map
  stays the identity;
* ``StreamingDecoder`` against the reference's on the same bank (both
  packages' banks from one set of numpy arrays): loop graphs (K17's
  uniform route), a loop of 1-state words (its general route) and a
  lexical tree (K18), chunks of 1, 7 and longer than the utterance, a
  ragged batch of 3, incremental emission single and batched and over
  the trie; words and states equal, costs at rtol 1e-5 (emission GEMMs
  sum in other orders), the words emitted at every push equal, and the
  ancestor maps and ``_immortal_scan`` packs equal chunk for chunk;
* ``emit_incremental`` raises on a partial push before the last;
* ``cli stream --device cpu`` prints the reference CLI's words (costs at
  rtol 1e-5) for ``loop``, ``loop --incremental`` and ``lextree``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.decode import streaming as jstream
from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.models import lexgraph as jlg
from speech_recognition_tpu_torch.decode import streaming as tstream
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.models import lexgraph as tlg
from speech_recognition_tpu_torch.ops import viterbi_banded as tvb
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as tvk
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as tlk
from speech_recognition_tpu_torch.utils.numerics import POS_INF
from tests.test_torch_gmm_hmm import both_banks

WORDS = ["ab", "abc", "ba", "d", "ca", "cab", "bad", "c"]


def _loop(seed=31, n_models=4, n_states=3):
    jb, tb = both_banks(seed, n_models=n_models, n_states=n_states, n_mix=2, dim=6, sep=6.0)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(n_models)]
    kw = dict(word_insertion_cost=0.5)
    return jb, tb, jgraph.build_loop_graph(trans, **kw), tgraph.build_loop_graph(trans, **kw)


def _sausage1(seed=35, n_slots=4):
    """A sausage of 1-state words (every word start is a word end, eps
    depth > 1): the graphs K17 takes in its general route."""
    jb, tb = both_banks(seed, n_models=4, n_states=1, n_mix=2, dim=6, sep=6.0)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    layers = [list(range(4))] * n_slots
    return jb, tb, jgraph.build_word_graph(trans, layers), tgraph.build_word_graph(trans, layers)


def _lex(seed=33):
    jb, tb = both_banks(seed, n_models=4, n_states=3, n_mix=2, dim=6, sep=6.0)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(4)]
    ids = {ch: i for i, ch in enumerate("abcd")}
    kw = dict(word_insertion_cost=0.5)
    return (jb, tb, jlg.build_lex_graph(WORDS, trans, ids, **kw),
            tlg.build_lex_graph(WORDS, trans, ids, **kw))


def _planted(jb, seqs, seed, noise=0.3, dwell=(2, 5)):
    """``[B, T, D]`` features walking each stream's unit sequence (a few
    frames near each state's first-mixture mean), zero-padded, and the
    lengths."""
    rng = np.random.default_rng(seed)
    means = np.asarray(jb.means)[:, :, 0, :]  # [N, S, D]
    rows = []
    for seq in seqs:
        f = [means[u, s] + noise * rng.standard_normal(means.shape[2])
             for u in seq for s in range(means.shape[1])
             for _ in range(int(rng.integers(*dwell)))]
        rows.append(np.asarray(f, np.float32))
    t = max(len(r) for r in rows)
    x = np.zeros((len(rows), t, means.shape[2]), np.float32)
    for i, r in enumerate(rows):
        x[i, : len(r)] = r
    return x, np.array([len(r) for r in rows], np.int32)


def _units(seed, n, n_units=4):
    return [int(u) for u in np.random.default_rng(seed).integers(0, n_units, n)]


def _push_all(dec, x, nf, chunk, batched):
    """Push ``x [B, T, D]`` chunk by chunk (lengths ``nf``); returns the
    words each push emitted."""
    out = []
    t_max = int(nf.max())
    t = 0
    while t < t_max:
        nv = np.clip(nf - t, 0, chunk).astype(np.int32)
        buf = np.zeros((x.shape[0], chunk, x.shape[2]), np.float32)
        c = min(chunk, t_max - t)
        buf[:, :c] = x[:, t:t + c]
        if batched:
            out.append(dec.push(buf, n_valid=nv))
        else:
            out.append(dec.push(buf[0], n_valid=int(nv[0])))
        t += chunk
    return out


def _results(res, batch):
    return [res] if batch == 1 else res


def _both(jb, tb, gj, gt, x, nf, chunk, **kw):
    b = x.shape[0]
    dj = jstream.StreamingDecoder(jb, gj, chunk_frames=chunk, batch=b, **kw)
    dt = tstream.StreamingDecoder(tb, gt, chunk_frames=chunk, batch=b, **kw)
    return dj, dt


def _check_results(rj, rt, batch):
    for (wj, sj, cj), (wt, st, ct) in zip(_results(rj, batch), _results(rt, batch)):
        assert wt == wj
        np.testing.assert_array_equal(st, np.asarray(sj))
        np.testing.assert_allclose(ct, cj, rtol=1e-5)


# ---------------------------------------------------------------------------
# the plain chunk DPs against the monolithic plain DPs
# ---------------------------------------------------------------------------


def _chunked(step, nll_tb, frontier, nf, chunk, **kw):
    """Run ``step`` over ``nll_tb [T, ...]`` chunk by chunk; returns the
    final carry and the per-chunk outputs concatenated along time."""
    t_len = nll_tb.shape[0]
    outs, fr = [], frontier
    for t0 in range(0, t_len, chunk):
        c = min(chunk, t_len - t0)
        nv = torch.clamp(nf - t0, 0, c)
        fr, *rest = step(nll_tb[t0:t0 + c], fr, nv, t0 == 0, **kw)
        outs.append(rest)
    return fr, [torch.cat([o[i] for o in outs]) if outs[0][i] is not None else None
                for i in range(len(outs[0]))]


def _plain_graphs():
    _, _, _, gl = _loop(n_states=3)
    _, _, _, g1 = _sausage1()
    _, _, _, lx = _lex()
    return {"loop": (tvb.banded_arrays(gl), 1),
            "1-state sausage": (tvb.banded_arrays(g1), g1.eps_depth), "trie": (lx.banded, 1)}


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("kind", ["loop", "1-state sausage", "trie"])
def test_plain_chunk_dp_equals_monolithic(kind, chunk):
    g, depth = _plain_graphs()[kind]
    rng = np.random.default_rng(chunk)
    t_len, b = 41, 4
    nll = torch.from_numpy(rng.uniform(0, 5, (t_len, g.n_states, b)).astype(np.float32))
    nf = torch.tensor([41, 23, 1, 7])
    final, bp8, eps_u = tvb.viterbi_banded_tb(nll, g, nf, depth)
    init = g.init_cost[:, None].expand(-1, b).contiguous()
    fr, (bp_c, eu_c, _) = _chunked(
        lambda x, f, nv, first, **kw: tvb.viterbi_banded_chunk_tb(x, g, f, nv, depth, first,
                                                                  True),
        nll, init, nf, chunk)
    assert torch.equal(fr, final) and torch.equal(bp_c, bp8) and torch.equal(eu_c, eps_u)
    ends = g.end_states[torch.argmin(final[g.end_states] + g.end_bonus[:, None], 0)]
    s1, f1 = tvb.banded_backtrace_tb(bp8, eps_u, g, ends, nf, depth)
    s2, f2 = tvb.banded_backtrace_tb(bp_c, eu_c, g, ends, nf, depth)
    assert torch.equal(s1, s2) and torch.equal(f1, f2)
    if kind == "trie":  # K18's plain version in K4's layouts against K4's
        topo = tlk.lex_topology(g)
        nll_ubt = torch.from_numpy(rng.uniform(0, 5, (int(g.bank_state.max()) + 1, t_len, b))
                                   .astype(np.float32))
        want = tlk.viterbi_lex_ref(nll_ubt, g, topo, nf)
        fr, got = _chunked(
            lambda x, f, nv, first: tlk.viterbi_lex_chunk(x.permute(1, 0, 2), g, topo, f, nv,
                                                          first, True),
            nll_ubt.permute(1, 0, 2), init.T.contiguous(), nf, chunk)
        assert torch.equal(fr, want[0])
        for w, x in zip(want[1:], got[:3]):
            assert torch.equal(w, x)
    if kind == "loop":  # K17's uniform-mode DP against K1's plain DP
        nll_ubt = torch.from_numpy(rng.uniform(0, 5, (int(g.bank_state.max()) + 1, t_len, b))
                                   .astype(np.float32))
        want = tvk.fused_dp_ref(nll_ubt, g, nf)
        fr, got = _chunked(
            lambda x, f, nv, first: tvk._fused_dp(x.permute(1, 0, 2), g, nv, f, f, first,
                                                  True),
            nll_ubt.permute(1, 0, 2), init, nf, chunk)
        assert torch.equal(fr, want[0])
        for w, x in zip(want[1:], got[:3]):
            assert torch.equal(w, x)


def test_frozen_stream_keeps_its_frontier():
    """``n_valid = 0`` freezes a stream for the whole chunk, frame 0
    included: its carry comes back unchanged and its ancestor map is the
    identity, in every plain chunk DP; the other streams move on."""
    graphs = _plain_graphs()
    rng = np.random.default_rng(5)
    for kind, (g, depth) in graphs.items():
        s, b, c = g.n_states, 3, 6
        fr = torch.from_numpy(rng.uniform(0, 50, (s, b)).astype(np.float32))
        nv = torch.tensor([c, 0, 2])
        nll = torch.from_numpy(rng.uniform(0, 5, (c, s, b)).astype(np.float32))
        ident = torch.arange(s, dtype=torch.int32)
        for first in (True, False):
            fo, bp8, _, org = tvb.viterbi_banded_chunk_tb(nll, g, fr, nv, depth, first, True)
            assert torch.equal(fo[:, 1], fr[:, 1]) and torch.equal(org[:, 1], ident), kind
            assert not torch.equal(fo[:, 0], fr[:, 0])
            if kind == "trie":
                topo = tlk.lex_topology(g)
                u = int(g.bank_state.max()) + 1
                nll_u = torch.from_numpy(rng.uniform(0, 5, (u, c, b)).astype(np.float32))
                fo, *_, org = tlk.viterbi_lex_chunk_ref(nll_u, g, topo, fr.T.contiguous(), nv,
                                                        first, True)
                assert torch.equal(fo[1], fr[:, 1]) and torch.equal(org[1], ident)
            if kind == "loop":
                u = int(g.bank_state.max()) + 1
                nll_u = torch.from_numpy(rng.uniform(0, 5, (u, c, b)).astype(np.float32))
                fo, *_, org = tvk._fused_dp(nll_u, g, nv, fr, fr, first, True)
                assert torch.equal(fo[:, 1], fr[:, 1]) and torch.equal(org[:, 1], ident)


def test_chunk_routes():
    """K17's route follows the monolithic decode's: K1's DP on a loop of
    3-state words, K8's on a sausage of 1-state words (eps depth > 1)."""
    _, _, _, gl = _loop()
    _, _, _, g1 = _sausage1()
    assert tvk.banded_route(tvk.banded_topology(tvb.banded_arrays(gl)), gl.eps_depth) == "fused"
    assert tvk.banded_route(tvk.banded_topology(tvb.banded_arrays(g1)), g1.eps_depth) == \
        "general"


# ---------------------------------------------------------------------------
# StreamingDecoder against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1, 7, 500])
def test_streaming_loop_matches_reference(chunk):
    jb, tb, gj, gt = _loop()
    x, nf = _planted(jb, [_units(1, 9)], seed=2)
    if chunk == 1:
        x, nf = x[:, :60], np.minimum(nf, 60)
    dj, dt = _both(jb, tb, gj, gt, x, nf, chunk)
    _push_all(dj, x, nf, chunk, batched=False)
    _push_all(dt, x, nf, chunk, batched=False)
    rj, rt = dj.finish(), dt.finish()
    _check_results(rj, rt, 1)
    assert rt[0] == _units(1, 9) or chunk == 1
    np.testing.assert_allclose(dt.best_cost(), dj.best_cost(), rtol=1e-5)


def test_streaming_general_route_matches_reference():
    """A sausage of 1-state words (K17's general route, eps depth > 1)."""
    jb, tb, gj, gt = _sausage1()
    assert gt.eps_depth > 1
    x, nf = _planted(jb, [_units(3, 4)], seed=4, dwell=(3, 9))
    dj, dt = _both(jb, tb, gj, gt, x, nf, 7)
    _push_all(dj, x, nf, 7, batched=False)
    _push_all(dt, x, nf, 7, batched=False)
    _check_results(dj.finish(), dt.finish(), 1)


@pytest.mark.parametrize("chunk", [7, 200])
def test_streaming_lexgraph_matches_reference(chunk):
    jb, tb, gj, gt = _lex()
    ids = {ch: i for i, ch in enumerate("abcd")}
    say = [WORDS[i] for i in np.random.default_rng(6).integers(0, len(WORDS), 7)]
    x, nf = _planted(jb, [[ids[ch] for w in say for ch in w]], seed=7)
    dj, dt = _both(jb, tb, gj, gt, x, nf, chunk)
    _push_all(dj, x, nf, chunk, batched=False)
    _push_all(dt, x, nf, chunk, batched=False)
    _check_results(dj.finish(), dt.finish(), 1)


def test_streaming_ragged_batch_matches_reference():
    """Three streams of different lengths in lock-step: short streams sit
    frozen (``n_valid`` 0) for whole chunks."""
    jb, tb, gj, gt = _loop()
    x, nf = _planted(jb, [_units(8, 9), _units(9, 4), _units(10, 2)], seed=11)
    dj, dt = _both(jb, tb, gj, gt, x, nf, 16)
    _push_all(dj, x, nf, 16, batched=True)
    _push_all(dt, x, nf, 16, batched=True)
    _check_results(dj.finish(), dt.finish(), 3)


@pytest.mark.parametrize("kind", ["loop", "trie"])
def test_streaming_ragged_midstream_pushes_match_reference(kind):
    """Partial pushes in the middle of a stream (not only at its end):
    the port compacts the planes on the device (in both plane layouts),
    the reference on the host; the same paths come out."""
    jb, tb, gj, gt = _loop() if kind == "loop" else _lex()
    x, nf = _planted(jb, [_units(12, 6), _units(13, 6)], seed=14)
    dj, dt = _both(jb, tb, gj, gt, x, nf, 10)
    for dec in (dj, dt):
        t = np.zeros(2, np.int64)
        for nv in ([10, 3], [4, 10], [10, 0], [0, 10]) * 3 + ([10, 10],) * 8:
            nv = np.minimum(np.array(nv), nf - t).clip(0)
            buf = np.zeros((2, 10, x.shape[2]), np.float32)
            for i in range(2):
                buf[i, : nv[i]] = x[i, t[i]:t[i] + nv[i]]
            dec.push(buf, n_valid=nv.astype(np.int32))
            t += nv
        assert (t == nf).all()
    _check_results(dj.finish(), dt.finish(), 2)


def _incremental(jb, tb, gj, gt, x, nf, chunk, window, flush_every=2):
    """Run both decoders incrementally, holding the ancestor maps and the
    immortality packs equal after every push; returns the emitted words
    per push and the final results."""
    b = x.shape[0]
    kw = dict(emit_incremental=True, window_chunks=window, flush_every=flush_every)
    dj, dt = _both(jb, tb, gj, gt, x, nf, chunk, **kw)
    emitted = []
    t = 0
    while t < int(nf.max()):
        c = min(chunk, int(nf.max()) - t)
        buf = np.zeros((b, chunk, x.shape[2]), np.float32)
        buf[:, :c] = x[:, t:t + c]
        ej = dj.push(buf, n_valid=c)
        et = dt.push(buf, n_valid=c)
        assert et == ej
        emitted.append(et)
        assert len(dt._org_chunks) == len(dj._org_chunks)
        np.testing.assert_array_equal(dt._org_chunks[-1].numpy(),
                                      np.asarray(dj._org_chunks[-1]))
        alive_j = np.asarray(dj._frontier) < POS_INF / 2
        np.testing.assert_array_equal((dt._frontier_bs() < POS_INF / 2).numpy(), alive_j)
        pj = np.asarray(jstream._immortal_scan(jnp.stack(dj._org_chunks), jnp.asarray(alive_j)))
        pt = tstream._immortal_scan(torch.stack(dt._org_chunks),
                                    torch.from_numpy(alive_j)).numpy()
        np.testing.assert_array_equal(pt, pj)
        assert dt._flushed == dj._flushed
        t += chunk
    return emitted, dj.finish(), dt.finish()


def test_incremental_single_matches_reference():
    jb, tb, gj, gt = _loop()
    x, nf = _planted(jb, [_units(15, 24)], seed=16)
    emitted, rj, rt = _incremental(jb, tb, gj, gt, x, nf, 16, 2)
    _check_results(rj, rt, 1)
    early = [w for e in emitted for w in e[0]]
    assert len(early) >= len(rt[0]) // 2 and early == rt[0][: len(early)]


def test_incremental_batched_matches_reference():
    jb, tb, gj, gt = _loop()
    x0, nf0 = _planted(jb, [_units(17, 20)], seed=18)
    rng = np.random.default_rng(19)
    x = np.concatenate([x0, x0 + 0.05 * rng.standard_normal(x0.shape).astype(np.float32)])
    nf = np.concatenate([nf0, nf0])
    emitted, rj, rt = _incremental(jb, tb, gj, gt, x, nf, 12, 2, flush_every=1)
    _check_results(rj, rt, 2)
    assert sum(len(e[0]) for e in emitted) > 0


def test_incremental_lexgraph_matches_reference():
    jb, tb, gj, gt = _lex()
    ids = {ch: i for i, ch in enumerate("abcd")}
    say = [WORDS[i] for i in np.random.default_rng(20).integers(0, len(WORDS), 16)]
    x, nf = _planted(jb, [[ids[ch] for w in say for ch in w]], seed=21)
    emitted, rj, rt = _incremental(jb, tb, gj, gt, x, nf, 12, 2, flush_every=1)
    _check_results(rj, rt, 1)
    early = [w for e in emitted for w in e[0]]
    assert len(early) >= len(rt[0]) // 2 and early == rt[0][: len(early)]


def test_incremental_refuses_a_partial_push_before_the_last():
    _, tb, _, gt = _loop()
    dec = tstream.StreamingDecoder(tb, gt, chunk_frames=8, emit_incremental=True)
    x = np.zeros((8, 6), np.float32)
    dec.push(x, n_valid=8)
    dec.push(x, n_valid=5)  # the final chunk may be partial
    with pytest.raises(ValueError, match="full-width"):
        dec.push(x, n_valid=8)


def test_push_refuses_a_tensor_on_another_device():
    _, tb, _, gt = _loop()
    dec = tstream.StreamingDecoder(tb, gt, chunk_frames=8)
    with pytest.raises(ValueError, match="on meta"):
        dec.push(torch.zeros((8, 6), device="meta"))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _parse(out):
    """``{file: (words, emitted counts, cost)}`` from stream's lines."""
    got = {}
    for line in out.splitlines():
        m = re.match(r"(\S+): (\[.*\]) \((?:(\d+/\d+) words emitted mid-stream, )?"
                     r"cost (\S+)\)$", line)
        if m:
            got[m.group(1)] = (m.group(2), m.group(3), float(m.group(4)))
    return got


def test_cli_stream_matches_reference(tmp_path, capsys, monkeypatch):
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    monkeypatch.chdir(tmp_path)
    jmain(["synth", "-o", "data", "--n-train", "3", "--n-test", "1", "--n-continuous", "8"])
    jmain(["isolated_train", "-i", "data/train", "-o", "models/bank.npz",
           "--n-gaussians", "2"])
    capsys.readouterr()
    runs = (["--chunk-frames", "48"],
            ["--chunk-frames", "32", "--incremental", "--window-chunks", "2"],
            ["--graph", "lextree", "--chunk-frames", "48"])
    words = []
    for extra in runs:
        cmd = ["stream", "-i", "models/bank.npz", "-d", "data/test", *extra]
        jmain(cmd)
        ref = _parse(capsys.readouterr().out)
        tmain(cmd + ["--device", "cpu"])
        got = _parse(capsys.readouterr().out)
        assert sorted(got) == sorted(ref) and len(ref) >= 12, extra
        for f in ref:
            assert got[f][:2] == ref[f][:2], (extra, f)
            np.testing.assert_allclose(got[f][2], ref[f][2], rtol=1e-5)
        words.append({f: v[0] for f, v in got.items()})
    assert words[0] == words[1] == words[2]
    if not torch.cuda.is_available():  # the default device is cuda: no CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmain(["stream", "-i", "models/bank.npz", "-d", "data/test"])


# ---------------------------------------------------------------------------
# the chunk kernels' launch plans (host-side)
# ---------------------------------------------------------------------------

LIMIT = 227 * 1024  # the H100's shared memory per CTA


def _r16(n):
    return -(-n // 16) * 16


@pytest.mark.parametrize("base", ["fused", "general"])
@pytest.mark.parametrize("s,r,l", [(55, 11, 11), (7500, 1500, 1500), (77, 77, 77)])
def test_k17_plans_count_the_ancestor_rows(base, s, r, l):
    """K17's work area is its DP's, plus two padded ancestor-map rows and
    the word ends' ancestors with the map; its staged planes are its DP's;
    a four-warp plan is found at every size, with the work area in device
    memory where four streams' do not fit (no size is refused); the plan
    banded_plan picks is the warp form up to BANDED_WARP_MAX_STATES
    states and 32 words, with the ends' ancestors in its warp area."""
    row = _r16(4 * (s + 4))
    plain = tvk.banded_work_bytes(f"{base}_chunk", s, r, l)
    assert plain == tvk.banded_work_bytes(base, s, r, l)
    assert tvk.banded_work_bytes(f"{base}_chunk_org", s, r, l) == plain + 2 * row + _r16(4 * l)
    assert tvk.banded_stage_bytes(f"{base}_chunk", s, r, 4) == tvk.banded_stage_bytes(base, s,
                                                                                        r, 4)
    for org in ("", "_org"):
        mode = f"{base}_chunk{org}"
        auto = tvk.banded_plan(512, 132, s, r, l, 55, mode, LIMIT)
        small = s <= tvk.BANDED_WARP_MAX_STATES and max(r, l) <= tvk.WARP_MAX_ROWS
        assert auto.form == ("warp" if small else "four")
        if auto.form == "warp":  # the map adds the ends' ancestors' snapshot row
            assert tvk.banded_warp_smem_bytes(mode, 55, 1) - tvk.banded_warp_smem_bytes(
                f"{base}_chunk", 55, 1) == (128 if org else 0)
            assert auto.smem == tvk.banded_warp_smem_bytes(mode, 55, auto.tile) <= LIMIT
        plan = tvk.banded_plan(512, 132, s, r, l, 55, mode, LIMIT, form="four")
        assert plan.form == "four"
        assert plan.smem <= LIMIT and plan.work == tvk.banded_work_bytes(mode, s, r, l)
        assert plan.work_smem == (4 * plan.work <= LIMIT)
        assert plan.smem == tvk.banded_smem_bytes(mode, 55, s, r, l, plan.tile, plan.work_smem,
                                                  plan.tables, plan.ring, plan.kf)


def test_k18_plans_count_the_ancestor_rows():
    """K18's shared memory is K4's, plus the ancestor map's two rows
    where it keeps them on chip (the rows K6 keeps its entry times in);
    its plans take every tier: the trie on chip, and without row tables
    past ~7,000 bank rows."""
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon, large_bank_lexicon

    dims = (1234, 77, 77, 24, 5)
    row = 2 * _r16(4 * (1234 + 4))
    for front, tau in ((True, True), (True, False), (False, True)):
        k4 = tlk.lex_smem_bytes(0, *dims, front, tau, True, True, False, 8)
        assert tlk.lex_smem_bytes(2, *dims, front, tau, True, True, False, 8) == k4
        assert tlk.lex_smem_bytes(3, *dims, front, tau, True, True, False, 8) == \
            k4 + (row if tau else 0)
    for lexicon, rep in ((bench_lexicon, 8), (large_bank_lexicon, 0)):
        words, trans, ids, _ = lexicon()
        topo = tlk.lex_topology(tlg.build_lex_graph(words, trans, ids).banded)
        for mode in (2, 3):
            plan = tlk.lex_plan(mode, topo, LIMIT)
            assert plan.smem <= LIMIT and plan.rep == rep
            assert plan.front == (rep > 0)
            assert plan.tau == (mode == 3)  # the ancestor rows fit on chip in both

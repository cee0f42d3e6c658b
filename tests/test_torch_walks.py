"""Port vs reference: the three backtrace walks that kernels K21-K23 run
on the card, through their plain versions on the CPU.

* ``viterbi_backtrace_ref`` (K21's plain version) against the reference's
  scan ``ops/viterbi.viterbi_backtrace`` stream by stream, on random
  planes whose eps chains run at every frame down to frame 0 and on the
  planes of the reference's own dense Viterbi, at eps depth 1 and 2 with
  n_frames T, 0, 1 and mid-length in one batch;
* ``lattice_words_ref`` (K22's) against ``ops/lattice.lattice_words_device``
  on random chains, with a ``max_words`` that cuts the longest chain and
  one that holds every chain, on ``[T, L, B]`` views of ``[T, B, L]``
  planes (the layout K6 and K7 write);
* ``wordtrace_words_ref`` (K23's) against
  ``ops/viterbi_banded_pallas.wordtrace_words_device`` with ``eps_u`` in
  each type ``_eps_u_dtype`` gives (int8, int32);
* each kernel's per-thread loop (``csrc/dense_backtrace.cu``,
  ``csrc/word_walk.cu``) emulated in Python against the plain version,
  and K23's row count from the longest chain against the plain walk's;
* the wrappers' gating: CPU tensors run the plain versions and leave the
  launch counters alone; a wrong dtype, rank or device is refused with
  ``ValueError`` before the kernel library is loaded.

Every comparison is exact (integers, no tolerance).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.ops import lattice as jlat
from speech_recognition_tpu.ops.viterbi_banded_pallas import wordtrace_words_device as j_wt
from speech_recognition_tpu_torch.ops import lattice as tlat
from speech_recognition_tpu_torch.ops import lattice_kernels as tlk
from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as tvk
from speech_recognition_tpu_torch.ops import viterbi_kernels as tdk
from speech_recognition_tpu_torch.ops.viterbi_banded import _eps_u_dtype
from speech_recognition_tpu_torch.utils import build

jv = importlib.import_module("speech_recognition_tpu.ops.viterbi")
tv = importlib.import_module("speech_recognition_tpu_torch.ops.viterbi")

T_LEN = 23


# ---------------------------------------------------------------------------
# K21: the dense backtrace
# ---------------------------------------------------------------------------


def random_dense_planes(seed, b=7, t=T_LEN, s=9, p_eps=0.4):
    """Random int32 ``bp`` / ``eps_bp [B, T, S]`` (bp -1 at frame 0, eps
    origins at every frame, most states' at frame 0), end states and
    n_frames T, 0, 1 and mid-length."""
    rng = np.random.default_rng(seed)
    bp = rng.integers(0, s, (b, t, s)).astype(np.int32)
    bp[:, 0] = -1
    eps_bp = rng.integers(0, s, (b, t, s)).astype(np.int32)
    p = np.full((t, s), p_eps)
    p[0] = 0.9  # most chains take an eps hop at frame 0, where the walk ends
    eps_bp[rng.uniform(size=eps_bp.shape) >= p] = -1
    end = rng.integers(0, s, b).astype(np.int32)
    nf = np.r_[t, 0, 1, rng.integers(2, t, max(b - 3, 0))][:b].astype(np.int32)
    return bp, eps_bp, end, nf


def viterbi_dense_planes(seed, depth, b=6, t=T_LEN, s=10):
    """The reference's dense Viterbi planes on a random graph with eps
    edges (stream by stream), its best end states and n_frames."""
    rng = np.random.default_rng(seed)
    trans = rng.uniform(0, 3, (s, s)).astype(np.float32)
    trans[rng.uniform(size=trans.shape) < 0.5] = 1e30
    eps = rng.uniform(0, 0.5, (s, s)).astype(np.float32)
    eps[rng.uniform(size=eps.shape) < 0.5] = 1e30
    np.fill_diagonal(eps, 1e30)
    init = np.where(np.arange(s) < 3, rng.uniform(0, 1, s), 1e30).astype(np.float32)
    nf = np.r_[t, 0, 1, rng.integers(2, t, b - 3)].astype(np.int32)
    bps, ebps, ends = [], [], []
    for i in range(b):
        nll = rng.uniform(0, 5, (t, s)).astype(np.float32)
        res = jv.viterbi(jnp.asarray(nll), jnp.asarray(trans), jnp.asarray(init),
                         jnp.int32(nf[i]), eps_trans=jnp.asarray(eps), eps_depth=depth)
        bps.append(np.asarray(res.bp, np.int32))
        ebps.append(np.asarray(res.eps_bp, np.int32))
        ends.append(int(np.argmin(np.asarray(res.final_cost))))
    return np.stack(bps), np.stack(ebps), np.asarray(ends, np.int32), nf


def dense_case(kind, depth):
    if kind == "random":
        return random_dense_planes(31 + depth)
    return viterbi_dense_planes(41 + depth, depth)


def jax_backtrace(bp, eps_bp, end, nf, depth):
    """The reference's scan, one stream at a time -> ``[B, T]`` arrays."""
    outs = [jv.viterbi_backtrace(jnp.asarray(bp[i]), jnp.asarray(eps_bp[i]),
                                 jnp.int32(end[i]), jnp.int32(nf[i]), eps_depth=depth)
            for i in range(bp.shape[0])]
    return (np.stack([np.asarray(s) for s, _ in outs]),
            np.stack([np.asarray(f) for _, f in outs]))


def k21_emulated(bp, eps_bp, end, nf, depth):
    """``dense_backtrace_kernel``'s per-thread loop: the frame's backpointer
    read beside the first eps read, the eps hops stopped at the first
    origin < 0, the backpointer re-read only after a hop."""
    b, t_len, s = bp.shape
    states = np.zeros((b, t_len), np.int32)
    flags = np.zeros((b, t_len), bool)

    def idx(x):
        x = x + s if x < 0 else x
        return min(max(x, 0), s - 1)

    for i in range(b):
        st = int(end[i])
        for t in range(t_len - 1, -1, -1):
            states[i, t] = st
            used = False
            if t < nf[i]:
                se = idx(st)
                prev = int(bp[i, t, se]) if t > 0 else 0
                for _ in range(depth):
                    origin = int(eps_bp[i, t, se])
                    if origin < 0:
                        break
                    used, se = True, idx(origin)
                if t > 0:
                    st = int(bp[i, t, se]) if used else prev
            flags[i, t] = used
    return states, flags


@pytest.mark.parametrize("kind", ["random", "viterbi planes"])
@pytest.mark.parametrize("depth", [1, 2])
def test_dense_backtrace_plain_matches_reference(kind, depth):
    bp, eps_bp, end, nf = dense_case(kind, depth)
    s_j, f_j = jax_backtrace(bp, eps_bp, end, nf, depth)
    before = tdk.dense_backtrace.launches
    s_t, f_t = tv.viterbi_backtrace(torch.from_numpy(bp), torch.from_numpy(eps_bp),
                                    torch.from_numpy(end), torch.from_numpy(nf),
                                    eps_depth=depth)
    s_w, f_w = tdk.dense_backtrace(torch.from_numpy(bp), torch.from_numpy(eps_bp),
                                   torch.from_numpy(end), torch.from_numpy(nf), depth)
    assert tdk.dense_backtrace.launches == before  # CPU tensors: the plain version
    assert s_t.dtype == torch.int32 and f_t.dtype == torch.bool
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    assert torch.equal(s_w, s_t) and torch.equal(f_w, f_t)
    # eps hops were taken, some at frame 0 where the walk ends
    assert f_j.any() and (kind != "random" or f_j[:, 0].any())
    # the single-stream form, scalar arguments
    for i in (0, 1, 2):
        s1, f1 = tdk.dense_backtrace(torch.from_numpy(bp[i]), torch.from_numpy(eps_bp[i]),
                                     int(end[i]), int(nf[i]), depth)
        np.testing.assert_array_equal(s1.numpy(), s_j[i])
        np.testing.assert_array_equal(f1.numpy(), f_j[i])


@pytest.mark.parametrize("kind", ["random", "viterbi planes"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_dense_backtrace_kernel_loop_emulated(kind, depth):
    bp, eps_bp, end, nf = dense_case(kind, min(depth, 2))
    s_t, f_t = tv.viterbi_backtrace_ref(torch.from_numpy(bp), torch.from_numpy(eps_bp),
                                        torch.from_numpy(end), torch.from_numpy(nf), depth)
    s_e, f_e = k21_emulated(bp, eps_bp, end, nf, depth)
    np.testing.assert_array_equal(s_e, s_t.numpy())
    np.testing.assert_array_equal(f_e, f_t.numpy())


SENTINEL = -(1 << 40)  # a staged word that no load wrote


def k21_window_emulated(bp, eps_bp, end, nf, depth, w, r):
    """``dense_backtrace_window_kernel``'s walk with windows of ``w``
    frames x ``r`` states (r <= S), one stream at a time: every read goes
    through a staged copy of its window (a word no load wrote holds
    ``SENTINEL``), windows load where the kernel loads them (where R = S on
    a grid of W frames from T - 1, the same for every stream), and the load
    ahead is taken or dropped as the kernel takes or drops it.  Returns
    ``(states, flags, events)``; ``events[i]`` lists stream i's window
    starts: "first"; "frames" (the load ahead taken at the frame edge);
    "frames+drop" / "frames+rise" (the frame edge crossed at a state below
    / above the load ahead); "drop" / "rise" (the frame's state below /
    above its window); "eps" (an eps origin outside the window, at the same
    frame); and "dropped" after a miss that threw a load ahead away."""
    b, t_len, s = bp.shape
    assert r <= s
    states = np.zeros((b, t_len), np.int32)
    flags = np.zeros((b, t_len), bool)
    events = []

    def idx(x):
        x = x + s if x < 0 else x
        return min(max(x, 0), s - 1)

    for i in range(b):
        stage = np.full((2, 2, w, r), SENTINEL, np.int64)  # [stage, plane, frame, state]
        win = {"cur": 0, "wt": None, "wlo": 0, "pt": -1}
        ev = []

        def load(st, t_lo, t_hi, lo):
            stage[st] = SENTINEL
            stage[st, 0, :t_hi - t_lo + 1] = bp[i, t_lo:t_hi + 1, lo:lo + r]
            stage[st, 1, :t_hi - t_lo + 1] = eps_bp[i, t_lo:t_hi + 1, lo:lo + r]

        def at(t, se, eps_read):
            cur, wt, wlo, pt = win["cur"], win["wt"], win["wlo"], win["pt"]
            if wt is not None and t >= wt and 0 <= se - wlo < r:
                return cur, t - wt, se - wlo
            if pt >= 0 and pt <= t < wt and 0 <= se - wlo < r:
                ev.append("frames")
                cur, wt, pt = cur ^ 1, pt, -1
                if wt > 0:
                    pt = max(0, wt - w)
                    load(cur ^ 1, pt, wt - 1, wlo)
            else:
                if wt is None:
                    ev.append("first")
                elif eps_read:
                    ev.append("eps")
                else:
                    ev.append(("frames+" if t < wt else "") + ("drop" if se < wlo else "rise"))
                if pt >= 0:
                    ev.append("dropped")
                # R = S: windows on a frame grid from T - 1
                top = t_len - 1 - w * ((t_len - 1 - t) // w) if r == s else t
                lo, t_lo = max(0, se - r + 1), max(0, top - w + 1)
                load(cur ^ 1, t_lo, top, lo)
                pt = -1
                if t_lo > 0:
                    pt = max(0, t_lo - w)
                    load(cur, pt, t_lo - 1, lo)
                cur, wt, wlo = cur ^ 1, t_lo, lo
            win.update(cur=cur, wt=wt, wlo=wlo, pt=pt)
            return cur, t - wt, se - wlo

        st = int(end[i])
        n = min(max(int(nf[i]), 0), t_len)
        states[i, n:] = st
        for t in range(n - 1, -1, -1):
            states[i, t] = st
            c, f, k_ = at(t, idx(st), False)
            prev = stage[c, 0, f, k_] if t > 0 else 0
            used = False
            for k in range(depth):
                origin = stage[c, 1, f, k_]
                assert origin != SENTINEL, (i, t)
                if origin < 0:
                    break
                used = True
                if k + 1 < depth or t > 0:
                    c, f, k_ = at(t, idx(int(origin)), True)
            if t > 0:
                nxt = stage[c, 0, f, k_] if used else prev
                assert nxt != SENTINEL, (i, t)
                st = int(nxt)
            flags[i, t] = used
        events.append(ev)
    return states, flags, events


def left_to_right_planes(seed, b=6, t=T_LEN, s=40, fall=3, drop=12, p_eps=0.3):
    """Planes of a left-to-right graph, as the paths' graphs give: a
    frame's backpointer is 0-``fall`` states below its state, an eps origin
    (at ``p_eps`` of the entries) 1-``drop`` below, -1 below state 0; end
    states near the top; n_frames T, 0, 1 and mid-length."""
    rng = np.random.default_rng(seed)
    here = np.arange(s)[None, None, :]
    bp = np.maximum(here - rng.integers(0, fall + 1, (b, t, s)), 0).astype(np.int32)
    bp[:, 0] = -1
    eps_bp = (here - rng.integers(1, drop + 1, (b, t, s))).astype(np.int32)
    eps_bp[(rng.uniform(size=eps_bp.shape) >= p_eps) | (eps_bp < 0)] = -1
    end = (s - 1 - rng.integers(0, 4, b)).astype(np.int32)
    nf = np.r_[t, 0, 1, rng.integers(2, t, max(b - 3, 0))][:b].astype(np.int32)
    return bp, eps_bp, end, nf


WINDOW_CASES = {
    # (planes, w, r, window starts the case must show)
    "left to right, 4 x 8": (lambda d: left_to_right_planes(50 + d), 4, 8,
                             {"first", "frames", "drop", "eps", "dropped"}),
    "left to right, 5 x 16": (lambda d: left_to_right_planes(65 + d, fall=4), 5, 16,
                              {"first", "frames", "frames+drop", "drop"}),
    "random (rises), 4 x 4": (lambda d: random_dense_planes(70 + d), 4, 4,
                              {"first", "rise", "drop", "dropped"}),
    "reference's planes, 3 x 6": (lambda d: viterbi_dense_planes(80 + d, d), 3, 6,
                                  {"first", "frames"}),
    # R = S: every state in every window, only frames end one
    "left to right, S <= R": (lambda d: left_to_right_planes(90 + d, s=12), 4, 12,
                              {"first", "frames"}),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_dense_backtrace_window_walk_emulated(case, depth):
    """The window form's walk, read only through its staged windows, gives
    ``viterbi_backtrace_ref`` and the reference's scan bit for bit: windows
    cut by frames, by a drop below the window, by a rise, by an eps origin
    outside it at the same frame; n_frames inside a window, T (23) not a
    multiple of W, eps depth 1-3."""
    make, w, r, want_events = WINDOW_CASES[case]
    bp, eps_bp, end, nf = make(min(depth, 2))
    s_t, f_t = tv.viterbi_backtrace_ref(*(torch.from_numpy(x) for x in (bp, eps_bp, end, nf)),
                                        depth)
    s_j, f_j = jax_backtrace(bp, eps_bp, end, nf, depth)
    s_e, f_e, events = k21_window_emulated(bp, eps_bp, end, nf, depth, w, r)
    np.testing.assert_array_equal(s_e, s_t.numpy())
    np.testing.assert_array_equal(f_e, f_t.numpy())
    np.testing.assert_array_equal(s_e, s_j)
    np.testing.assert_array_equal(f_e, f_j)
    seen = {e for ev in events for e in ev}
    assert want_events <= seen, (want_events - seen, seen)
    if r == bp.shape[2]:
        assert seen <= {"first", "frames"}
    assert T_LEN % w and f_e.any()
    assert any(0 < n < T_LEN and n % w for n in nf)  # a length inside a window


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_dense_backtrace_window_walk_wraps_and_clamps(depth):
    """Indices below 0 wrap by S (a rise into another window) and past S -
    1 clamp, as the reference's indexing does: the window walk equals the
    reference's scan and the chain form's loop (``viterbi_backtrace_ref``
    gathers and takes neither)."""
    bp, eps_bp, end, nf = left_to_right_planes(95)
    rng = np.random.default_rng(96)
    hit = rng.uniform(size=bp.shape) < 0.05
    bp[hit] = rng.integers(-3, 0, int(hit.sum()))  # wraps to the top: a rise
    bp[rng.uniform(size=bp.shape) < 0.02] = bp.shape[2] + 3
    end[0] = -3
    s_j, f_j = jax_backtrace(bp, eps_bp, end, nf, depth)
    s_c, f_c = k21_emulated(bp, eps_bp, end, nf, depth)
    s_e, f_e, events = k21_window_emulated(bp, eps_bp, end, nf, depth, 4, 8)
    np.testing.assert_array_equal(s_e, s_j)
    np.testing.assert_array_equal(f_e, f_j)
    np.testing.assert_array_equal(s_c, s_j)
    np.testing.assert_array_equal(f_c, f_j)
    assert {"rise", "frames+rise"} & {e for ev in events for e in ev}


SMEM_LIMIT, N_SM = 232448, 132  # the H100's, as the card reports them


def _strides(b, t, s):
    return [(t * s, s, 1)] * 2


def test_dense_backtrace_plan_window_form():
    """Contiguous planes take the window form: 32 frames x every state of
    the sausage's 385 in the block layout, one stream a warp and a CTA each
    for 64 streams; 128-state rows where a window of every state does not
    fit (500 states) or the rows are not contiguous; every state of the
    isolated shape's 5 in a window, 4 lanes a stream; a ``[T, S]`` plane's
    view too; eps depth 0 stages one plane."""
    p = tdk.dense_backtrace_plan(64, 500, 385, _strides(64, 500, 385), SMEM_LIMIT, N_SM)
    # a window of 32 x 385 words (3,081 16-byte chunks a plane) and 44
    # words for a ring of the last 32 states and flags and two mbarriers
    assert p == tdk.BacktracePlan("window", 32, 385, 32, 1, 64, (2 * 2 * 12324 + 44) * 4,
                                  True)
    p = tdk.dense_backtrace_plan(64, 500, 500, _strides(64, 500, 500), SMEM_LIMIT, N_SM)
    # rows of 132 words (the 33 16-byte chunks that 128 states can span)
    assert p == tdk.BacktracePlan("window", 32, 128, 32, 1, 64, (2 * 2 * 32 * 132 + 44) * 4,
                                  False)
    assert tdk.dense_backtrace_plan(64, 500, 385, [(500 * 400, 400, 1)] * 2, SMEM_LIMIT,
                                    N_SM)[:3] == ("window", 32, 128)
    p = tdk.dense_backtrace_plan(5632, 500, 5, _strides(5632, 500, 5), SMEM_LIMIT, N_SM)
    assert (p.form, p.rows, p.states, p.lanes, p.warps, p.block) == ("window", 32, 5, 4, 4,
                                                                     True)
    # the block layout: a window's 32 x 5 words as one segment of 41 chunks
    assert p.grid * p.warps * 8 >= 5632 and p.smem == 4 * 8 * (2 * 2 * 164 + 44) * 4
    assert not tdk.dense_backtrace_plan(5632, 500, 5, [(5000, 10, 1)] * 2, SMEM_LIMIT,
                                        N_SM).block
    one = torch.zeros((1, 30, 7), dtype=torch.int32)[0]  # viterbi's bp[0]
    p = tdk.dense_backtrace_plan(1, 30, 7, [one[None].stride()] * 2, SMEM_LIMIT, N_SM)
    assert (p.form, p.rows, p.states, p.lanes) == ("window", 30, 7, 4)
    p0 = tdk.dense_backtrace_plan(64, 500, 385, _strides(64, 500, 385), SMEM_LIMIT, N_SM,
                                  eps_depth=0)
    assert p0.smem == (2 * 12324 + 44) * 4  # the bp plane alone
    p = tdk.dense_backtrace_plan(3, 1, 9, _strides(3, 1, 9), SMEM_LIMIT, N_SM)
    assert (p.form, p.rows) == ("window", 1)


def test_dense_backtrace_plan_chain_form():
    """Strided views and S past K11's shared-memory frontier take the
    chain form; so does a window that fits fewer than 8 frames."""
    b, t, s = 8, 100, 40
    strided = [(t * s, 1, t), (t * s, s, 1)]  # bp a [B, S, T] storage's view
    assert tdk.dense_backtrace_plan(b, t, s, strided, SMEM_LIMIT, N_SM).form == "chain"
    big = SMEM_LIMIT // 20 + 1  # K11's scratch tier starts here: 11,623 states
    assert big == 11623
    assert tdk.dense_backtrace_plan(2, 4, big, _strides(2, 4, big), SMEM_LIMIT,
                                    N_SM).form == "chain"
    assert tdk.dense_backtrace_plan(2, 4, big - 1, _strides(2, 4, big - 1), SMEM_LIMIT,
                                    N_SM).form == "window"
    assert tdk.window_plan(b, t, 4096, 1, 32, 4096, SMEM_LIMIT, N_SM) is None
    with pytest.raises(ValueError):
        tdk.dense_backtrace_plan(0, t, s, _strides(0, t, s), SMEM_LIMIT, N_SM)


@pytest.mark.parametrize("b", [1, 7, 64, 133, 256, 5632])
@pytest.mark.parametrize("s", [1, 2, 5, 31, 48, 75, 128, 385, 4000])
def test_dense_backtrace_plan_sizes_fit(b, s):
    """Every window plan holds every stream, fits its shared memory under
    the limit, and its lanes divide the warp and are at most R."""
    for t, depth in ((500, 1), (7, 2), (200, 0)):
        p = tdk.dense_backtrace_plan(b, t, s, _strides(b, t, s), SMEM_LIMIT, N_SM, depth)
        assert p.form == "window"
        groups = 32 // p.lanes
        assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= min(32, p.states)
        assert p.rows == min(t, tdk.WINDOW_ROWS) and p.block == (p.states == s)
        # every state where two stages of 32 frames of them fit, else 128
        full = tdk.window_smem(p.rows, s, s, 32, 1, depth, True) <= SMEM_LIMIT
        assert p.states == (s if full else min(s, tdk.WINDOW_STATES))
        assert p.grid * p.warps * groups >= b > (p.grid - 1) * p.warps * groups
        assert p.smem == tdk.window_smem(p.rows, p.states, s, p.lanes, p.warps, depth, p.block)
        assert p.smem >= p.warps * groups * 2 * (2 if depth else 1) * p.rows * p.states * 4
        assert p.smem <= SMEM_LIMIT and 1 <= p.warps <= tdk.BACKTRACE_WARPS


# ---------------------------------------------------------------------------
# K22: the lattice word walk
# ---------------------------------------------------------------------------


def random_lattice(seed, t=T_LEN, l=6, b=7):
    """``pred_w`` / ``ends_tau [T, L, B]`` as views of ``[T, B, L]``
    planes: entry times below the frame (0 for some arcs), predecessors in
    [0, L); best leaves; n_frames T, 0, 1 and mid-length."""
    rng = np.random.default_rng(seed)
    tau = (rng.uniform(size=(t, b, l)) * np.arange(t)[:, None, None]).astype(np.int32)
    tau[rng.uniform(size=tau.shape) < 0.1] = 0
    pred = rng.integers(0, l, (t, b, l)).astype(np.int32)
    best = rng.integers(0, l, b).astype(np.int32)
    nf = np.r_[t, 0, 1, rng.integers(2, t, b - 3)].astype(np.int32)
    return pred, tau, best, nf


@pytest.mark.parametrize("max_words", [2, T_LEN])
def test_lattice_walk_plain_matches_reference(max_words):
    pred, tau, best, nf = random_lattice(5)
    p_v = torch.from_numpy(pred).transpose(1, 2)
    t_v = torch.from_numpy(tau).transpose(1, 2)
    assert not p_v.is_contiguous()
    before = tlk.lattice_walk.launches
    lr, nw = tlat.lattice_words_device(p_v, t_v, torch.from_numpy(best), torch.from_numpy(nf),
                                       max_words=max_words)
    assert tlk.lattice_walk.launches == before  # CPU tensors: the plain version
    lr_j, nw_j = jlat.lattice_words_device(
        jnp.asarray(pred.transpose(0, 2, 1)), jnp.asarray(tau.transpose(0, 2, 1)),
        jnp.asarray(best), jnp.asarray(nf), max_words=max_words)
    assert lr.shape == (max_words, len(nf)) and lr.dtype == nw.dtype == torch.int32
    np.testing.assert_array_equal(lr.numpy(), np.asarray(lr_j))
    np.testing.assert_array_equal(nw.numpy(), np.asarray(nw_j))
    full = tlat.lattice_words_ref(p_v, t_v, torch.from_numpy(best), torch.from_numpy(nf),
                                  max_words=T_LEN)[1]
    if max_words < T_LEN:  # the cut: the longest chain is longer than max_words
        assert int(full.max()) > max_words and int(nw.max()) == max_words
    assert int(nw[1]) == 0 and int(nw[2]) == 1  # n_frames 0 and 1


def k22_emulated(pred, tau, best, nf, max_words):
    """``lattice_walk_kernel``'s per-thread loop on ``[T, L, B]`` arrays."""
    t_len, l, b = pred.shape
    out = np.full((max_words, b), -1, np.int32)
    n_words = np.zeros(b, np.int32)
    for i in range(b):
        leaf, t = int(best[i]), min(max(int(nf[i]) - 1, 0), t_len - 1)
        for k in range(max_words if nf[i] > 0 else 0):
            out[k, i] = leaf
            n_words[i] += leaf >= 0
            lc = min(max(leaf, 0), l - 1)
            tu = int(tau[t, lc, i])
            if tu <= 0:
                break
            t = min(tu, t_len - 1)
            leaf = int(pred[t, lc, i])
    return out, n_words


def test_lattice_walk_kernel_loop_emulated():
    pred, tau, best, nf = random_lattice(8)
    p_tlb, t_tlb = pred.transpose(0, 2, 1), tau.transpose(0, 2, 1)
    for max_words in (0, 1, 4, T_LEN):
        lr, nw = tlat.lattice_words_ref(torch.from_numpy(p_tlb), torch.from_numpy(t_tlb),
                                        torch.from_numpy(best), torch.from_numpy(nf),
                                        max_words)
        lr_e, nw_e = k22_emulated(p_tlb, t_tlb, best, nf, max_words)
        np.testing.assert_array_equal(lr.numpy(), lr_e)
        np.testing.assert_array_equal(nw.numpy(), nw_e)


# ---------------------------------------------------------------------------
# K23: the word-trace walk
# ---------------------------------------------------------------------------


def random_wordtrace(seed, u_dtype, t=T_LEN, r=5, b=7):
    """Random K10 side planes ``[T, R, B]``: entry times below the frame,
    origin slots in [0, R) in ``u_dtype``; final slots, entry times and
    n_frames T, 0, 1 and mid-length."""
    rng = np.random.default_rng(seed)
    et = (rng.uniform(size=(t, r, b)) * np.arange(t)[:, None, None]).astype(np.int32)
    eu = rng.integers(0, r, (t, r, b)).astype(u_dtype)
    best = rng.integers(0, r, b).astype(np.int32)
    entry = rng.integers(0, t, b).astype(np.int32)
    entry[0] = t - 1
    nf = np.r_[t, 0, 1, rng.integers(2, t, b - 3)].astype(np.int32)
    return eu, et, best, entry, nf


U_DTYPES = {str(d).split(".")[-1]: d for d in (_eps_u_dtype(5), _eps_u_dtype(300))}


@pytest.mark.parametrize("u_name", sorted(U_DTYPES))
def test_wordtrace_walk_plain_matches_reference(u_name):
    u_dtype = U_DTYPES[u_name]
    assert set(U_DTYPES.values()) == {torch.int8, torch.int32}
    eu, et, best, entry, nf = random_wordtrace(3, str(u_dtype).split(".")[-1])
    args = [torch.from_numpy(x) for x in (eu, et, best, entry, nf)]
    assert args[0].dtype == u_dtype
    before = tvk.wordtrace_words_device.launches
    wt, nt = tvk.wordtrace_words_device(*args)
    assert tvk.wordtrace_words_device.launches == before  # CPU tensors: the plain version
    max_words = T_LEN + 1
    wj, nj = j_wt(*[jnp.asarray(x) for x in (eu, et, best, entry, nf)], max_words=max_words)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    k = wt.shape[0]
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj)[:k])
    assert (np.asarray(wj)[k:] == -1).all()
    assert k == T_LEN + 1 and int(nt.max()) <= k and int(nt.max()) > 1


def k23_emulated(eu, et, best, entry, nf):
    """``wordtrace_walk_kernel``'s per-thread loop: the ``[T + 1, B]``
    plane and n_words."""
    t_len, r, b = eu.shape
    out = np.full((t_len + 1, b), -1, np.int32)
    n_words = np.zeros(b, np.int32)
    for i in range(b):
        v, t, k = int(best[i]), int(entry[i]), 0
        if nf[i] > 0:
            while k < t_len + 1:
                out[k, i] = v
                n_words[i] += v >= 0
                k += 1
                if t <= 0:
                    break
                tc, vc = min(max(t, 0), t_len - 1), min(max(v, 0), r - 1)
                v, t = int(eu[tc, vc, i]), int(et[tc, vc, i])
    return out, n_words


@pytest.mark.parametrize("t_len", [5, 15, 16, 40])
def test_wordtrace_kernel_loop_and_rows_emulated(t_len):
    """The kernel's loop gives the plain walk's plane, rows included: both
    write T + 1 rows (every chain ends within them), -1 past each chain,
    and the plain walk returns its words and counts as the rows of one
    ``[T + 2, B]`` buffer, which ``wordtrace_words_host`` copies at once."""
    for seed in range(3):
        eu, et, best, entry, nf = random_wordtrace(seed, np.int8, t=t_len)
        if seed == 2:
            nf[:] = 0  # no chain at all: the plain walk still writes T + 1 rows
        wt, nt = tvk.wordtrace_words_ref(*[torch.from_numpy(x)
                                           for x in (eu, et, best, entry, nf)])
        out, n_words = k23_emulated(eu, et, best, entry, nf)
        assert wt.shape[0] == t_len + 1
        np.testing.assert_array_equal(out, wt.numpy())
        np.testing.assert_array_equal(n_words, nt.numpy())
        assert nt.storage_offset() == wt.numel()
        host_w, host_n = tvk.wordtrace_words_host(wt, nt)
        np.testing.assert_array_equal(host_w, out)
        np.testing.assert_array_equal(host_n, n_words)
    with pytest.raises(ValueError, match="one buffer"):
        tvk.wordtrace_words_host(wt, nt.clone())


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------


def _no_library(monkeypatch):
    """Make loading the kernel library fail the test."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(build, "load_library", refuse)


def _k21_args(bad):
    bp, eps_bp, end, nf = [torch.from_numpy(x) for x in random_dense_planes(1)]
    args = dict(bp=bp, eps_bp=eps_bp, end_state=end, n_frames=nf)
    if bad == "dtype":
        args["bp"] = bp.to(torch.int64)
    elif bad == "rank":
        args.update(bp=bp[None], eps_bp=eps_bp[None])
    elif bad == "device":
        args["eps_bp"] = torch.empty(eps_bp.shape, dtype=torch.int32, device="meta")
    elif bad == "vector":
        args["n_frames"] = nf.float()
    return tdk.dense_backtrace, args


def _k22_args(bad):
    pred, tau, best, nf = [torch.from_numpy(x) for x in random_lattice(2)]
    args = dict(pred_w=pred.transpose(1, 2), ends_tau=tau.transpose(1, 2), best_leaf=best,
                n_frames=nf)
    if bad == "dtype":
        args["ends_tau"] = args["ends_tau"].to(torch.int64)
    elif bad == "rank":
        args.update(pred_w=pred[0], ends_tau=tau[0])
    elif bad == "device":
        args["best_leaf"] = torch.empty(best.shape, dtype=torch.int32, device="meta")
    elif bad == "vector":
        args["n_frames"] = nf[:-1]
    return tlk.lattice_walk, args


def _k23_args(bad):
    eu, et, best, entry, nf = [torch.from_numpy(x) for x in random_wordtrace(2, np.int8)]
    args = dict(eps_u=eu, eps_tau=et, best_slot=best, entry_t=entry, n_frames=nf)
    if bad == "dtype":
        args["eps_u"] = eu.to(torch.int16)
    elif bad == "rank":
        args.update(eps_u=eu[0], eps_tau=et[0])
    elif bad == "device":
        args["eps_tau"] = torch.empty(et.shape, dtype=torch.int32, device="meta")
    elif bad == "vector":
        args["entry_t"] = entry.double()
    return tvk.wordtrace_words_device, args


@pytest.mark.parametrize("kernel", ["K21", "K22", "K23"])
@pytest.mark.parametrize("bad", [None, "dtype", "rank", "device", "vector"])
def test_wrappers_gate_on_the_device_and_refuse_bad_inputs(kernel, bad, monkeypatch):
    _no_library(monkeypatch)
    wrapper, args = {"K21": _k21_args, "K22": _k22_args, "K23": _k23_args}[kernel](bad)
    before = wrapper.launches
    if bad is None:
        wrapper(**args)  # CPU tensors: the plain version, no library
    else:
        with pytest.raises(ValueError):
            wrapper(**args)
    assert wrapper.launches == before


def test_callers_route_through_the_walk_wrappers():
    """The public functions of the three walks reach the wrappers (whose
    CPU path is the plain version) and keep their results."""
    assert tdk.dense_backtrace_ref is tv.viterbi_backtrace_ref
    assert tlk.lattice_walk_ref is tlat.lattice_words_ref
    bp, eps_bp, end, nf = [torch.from_numpy(x) for x in random_dense_planes(4)]
    s_a, f_a = tv.viterbi_backtrace(bp, eps_bp, end, nf, 2)
    s_b, f_b = tv.viterbi_backtrace_ref(bp, eps_bp, end, nf, 2)
    assert torch.equal(s_a, s_b) and torch.equal(f_a, f_b)


@pytest.mark.parametrize("eps_depth, eps_reads, first_reads", [(1, 9, 5), (2, 11, 6),
                                                                 (3, 12, 7)])
def test_walk_work_models_count_the_chains(eps_depth, eps_reads, first_reads):
    """The bound models of K21-K23 (``utils/roofline.py``) count the plane
    entries the chains read, by hand."""
    from speech_recognition_tpu_torch.utils import roofline

    nf = torch.tensor([5, 0, 1, 3])
    states = torch.zeros((4, 5), dtype=torch.int32)
    eps_bp = torch.full((4, 5, 3), -1, dtype=torch.int32)
    # stream 0, frame 2: hops 0 -> 1 -> 2, then 2 has none; stream 3,
    # frame 0: one hop 0 -> 2; the hops past a stream's length are not read
    eps_bp[0, 2, 0], eps_bp[0, 2, 1], eps_bp[3, 0, 0] = 1, 2, 2
    eps_bp[1, 0, 0] = eps_bp[2, 3, 0] = 1
    # eps_bp: 9 frames, plus at depth 2 a second read on both chains, at
    # depth 3 a third on stream 0's; bp: 4 + 0 + 0 + 2 frames past frame 0
    assert roofline.dense_walk_work(states, eps_bp, nf, eps_depth) == (
        4 * (eps_reads + 6) + 5 * 4 * 5 + 8 * 4, 36.0)
    # the single-stream form counts as its batch of one (stream 0 alone)
    assert roofline.dense_walk_work(states[0], eps_bp[0], 5, eps_depth) == (
        4 * (first_reads + 4) + 5 * 5 + 8, 20.0)
    n_words = torch.tensor([3, 0, 1])
    # 4 words, 2 steps between words (3 - 1 and 1 - 1)
    assert roofline.chain_walk_work(n_words, 16, 4, 5, 8) == (
        4 * 4 + 2 * 5 + 4 * 3 * 17 + 8 * 3, 16.0)

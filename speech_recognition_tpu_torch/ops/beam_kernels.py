"""The launches of the token beam's two kernels, K19 (the beam step, every
frame of a batch in one launch; ``csrc/token_beam.cu``) and K26 (the token
walk; ``csrc/word_walk.cu``): their packed tables, plans, checks and
calls into the kernel library.

Neither has a TPU kernel: each replaces a jitted ``lax.scan`` of the JAX
package, ``speech_recognition_tpu/ops/beam.py:155`` ``beam_search`` (its
scan ``:317``) and ``:327`` ``beam_backtrace`` (its scan ``:367``).  The
gates that pick the kernel or the plain version and count the launches
are ``ops.beam.beam_search`` and ``ops.beam.beam_backtrace``.

K19's live slots (state >= 0: cost < POS_INF / 2) equal the plain
version's bit for bit: the token planes, the final frontier and its
predecessor words.  Its dead slots hold -1 (state, prev, word, final
predecessor) and POS_INF (final cost), where the plain version leaves
the order of dropped duplicates.  K26 follows only live tokens, so it
gives the same words and costs from either's planes.

K19 reads the graph through ``beam_pack``, int32 records built once per
graph (``device_pack`` keeps them per tables and device): each state's
proposals as one run of edge records (target, weight, target's bank
row), each state's record (its run, end slot, end word), the init states
and the word starts.  ``beam_plan`` is the pure host function that sizes
a launch: a stream's working set (``_layout_bytes``, the kernel's
``beam_layout``: a key table and a token index a state, the sort runs
for the most states a frame can touch (``beam_widest``), the frontier,
M and the eps candidates) with two emission rows in shared memory where
it fits (``"shared"``; the 1k trie at k = 64 takes ~130 KB), else in a
device scratch of B rows (``"device"``: the dictionary-shaped trie
(86,520 states) or k = S), the rows still staged where they fit; the
threads a CTA follow k.  No size is refused.  ``walk_plan`` picks K26's
form: a ring of four windows of frames in shared memory, filled by bulk
copies, where eight frames of both planes fit it with the stream's rows
and the planes are aligned, else one thread a stream.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["BeamPack", "beam_pack", "beam_widest", "device_pack", "BeamPlan", "beam_plan",
           "WalkPlan", "walk_plan", "check_search", "check_walk", "launch_search",
           "launch_walk", "SMEM_LIMIT"]

# the dynamic shared memory a CTA may ask for: the card's 227 KB opt-in
# limit less the kernel's static counters
SMEM_LIMIT = 227 * 1024 - 64
THREADS_MIN, THREADS_MAX = 256, 1024
RUN, GROUP = 32, 8  # the kernel's kRun (keys a warp sorts) and kGroup (runs a round merges)
# K19's counters a stream (its kStats): frames, survivors summed, the most
# in a frame, then the cycles of each phase of a frame
PHASES = ("proposals", "warp sort", "merge and M step", "eps", "ranks and end")
STATS = 3 + len(PHASES)
# K26's frames a window, the fewest worth a window, and the windows in flight
WALK_WINDOW, WALK_MIN_WINDOW, WALK_STAGES = 32, 8, 4


class BeamPack(NamedTuple):
    """K19's tables of one graph, int32 ``[n, 4]`` records (``beam_pack``)."""

    edges: np.ndarray  # [E, 4]: target, weight's float32 bits, target's bank row, 0
    rec: np.ndarray  # [S, 4]: first edge, edge count, end slot, end word
    init: np.ndarray  # [R0, 4]: state, init cost's float32 bits, bank row, 0
    starts: np.ndarray  # [R, 4]: word start state, bank row, first edge, edge count
    dup_starts: bool  # two word starts share a state
    widest: np.ndarray  # [S + 1] int64: the most proposals of n tokens (n largest runs)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.int32)


def beam_pack(tables, has_cross: bool = True) -> BeamPack:
    """The packed tables of ``ops.beam.BeamTables`` (on any device).

    A state's proposals, in the plain version's order: the band moves d =
    0..2 to s + d below S, then (``has_cross``) its child slots.  Edges of
    weight POS_INF / 2 or more are left out: from a live token they never
    make a live candidate (the graphs' absent edges are POS_INF, and
    ``beam_tables`` lists only finite cross edges)."""
    band = tables.band.cpu().numpy()
    s = band.shape[1]
    bank = tables.bank_state.cpu().numpy().astype(np.int32)
    src, tgt, w, order = [], [], [], []
    for d in range(MAX_BAND + 1):
        st = np.arange(s - d)
        keep = band[d, d:] < POS_INF / 2
        src.append(st[keep])
        tgt.append(st[keep] + d)
        w.append(band[d, d:][keep])
        order.append(np.full(int(keep.sum()), d))
    if has_cross:
        cs = tables.child_starts.cpu().numpy()
        cc = tables.child_costs.cpu().numpy()
        ii, jj = np.nonzero((cs >= 0) & (cc < POS_INF / 2))
        src.append(ii)
        tgt.append(cs[ii, jj])
        w.append(cc[ii, jj])
        order.append(MAX_BAND + 1 + jj)
    src, tgt, w, order = (np.concatenate(x) for x in (src, tgt, w, order))
    perm = np.lexsort((order, src))
    src, tgt, w = src[perm], tgt[perm].astype(np.int32), w[perm]
    cnt = np.bincount(src, minlength=s).astype(np.int64)
    off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    edges = np.zeros((max(1, len(tgt)), 4), np.int32)
    edges[: len(tgt), 0] = tgt
    edges[: len(tgt), 1] = _bits(w)
    edges[: len(tgt), 2] = bank[tgt]
    rec = np.stack([off, cnt, tables.end_slot.cpu().numpy(), tables.end_word.cpu().numpy()],
                   1).astype(np.int32)
    init_s = tables.init_states.cpu().numpy()
    init = np.zeros((max(1, len(init_s)), 4), np.int32)
    init[: len(init_s), 0] = init_s
    init[: len(init_s), 1] = _bits(tables.init_costs.cpu().numpy())
    init[: len(init_s), 2] = bank[init_s]
    ws = tables.word_starts.cpu().numpy()
    starts = np.zeros((max(1, len(ws)), 4), np.int32)
    starts[: len(ws)] = np.stack([ws, bank[ws], off[ws], cnt[ws]], 1)
    widest = np.concatenate([[0], np.cumsum(np.sort(cnt)[::-1])]).astype(np.int64)
    return BeamPack(edges=edges, rec=rec, init=init, starts=starts,
                    dup_starts=len(np.unique(ws)) < len(ws), widest=widest)


def beam_widest(pack: BeamPack, k: int, n_init: int) -> int:
    """The most states a frame can touch at beam ``k``: the proposals of the
    k tokens with the longest runs (the init states at frame 0), at most S."""
    s = pack.rec.shape[0]
    return int(min(s, max(n_init, int(pack.widest[min(k, s)]), 1)))


_PACKS: "collections.OrderedDict" = collections.OrderedDict()
_PACKS_KEPT = 8


def _tensors_key(ts) -> tuple:
    return tuple((t.data_ptr(), t._version, tuple(t.shape), str(t.device)) for t in ts)


def device_pack(tables, has_cross: bool, dev) -> dict:
    """``beam_pack`` of ``tables`` as int32 tensors on ``dev`` (``edges``,
    ``rec``, ``init``, ``starts``) with the host pack (``pack``), built
    once per tables (their tensors and versions) and kept for the last
    few; an entry holds its tables, so their memory is not reused while
    it is kept."""
    key = (_tensors_key(t for t in tables if isinstance(t, torch.Tensor)), bool(has_cross),
           str(dev))
    ent = _PACKS.get(key)
    if ent is None:
        pack = beam_pack(tables, has_cross)
        ent = {"tables": tables, "pack": pack}
        ent.update({f: torch.from_numpy(getattr(pack, f)).to(dev)
                    for f in ("edges", "rec", "init", "starts")})
        _PACKS[key] = ent
        while len(_PACKS) > _PACKS_KEPT:
            _PACKS.popitem(last=False)
    else:
        _PACKS.move_to_end(key)
    return ent


class BeamPlan(NamedTuple):
    """A K19 launch's layout: where a stream's working set lives
    (``"shared"`` or ``"device"``), the threads a CTA, the working set's
    bytes and whether the two emission rows are staged in shared memory."""

    tier: str
    threads: int
    nbytes: int
    staged: bool


def _r8(x: int) -> int:
    return (x + 7) & ~7


def _pow2(m: int) -> int:
    p = 1
    while p < m:
        p <<= 1
    return p


def _sort_cap(mmax: int, k: int) -> int:
    """The sort buffers' length (the kernel's ``sort_cap``): the widest
    layout of runs any merge round writes for up to ``mmax`` survivors,
    runs of 32 merged 8 at a time, each run cut at k."""
    n = -(-mmax // RUN)
    length, need = RUN, n * RUN
    while n > 1:
        g = min(n, GROUP)
        n = -(-n // g)
        length = min(g * length, k)
        need = max(need, n * length)
    return need


def _layout_bytes(s: int, k: int, mmax: int, r: int, l: int) -> int:
    """A stream's working set in bytes, segment by segment as the kernel's
    ``beam_layout``: keys [S], two sort buffers [``_sort_cap``], M's keys
    [k] and the winners' keys [R] (8 bytes); the token index [S], the
    sort's places (2 [``_sort_cap``]), the touched list [mmax], the frontier (5 [k]), M (8 [k]), the end list
    [min(k, L)], the eps candidates (7 [R]) and the winners' kills and
    word starts (2 [R])."""
    cap = _sort_cap(mmax, k)
    segs = [8 * s, 8 * cap, 8 * cap, 8 * k, 8 * r, 4 * s, 4 * cap, 4 * cap, 4 * mmax]
    segs += [4 * k] * 13
    segs += [4 * min(k, l)] + [4 * r] * 9
    return sum(_r8(x) for x in segs)


def _row_bytes(u: int) -> int:
    """The two staged emission rows (the kernel's ``row_bytes``)."""
    return 2 * _r8(4 * u)


def beam_threads(k: int) -> int:
    """Threads a K19 CTA: about four a token (``g``, the threads a
    token's proposals share), 256 to 1,024."""
    return min(THREADS_MAX, max(THREADS_MIN, _pow2(4 * k)))


def beam_plan(n_states: int, k: int, mmax: int, n_starts: int, n_ends: int, n_units: int,
              limit: int = SMEM_LIMIT) -> BeamPlan:
    """The K19 layout for a trie of ``n_states`` states, beam ``k``, at most
    ``mmax`` states touched a frame (``beam_widest``), ``n_starts`` word
    starts, ``n_ends`` leaves and ``n_units`` emission rows: the working
    set and the rows in shared memory where they fit in ``limit`` bytes,
    else the working set in a device scratch a stream and the rows staged
    where they fit alone."""
    ws = _layout_bytes(n_states, k, mmax, n_starts, n_ends)
    rows = _row_bytes(n_units)
    threads = beam_threads(k)
    if ws + rows <= limit:
        return BeamPlan("shared", threads, ws, True)
    return BeamPlan("device", threads, ws, rows <= limit)


class WalkPlan(NamedTuple):
    """A K26 launch's form: ``"window"`` (one warp a stream, ``window``
    frames of both planes a copy, ``nbytes`` of shared memory) or
    ``"chain"`` (one thread a stream through device memory)."""

    form: str
    window: int
    nbytes: int


def _walk_smem(window: int, k: int, t_len: int) -> int:
    """The window form's shared memory (the kernel's ``walk_smem``): a ring
    of WALK_STAGES windows of both planes, the stream's rows, the stages'
    mbarriers."""
    return 4 * (2 * WALK_STAGES * window * k + t_len) + 8 * WALK_STAGES + 8


def walk_plan(k: int, t_len: int, aligned: bool = True, limit: int = SMEM_LIMIT) -> WalkPlan:
    """K26's form at beam ``k`` and ``t_len`` frames: windows of up to 32
    frames where the planes take bulk copies (``aligned``: 16-byte aligned,
    k a multiple of 4) and the ring and the rows fit ``limit`` with at
    least 8 frames a window (k up to ~900 at 500 frames), else the chain
    form."""
    room = limit - _walk_smem(0, k, t_len)
    w = min(WALK_WINDOW, max(0, room) // (8 * WALK_STAGES * k))
    if aligned and k % 4 == 0 and w >= WALK_MIN_WINDOW:
        return WalkPlan("window", w, _walk_smem(w, k, t_len))
    return WalkPlan("chain", 0, 0)


def _check(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the beam's inputs on {dev}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} of shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def check_search(nll, tables, n_frames, bigram_cost):
    """``ValueError`` unless the beam's inputs are what K19 takes: float32
    ``nll [B, T, U]`` with T >= 1, the tables of ``beam_tables`` on its
    device, ``n_frames [B]`` and a float32 ``bigram_cost [V + 1, V]``."""
    if nll.dtype != torch.float32 or nll.dim() != 3 or nll.shape[1] == 0:
        raise ValueError(f"the token beam takes float32 emissions [B, T >= 1, U], got "
                         f"{nll.dtype} {tuple(nll.shape)}")
    dev, tb = nll.device, tables
    s, c = tb.child_starts.shape
    r, l = tb.eps_block.shape
    for name, t, dtype, shape in (
            ("band", tb.band, torch.float32, (MAX_BAND + 1, s)),
            ("child_costs", tb.child_costs, torch.float32, (s, c)),
            ("end_slot", tb.end_slot, torch.int64, (s,)),
            ("end_word", tb.end_word, torch.int64, (s,)),
            ("word_starts", tb.word_starts, torch.int64, (r,)),
            ("init_costs", tb.init_costs, torch.float32, tuple(tb.init_states.shape)),
            ("bank_state", tb.bank_state, torch.int64, (s,)),
            ("child_starts", tb.child_starts, torch.int64, (s, c)),
            ("init_states", tb.init_states, torch.int64, tuple(tb.init_states.shape)),
            ("end_bonus", tb.end_bonus, torch.float32, tuple(tb.end_bonus.shape))):
        _check(name, t, dtype, shape, dev)
    if s != tb.n_states or tb.eps_block.dtype != torch.float32 or tb.eps_block.device != dev:
        raise ValueError("the beam tables disagree with their state count or device")
    if tuple(n_frames.shape) != (nll.shape[0],) or n_frames.device != dev:
        raise ValueError(f"n_frames must be [B] = [{nll.shape[0]}] on {dev}")
    if bigram_cost is not None:
        v = bigram_cost.shape[-1]
        _check("bigram_cost", bigram_cost, torch.float32, (v + 1, v), dev)


def check_walk(final_state, final_cost, tok_prev, tok_word, tables, n_frames, final_pred,
               bigram_cost, bigram_end):
    """``ValueError`` unless the walk's inputs are what K26 takes: K19's
    int32 frontier and planes, float32 costs, the tables' end arrays, the
    lengths and a bigram on the planes' device, T >= 1, and the final
    predecessors where a bigram is given."""
    b, t_len, k = tok_prev.shape
    dev = tok_prev.device
    if t_len == 0:
        raise ValueError("the token walk needs planes of at least one frame")
    if bigram_cost is not None and final_pred is None:
        raise ValueError("a bigram needs the final tokens' predecessor words (final_pred)")
    if bigram_end is not None and bigram_cost is None:
        raise ValueError("bigram_end needs bigram_cost")
    i32, f32 = torch.int32, torch.float32
    for name, t, dtype, shape in (("final_state", final_state, i32, (b, k)),
                                  ("final_cost", final_cost, f32, (b, k)),
                                  ("final_pred", final_pred, i32, (b, k)),
                                  ("tok_word", tok_word, i32, (b, t_len, k)),
                                  ("n_frames", n_frames, n_frames.dtype, (b,))):
        if t is not None:
            _check(name, t, dtype, shape, dev)
    if bigram_cost is not None:
        v = bigram_cost.shape[-1]
        _check("bigram_cost", bigram_cost, f32, (v + 1, v), dev)
        if bigram_end is not None:
            _check("bigram_end", bigram_end, f32, (v,), dev)
    if tok_prev.dtype != i32:
        raise ValueError(f"tok_prev must be int32, got {tok_prev.dtype}")
    s = tables.n_states
    for name, t, dtype, shape in (("end_slot", tables.end_slot, torch.int64, (s,)),
                                  ("end_word", tables.end_word, torch.int64, (s,)),
                                  ("end_bonus", tables.end_bonus, f32,
                                   tuple(tables.end_bonus.shape))):
        _check(name, t, dtype, shape, dev)


def _c(t):
    return None if t is None else t.contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_search(nll, tables, n_frames, k: int, has_cross: bool, bigram_cost, plan=None,
                  stats=None):
    """One K19 launch on checked CUDA tensors (``ops.beam.beam_search``
    checks and counts): ``(final_state [B, k], final_cost, final_pred,
    tok_state [B, T, k], tok_prev, tok_word)``, int32 but the costs.
    ``plan`` forces a ``BeamPlan`` (its working set must be the layout's);
    ``stats``, an int64 ``[B, 8]`` tensor (``STATS``), takes each stream's
    frames, the states its frames touched summed, the most in one frame,
    and its CTA's clock64 cycles summed by phase (``PHASES``)."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    b, t_len, u = nll.shape
    tb = tables
    dev = nll.device
    s = tb.n_states
    r, l = tb.eps_block.shape
    r0 = tb.init_states.shape[0]
    v = 0 if bigram_cost is None else bigram_cost.shape[1]
    packed = device_pack(tb, has_cross, dev)
    mmax = beam_widest(packed["pack"], k, r0)
    plan = plan or beam_plan(s, k, mmax, r, l, u)
    i32 = dict(dtype=torch.int32, device=dev)
    fst = torch.empty((b, k), **i32)
    fco = torch.empty((b, k), dtype=torch.float32, device=dev)
    fpd = torch.empty((b, k), **i32)
    tok_s = torch.empty((b, t_len, k), **i32)
    tok_p = torch.empty_like(tok_s)
    tok_w = torch.empty_like(tok_s)
    if b == 0:
        return fst, fco, fpd, tok_s, tok_p, tok_w
    if stats is not None and (stats.dtype != torch.int64 or tuple(stats.shape) != (b, STATS)
                              or stats.device != dev):
        raise ValueError(f"stats must be int64 [{b}, {STATS}] on {dev}")
    scratch = None
    if plan.tier == "device":
        scratch = torch.empty((b * plan.nbytes,), dtype=torch.uint8, device=dev)
    nf = n_frames if n_frames.dtype == torch.int32 else n_frames.to(torch.int32)
    ins = [_c(x) for x in (nll, packed["edges"], packed["rec"], packed["init"],
                           packed["starts"], tb.eps_block, bigram_cost, nf)]
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.token_beam_launch(
            *[_ptr(x) for x in ins], fst.data_ptr(), fco.data_ptr(), fpd.data_ptr(),
            tok_s.data_ptr(), tok_p.data_ptr(), tok_w.data_ptr(), _ptr(scratch), _ptr(stats),
            b, t_len, u, s, r, l, r0, v, k, mmax, int(packed["pack"].dup_starts),
            int(plan.tier == "shared"), int(plan.staged), plan.threads, plan.nbytes,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "token beam kernel")
    return fst, fco, fpd, tok_s, tok_p, tok_w


def launch_walk(final_state, final_cost, tok_prev, tok_word, tables, n_frames, final_pred,
                bigram_cost, bigram_end, plan=None):
    """One K26 launch on CUDA tensors (``ops.beam.beam_backtrace`` checks
    and counts): ``(best_cost [B], words_rev [B, T + 1] int32)``.
    ``plan`` forces a ``WalkPlan``."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    b, t_len, k = tok_prev.shape
    dev = tok_prev.device
    best = torch.empty((b,), dtype=torch.float32, device=dev)
    words = torch.empty((b, t_len + 1), dtype=torch.int32, device=dev)
    if b == 0:
        return best, words
    tb = tables
    plan = plan or walk_plan(k, t_len, aligned=(tok_prev.data_ptr() | tok_word.data_ptr()) % 16
                             == 0 and tok_prev.is_contiguous() and tok_word.is_contiguous())
    v = 0 if bigram_cost is None else bigram_cost.shape[1]
    nf = n_frames if n_frames.dtype == torch.int32 else n_frames.to(torch.int32)
    ins = [_c(x) for x in (final_state, final_cost, final_pred, tok_prev, tok_word,
                           tb.end_slot, tb.end_word, tb.end_bonus, bigram_cost, bigram_end,
                           nf)]
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.token_walk_launch(
            *[_ptr(x) for x in ins], best.data_ptr(), words.data_ptr(), b, t_len, k,
            tb.n_states, tb.end_bonus.shape[0], v, plan.window,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "token walk kernel")
    return best, words

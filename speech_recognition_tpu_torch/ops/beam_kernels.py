"""The launches of the token beam's two kernels, K19 (the beam step, every
frame of a batch in one launch; ``csrc/token_beam.cu``) and K26 (the token
walk; ``csrc/word_walk.cu``): their plan, their checks and their calls
into the kernel library.

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

``beam_plan`` is the pure host function that sizes a K19 launch: a
stream's working set (``_layout_bytes``, the kernel's ``beam_layout``: a
dense key table and a token index a state, the frontiers, the sort
buffer, the eps candidates) with the frame's emission row staged, in
shared memory where it fits (``"shared"``, 512 threads a CTA; the 1k
trie at k = 64 takes ~130 KB), else in a device scratch of B rows
(``"device"``, 1,024 threads, the emission rows read from device
memory): the dictionary-shaped trie (86,520 states) or k = S.  No size
is refused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND

__all__ = ["BeamPlan", "beam_plan", "check_search", "check_walk", "launch_search",
           "launch_walk", "SMEM_LIMIT"]

# the dynamic shared memory a CTA may ask for: the card's 227 KB opt-in
# limit less the kernel's static counters
SMEM_LIMIT = 227 * 1024 - 64
THREADS_SHARED = 512
THREADS_DEVICE = 1024


class BeamPlan(NamedTuple):
    """A K19 launch's layout: where a stream's working set lives
    (``"shared"`` or ``"device"``), the threads a CTA and the working
    set's bytes."""

    tier: str
    threads: int
    nbytes: int


def _r8(x: int) -> int:
    return (x + 7) & ~7


def _pow2(m: int) -> int:
    p = 1
    while p < m:
        p <<= 1
    return p


def _layout_bytes(s: int, k: int, nb: int, r: int, l: int, u: int, staged: bool) -> int:
    """A stream's working set in bytes, segment by segment as the kernel's
    ``beam_layout``: keys [S] and the sort buffer [P] (8 bytes), the
    token index [S], the slot index [L], the touched list [mmax], the
    frontier (3 [k]), the merged list (4 [k]), the end list [min(k, L)],
    the eps candidates (7 [R]) and, staged, the emission row [U]."""
    mmax = min(s, k * nb)
    segs = [8 * s, 8 * _pow2(mmax), 4 * s, 4 * l, 4 * mmax] + [4 * k] * 7 + [4 * min(k, l)]
    segs += [4 * r] * 7 + [4 * u if staged else 0]
    return sum(_r8(x) for x in segs)


def beam_plan(n_states: int, k: int, n_children: int, n_starts: int, n_ends: int,
              n_units: int, limit: int = SMEM_LIMIT) -> BeamPlan:
    """The K19 layout for a trie of ``n_states`` states, beam ``k``,
    ``n_children`` child slots a state (0 without cross edges: 3 proposals
    a token, else 3 + C), ``n_starts`` word starts, ``n_ends`` leaves and
    ``n_units`` emission rows: shared memory where the working set fits
    in ``limit`` bytes, else a device scratch a stream."""
    nb = MAX_BAND + 1 + n_children
    shared = _layout_bytes(n_states, k, nb, n_starts, n_ends, n_units, True)
    if shared <= limit:
        return BeamPlan("shared", THREADS_SHARED, shared)
    return BeamPlan("device", THREADS_DEVICE,
                    _layout_bytes(n_states, k, nb, n_starts, n_ends, n_units, False))


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


def launch_search(nll, tables, n_frames, k: int, has_cross: bool, bigram_cost):
    """One K19 launch on checked CUDA tensors (``ops.beam.beam_search``
    checks and counts): ``(final_state [B, k], final_cost, final_pred,
    tok_state [B, T, k], tok_prev, tok_word)``, int32 but the costs."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    b, t_len, u = nll.shape
    tb = tables
    dev = nll.device
    s, c = tb.child_starts.shape
    r, l = tb.eps_block.shape
    r0 = tb.init_states.shape[0]
    v = 0 if bigram_cost is None else bigram_cost.shape[1]
    plan = beam_plan(s, k, c if has_cross else 0, r, l, u)
    i32 = dict(dtype=torch.int32, device=dev)
    fst = torch.empty((b, k), **i32)
    fco = torch.empty((b, k), dtype=torch.float32, device=dev)
    fpd = torch.empty((b, k), **i32)
    tok_s = torch.empty((b, t_len, k), **i32)
    tok_p = torch.empty_like(tok_s)
    tok_w = torch.empty_like(tok_s)
    if b == 0:
        return fst, fco, fpd, tok_s, tok_p, tok_w
    scratch = None
    if plan.tier == "device":
        scratch = torch.empty((b * plan.nbytes,), dtype=torch.uint8, device=dev)
    nf = n_frames if n_frames.dtype == torch.int32 else n_frames.to(torch.int32)
    ins = [_c(x) for x in (nll, tb.band, tb.child_starts, tb.child_costs, tb.end_slot,
                           tb.end_word, tb.word_starts, tb.eps_block, tb.init_states,
                           tb.init_costs, tb.bank_state, bigram_cost, nf)]
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.token_beam_launch(
            *[None if x is None else x.data_ptr() for x in ins], fst.data_ptr(),
            fco.data_ptr(), fpd.data_ptr(), tok_s.data_ptr(), tok_p.data_ptr(),
            tok_w.data_ptr(), None if scratch is None else scratch.data_ptr(), b, t_len, u, s,
            c, r, l, r0, v, k, int(has_cross), int(plan.tier == "shared"), plan.threads,
            plan.nbytes, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "token beam kernel")
    return fst, fco, fpd, tok_s, tok_p, tok_w


def launch_walk(final_state, final_cost, tok_prev, tok_word, tables, n_frames, final_pred,
                bigram_cost, bigram_end):
    """One K26 launch on CUDA tensors (``ops.beam.beam_backtrace`` checks
    and counts): ``(best_cost [B], words_rev [B, T + 1] int32)``."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    b, t_len, k = tok_prev.shape
    dev = tok_prev.device
    best = torch.empty((b,), dtype=torch.float32, device=dev)
    words = torch.empty((b, t_len + 1), dtype=torch.int32, device=dev)
    if b == 0:
        return best, words
    tb = tables
    v = 0 if bigram_cost is None else bigram_cost.shape[1]
    nf = n_frames if n_frames.dtype == torch.int32 else n_frames.to(torch.int32)
    ins = [_c(x) for x in (final_state, final_cost, final_pred, tok_prev, tok_word,
                           tb.end_slot, tb.end_word, tb.end_bonus, bigram_cost, bigram_end,
                           nf)]
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.token_walk_launch(
            *[None if x is None else x.data_ptr() for x in ins], best.data_ptr(),
            words.data_ptr(), b, t_len, k, tb.n_states, tb.end_bonus.shape[0], v,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "token walk kernel")
    return best, words

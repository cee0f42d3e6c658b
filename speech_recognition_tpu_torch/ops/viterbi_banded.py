"""Banded min-cost Viterbi over composed word graphs: graph arrays and
the plain (unfused) oracles.

Counterpart of ``speech_recognition_tpu/ops/viterbi_banded.py``.  Frame
edges of every composed word graph lie within a word at state offsets
0 (self), +1 (step) and +2 (skip), so one frame step is three shifted
adds of the ``[S, B]`` frontier plus a small dense ``[R, L]`` epsilon
block between word ends and word starts.  Lexical trees add one frame
edge per arc start with a static origin, parent-arc end -> child-arc
start (``cross_src`` / ``cross_cost``), a gather of the previous
frontier.  Backpointers are one int8 per (frame, state): the band
offset 0..2, ``_CROSS`` for the cross edge, or ``_EPS`` for an epsilon
arrival whose origin word end goes to the ``[T, R, B]`` side plane.

``viterbi_banded_tb`` / ``banded_backtrace_tb`` are per-frame Python
loops over ``[S, B]`` tensors: the oracles for any banded graph and
the CPU path for graphs the fused kernels do not take.  With a beam
(``beam_width``) the forward is this loop on either device, as no
kernel prunes.  The production
path is ``ops.viterbi_banded_kernels``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.viterbi import _beam_prune
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["MAX_BAND", "BandedGraph", "banded_arrays", "eps_ranges",
           "viterbi_banded_tb", "viterbi_banded_chunk_tb", "banded_backtrace_tb"]

MAX_BAND = 2  # reference max_jump_dist
_CROSS = MAX_BAND + 1  # bp8 code: cross-arc frame edge (origin = cross_src[s])
_EPS = MAX_BAND + 2  # bp8 code: eps arrival; origin u in the eps_u side plane


class BandedGraph(NamedTuple):
    """Banded form of a WordGraph, as tensors on one device.

    ``word_starts [R]`` / ``word_ends [L]`` are the epsilon re-entry and
    exit states; ``eps_block [R, L]`` the same-column costs between them.
    ``cross_src`` / ``cross_cost`` (None for composed word graphs) add a
    frame edge with a static origin per state: a trie's parent-end ->
    child-start edges.
    """

    band: torch.Tensor  # [MAX_BAND+1, S] cost of arriving from state v-d
    init_cost: torch.Tensor  # [S]
    word_starts: torch.Tensor  # [R] int64
    word_ends: torch.Tensor  # [L] int64
    eps_block: torch.Tensor  # [R, L]
    start_pos: torch.Tensor  # [S] slot r if state is starts[r] else 0
    is_start: torch.Tensor  # [S] bool
    end_states: torch.Tensor  # [E] int64
    end_bonus: torch.Tensor  # [E]
    bank_state: torch.Tensor  # [S] int64
    cross_src: Optional[torch.Tensor] = None  # [S] int64 static frame-edge origin
    cross_cost: Optional[torch.Tensor] = None  # [S] f32, POS_INF where absent

    @property
    def n_states(self) -> int:
        return self.band.shape[1]

    @property
    def n_words(self) -> int:
        return self.word_starts.shape[0]

    @property
    def n_ends(self) -> int:
        return self.word_ends.shape[0]

    def to(self, device) -> "BandedGraph":
        return BandedGraph(*[None if t is None else t.to(device) for t in self])


def _eps_u_dtype(n_ends: int):
    """Side-plane dtype for epsilon origins: int8 up to 127 ends."""
    return torch.int8 if n_ends <= 127 else torch.int32


def banded_arrays(graph, device=None) -> BandedGraph:
    """Extract the banded form; raises ValueError if the graph is not
    banded."""
    s = graph.n_states
    trans = np.asarray(graph.trans)
    band = np.full((MAX_BAND + 1, s), POS_INF, dtype=np.float32)
    covered = np.zeros_like(trans, dtype=bool)
    for d in range(MAX_BAND + 1):
        idx = np.arange(d, s)
        band[d, idx] = trans[idx, idx - d]
        covered[idx, idx - d] = True
    if ((trans < POS_INF / 2) & ~covered).any():
        raise ValueError("graph has frame edges outside the +0..+2 band")

    slot = np.asarray(graph.slot)
    starts = np.flatnonzero(np.r_[True, slot[1:] != slot[:-1]])
    ends = np.r_[starts[1:] - 1, s - 1]
    for d in range(1, MAX_BAND + 1):
        idx = np.arange(d, s)
        crosses = slot[idx] != slot[idx - d]
        if np.any((band[d, idx] < POS_INF / 2) & crosses):
            raise ValueError("band edge crosses a word boundary")

    eps = np.asarray(graph.eps_trans)
    eps_block = eps[np.ix_(starts, ends)].astype(np.float32)
    covered_eps = np.zeros_like(eps, dtype=bool)
    covered_eps[np.ix_(starts, ends)] = True
    if ((eps < POS_INF / 2) & ~covered_eps).any():
        raise ValueError("epsilon edge outside end->start structure")

    start_pos = np.zeros(s, dtype=np.int64)
    start_pos[starts] = np.arange(len(starts))
    is_start = np.zeros(s, dtype=bool)
    is_start[starts] = True

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BandedGraph(
        band=t(band, torch.float32),
        init_cost=t(graph.init_cost, torch.float32),
        word_starts=t(starts, torch.int64),
        word_ends=t(ends, torch.int64),
        eps_block=t(eps_block, torch.float32),
        start_pos=t(start_pos, torch.int64),
        is_start=t(is_start, torch.bool),
        end_states=t(graph.end_states, torch.int64),
        end_bonus=t(graph.end_bonus, torch.float32),
        bank_state=t(graph.bank_state, torch.int64),
    )


def eps_ranges(g: BandedGraph) -> tuple:
    """Maximal runs of consecutive to-arcs sharing one finite from-arc
    span of the eps block, as ``((r_lo, r_hi, u_lo, u_hi), ...)``."""
    blk = g.eps_block.cpu().numpy()
    spans = []
    for i in range(blk.shape[0]):
        us = np.flatnonzero(blk[i] < POS_INF / 2)
        spans.append((int(us.min()), int(us.max()) + 1) if us.size else None)
    out, cur = [], None
    for i, sp in enumerate(spans):
        if sp is None:
            if cur:
                out.append(cur)
            cur = None
        elif cur and (cur[2], cur[3]) == sp:
            cur = (cur[0], i + 1, cur[2], cur[3])
        else:
            if cur:
                out.append(cur)
            cur = (i, i + 1, sp[0], sp[1])
    if cur:
        out.append(cur)
    return tuple(out)


def _shift_s(x, d):
    """``x[v-d]`` along the state axis (0) with POS_INF fill."""
    if d == 0:
        return x
    pad = torch.full((d,) + x.shape[1:], POS_INF, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:-d]], dim=0)


def _select_band(cands):
    """Dense-argmin tie-break = largest d: iterate d ascending and
    replace on <=."""
    best = torch.full_like(cands[0], POS_INF)
    d_sel = torch.zeros(cands[0].shape, dtype=torch.int8, device=cands[0].device)
    for d, cand in enumerate(cands):
        take = cand <= best
        best = torch.where(take, cand, best)
        d_sel = torch.where(take, torch.full_like(d_sel, d), d_sel)
    return torch.clamp(best, max=POS_INF), d_sel


def _cross_relax(base, d_sel, prev, g: BandedGraph):
    """Static-origin cross edges: ``prev[cross_src] + cross_cost``, read
    from the PREVIOUS frontier after the band select.  Ties go to the
    cross edge (its origin precedes every band origin in preorder)."""
    if g.cross_src is None:
        return base, d_sel
    cand = torch.clamp(prev[g.cross_src] + g.cross_cost[:, None], max=POS_INF)
    take = cand <= base
    return (torch.where(take, cand, base),
            torch.where(take, torch.full_like(d_sel, _CROSS), d_sel))


def _first_min(scores, dim):
    """``(min, index of the first minimum)`` along ``dim``."""
    return scores.amin(dim), torch.argmin(scores, dim)


def _column(base_cost, d_sel, emis, g: BandedGraph, eps_depth: int, u_dtype, org=None):
    """One frame after the band (and cross) select: the emission, then
    ``eps_depth`` Jacobi eps passes.  ``org [S, B]`` (the ancestor map
    after the band move, or None) follows each eps arrival: a start that
    an arrival improves takes the org of the origin word end as the pass
    found it.  Returns ``(cost, bp8, eps_u [R, B], org)``."""
    cost = torch.clamp(base_cost + emis, max=POS_INF)
    bp8 = d_sel
    eps_u = torch.zeros((g.n_words, cost.shape[1]), dtype=u_dtype, device=cost.device)
    for _ in range(eps_depth):
        end_vals = cost[g.word_ends]  # [L, B]
        base, origin = _first_min(g.eps_block[:, :, None] + end_vals[None], 1)
        cand = torch.clamp(base + emis[g.word_starts], max=POS_INF)
        cand_dense = cand[g.start_pos]
        better = g.is_start[:, None] & (cand_dense < cost)
        if org is not None:
            arc_org = org[g.word_ends].gather(0, origin)  # [R, B]
            org = torch.where(better, arc_org[g.start_pos], org)
        cost = torch.where(better, cand_dense, cost)
        bp8 = torch.where(better, torch.full_like(bp8, _EPS), bp8)
        better_r = better[g.word_starts]
        eps_u = torch.where(better_r, origin.to(u_dtype), eps_u)
    return cost, bp8, eps_u, org


def viterbi_banded_tb(nll_tb, g: BandedGraph, n_frames, eps_depth: int = 1,
                      beam_width: int = 0):
    """State-major batched banded Viterbi: ``nll_tb [T, S, B]``,
    ``n_frames [B]`` -> ``(final [S, B], bp8 [T, S, B] int8,
    eps_u [T, R, B])``.

    ``beam_width`` k > 0 prunes each column after its eps passes to the
    costs ``<=`` the stream's k-th smallest, and the pruned column is the
    carry: the reference's per-utterance ``viterbi_banded(beam_width=)``
    run on every stream at once (its batched form takes no beam)."""
    t_len, s, b = nll_tb.shape
    r = g.n_words
    u_dtype = _eps_u_dtype(g.n_ends)
    dev = nll_tb.device
    nll_tb = torch.clamp(nll_tb, max=POS_INF)
    n_frames = n_frames.to(dev)

    def column(base_cost, d_sel, emis):
        cost, bp8, eps_u, _ = _column(base_cost, d_sel, emis, g, eps_depth, u_dtype)
        if beam_width:
            cost = _beam_prune(cost, beam_width, dim=0)
        return cost, bp8, eps_u

    bp8 = torch.empty((t_len, s, b), dtype=torch.int8, device=dev)
    eps_u = torch.empty((t_len, r, b), dtype=u_dtype, device=dev)
    init = g.init_cost[:, None].expand(s, b)
    cost, bp8[0], eps_u[0] = column(init, torch.zeros((s, b), dtype=torch.int8,
                                                      device=dev), nll_tb[0])
    final = torch.where((n_frames == 1)[None, :], cost, torch.full_like(cost, POS_INF))
    for t in range(1, t_len):
        prev = cost
        base, d_sel = _select_band([g.band[d][:, None] + _shift_s(prev, d)
                                    for d in range(MAX_BAND + 1)])
        base, d_sel = _cross_relax(base, d_sel, prev, g)
        cost, bp8[t], eps_u[t] = column(base, d_sel, nll_tb[t])
        cost = torch.where((t < n_frames)[None, :], cost, prev)
        final = torch.where((t == n_frames - 1)[None, :], cost, final)
    return final, bp8, eps_u


def _shift_org(org, d):
    """``org[v-d]`` along the state axis with 0 fill (an int32 carry that
    follows the band winner: an ancestor map or an entry time)."""
    pad = torch.zeros((d,) + org.shape[1:], dtype=org.dtype, device=org.device)
    return torch.cat([pad, org[:-d]], dim=0)


def viterbi_banded_chunk_tb(nll_tb, g: BandedGraph, frontier, n_valid, eps_depth: int = 1,
                            first_chunk: bool = False, track_org: bool = False):
    """One chunk of a streaming decode: ``nll_tb [C, S, B]`` advances the
    carried ``frontier [S, B]``; ``n_valid [B]`` frames of each stream are
    real.  Returns ``(frontier_out [S, B], bp8 [C, S, B] int8,
    eps_u [C, R, B], org [S, B] int32 or None)``.

    ``first_chunk``: frame 0 seeds from ``frontier`` (the graph's init
    cost) with code 0, as the utterance's first frame does; otherwise
    frame 0 relaxes the band and cross edges from ``frontier``, the
    previous chunk's last column.  Every frame ``t >= n_valid`` freezes
    the carry (frame 0 included) and ``frontier_out`` is the carry, so a
    stream with no valid frame keeps its frontier; frozen frames still
    write their plane rows from the frozen carry.  With ``track_org``
    the ancestor map ``org`` (state -> the state at the chunk start its
    best token descends from) starts as the identity, follows the band
    winner (``org[s-d]``, 0 for ``s < d``), the cross edge
    (``org[cross_src]``) and each eps arrival, and freezes with the
    carry.  Fed a whole utterance's emissions chunk by chunk, the planes
    and the final carry equal ``viterbi_banded_tb``'s."""
    c_len, s, b = nll_tb.shape
    u_dtype = _eps_u_dtype(g.n_ends)
    dev = nll_tb.device
    nll_tb = torch.clamp(nll_tb, max=POS_INF)
    active = torch.arange(c_len, device=dev)[:, None] < n_valid.to(dev)[None, :]  # [C, B]
    bp8 = torch.empty((c_len, s, b), dtype=torch.int8, device=dev)
    eps_u = torch.empty((c_len, g.n_words, b), dtype=u_dtype, device=dev)
    prev = frontier
    org = (torch.arange(s, dtype=torch.int32, device=dev)[:, None].expand(s, b).contiguous()
           if track_org else None)
    for t in range(c_len):
        if t == 0 and first_chunk:
            base, d_sel = prev, torch.zeros((s, b), dtype=torch.int8, device=dev)
        else:
            base, d_sel = _select_band([g.band[d][:, None] + _shift_s(prev, d)
                                        for d in range(MAX_BAND + 1)])
            base, d_sel = _cross_relax(base, d_sel, prev, g)
        new_org = org
        if track_org:
            for d in range(1, MAX_BAND + 1):
                new_org = torch.where(d_sel == d, _shift_org(org, d), new_org)
            if g.cross_src is not None:
                new_org = torch.where(d_sel == _CROSS, org[g.cross_src], new_org)
        cost, bp8[t], eps_u[t], new_org = _column(base, d_sel, nll_tb[t], g, eps_depth,
                                                   u_dtype, new_org)
        prev = torch.where(active[t][None, :], cost, prev)
        if track_org:
            org = torch.where(active[t][None, :], new_org, org)
    return prev, bp8, eps_u, org


def banded_backtrace_tb(bp8, eps_u, g: BandedGraph, end_state, n_frames,
                        eps_depth: int = 1):
    """Backtrace ``bp8 [T, S, B]``, ``eps_u [T, R, B]`` from
    ``end_state [B]`` -> ``(states [T, B] int32, eps_entered [T, B]
    bool)``.  The recorded state of frame t is the pre-unwind state."""
    t_len, s, b = bp8.shape
    dev = bp8.device
    n_frames = n_frames.to(dev)
    cols = torch.arange(b, device=dev)
    st = end_state.to(dev, torch.int64)
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    for t in range(t_len - 1, -1, -1):
        rec = st
        code = bp8[t][st, cols].to(torch.int64)
        used = torch.zeros(b, dtype=torch.bool, device=dev)
        for _ in range(eps_depth):
            is_eps = code == _EPS
            used = used | is_eps
            u = eps_u[t][g.start_pos[st], cols].to(torch.int64)
            st = torch.where(is_eps, g.word_ends[u], st)
            code = torch.where(is_eps, bp8[t][st, cols].to(torch.int64), code)
        if g.cross_src is None:
            prev = st - code
        else:
            prev = torch.where(code == _CROSS, g.cross_src[st],
                               st - torch.clamp(code, max=MAX_BAND))
        active = (t > 0) & (t < n_frames)
        states[t] = rec.to(torch.int32)
        flags[t] = used & (t < n_frames)
        st = torch.where(active, prev, rec)
    return states, flags

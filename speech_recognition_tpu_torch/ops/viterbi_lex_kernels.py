"""Lexical-tree Viterbi kernels K4 (forward) and K5 (value backtrace),
with their plain PyTorch versions.

Counterpart of ``speech_recognition_tpu/ops/viterbi_lex_pallas.py``:
K4 replaces ``_lex_kernel`` (``viterbi_lex_pallas(...,
emit_eps_prev=True)``) and its lane-major twin ``_lex_kernel_wide``; K5
replaces the three reverse walks ``_lex_bt_kernel``,
``_lex_bt_val_kernel`` and ``_lex_bt_wide_kernel``.  The Pallas
kernels renumber states (SoA rows, BFS-level selectors, bf16 x 3
splits, 8/128 padding, VMEM budgets) so that every gather becomes an
MXU one-hot; on the GPU a gather is an indexed load, so both kernels
work in the graph's own state numbering.

Layouts follow the wide twin: emissions ``nll [U, T, B]`` (the layout
``models.hmm.bank_nll_ubt`` gives), ``final [B, S]``, ``bp8 [T, B, S]``,
``eps_u`` / ``eps_prev [T, B, R]``, so one stream's row is contiguous.

Each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors (or raises), counting launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import (
    _CROSS,
    _EPS,
    MAX_BAND,
    BandedGraph,
    _eps_u_dtype,
    viterbi_banded_tb,
)
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import use_kernels

__all__ = ["LexTopo", "lex_topology", "viterbi_lex", "viterbi_lex_ref",
           "lex_backtrace_val", "lex_backtrace_val_ref"]

class LexTopo(NamedTuple):
    """Static facts about a lexical-tree BandedGraph that select and
    feed the kernels (host-side)."""

    n_states: int  # S
    n_roots: int  # R (re-entry slots = root arc starts)
    n_leaves: int  # L (leaf arc ends = word ends)
    # no state is both a word start and a word end (units of >= 2 states)
    disjoint: bool
    # largest bank row the graph reads (checked against the emissions)
    max_bank_state: int

    @property
    def eps_u_dtype(self) -> torch.dtype:
        """Side-plane dtype for eps origins: int8 up to 127 leaves."""
        return _eps_u_dtype(self.n_leaves)


def lex_topology(g: BandedGraph) -> LexTopo:
    """Host-side topology of a lexical-tree graph (one with cross edges)."""
    if g.cross_src is None or g.cross_cost is None:
        raise ValueError("not a lexical-tree graph: cross_src / cross_cost missing")
    starts = set(g.word_starts.cpu().tolist())
    ends = set(g.word_ends.cpu().tolist())
    s = g.n_states
    return LexTopo(n_states=s, n_roots=g.n_words, n_leaves=g.n_ends,
                   disjoint=not (starts & ends),
                   max_bank_state=int(g.bank_state.max()) if s else -1)


# ---------------------------------------------------------------------------
# K4: lexical-tree Viterbi forward
# ---------------------------------------------------------------------------


def lex_launch_inputs(nll, g: BandedGraph, topo: LexTopo, n_frames, what: str):
    """The checks K4 and its lattice mode K6 share (devices, ``nll``'s
    dtype and layout, the graph's topology) and their common launcher
    inputs ``[nll, band, init, bank_state, cross_src, cross_cost,
    word_starts, word_ends, eps, n_frames]`` with int32 indices, to be
    kept referenced until the launch has been enqueued."""
    dev = nll.device
    for name, x in (("n_frames", n_frames),
                    *((f, x) for f, x in zip(g._fields, g) if x is not None)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, emissions on {dev}")
    if nll.dtype != torch.float32 or nll.dim() != 3 or not nll.is_contiguous():
        raise ValueError("nll must be a contiguous float32 [U, T, B] tensor")
    if g.cross_src is None or topo.n_states != g.n_states or not topo.disjoint:
        raise ValueError(f"{what} needs the graph's LexTopo (cross edges, disjoint "
                         "word starts and ends)")
    u, _, b = nll.shape
    if n_frames.shape != (b,):
        raise ValueError(f"n_frames has shape {tuple(n_frames.shape)}, batch is {b}")
    if topo.max_bank_state >= u:
        raise ValueError(f"graph reads bank row {topo.max_bank_state}, emissions have {u}")

    def i32(x):
        return x.to(torch.int32).contiguous()

    return [nll, g.band.contiguous(), g.init_cost.contiguous(), i32(g.bank_state),
            i32(g.cross_src), g.cross_cost.contiguous(), i32(g.word_starts),
            i32(g.word_ends), g.eps_block.contiguous(), i32(n_frames)]


def check_lex_smem(lib, u: int, r: int, what: str) -> None:
    """Raise when the per-frame shared memory of K4 / K6 (``u`` bank rows,
    ``r`` roots) is over the per-CTA limit."""
    need, limit = lib.viterbi_lex_smem_bytes(u, r), lib.srt_smem_limit()
    if need > limit:
        raise ValueError(f"{what}: {need} B of shared memory for {u} bank rows, "
                         f"over the {limit} B limit per CTA")


def viterbi_lex_ref(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """Plain version of K4: the extended plain banded DP
    (``ops.viterbi_banded.viterbi_banded_tb``, per-frame loop) in K4's
    layouts.

    ``nll [U, T, B]`` bank emissions, ``n_frames [B]`` ->
    ``(final [B, S], bp8 [T, B, S] int8, eps_u [T, B, R],
    eps_prev [T, B, R] int32)``.  ``eps_prev`` is each re-entry winner's
    predecessor: the winning leaf end minus its band code (a leaf end
    never carries a cross or eps code).
    """
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    nll_tb = nll.permute(1, 0, 2)[:, g.bank_state, :]  # [T, S, B]
    final, bp8, eps_u = viterbi_banded_tb(nll_tb, g, n_frames)
    ends = g.word_ends[eps_u.to(torch.int64)]  # [T, R, B]
    code_end = torch.gather(bp8, 1, ends).to(torch.int64)
    took = bp8[:, g.word_starts, :] == _EPS
    eps_prev = torch.where(took, ends - code_end, 0).to(torch.int32)
    return (final.T.contiguous(), bp8.transpose(1, 2).contiguous(),
            eps_u.transpose(1, 2).contiguous(), eps_prev.transpose(1, 2).contiguous())


def viterbi_lex(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """K4 for CUDA tensors (``csrc/viterbi_lex.cu``), the plain version
    for CPU tensors.  Arguments and results as ``viterbi_lex_ref``.

    The kernel keeps each stream's frontier in a ``[B, 2, S]``
    device-memory scratch, so the graph's size is bounded only by
    device memory.  It stops each stream at its own length, so its
    planes hold values only for frames ``t < n_frames`` (the plain
    version fills every frame)."""
    if not use_kernels(nll):
        return viterbi_lex_ref(nll, g, topo, n_frames)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    args = lex_launch_inputs(nll, g, topo, n_frames, "lexical-tree kernel")
    dev = nll.device
    u, t_len, b = nll.shape
    s, r, l = g.n_states, g.n_words, g.n_ends
    u_dtype = topo.eps_u_dtype
    final = torch.empty((b, s), dtype=torch.float32, device=dev)
    bp8 = torch.empty((t_len, b, s), dtype=torch.int8, device=dev)
    eps_u = torch.empty((t_len, b, r), dtype=u_dtype, device=dev)
    eps_prev = torch.empty((t_len, b, r), dtype=torch.int32, device=dev)
    if b == 0:
        return final, bp8, eps_u, eps_prev
    lib = load_library()
    check_lex_smem(lib, u, r, "lexical-tree kernel")
    scratch = torch.empty((b, 2, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.viterbi_lex_launch(
            *[x.data_ptr() for x in args], scratch.data_ptr(),
            final.data_ptr(), bp8.data_ptr(), eps_u.data_ptr(),
            int(u_dtype == torch.int32), eps_prev.data_ptr(),
            u, t_len, b, s, r, l, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "lexical-tree Viterbi kernel")
    viterbi_lex.launches += 1
    return final, bp8, eps_u, eps_prev


viterbi_lex.launches = 0


# ---------------------------------------------------------------------------
# K5: value backtrace
# ---------------------------------------------------------------------------


def lex_backtrace_val_ref(bp8, eps_prev, g: BandedGraph, end_state, n_frames):
    """Plain version of K5: ``bp8 [T, B, S]``, ``eps_prev [T, B, R]``,
    ``end_state [B]``, ``n_frames [B]`` -> ``(states [T, B] int32,
    eps_entered [T, B] bool)``.  The recorded state of frame t is the
    state before the step; the walk advances only while 0 < t < nf."""
    t_len, b, s = bp8.shape
    dev = bp8.device
    n_frames = n_frames.to(dev)
    rows = torch.arange(b, device=dev)
    st = end_state.to(dev, torch.int64)
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    for t in range(t_len - 1, -1, -1):
        code = bp8[t, rows, st].to(torch.int64)
        m = code == _EPS
        pprev = eps_prev[t, rows, g.start_pos[st]].to(torch.int64)
        prev = torch.where(m, pprev, torch.where(
            code == _CROSS, g.cross_src[st], st - torch.clamp(code, max=MAX_BAND)))
        states[t] = st.to(torch.int32)
        flags[t] = m & (t < n_frames)
        st = torch.where((t > 0) & (t < n_frames), prev, st)
    return states, flags


def lex_backtrace_val(bp8, eps_prev, g: BandedGraph, end_state, n_frames):
    """K5 for CUDA tensors (``csrc/lex_backtrace.cu``), the plain version
    for CPU tensors.  Arguments and results as ``lex_backtrace_val_ref``."""
    if not use_kernels(bp8):
        return lex_backtrace_val_ref(bp8, eps_prev, g, end_state, n_frames)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    dev = bp8.device
    t_len, b, s = bp8.shape
    r = g.n_words
    if (bp8.dtype != torch.int8 or eps_prev.dtype != torch.int32
            or eps_prev.shape != (t_len, b, r) or s != g.n_states
            or end_state.shape != (b,) or n_frames.shape != (b,)
            or not (bp8.is_contiguous() and eps_prev.is_contiguous())):
        raise ValueError("lexical-tree backtrace kernel takes contiguous int8 "
                         "bp8 [T, B, S], int32 eps_prev [T, B, R] and [B] "
                         "end_state / n_frames")
    if g.cross_src is None:
        raise ValueError("not a lexical-tree graph: cross_src missing")
    for name, x in (("eps_prev", eps_prev), ("end_state", end_state),
                    ("n_frames", n_frames), ("cross_src", g.cross_src),
                    ("start_pos", g.start_pos)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, planes on {dev}")
    i32 = [x.to(torch.int32).contiguous()
           for x in (g.cross_src, g.start_pos, end_state, n_frames)]
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    if b == 0 or t_len == 0:
        return states, flags
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.lex_backtrace_launch(
            bp8.data_ptr(), eps_prev.data_ptr(), *[x.data_ptr() for x in i32],
            states.data_ptr(), flags.data_ptr(), t_len, b, s, r,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "lexical-tree backtrace kernel")
    lex_backtrace_val.launches += 1
    return states, flags


lex_backtrace_val.launches = 0

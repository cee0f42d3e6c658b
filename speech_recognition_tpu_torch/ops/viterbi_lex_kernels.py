"""Lexical-tree Viterbi kernels K4 (forward) and K5 (value backtrace),
with their plain PyTorch versions.

Counterpart of ``speech_recognition_tpu/ops/viterbi_lex_pallas.py``:
K4 replaces ``_lex_kernel`` (``viterbi_lex_pallas(...,
emit_eps_prev=True)``) and its lane-major twin ``_lex_kernel_wide``; K5
replaces the three reverse walks ``_lex_bt_kernel``,
``_lex_bt_val_kernel`` and ``_lex_bt_wide_kernel``.  K18
(``viterbi_lex_chunk``) is K4 in its chunk mode: one chunk of a
streaming decode from a carried frontier, optionally with an ancestor
map (the JAX package's ``decode/streaming.py:86 _chunk_step``, a
``lax.scan``).  The Pallas
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

import ctypes
import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import (
    _CROSS,
    _EPS,
    MAX_BAND,
    BandedGraph,
    _eps_u_dtype,
    viterbi_banded_chunk_tb,
    viterbi_banded_tb,
)
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import use_kernels
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["LexPack", "lex_pack", "LexTopo", "lex_topology", "LexPlan", "lex_plan",
           "lex_smem_bytes", "viterbi_lex", "viterbi_lex_ref", "lex_chains",
           "lex_backtrace_val", "lex_backtrace_val_ref", "LEX_MODES",
           "viterbi_lex_chunk", "viterbi_lex_chunk_ref"]


class LexPack(NamedTuple):
    """The lexical-tree kernels' packed form of a graph (host numpy
    arrays, built once per graph by ``lex_pack``).

    Per state one 32-bit record: the bank row in the low ``shift`` bits,
    above them a link, either the state's entry in ``cross`` (0: the
    default pair, which most states carry, in entry 0) or, with bit 31
    set, the state's leaf slot (a word end, whose cost the band phase
    writes into the frame's leaf-end row; its pair is the default).
    Where the bank rows and the links do not fit 31 bits together, the
    wide form keeps two words per state (``rec [S, 2]``: the bank row,
    then the link with the leaf bit; ``shift`` 0).
    Where the band factorises over bank rows (``band[d, v] == rows[bank_state[v], d]``
    bit for bit, true of every trie ``build_lex_graph`` makes), ``rows``
    holds it and ``band_s`` is None; otherwise the kernel's general mode
    reads ``band_s``, one row per state.  ``eps`` is the eps block, or
    one value per row where every row is constant (a trie without an
    LM); the kernel still adds it to every leaf's cost."""

    rec: np.ndarray  # [S] int32 (uint32 bits), or [S, 2] in the wide form
    rows: np.ndarray  # [n_rows, 4] f32: band costs per bank row (.w: emission slot)
    band_s: Optional[np.ndarray]  # [S, 4] f32 per-state band costs, or None
    cross: np.ndarray  # [n_cx, 2] int32: (source state, cost bits); entry 0 the default
    eps: np.ndarray  # [R, L] f32, or [R] where each row is one value
    init: np.ndarray  # [S] f32 frame-0 costs
    starts: np.ndarray  # [R] int32 word starts
    ends: np.ndarray  # [L] int32 word ends
    shift: int  # bits of the bank row
    # the leaf ends cannot be written into their slots (a repeated word
    # end, or one with its own cross pair): each root gathers them itself
    gather: bool

    @property
    def factorised(self) -> bool:
        return self.band_s is None

    @property
    def wide(self) -> bool:
        """Two words per state record (bank row, link)."""
        return self.rec.ndim == 2


_LEAF = 1 << 31


def lex_pack(g: BandedGraph) -> LexPack:
    """Pack a graph with cross edges for K4 / K6 (see ``LexPack``)."""
    band = g.band.cpu().numpy().astype(np.float32)  # [3, S]
    bank = g.bank_state.cpu().numpy().astype(np.int64)
    src = g.cross_src.cpu().numpy().astype(np.int64)
    cost = g.cross_cost.cpu().numpy().astype(np.float32)
    ends = g.word_ends.cpu().numpy().astype(np.int64)
    eps = np.ascontiguousarray(g.eps_block.cpu().numpy(), dtype=np.float32)
    if (eps.view(np.int32) == eps[:, :1].view(np.int32)).all():
        eps = np.ascontiguousarray(eps[:, 0])
    s = band.shape[1]
    n_rows = int(bank.max()) + 1
    rows = np.zeros((n_rows, 4), np.float32)
    rows[bank, :3] = band.T  # a row's last state wins; checked against every state
    band_s = None
    if not np.array_equal(rows[bank, :3].view(np.int32), band.T.view(np.int32)):
        band_s = np.zeros((s, 4), np.float32)
        band_s[:, :3] = band.T
        rows[:, :3] = 0.0
    # the default pair: that of the first state without a cross edge
    absent = np.nonzero(cost >= POS_INF)[0]
    src_d, cost_d = (int(src[absent[0]]), cost[absent[0]]) if len(absent) else (
        0, np.float32(POS_INF))
    own = (src != src_d) | (cost.view(np.int32) != np.float32(cost_d).view(np.int32))
    gather = len(np.unique(ends)) != len(ends) or bool(own[ends].any())
    link = np.zeros(s, np.int64)
    idx = np.nonzero(own)[0]
    link[idx] = np.arange(1, len(idx) + 1)
    if not gather:
        link[ends] = np.arange(len(ends)) | _LEAF
    cross = np.concatenate([[[src_d, np.float32(cost_d).view(np.int32)]],
                            np.stack([src[idx], cost[idx].view(np.int32)], 1)]).astype(np.int32)
    shift = max(1, (n_rows - 1).bit_length())
    n_links = max(len(idx), len(ends))
    if n_links < 1 << (31 - shift):
        rec = (bank | ((link & (_LEAF - 1)) << shift) | (link & _LEAF)).astype(np.uint32)
    else:  # the wide form: the bank row, then the link with its leaf bit
        rec, shift = np.stack([bank, link], 1).astype(np.uint32), 0
    return LexPack(rec=rec.view(np.int32), rows=rows, band_s=band_s, cross=cross, eps=eps,
                   init=np.ascontiguousarray(g.init_cost.cpu().numpy(), dtype=np.float32),
                   starts=g.word_starts.cpu().numpy().astype(np.int32),
                   ends=ends.astype(np.int32), shift=shift, gather=gather)


class LexTopo(NamedTuple):
    """Static facts about a lexical-tree BandedGraph that select and
    feed the kernels (host-side), with its packed tables."""

    n_states: int  # S
    n_roots: int  # R (re-entry slots = root arc starts)
    n_leaves: int  # L (leaf arc ends = word ends)
    # no state is both a word start and a word end (units of >= 2 states)
    disjoint: bool
    # largest bank row the graph reads (checked against the emissions)
    max_bank_state: int
    pack: LexPack
    # device copies of the packed tables and the launch plans, filled at
    # first launch per device
    on_device: dict

    @property
    def eps_u_dtype(self) -> torch.dtype:
        """Side-plane dtype for eps origins: int8 up to 127 leaves."""
        return _eps_u_dtype(self.n_leaves)

    @property
    def dims(self):
        """``(S, eps entries, L, bank rows, cross entries)``: the sizes
        the kernels' shared-memory layout depends on."""
        p = self.pack
        return (self.n_states, p.eps.size, self.n_leaves, p.rows.shape[0], p.cross.shape[0])


def lex_topology(g: BandedGraph) -> LexTopo:
    """Host-side topology of a lexical-tree graph (one with cross edges)
    and its packed tables (``lex_pack``)."""
    if g.cross_src is None or g.cross_cost is None:
        raise ValueError("not a lexical-tree graph: cross_src / cross_cost missing")
    starts = set(g.word_starts.cpu().tolist())
    ends = set(g.word_ends.cpu().tolist())
    s = g.n_states
    return LexTopo(n_states=s, n_roots=g.n_words, n_leaves=g.n_ends,
                   disjoint=not (starts & ends),
                   max_bank_state=int(g.bank_state.max()) if s else -1,
                   pack=lex_pack(g), on_device={})


_PACKED = ("init", "rec", "rows", "band_s", "cross", "starts", "ends", "eps")


def _device_pack(topo: LexTopo, dev):
    """``topo.pack``'s arrays (``_PACKED``, band_s None in the factorised
    form) on ``dev``, copied once per device."""
    key = str(dev)
    if key not in topo.on_device:
        p = topo.pack
        topo.on_device[key] = {k: None if getattr(p, k) is None
                               else torch.from_numpy(getattr(p, k)).to(dev) for k in _PACKED}
    return topo.on_device[key]


# ---------------------------------------------------------------------------
# The forward kernel's launch plan (csrc/viterbi_lex.cu), mirrored here so
# that it is testable without a card; the card tests hold these byte
# counts equal to the kernel's own.
# ---------------------------------------------------------------------------


class LexPlan(NamedTuple):
    """Where K4 / K6 keep what a frame step reads: ``front`` the cost
    frontier (with K4's codes of two frames) and ``tau`` K6's entry-time
    frontier in shared memory, else in a ``[B, 2, S + 4]`` device scratch
    (the codes then go straight to the plane); ``tables`` the records
    and cross table, and ``eps`` the eps block, staged into shared
    memory, else read through L1; ``gather`` each root gathers the leaf
    ends itself (no leaf-end row); ``rep`` copies of each bank row in the
    per-frame row tables (8: a quarter warp's loads never share a bank;
    0: no row tables, the band phase reads each state's band costs and
    emission through L1); ``smem`` bytes of shared memory per CTA."""

    front: bool
    tau: bool
    tables: bool
    eps: bool
    gather: bool
    rep: int  # copies of each row of the row tables (8: no bank conflicts)
    smem: int

    @property
    def frontier(self) -> str:
        """Where the cost frontier lives: ``shared`` or ``device`` memory."""
        return "shared" if self.front else "device"


def _r16(n: int) -> int:
    return (n + 15) & ~15


# the forward kernel's modes in the C interface: K4, K6 (the lattice pass),
# K18 (the chunk step) and K18 with the ancestor map
LEX_MODES = {"forward": 0, "lattice": 1, "chunk": 2, "chunk_org": 3}


def _has_tau(mode: int) -> bool:
    """Whether a mode keeps a second int32 frontier: K6's entry times,
    K18's ancestor map."""
    return mode in (1, 3)


def lex_smem_bytes(mode: int, s: int, n_eps: int, l: int, n_rows: int, n_cx: int,
                   front: bool, tau: bool, tables: bool, eps: bool, gather: bool,
                   rep: int) -> int:
    """Shared memory of one K4 / K6 / K18 CTA (``viterbi_lex_smem_bytes``)
    in ``mode`` (a value of ``LEX_MODES``; False / True are K4 / K6) for a
    graph of ``LexTopo.dims``: the frontier rows (with K4's and K18's
    staged codes of two frames), K6's tau rows or K18's ancestor rows, the
    tables, the eps block, the two row tables and the leaf-slot rows."""
    row = 2 * _r16(4 * (s + 4))
    return ((row + (0 if mode == 1 else 2 * _r16(s)) if front else 0)
            + (row if _has_tau(mode) and tau else 0)
            + (_r16(4 * s) + _r16(8 * n_cx) if tables else 0) + (_r16(4 * n_eps) if eps else 0)
            + 2 * _r16(16 * n_rows * rep)
            + (0 if gather else 2 * _r16(4 * l)))


def lex_plan(mode: int, topo: LexTopo, limit: int) -> LexPlan:
    """The plan for ``topo``'s graph in ``mode`` (as ``lex_smem_bytes``):
    in order of preference the cost frontier, K6's tau frontier (K18's
    ancestor map), the tables and the eps block in shared
    memory (the general mode and the wide records read their tables
    through L1, and the wide records keep the frontier in device memory),
    then the leaf-end row (where the pack allows it), then eight copies
    of each bank row: the first combination that fits ``limit``.  Where
    not even the two per-frame row tables fit (over ~7,000 bank rows),
    the last tier keeps no row tables (``rep`` 0) and the frontier and
    tables in device memory; it fits any graph."""
    p = topo.pack
    plans = [LexPlan(front, tau, tables, eps, gather, rep,
                     lex_smem_bytes(mode, *topo.dims, front, tau, tables, eps, gather, rep))
             for rows in (True, False)  # row tables in shared memory, else none
             for front, tau, tables, eps, gather, rep in itertools.product(
                 (True, False) if rows and not p.wide else (False,),
                 (True, False) if _has_tau(mode) else (False,),
                 (True, False) if rows and p.factorised and not p.wide else (False,),
                 (True, False), (True,) if p.gather else (False, True),
                 (8, 1) if rows else (0,))]
    # the last plan keeps everything in device memory: 0 bytes
    return next((plan for plan in plans if plan.smem <= limit), plans[-1])


# ---------------------------------------------------------------------------
# K4: lexical-tree Viterbi forward
# ---------------------------------------------------------------------------


def _check_graph(g: BandedGraph, topo: LexTopo, dev, what: str) -> None:
    """The checks of the graph itself (its tensors on ``dev``, ``topo``
    its topology), once per topo, device and graph tensors: a launch with
    the same tensors skips them."""
    key = ("checked", str(dev))
    src = tuple((x.data_ptr(), x._version) for x in g if x is not None)
    if topo.on_device.get(key) == src:
        return
    for f, x in zip(g._fields, g):
        if x is not None and x.device != dev:
            raise ValueError(f"{f} is on {x.device}, emissions on {dev}")
    if g.cross_src is None or topo.n_states != g.n_states or not topo.disjoint:
        raise ValueError(f"{what} needs the graph's LexTopo (cross edges, disjoint "
                         "word starts and ends)")
    topo.on_device[key] = src


def lex_launch_inputs(nll, g: BandedGraph, topo: LexTopo, n_frames, what: str):
    """The checks K4 and its lattice mode K6 share (devices, ``nll``'s
    dtype and layout, the graph's topology, checked once per topo and
    device by ``_check_graph``); returns ``n_frames`` as int32.  The
    kernels read the graph from ``topo``'s packed tables, so ``topo``
    must be ``lex_topology`` of this graph."""
    dev = nll.device
    _check_graph(g, topo, dev, what)
    if n_frames.device != dev:
        raise ValueError(f"n_frames is on {n_frames.device}, emissions on {dev}")
    if nll.dtype != torch.float32 or nll.dim() != 3 or not nll.is_contiguous():
        raise ValueError("nll must be a contiguous float32 [U, T, B] tensor")
    u, _, b = nll.shape
    if n_frames.shape != (b,):
        raise ValueError(f"n_frames has shape {tuple(n_frames.shape)}, batch is {b}")
    if topo.max_bank_state >= u:
        raise ValueError(f"graph reads bank row {topo.max_bank_state}, emissions have {u}")
    return n_frames if n_frames.dtype == torch.int32 else n_frames.to(torch.int32)


def lex_forward(nll, g: BandedGraph, topo: LexTopo, n_frames, lattice: bool, wrapper,
                plan: LexPlan = None, trace=None, frontier=None, first: bool = False,
                track_org: bool = False):
    """Launch ``csrc/viterbi_lex.cu`` (K4, or K6 with ``lattice``, or K18
    with a carried ``frontier [B, S]``) with ``plan`` (default
    ``lex_plan``'s) and count the launch on ``wrapper``; ``trace``: None
    or a ``[B, 6]`` int64 tensor that receives each stream's cycles per
    phase of its frame steps (band, barrier, eps scan, warp reduction,
    apply, barrier; thread 0's clock).  K18 (``first``: frame 0 seeds
    from the frontier; ``track_org``: the ancestor map) returns K4's
    outputs and ``org [B, S]`` int32 or None."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    chunk = frontier is not None
    mode = LEX_MODES["lattice" if lattice else
                     ("chunk_org" if track_org else "chunk") if chunk else "forward"]
    what = ("lattice kernel" if lattice else "lexical-tree chunk kernel" if chunk
            else "lexical-tree kernel")
    nf = lex_launch_inputs(nll, g, topo, n_frames, what)
    dev = nll.device
    u, t_len, b = nll.shape
    s, r, l = g.n_states, g.n_words, g.n_ends
    final = torch.empty((b, s), dtype=torch.float32, device=dev)
    org = torch.empty((b, s), dtype=torch.int32, device=dev) if chunk and track_org else None
    if lattice:
        if t_len == 0:
            raise ValueError("the lattice pass needs at least one frame")
        outs = (final, torch.empty((t_len, b, l), dtype=torch.float32, device=dev),
                torch.empty((t_len, b, l), dtype=torch.int32, device=dev))
        planes = [None, None, 0, None, outs[1], outs[2], None]
    else:
        u_dtype = topo.eps_u_dtype
        outs = (final, torch.empty((t_len, b, s), dtype=torch.int8, device=dev),
                torch.empty((t_len, b, r), dtype=u_dtype, device=dev),
                torch.empty((t_len, b, r), dtype=torch.int32, device=dev))
        planes = [outs[1], outs[2], int(u_dtype == torch.int32), outs[3], None, None, org]
        if chunk:
            if (frontier.dtype != torch.float32 or frontier.shape != (b, s)
                    or frontier.device != dev):
                raise ValueError(f"frontier must be a float32 [{b}, {s}] tensor on {dev}")
            outs = (*outs, org)
    if b == 0:
        return outs
    lib = load_library()
    if plan is None:
        key = ("plan", mode)
        plan = topo.on_device.get(key)
        if plan is None:
            plan = topo.on_device[key] = lex_plan(mode, topo, lib.srt_smem_limit())
    pk = topo.pack
    t = _device_pack(topo, dev)
    row = _r16(4 * (s + 4)) // 4  # entries per frontier row
    scratch = None if plan.front else torch.empty((b, 2, row), dtype=torch.float32, device=dev)
    tau_scratch = None if not _has_tau(mode) or plan.tau else torch.empty(
        (b, 2, row), dtype=torch.int32, device=dev)
    tables = [frontier.contiguous() if chunk else t["init"], *(t[k] for k in _PACKED[1:])]

    def ptr(x):
        return x if x is None or isinstance(x, int) else x.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.viterbi_lex_launch(
            mode, *map(ptr, (nll, *tables, nf.contiguous())), int(first),
            *map(ptr, (scratch, tau_scratch, final)),
            *map(ptr, planes), ptr(trace), u, t_len, b, s, r, l, pk.rows.shape[0],
            pk.cross.shape[0], pk.shift, int(pk.wide),
            0 if pk.eps.ndim == 1 else l, int(plan.front), int(plan.tau), int(plan.tables),
            int(plan.eps), int(plan.gather), plan.rep, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, what)
    wrapper.launches += 1
    return outs


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
    return _k4_layouts(g, *viterbi_banded_tb(nll_tb, g, n_frames))


def _k4_layouts(g: BandedGraph, final, bp8, eps_u):
    """The plain banded DP's ``final [S, B]``, ``bp8 [T, S, B]`` and
    ``eps_u [T, R, B]`` in K4's layouts, with each re-entry winner's
    ``eps_prev``: ``(final [B, S], bp8 [T, B, S], eps_u [T, B, R],
    eps_prev [T, B, R] int32)``."""
    ends = g.word_ends[eps_u.to(torch.int64)]  # [T, R, B]
    code_end = torch.gather(bp8, 1, ends).to(torch.int64)
    took = bp8[:, g.word_starts, :] == _EPS
    eps_prev = torch.where(took, ends - code_end, 0).to(torch.int32)
    return (final.T.contiguous(), bp8.transpose(1, 2).contiguous(),
            eps_u.transpose(1, 2).contiguous(), eps_prev.transpose(1, 2).contiguous())


def viterbi_lex(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """K4 for CUDA tensors (``csrc/viterbi_lex.cu``), the plain version
    for CPU tensors.  Arguments and results as ``viterbi_lex_ref``.

    The kernel keeps each stream's frontier, the packed graph tables and
    the per-frame bank row tables in shared memory where ``lex_plan``
    finds room, else in device memory (or reads them through L1), so the
    graph's size is bounded only by device memory.  It
    stops each stream at its own length, so its planes hold values only
    for frames ``t < n_frames`` (the plain version fills every frame)."""
    if not use_kernels(nll):
        return viterbi_lex_ref(nll, g, topo, n_frames)
    return lex_forward(nll, g, topo, n_frames, False, viterbi_lex)


viterbi_lex.launches = 0


# ---------------------------------------------------------------------------
# K18: the streaming chunk step over a lexical tree (K4's chunk mode)
# ---------------------------------------------------------------------------


def viterbi_lex_chunk_ref(nll, g: BandedGraph, topo: LexTopo, frontier, n_valid,
                          first_chunk: bool, track_org: bool):
    """Plain version of K18: the plain chunk DP
    (``ops.viterbi_banded.viterbi_banded_chunk_tb``) in K4's layouts.

    ``nll [U, C, B]`` bank emissions of the chunk, ``frontier [B, S]``
    the carry, ``n_valid [B]`` -> ``(frontier_out [B, S], bp8 [C, B, S]
    int8, eps_u [C, B, R], eps_prev [C, B, R] int32, org [B, S] int32 or
    None)``; ``eps_prev`` as ``viterbi_lex_ref`` derives it."""
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    nll_tb = nll.permute(1, 0, 2)[:, g.bank_state, :]  # [C, S, B]
    *outs, org = viterbi_banded_chunk_tb(nll_tb, g, frontier.T, n_valid, 1, first_chunk,
                                         track_org)
    return (*_k4_layouts(g, *outs), None if org is None else org.T.contiguous())


def viterbi_lex_chunk(nll, g: BandedGraph, topo: LexTopo, frontier, n_valid,
                      first_chunk: bool, track_org: bool):
    """K18 for CUDA tensors (``csrc/viterbi_lex.cu`` in its chunk mode: K4
    from each stream's carried frontier, every frame computed, the carry
    frozen at ``t >= n_valid``), the plain version for CPU tensors.
    Arguments and results as ``viterbi_lex_chunk_ref``; every
    ``lex_plan`` tier is taken."""
    if not use_kernels(nll):
        return viterbi_lex_chunk_ref(nll, g, topo, frontier, n_valid, first_chunk, track_org)
    return lex_forward(nll, g, topo, n_valid, False, viterbi_lex_chunk, frontier=frontier,
                       first=first_chunk, track_org=track_org)


viterbi_lex_chunk.launches = 0


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


CHAIN = 32  # positions of a chain row (csrc/lex_backtrace.cu kChain)


def lex_chains(g: BandedGraph):
    """K5's chain table of a graph with cross edges: ``(chains [S, 32],
    heads [S, 2])`` int32 numpy arrays.

    The chain of state s is what the walk can reach backwards from s
    without an eps step: the states of s's arc below it, then, through
    the cross edge at the arc's start, the parent arc's end and its chain,
    up to a root.  An arc starts at state 0, at a word start and at a
    state whose cross edge (finite cost) comes from a lower state.
    ``chains[s]`` holds the last 32 states of s's chain, first state
    first, so ``s`` is at position ``P - 1`` (padded with 0);
    ``heads[s]`` is ``(P, start_pos[chains[s, 0]])``."""
    s_n = g.n_states
    v = np.arange(s_n)
    src = g.cross_src.cpu().numpy().astype(np.int64)
    linked = (g.cross_cost.cpu().numpy() < POS_INF) & (src < v)
    arc_start = linked | g.is_start.cpu().numpy().astype(bool)
    arc_start[0] = True
    prev = np.where(arc_start, np.where(linked, src, -1), v - 1)  # -1: the chain ends
    anc = np.empty((CHAIN, s_n), np.int64)  # anc[k]: k steps back, -1 past the end
    anc[0] = v
    for k in range(1, CHAIN):
        anc[k] = np.where(anc[k - 1] >= 0, prev[np.maximum(anc[k - 1], 0)], -1)
    length = (anc >= 0).sum(0)
    pos = np.arange(CHAIN)[None, :]
    back = np.clip(length[:, None] - 1 - pos, 0, CHAIN - 1)  # position -> steps back
    chains = np.where(pos < length[:, None], anc[back, v[:, None]], 0).astype(np.int32)
    heads = np.stack([length, g.start_pos.cpu().numpy()[chains[:, 0]]], 1).astype(np.int32)
    return chains, heads


def lex_backtrace_val(bp8, eps_prev, g: BandedGraph, end_state, n_frames,
                      topo: Optional[LexTopo] = None, trace=None):
    """K5 for CUDA tensors (``csrc/lex_backtrace.cu``), the plain version
    for CPU tensors.  Arguments and results as ``lex_backtrace_val_ref``.

    The kernel reads the graph's chain table (``lex_chains``) and its
    cross sources and eps_prev slots as int32, cached on ``topo``
    (``lex_topology(g)``) per device, else built for this call.
    ``trace``: None or a ``[B, 9]`` int64 tensor that receives each
    stream's cycles fetching new chains, waiting for windows, stashing,
    issuing the next window, walking and writing out, the windows waited
    for and loaded during the walk, and the frames."""
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
    if topo is not None and topo.n_states != s:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {s}")
    for name, x in (("eps_prev", eps_prev), ("end_state", end_state),
                    ("n_frames", n_frames), ("cross_src", g.cross_src),
                    ("start_pos", g.start_pos)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, planes on {dev}")
    key = ("chains", str(dev))
    if topo is None or key not in topo.on_device:
        tabs = (*(torch.from_numpy(x).to(dev) for x in lex_chains(g)),
                *(x.to(torch.int32).contiguous() for x in (g.cross_src, g.start_pos)))
        if topo is not None:
            topo.on_device[key] = tabs
    else:
        tabs = topo.on_device[key]
    chains, heads, cross_src, start_pos = tabs
    end_state, n_frames = (x.to(torch.int32).contiguous() for x in (end_state, n_frames))
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    if b == 0 or t_len == 0:
        return states, flags
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.lex_backtrace_launch(
            *(x.data_ptr() for x in (bp8, eps_prev, cross_src, start_pos, chains, heads,
                                     end_state, n_frames, states, flags)), t_len, b, s, r,
            None if trace is None else trace.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "lexical-tree backtrace kernel")
    lex_backtrace_val.launches += 1
    return states, flags


lex_backtrace_val.launches = 0

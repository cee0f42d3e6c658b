"""Banded Viterbi kernels with their plain PyTorch versions.

Counterpart of ``speech_recognition_tpu/ops/viterbi_banded_pallas.py``
on the connected-decode path:

* K1 (fused emission + forward, ``viterbi_banded_tb_pallas(...,
  fuse_emission=True, emit_eps_prev=True)``) and K2 (value backtrace,
  ``banded_backtrace_tb_pallas(..., eps_prev=...)``) take uniform
  composed word graphs (V words of W states, slot-major) with eps depth
  1 and disjoint word starts and ends: every graph ``build_word_graph``
  / ``build_loop_graph`` composes from a bank of equal-length words;
* K8 (forward on unit-bank emissions, ``viterbi_banded_tb_pallas(...,
  bank_input=True)``) and K9 (general backtrace,
  ``banded_backtrace_tb_pallas`` without ``eps_prev``) take any banded
  graph and any eps depth: 1-state words, words of different lengths,
  transcript graphs;
* K10 (the word-trace forward, ``viterbi_banded_wordtrace_pallas``)
  takes K1's graphs and emission and writes entry-time side planes
  instead of backpointers; ``wordtrace_words_device`` (kernel K23,
  ``csrc/word_walk.cu``, in place of the JAX package's scan of that
  name) walks them;
* K17 (the streaming chunk step, ``viterbi_banded_chunk``; the JAX
  package runs it as a ``lax.scan``, ``decode/streaming.py:86
  _chunk_step``) advances a carried frontier over one chunk on K1's DP
  (after K13) or K8's, routed as a whole utterance is
  (``banded_route``), optionally with an ancestor map for incremental
  emission.

K1 and K10 run as two launches each: the emission kernel K13
(``bank_emission``, ``csrc/bank_emission.cu``: every frame's bank NLLs
in one tiled GEMM with the mixture logsumexp in its epilogue) and the
banded DP of ``csrc/banded_forward.cu`` in its uniform-graph mode (K1)
or its word-trace mode (K10); K8 is the same DP in its general mode on
``bank_nll_ubt``'s emissions; K17 is K1's or K8's DP in a chunk mode.  ``banded_plan`` picks the DP's streams
per CTA, where its frontier lives (shared memory or a device-memory
scratch) and how many frames of planes it stages; no graph size is
refused.

The forward kernels (K1, K8, K10, K17) implement no cross edges, so they
refuse a graph that carries them (a lexical tree) rather than decode it
without them; its forward goes to ``ops.viterbi_lex_kernels``, or, with a
beam, to the plain ``viterbi_banded_tb``.  K9 walks cross edges: it
backtraces a trie's planes from either forward.

Each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.gmm import gmm_emission_weights
from speech_recognition_tpu_torch.ops.viterbi_banded import (
    _EPS,
    MAX_BAND,
    BandedGraph,
    _eps_u_dtype,
    _shift_org,
    _shift_s,
    banded_backtrace_tb,
    eps_ranges,
    viterbi_banded_chunk_tb,
    viterbi_banded_tb,
)
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["BandedTopo", "banded_topology", "use_kernels", "BandedPlan", "banded_plan",
           "bank_emission", "bank_emission_ref", "fused_dp_ref",
           "viterbi_banded_fused", "viterbi_banded_fused_ref",
           "banded_backtrace_val", "banded_backtrace_val_ref",
           "viterbi_banded_general", "viterbi_banded_general_ref",
           "banded_backtrace_general", "banded_backtrace_general_ref",
           "viterbi_banded_chunk", "viterbi_banded_chunk_ref", "banded_route",
           "viterbi_banded_wordtrace", "viterbi_banded_wordtrace_ref",
           "wordtrace_words_device", "wordtrace_words_ref", "wordtrace_words_host"]


class BandedTopo(NamedTuple):
    """Static facts about a BandedGraph that select and feed the kernels.

    A topo belongs to the graph it was built from (``banded_topology``):
    the DP's launch tables are built from that graph's tensors at its
    first launch on a device and kept in ``on_device``.  A launch with a
    graph of another size raises; one with other tensors of the same size
    (the graph moved to the device again, or changed in place) rebuilds
    the tables."""

    n_states: int
    # W when the graph is V words of W states, slot-major (starts = v*W,
    # ends = v*W + W-1); 0 otherwise
    uniform_w: int
    # eps_ranges(): runs of to-arcs sharing one finite from-arc span
    ranges: Tuple[Tuple[int, int, int, int], ...]
    # no state is both a word start and a word end
    disjoint: bool
    # largest bank row the graph reads (checked against the bank on the host)
    max_bank_state: int
    # the graph carries cross edges (cross_src / cross_cost), which K1/K2
    # do not implement
    cross: bool = False
    # the DP's launch tables and plans per device (``launch_tables``);
    # ``banded_topology`` gives each topo a dict of its own
    on_device: Optional[dict] = None

    @property
    def fused_ok(self) -> bool:
        """Whether K1/K2 take the graph (eps depth is checked by callers)."""
        return bool(self.uniform_w) and self.disjoint and not self.cross

    def row_spans(self, n_rows: int):
        """Per eps-block row ``(lo, hi)`` origin span; empty rows (0, 0)."""
        lo = np.zeros(n_rows, np.int32)
        hi = np.zeros(n_rows, np.int32)
        for r_lo, r_hi, u_lo, u_hi in self.ranges:
            lo[r_lo:r_hi], hi[r_lo:r_hi] = u_lo, u_hi
        return lo, hi


def banded_topology(g: BandedGraph) -> BandedTopo:
    """Host-side topology of a banded graph, with an empty cache of its
    launch tables."""
    starts = g.word_starts.cpu().numpy()
    ends = g.word_ends.cpu().numpy()
    s, v = g.n_states, len(starts)
    uniform_w = 0
    if v and s % v == 0:
        w = s // v
        if (np.array_equal(starts, np.arange(v) * w)
                and np.array_equal(ends, np.arange(v) * w + w - 1)):
            uniform_w = w
    return BandedTopo(n_states=s, uniform_w=uniform_w, ranges=eps_ranges(g),
                      disjoint=not (set(starts.tolist()) & set(ends.tolist())),
                      max_bank_state=int(g.bank_state.max()) if s else -1,
                      cross=g.cross_src is not None, on_device={})


def banded_route(topo: BandedTopo, eps_depth: int) -> str:
    """The DP a graph runs on: ``fused`` (K13 + K1's DP, backtraced by K2)
    where K1 takes the graph at this eps depth, else ``general`` (K8's DP
    on bank emissions, backtraced by K9).  A whole utterance
    (``decode.connected``) and a streaming chunk (K17) route alike."""
    return "fused" if topo.fused_ok and eps_depth == 1 else "general"


def use_kernels(t: torch.Tensor) -> bool:
    """The backend rule in one place: the CUDA kernels serve CUDA
    tensors; CPU tensors take the plain versions."""
    return t.is_cuda


# ---------------------------------------------------------------------------
# K1: fused emission + banded Viterbi forward
# ---------------------------------------------------------------------------


def _check_fused(g: BandedGraph, topo: BandedTopo, what: str = "fused banded Viterbi"):
    if not topo.fused_ok:
        raise ValueError(f"{what} needs a uniform word graph with disjoint word "
                         "starts and ends and no cross edges")
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")


def _check_devices(dev, what: str, tensors) -> None:
    """Raise unless every ``(name, tensor)`` lies on ``dev``."""
    for name, x in tensors:
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, {what} on {dev}")


def _walk_vector(x, b: int, dev, name: str):
    """A walk's per-stream integer argument (a ``[B]`` tensor, or a scalar
    for one stream) as a contiguous int32 ``[B]`` tensor on ``dev``;
    raises ``ValueError`` on a float, a wrong size or a device mismatch."""
    if torch.is_tensor(x):
        if x.is_floating_point() or x.is_complex() or x.dtype == torch.bool:
            raise ValueError(f"{name} must be integer, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, planes on {dev}")
    else:
        x = torch.as_tensor(x, dtype=torch.int32, device=dev)
    if x.numel() != b:
        raise ValueError(f"{name} has {x.numel()} entries, batch is {b}")
    return x.reshape(b).to(torch.int32).contiguous()


@functools.lru_cache(maxsize=None)
def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def bank_emission_ref(xa, w, lw):
    """Plain version of the emission kernel K13: ``xa [A, T, B]``
    augmented features, ``w [U, M, A]`` / ``lw [U, M]`` ->
    ``nll [U, T, B] = -logsumexp_m(lw[u, m] - w[u, m] . xa[:, t, b])``,
    one GEMM and a max-shifted logsumexp (every frame, no length mask)."""
    a, t_len, b = xa.shape
    u, m, _ = w.shape
    pm = torch.matmul(w.reshape(u * m, a), xa.reshape(a, t_len * b))
    z = lw.reshape(u, m, 1) - pm.reshape(u, m, t_len * b)
    zmax = z.amax(1, keepdim=True)
    return (-(torch.log(torch.exp(z - zmax).sum(1)) + zmax[:, 0])).reshape(u, t_len, b)


_EMIS_COLS = 64  # columns per tile of the emission kernel
_EMIS_CHUNK = 64  # feature dimensions per chunk of its chunked form
EMISSION_MODES = ("l1", "staged", "chunked")  # the kernel's mode argument, in order


def _emission_smem(a: int, u: int, m: int, stage) -> int:
    """Shared memory of one emission CTA (``bank_emission_smem_bytes``):
    the ``[A][U][Mp]`` weights and ``[U][Mp]`` log weights (mixtures
    padded to a multiple of 4) when staged (``stage`` true or 1), and two
    ``[A][64]`` feature tiles; the chunked form (``stage`` 2) holds two
    ``[64][64]`` chunks of a tile and nothing else."""
    if stage == 2:
        return 4 * 2 * _EMIS_CHUNK * _EMIS_COLS
    return 4 * (((a + 1) * u * (-(-m // 4) * 4) if stage else 0) + 2 * a * _EMIS_COLS)


def emission_plan(a: int, u: int, m: int, limit: int) -> str:
    """K13's form for ``A`` feature dimensions, ``U`` bank states and ``M``
    mixtures under a shared-memory ``limit``: ``"staged"`` (the weights and
    two feature tiles in shared memory), ``"l1"`` (the weights read
    through L1) or, where two feature tiles do not fit (A above ~450),
    ``"chunked"`` (the tiles in chunks of 64 dimensions).  Any A gets one."""
    if _emission_smem(a, u, m, True) <= limit:
        return "staged"
    return "l1" if _emission_smem(a, u, m, False) <= limit else "chunked"


def _emission_warps(u: int) -> int:
    """Warps per emission CTA: of 8 down to 4, the count whose passes over
    a tile's ``8 ceil(U / 2)`` items (a pair of bank states and 8 columns)
    leave the fewest lanes idle (U = 55: 7, no lane idle)."""
    items = 8 * -(-u // 2)
    return min(range(8, 3, -1), key=lambda nw: -(-items // (32 * nw)) * 32 * nw - items)


def bank_emission(xa, w, lw):
    """K13 for CUDA tensors (``csrc/bank_emission.cu``), the plain version
    for CPU tensors.  Arguments and result as ``bank_emission_ref``; the
    kernel writes a ``[T, B, U]`` plane and returns it as a ``[U, T, B]``
    view (strides ``(1, B*U, U)``).  Any feature dimension: the form is
    :func:`emission_plan`'s."""
    if not use_kernels(xa):
        return bank_emission_ref(xa, w, lw)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    dev = xa.device
    if xa.dtype != torch.float32 or xa.dim() != 3 or not xa.is_contiguous():
        raise ValueError("xa must be a contiguous float32 [A, T, B] tensor")
    a, t_len, b = xa.shape
    u, m, a_w = w.shape
    if a_w != a or lw.shape != (u, m):
        raise ValueError(f"emission weights {tuple(w.shape)}/{tuple(lw.shape)} "
                         f"do not match features [A={a}]")
    if w.dtype != torch.float32 or lw.dtype != torch.float32:
        raise ValueError("emission weights must be float32")
    _check_devices(dev, "features", [("w", w), ("lw", lw)])
    out = torch.empty((t_len, b, u), dtype=torch.float32, device=dev)
    n = t_len * b
    if n == 0:
        return out.permute(2, 0, 1)
    lib = load_library()
    mode = EMISSION_MODES.index(emission_plan(a, u, m, _smem_limit()))
    wc, lwc = w.contiguous(), lw.contiguous()
    grid = min(-(-n // _EMIS_COLS), 2 * _n_sm(dev))
    with torch.cuda.device(dev):
        rc = lib.bank_emission_launch(xa.data_ptr(), wc.data_ptr(), lwc.data_ptr(),
                                      out.data_ptr(), a, n, u, m, mode,
                                      _emission_warps(u), grid,
                                      torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "bank emission kernel")
    bank_emission.launches += 1
    return out.permute(2, 0, 1)


bank_emission.launches = 0


def viterbi_banded_fused_ref(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """Plain version of K1.

    ``xa [A, T, B]`` augmented features (``ops.gmm.augment_dtb``),
    ``w [U, M, A]`` / ``lw [U, M]`` from ``gmm_emission_weights``,
    ``n_frames [B]`` -> ``(final [S, B], bp8 [T, S, B] int8,
    eps_u [T, R, B], eps_prev [T, R, B] int32)``.
    """
    _check_fused(g, topo)
    return fused_dp_ref(bank_emission_ref(xa, w, lw), g, n_frames)


def fused_dp_ref(nll_bank, g: BandedGraph, n_frames):
    """K1's DP on given bank emissions ``nll_bank [U, T, B]``: the min-chain
    band (largest d on ties), one eps pass (first minimum, strict
    improvement, ``eps_prev = end - d_end``) and the length mask.  The
    plain version of the DP kernel's uniform-graph mode."""
    s, b = g.n_states, nll_bank.shape[2]
    carry = torch.full((s, b), POS_INF, dtype=torch.float32, device=nll_bank.device)
    return _fused_dp(nll_bank, g, n_frames, g.init_cost[:, None].expand(s, b), carry, True,
                     False)[:4]


def _fused_dp(nll_bank, g: BandedGraph, n_valid, seed, carry, first: bool, track_org: bool):
    """The uniform-mode DP from ``carry [S, B]``: with ``first`` frame 0
    seeds from ``seed [S, B]`` (code 0), else it relaxes the band from
    the carry; frames ``t >= n_valid`` freeze the carry.  With
    ``track_org`` an ancestor map (identity at frame 0) follows the band
    winner (``org[s-d]``, 0 fill) and the eps arrivals (the origin end's
    org before the pass).  Returns ``(carry, bp8, eps_u, eps_prev, org
    or None)``."""
    _, t_len, b = nll_bank.shape
    dev = nll_bank.device
    s, r, l = g.n_states, g.n_words, g.n_ends
    n_valid = n_valid.to(dev)
    u_dtype = _eps_u_dtype(l)
    starts, ends = g.word_starts, g.word_ends
    bank_starts = g.bank_state[starts]

    bp8 = torch.empty((t_len, s, b), dtype=torch.int8, device=dev)
    eps_u = torch.empty((t_len, r, b), dtype=u_dtype, device=dev)
    eps_prev = torch.empty((t_len, r, b), dtype=torch.int32, device=dev)
    prev = carry
    org = (torch.arange(s, dtype=torch.int32, device=dev)[:, None].expand(s, b)
           if track_org else None)
    for t in range(t_len):
        emis_bank = nll_bank[:, t]  # [U, B]
        new_org = org
        if t == 0 and first:
            best = seed
            dsel = torch.zeros((s, b), dtype=torch.int8, device=dev)
        else:
            cands = [g.band[d][:, None] + _shift_s(prev, d) for d in range(MAX_BAND + 1)]
            best = torch.minimum(torch.minimum(cands[0], cands[1]), cands[2])
            dsel = torch.where(cands[2] == best, 2,
                               torch.where(cands[1] == best, 1, 0)).to(torch.int8)
            if track_org:
                new_org = torch.where(dsel == 2, _shift_org(org, 2),
                                      torch.where(dsel == 1, _shift_org(org, 1), org))
        cost = torch.clamp(best + emis_bank[g.bank_state], max=POS_INF)
        # eps: first-minimum origin per destination word
        end_vals = cost[ends]  # [L, B]
        scores = g.eps_block[:, :, None] + end_vals[None]  # [R, L, B]
        base, origin = scores.amin(1), torch.argmin(scores, 1)
        cand = torch.clamp(base + emis_bank[bank_starts], max=POS_INF)
        better = cand < cost[starts]
        pp = ends[origin] - dsel[ends].to(torch.int64).gather(0, origin)
        if track_org:
            arc_org = new_org[ends].gather(0, origin)  # [R, B]
            new_org = new_org.index_copy(0, starts, torch.where(better, arc_org,
                                                                new_org[starts]))
        cost[starts] = torch.where(better, cand, cost[starts])
        dsel[starts] = torch.where(better, torch.full_like(dsel[starts], _EPS),
                                   dsel[starts])
        eps_u[t] = torch.where(better, origin, 0).to(u_dtype)
        eps_prev[t] = torch.where(better, pp, 0).to(torch.int32)
        bp8[t] = dsel
        active = (t < n_valid)[None, :]
        prev = torch.where(active, cost, prev)
        if track_org:
            org = torch.where(active, new_org, org)
    return prev, bp8, eps_u, eps_prev, org


# The DP kernel's launch plan (csrc/banded_forward.cu), mirrored here so
# that it is testable without a card; the card tests hold these byte
# counts equal to the kernel's own.
_TILES = (1, 2, 4)  # streams per CTA (four warps each)
_RING = 4           # frames in each stream's emission ring
_KF = (8, 4, 2, 1)  # frames of planes staged per hand-off to the writer warp
# the DP's modes and their numbers in the C interface: K1, K8, K10, and
# K17 (the chunk step) on K1's or K8's DP, with or without the ancestor map
MODES = {"fused": 0, "general": 1, "wordtrace": 2, "fused_chunk": 3, "general_chunk": 4,
         "fused_chunk_org": 5, "general_chunk_org": 6}


class BandedPlan(NamedTuple):
    """How the DP kernel runs a batch.  ``form`` ``four`` (four warps a
    stream, ``csrc/banded_forward.cu``): ``tile`` streams per CTA;
    ``work_smem``: each stream's work area (its frontier, codes or entry
    times, word-end snapshot and row origins, ``work`` bytes) in shared
    memory, else in a device-memory scratch; ``tables``: the CTA's copy of
    the graph tables in shared memory, else they are read through L1;
    ``ring``: the emission ring; ``kf``: frames of planes staged per
    hand-off to the writer warp (0: each stream writes its rows itself).
    ``form`` ``warp`` (one warp a stream, ``csrc/banded_warp.cu``):
    ``tile`` warps (streams) per CTA, ``per`` states per lane, ``work``
    one warp's shared memory (its emission ring and the eps snapshot
    rows); the frontier, the tables and each lane's eps row are in
    registers, nothing is staged (``tables`` False, ``kf`` 0).  ``smem``:
    bytes of shared memory per CTA."""

    tile: int
    work_smem: bool
    tables: bool
    ring: bool
    kf: int
    smem: int
    work: int
    form: str = "four"
    per: int = 0

    @property
    def frontier(self) -> str:
        """Where the cost frontier lives: ``shared`` or ``device`` memory
        (the warp form: ``registers``)."""
        if self.form == "warp":
            return "registers"
        return "shared" if self.work_smem else "device"


def _r16(n: int) -> int:
    return (n + 15) & ~15


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"DP mode {mode!r} is not one of {sorted(MODES)}")


def _base_mode(mode: str) -> str:
    """The DP a mode runs: ``fused``, ``general`` or ``wordtrace``."""
    _check_mode(mode)
    return mode.split("_")[0]


def banded_work_bytes(mode: str, s: int, r: int, l: int) -> int:
    """One stream's work area: two cost rows (with 4 POS_INF entries in
    front) and the codes of the frontier (``wordtrace``: two entry-time
    rows with 4 zeros in front instead of the codes), the chunk step's two
    ancestor-map rows (``*_org``, 4 zeros in front), the word-end snapshot
    (and K1's eps_prev or K10's entry time per end, and the ancestor of
    each end), and each row's last improving origin
    (``banded_forward_work_bytes``)."""
    base, org = _base_mode(mode), mode.endswith("_org")
    row = _r16(4 * (s + 4))
    front = (4 * row if base == "wordtrace" else 2 * row + _r16(s)) + (2 * row if org else 0)
    return front + _r16(4 * l) * ((1 if base == "general" else 2) + org) + _r16(4 * r)


def banded_table_bytes(s: int, r: int, l: int) -> int:
    """The CTA's copy of the graph tables: per state a float4 of the band
    costs and the bank row, word starts, row spans, word ends and the
    transposed eps block."""
    return _r16(16 * s) + 3 * _r16(4 * r) + _r16(4 * l) + _r16(4 * l * r)


def banded_stage_bytes(mode: str, s: int, r: int, tile: int) -> int:
    """One frame of the CTA's plane staging: the bp8 rows (none in
    ``wordtrace`` mode) and the int32 eps rows (eps_u, and K1's eps_prev
    or K10's eps_tau)."""
    base = _base_mode(mode)
    return ((0 if base == "wordtrace" else _r16(s * tile))
            + (1 if base == "general" else 2) * _r16(4 * r * tile))


def banded_smem_bytes(mode: str, u: int, s: int, r: int, l: int, tile: int,
                      work_smem: bool, tables: bool, ring: bool, kf: int) -> int:
    """Shared memory of one DP CTA (``banded_forward_smem_bytes``)."""
    per_stream = ((banded_work_bytes(mode, s, r, l) if work_smem else 0)
                  + (_r16(4 * _RING * u) if ring else 0))
    return (per_stream * tile + kf * 2 * banded_stage_bytes(mode, s, r, tile)
            + (banded_table_bytes(s, r, l) if tables else 0))


# The warp form (csrc/banded_warp.cu) serves these modes (K10's word-trace
# mode keeps the four-warp form), up to 8 states a lane and one eps row and
# one word end a lane.
WARP_MODES = ("fused", "general", "fused_chunk", "general_chunk", "fused_chunk_org",
              "general_chunk_org")
_WARP_PER = (2, 4, 8)
_WARP_TILES = (1, 2, 4, 8)
WARP_MAX_ROWS = 32  # eps rows and word ends: one a lane
_WARP_RING = 8  # frames in each warp's emission ring
# banded_plan takes the warp form for graphs of at most this many states.
# Set from the chip sweep scripts/exp_r16_chunk_dp.py --sweep (the DP alone
# at 256 streams x 64 frames, both forms in one call; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §6): on loop graphs of 5 to 32 words (25-160 states)
# the warp form took 0.35-0.51x the four-warp form's time, the ratio
# rising with the states; 160 is the largest graph swept, and loops of
# 5-state words past it pass the warp form's 32 rows anyway.
BANDED_WARP_MAX_STATES = 160


def banded_warp_smem_bytes(mode: str, u: int, tile: int) -> int:
    """Shared memory of one warp-form CTA (``banded_warp_smem_bytes``):
    per warp the emission ring of 8 frames of ``u`` bank rows and the eps
    pass's 32-entry snapshot rows (word-end costs, word-start costs, K1's
    eps_prev entries, the ends' ancestors with the map)."""
    base, org = _base_mode(mode), mode.endswith("_org")
    return tile * (_r16(4 * _WARP_RING * u) + 128 * (2 + (base == "fused") + org))


def _warp_plan(b: int, n_sm: int, s: int, r: int, l: int, u: int, mode: str,
               limit: int):
    """The warp form's plan, or None where the graph has more states than
    a warp holds (8 a lane), more than 32 words or word ends, or not even
    one warp's emission ring fits ``limit``.  ``tile`` is the fewest warps
    per CTA that keep the grid within one CTA per SM, at least 2 (the
    sweep's best at 256 streams), fewer where the rings do not fit."""
    if (mode not in WARP_MODES or s > 32 * _WARP_PER[-1] or r > WARP_MAX_ROWS
            or l > WARP_MAX_ROWS):
        return None
    per = next(k for k in _WARP_PER if 32 * k >= s)
    want = next((t for t in _WARP_TILES if t >= 2 and -(-b // t) <= n_sm), _WARP_TILES[-1])
    for tile in (t for t in reversed(_WARP_TILES) if t <= want):
        smem = banded_warp_smem_bytes(mode, u, tile)
        if smem <= limit:
            return BandedPlan(tile, True, False, True, 0, smem,
                              banded_warp_smem_bytes(mode, u, 1), "warp", per)
    return None


def banded_plan(b: int, n_sm: int, s: int, r: int, l: int, u: int, mode: str,
                limit: int, form: str = None) -> BandedPlan:
    """The DP's plan in ``mode`` (a key of ``MODES``) for ``b`` streams over
    a graph of ``s`` states, ``r`` word starts, ``l`` word ends and ``u``
    bank rows.  ``form`` None: the warp form (``_warp_plan``) for graphs
    of at most ``BANDED_WARP_MAX_STATES`` states in the modes it serves,
    else the four-warp form; ``"warp"`` / ``"four"`` force one (``"warp"``
    raises where the warp form cannot take the graph).  Four-warp form:
    ``tile`` is the fewest streams per CTA that keep the grid within one
    CTA per SM, up to 4 (each stream takes four warps); then, in order of
    preference, the work area in shared memory, the graph tables in shared
    memory, the emission ring and the most staged frames that fit
    ``limit``.  Its last choice (everything in device memory, no ring, no
    staging) needs no shared memory, so every size gets a plan."""
    if form not in (None, "warp", "four"):
        raise ValueError(f"plan form {form!r} is not 'warp' or 'four'")
    if form == "warp" or (form is None and s <= BANDED_WARP_MAX_STATES):
        plan = _warp_plan(b, n_sm, s, r, l, u, mode, limit)
        if plan is not None:
            return plan
        if form == "warp":
            raise ValueError(f"the warp form does not take {s} states in mode {mode!r}")
    tile = next((t for t in _TILES if -(-b // t) <= n_sm), _TILES[-1])
    work = banded_work_bytes(mode, s, r, l)
    for work_smem in (True, False):
        for tables in (True, False):
            for ring in (True, False):
                for kf in (*_KF, 0):
                    smem = banded_smem_bytes(mode, u, s, r, l, tile, work_smem, tables,
                                             ring, kf)
                    if smem <= limit:
                        return BandedPlan(tile, work_smem, tables, ring, kf, smem, work)
    raise AssertionError("unreachable: the last plan uses no shared memory")


def eps_row_spans(g: BandedGraph):
    """``(lo [R], hi [R])`` int32 on the graph's device: each eps row's
    finite origin span, from its first to one past its last finite entry,
    ``(0, 0)`` for a row without one (``BandedTopo.row_spans``, computed
    with tensor ops so that no host copy holds up the launch)."""
    fin = g.eps_block < POS_INF / 2
    some = fin.any(1)
    lo = torch.where(some, fin.to(torch.int32).argmax(1), 0)
    hi = torch.where(some, g.n_ends - fin.flip(1).to(torch.int32).argmax(1), 0)
    return lo.to(torch.int32), hi.to(torch.int32)


def _graph_key(g: BandedGraph):
    """Which tensors (and which in-place version of each) the graph's
    launch tables come from."""
    return tuple((x.data_ptr(), x._version) for x in (g.band, g.bank_state, g.init_cost,
                                                      g.word_starts, g.word_ends, g.eps_block))


def launch_tables(g: BandedGraph, topo: BandedTopo, dev) -> dict:
    """The DP's launch tables of ``g`` on ``dev``, built at the first
    launch per device and kept on ``topo`` (``topo.on_device[str(dev)]``):
    ``band4 [S, 4]`` (the band costs, the bank row's int32 bits), int32
    ``starts`` / ``ends``, ``eps_t`` (the eps block transposed to
    ``[L, R]``), the row spans ``lo`` / ``hi`` (``eps_row_spans``) and the
    plans by ``(B, U, mode, smem limit)``.  Building them also checks
    once that every graph tensor lies on ``dev``.  A topo of another
    graph size raises; other tensors of this size (the graph moved to the
    device again, or changed in place) rebuild the tables."""
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    dev = torch.device(dev)
    cache = topo.on_device if topo.on_device is not None else {}
    key, src = str(dev), _graph_key(g)
    ent = cache.get(key)
    if ent is None or ent["src"] != src:
        _check_devices(dev, "the DP", zip(g._fields, g))
        band4 = torch.empty((g.n_states, 4), dtype=torch.float32, device=dev)
        band4[:, :3] = g.band.T
        band4[:, 3] = g.bank_state.to(torch.int32).view(torch.float32)
        lo, hi = eps_row_spans(g)
        ent = {"src": src, "band4": band4,
               "starts": g.word_starts.to(torch.int32).contiguous(),
               "ends": g.word_ends.to(torch.int32).contiguous(),
               "eps_t": g.eps_block.T.contiguous(), "lo": lo, "hi": hi, "plans": {}}
        ent.update(_warp_tables(g, lo, hi))
        cache[key] = ent
    return ent


def _warp_tables(g: BandedGraph, lo, hi) -> dict:
    """The warp form's tables: ``info [S]`` int32 (word-end slot + 1) |
    (word-start row + 1) << 16, and ``eps_m [R, 32]`` each row's eps
    entries over its finite span, +inf elsewhere and past L; ``warp_ok``
    whether the form takes the graph (at most 32 words and ends, each
    start and each end its own state).  Empty where it does not."""
    r, l = g.n_words, g.n_ends
    dev = g.word_starts.device
    if (r > WARP_MAX_ROWS or l > WARP_MAX_ROWS
            or torch.unique(g.word_starts).numel() != r
            or torch.unique(g.word_ends).numel() != l):
        return {"warp_ok": False}
    info = torch.zeros(g.n_states, dtype=torch.int32, device=dev)
    info[g.word_ends] = torch.arange(1, l + 1, dtype=torch.int32, device=dev)
    info.index_add_(0, g.word_starts,
                    torch.arange(1, r + 1, dtype=torch.int32, device=dev) << 16)
    u = torch.arange(32, device=dev)
    span = (u[None] >= lo[:, None]) & (u[None] < hi[:, None])
    eps = torch.zeros((r, 32), dtype=torch.float32, device=dev)
    eps[:, :l] = g.eps_block
    return {"warp_ok": True, "info": info,
            "eps_m": torch.where(span, eps, torch.tensor(float("inf"), device=dev))}


@functools.lru_cache(maxsize=1)
def _smem_limit() -> int:
    from speech_recognition_tpu_torch.utils.build import load_library

    return load_library().srt_smem_limit()


def _banded_forward(nll, g: BandedGraph, n_frames, eps_depth: int, mode: str, wrapper,
                    plan: BandedPlan = None, trace=None, frontier=None, first: bool = False,
                    topo: BandedTopo = None):
    """Launch the DP kernel in ``mode`` on emissions ``nll [U, T, B]`` (any
    strides) and count the launch on ``wrapper``: ``fused`` -> ``(final
    [S, B], bp8 [T, S, B], eps_u [T, R, B], eps_prev)``, ``general`` ->
    ``(final, bp8, eps_u)``, ``wordtrace`` -> ``(final, eps_u, eps_tau
    [T, R, B], final_tau [S, B])``; the chunk modes carry ``frontier
    [S, B]`` (``first``: frame 0 seeds from it) and return ``(carry,
    bp8, eps_u, eps_prev or None, org [S, B] or None)``.  The graph's
    launch tables and plan come from ``topo`` (``launch_tables``; built
    for this call where it is None).  ``plan`` overrides ``banded_plan``'s;
    ``trace``, a ``[B, 6]`` int64 tensor, receives each stream's cycles
    per phase of the frame steps."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    base = _base_mode(mode)
    chunk, org_on = "chunk" in mode, mode.endswith("_org")
    dev = nll.device
    u, t_len, b = nll.shape
    s, r, l = g.n_states, g.n_words, g.n_ends
    u_dtype = _eps_u_dtype(l)
    wt = base == "wordtrace"
    final = torch.empty((s, b), dtype=torch.float32, device=dev)
    bp8 = None if wt else torch.empty((t_len, s, b), dtype=torch.int8, device=dev)
    eps_u = torch.empty((t_len, r, b), dtype=u_dtype, device=dev)
    aux = (None if base == "general"
           else torch.empty((t_len, r, b), dtype=torch.int32, device=dev))
    final_tau = torch.empty((s, b), dtype=torch.int32, device=dev) if wt else None
    org = torch.empty((s, b), dtype=torch.int32, device=dev) if org_on else None
    if chunk:
        outs = (final, bp8, eps_u, aux, org)
    else:
        outs = {"fused": (final, bp8, eps_u, aux), "general": (final, bp8, eps_u),
                "wordtrace": (final, eps_u, aux, final_tau)}[mode]
    if b == 0 or t_len == 0:
        if chunk:
            final.copy_(frontier)
            if org_on:
                org.copy_(torch.arange(s, dtype=torch.int32, device=dev)[:, None].expand(s, b))
            return outs
        final.fill_(POS_INF)
        if wt:
            final_tau.zero_()
        return outs
    tabs = launch_tables(g, topo if topo is not None else banded_topology(g), dev)
    lib = load_library()
    if plan is None:
        key = (b, u, mode, _smem_limit())
        plan = tabs["plans"].get(key)
        if plan is None:
            plan = tabs["plans"][key] = banded_plan(b, _n_sm(dev), s, r, l, u, mode, key[3],
                                                    form=None if tabs["warp_ok"] else "four")
    # the chunk modes read each stream's carried frontier instead of init
    init = frontier.contiguous() if chunk else g.init_cost.contiguous()
    nf = n_frames if n_frames.dtype == torch.int32 else n_frames.to(torch.int32)
    nf = nf.contiguous()

    def ptr(x):
        return x.data_ptr() if x is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.form == "warp":
            if not tabs["warp_ok"]:
                raise ValueError("the warp form takes at most 32 words and word ends, each "
                                 "its own state")
            rc = lib.banded_warp_launch(
                MODES[mode], nll.data_ptr(), *nll.stride(),
                *[x.data_ptr() for x in (tabs["band4"], init, tabs["starts"], tabs["info"],
                                         tabs["eps_m"], nf)],
                int(first), final.data_ptr(), bp8.data_ptr(), eps_u.data_ptr(),
                int(u_dtype == torch.int32), ptr(aux), ptr(org), u, t_len, b, s, r, l,
                eps_depth, plan.tile, plan.per, ptr(trace), stream)
        else:
            ptrs = [x.data_ptr() for x in (tabs["band4"], init, tabs["starts"], tabs["ends"],
                                           tabs["eps_t"], tabs["lo"], tabs["hi"], nf)]
            scratch = None
            if not plan.work_smem:
                scratch = torch.empty(-(-b // plan.tile) * plan.tile * plan.work,
                                      dtype=torch.uint8, device=dev)
            rc = lib.banded_forward_launch(
                MODES[mode], nll.data_ptr(), *nll.stride(), *ptrs, int(first),
                final.data_ptr(), ptr(bp8), eps_u.data_ptr(), int(u_dtype == torch.int32),
                ptr(aux), ptr(final_tau), ptr(org), ptr(scratch), u, t_len, b, s, r, l,
                eps_depth, plan.tile, int(plan.work_smem), int(plan.tables), int(plan.ring),
                plan.kf, ptr(trace), stream)
    check(rc, wrapper.__name__)
    wrapper.launches += 1
    return outs


def _check_fused_inputs(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """The per-call checks K1 and K10 share: devices, shapes, dtypes, the
    bank's size (the graph's own tensors are checked once per device,
    when ``launch_tables`` builds its tables)."""
    dev = xa.device
    a, _, b = xa.shape
    u, m, a_w = w.shape
    if a_w != a or lw.shape != (u, m):
        raise ValueError(f"emission weights {tuple(w.shape)}/{tuple(lw.shape)} "
                         f"do not match features [A={a}]")
    _check_devices(dev, "features", [("w", w), ("lw", lw), ("n_frames", n_frames)])
    if xa.dtype != torch.float32 or not xa.is_contiguous():
        raise ValueError("xa must be a contiguous float32 [A, T, B] tensor")
    if n_frames.shape != (b,):
        raise ValueError(f"n_frames has shape {tuple(n_frames.shape)}, batch is {b}")
    if topo.max_bank_state >= u:
        raise ValueError(f"graph reads bank state {topo.max_bank_state}, bank has {u}")


def viterbi_banded_fused(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """K1 for CUDA tensors: the emission kernel K13, then the DP kernel
    (``csrc/banded_forward.cu``) in its uniform-graph mode; the plain
    version for CPU tensors.  Arguments and results as
    ``viterbi_banded_fused_ref``."""
    if not use_kernels(xa):
        return viterbi_banded_fused_ref(xa, w, lw, g, topo, n_frames)
    _check_fused(g, topo)
    _check_fused_inputs(xa, w, lw, g, topo, n_frames)
    nll = bank_emission(xa, w, lw)  # [U, T, B] view of a [T, B, U] plane
    return _banded_forward(nll, g, n_frames, 1, "fused", viterbi_banded_fused, topo=topo)


viterbi_banded_fused.launches = 0


def fused_forward(bank, feats, n_frames, g: BandedGraph, topo: BandedTopo):
    """Bank + ``feats [B, T, D]`` -> K1 outputs (emission fused in)."""
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb

    w, lw = gmm_emission_weights(*bank.flat_states())
    return viterbi_banded_fused(augment_dtb(feats), w, lw, g, topo, n_frames)


# ---------------------------------------------------------------------------
# K2: value backtrace
# ---------------------------------------------------------------------------


def banded_backtrace_val_ref(bp8, eps_prev, end_state, n_frames, uniform_w: int):
    """Plain version of K2: ``bp8 [T, S, B]``, ``eps_prev [T, R, B]``,
    ``end_state [B]``, ``n_frames [B]`` -> ``(states [T, B] int32,
    eps_entered [T, B] bool)``."""
    t_len, s, b = bp8.shape
    dev = bp8.device
    n_frames = n_frames.to(dev)
    cols = torch.arange(b, device=dev)
    st = end_state.to(dev, torch.int64)
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    for t in range(t_len - 1, -1, -1):
        code = bp8[t][st, cols].to(torch.int64)
        m = code == _EPS
        pprev = eps_prev[t][st // uniform_w, cols].to(torch.int64)
        prev = torch.where(m, pprev, st - torch.clamp(code, max=MAX_BAND))
        states[t] = st.to(torch.int32)
        flags[t] = m & (t < n_frames)
        st = torch.where((t > 0) & (t < n_frames), prev, st)
    return states, flags


def banded_backtrace_val(bp8, eps_prev, end_state, n_frames, uniform_w: int):
    """K2 for CUDA tensors (``csrc/banded_backtrace.cu``: one warp per
    stream, a window of frames x reachable states per round trip), the
    plain version for CPU tensors."""
    if not use_kernels(bp8):
        return banded_backtrace_val_ref(bp8, eps_prev, end_state, n_frames, uniform_w)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    dev = bp8.device
    t_len, s, b = bp8.shape
    r = eps_prev.shape[1]
    if (bp8.dtype != torch.int8 or eps_prev.dtype != torch.int32
            or eps_prev.shape != (t_len, r, b) or s != r * uniform_w
            or not (bp8.is_contiguous() and eps_prev.is_contiguous())):
        raise ValueError("backtrace kernel takes contiguous int8 bp8 [T, S, B] and "
                         "int32 eps_prev [T, S / W, B]")
    for name, x in (("eps_prev", eps_prev), ("end_state", end_state),
                    ("n_frames", n_frames)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, planes on {dev}")
    end_state = end_state.to(torch.int32).contiguous()
    nf = n_frames.to(torch.int32).contiguous()
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    if b == 0 or t_len == 0:
        return states, flags
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.banded_backtrace_launch(
            bp8.data_ptr(), eps_prev.data_ptr(), end_state.data_ptr(),
            nf.data_ptr(), states.data_ptr(), flags.data_ptr(),
            t_len, s, r, b, uniform_w, torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "banded backtrace kernel")
    banded_backtrace_val.launches += 1
    return states, flags


banded_backtrace_val.launches = 0


# ---------------------------------------------------------------------------
# K8: banded Viterbi forward on unit-bank emissions, any banded graph
# ---------------------------------------------------------------------------


def viterbi_banded_general_ref(nll, g: BandedGraph, topo: BandedTopo, n_frames,
                               eps_depth: int = 1):
    """Plain version of K8: the plain scan ``viterbi_banded_tb`` on the
    bank emissions gathered to graph states.

    ``nll [U, T, B]`` bank emissions (``models.hmm.bank_nll_ubt``),
    ``n_frames [B]`` -> ``(final [S, B], bp8 [T, S, B] int8,
    eps_u [T, R, B])``.
    """
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    return viterbi_banded_tb(nll.permute(1, 0, 2)[:, g.bank_state, :], g, n_frames,
                             eps_depth)


def viterbi_banded_general(nll, g: BandedGraph, topo: BandedTopo, n_frames,
                           eps_depth: int = 1):
    """K8 for CUDA tensors (``csrc/banded_forward.cu`` in its general
    mode), the plain version for CPU tensors.  Arguments and results as
    ``viterbi_banded_general_ref``; the kernel computes every frame's
    planes, frozen frames included, as the plain scan does."""
    if not use_kernels(nll):
        return viterbi_banded_general_ref(nll, g, topo, n_frames, eps_depth)
    _check_general_inputs(nll, g, topo, n_frames, eps_depth)
    return _banded_forward(nll, g, n_frames, eps_depth, "general", viterbi_banded_general,
                           topo=topo)


def _check_general_inputs(nll, g: BandedGraph, topo: BandedTopo, n_frames, eps_depth: int):
    """The per-call checks K8 and K17's general mode share (the graph's
    own tensors are checked once per device, by ``launch_tables``)."""
    if topo.cross:
        raise ValueError("the general banded kernel does not implement cross edges "
                         "(lexical trees decode through decode.lextree)")
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    dev = nll.device
    _check_devices(dev, "emissions", [("n_frames", n_frames)])
    if nll.dtype != torch.float32 or nll.dim() != 3 or not nll.is_contiguous():
        raise ValueError("nll must be a contiguous float32 [U, T, B] tensor")
    u, t_len, b = nll.shape
    if n_frames.shape != (b,):
        raise ValueError(f"n_frames has shape {tuple(n_frames.shape)}, batch is {b}")
    if topo.max_bank_state >= u:
        raise ValueError(f"graph reads bank row {topo.max_bank_state}, emissions have {u}")
    if eps_depth < 1:
        raise ValueError(f"eps_depth must be >= 1, got {eps_depth}")


viterbi_banded_general.launches = 0


# ---------------------------------------------------------------------------
# K9: general backtrace (eps unwind of any depth)
# ---------------------------------------------------------------------------

# Plain version of K9: ``bp8 [T, S, B]``, ``eps_u [T, R, B]``, the graph,
# ``end_state [B]``, ``n_frames [B]``, ``eps_depth`` -> ``(states [T, B]
# int32, eps_entered [T, B] bool)``.
banded_backtrace_general_ref = banded_backtrace_tb


def banded_backtrace_general(bp8, eps_u, g: BandedGraph, end_state, n_frames,
                             eps_depth: int = 1, trace=None):
    """K9 for CUDA tensors (``csrc/banded_backtrace.cu``: one warp per
    stream, a window of frames x the states of the word (or, on a graph
    with cross edges, the arc) the band can reach, with the word's eps_u
    entries, per round trip; a cross step goes to ``cross_src``), the
    plain version for CPU tensors.  Arguments and results as
    ``banded_backtrace_tb``; ``trace`` (int64 ``[B, 5]`` on the device)
    receives the kernel's clock64 counts per stream (see the launcher)."""
    if not use_kernels(bp8):
        return banded_backtrace_tb(bp8, eps_u, g, end_state, n_frames, eps_depth)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    dev = bp8.device
    t_len, s, b = bp8.shape
    r, l_ends = g.n_words, g.n_ends
    if (bp8.dtype != torch.int8 or eps_u.dtype not in (torch.int8, torch.int32)
            or eps_u.shape != (t_len, r, b) or s != g.n_states
            or end_state.shape != (b,) or n_frames.shape != (b,)
            or not (bp8.is_contiguous() and eps_u.is_contiguous())):
        raise ValueError("general backtrace kernel takes contiguous int8 bp8 [T, S, B], "
                         "int8 or int32 eps_u [T, R, B] and [B] end_state / n_frames")
    if eps_depth < 1:
        raise ValueError(f"eps_depth must be >= 1, got {eps_depth}")
    _check_devices(dev, "planes", [("eps_u", eps_u), ("end_state", end_state),
                                   ("n_frames", n_frames), ("start_pos", g.start_pos),
                                   ("word_ends", g.word_ends), ("is_start", g.is_start),
                                   ("cross_src", g.cross_src), ("cross_cost", g.cross_cost)])
    # the window's span hint: the word starts, and the targets of cross
    # edges (a trie's arc starts), which no band move crosses
    hint = g.is_start.to(torch.bool)
    cross = None
    if g.cross_src is not None:
        hint = hint | (g.cross_cost < POS_INF / 2)
        cross = g.cross_src.to(torch.int64).contiguous()
    tabs = [g.start_pos.to(torch.int64).contiguous(), g.word_ends.to(torch.int64).contiguous(),
            cross, hint.contiguous()]
    i32 = [x.to(torch.int32).contiguous() for x in (end_state, n_frames)]
    states = torch.empty((t_len, b), dtype=torch.int32, device=dev)
    flags = torch.empty((t_len, b), dtype=torch.bool, device=dev)
    if b == 0 or t_len == 0:
        return states, flags
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.banded_backtrace_general_launch(
            bp8.data_ptr(), eps_u.data_ptr(), int(eps_u.dtype == torch.int32),
            *[None if x is None else x.data_ptr() for x in tabs + i32], states.data_ptr(),
            flags.data_ptr(),
            t_len, s, r, l_ends, b, eps_depth,
            trace.data_ptr() if trace is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "general backtrace kernel")
    banded_backtrace_general.launches += 1
    return states, flags


banded_backtrace_general.launches = 0


# ---------------------------------------------------------------------------
# K17: the streaming chunk step (the DP's chunk modes)
# ---------------------------------------------------------------------------


def viterbi_banded_chunk_ref(inputs, g: BandedGraph, topo: BandedTopo, frontier, n_valid,
                             first_chunk: bool, track_org: bool, mode: str,
                             eps_depth: int = 1):
    """Plain version of K17: one chunk of a streaming decode from the
    carried ``frontier [S, B]``, ``n_valid [B]`` real frames per stream
    (``ops.viterbi_banded.viterbi_banded_chunk_tb``'s semantics: frame 0
    seeds from the frontier with ``first_chunk``, else relaxes the band
    from it; every frame ``t >= n_valid`` freezes the carry; the carry is
    returned).

    ``mode="fused"``: ``inputs = (xa [A, C, B], w, lw)`` (as K1's), K13's
    plain version then K1's DP (min-chain band, one eps pass, eps_prev);
    ``mode="general"``: ``inputs = nll [U, C, B]`` bank emissions, the
    plain scan at ``eps_depth``.  Returns ``(frontier_out [S, B], bp8
    [C, S, B] int8, eps_u [C, R, B], eps_prev [C, R, B] int32 (fused) or
    None, org [S, B] int32 or None)``."""
    if mode == "fused":
        _check_fused(g, topo, "the uniform chunk step")
        xa, w, lw = inputs
        return _fused_dp(bank_emission_ref(xa, w, lw), g, n_valid, frontier, frontier,
                         first_chunk, track_org)
    if mode != "general":
        raise ValueError(f"chunk mode {mode!r} is not 'fused' or 'general'")
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    fo, bp8, eps_u, org = viterbi_banded_chunk_tb(
        inputs.permute(1, 0, 2)[:, g.bank_state, :], g, frontier, n_valid, eps_depth,
        first_chunk, track_org)
    return fo, bp8, eps_u, None, org


def viterbi_banded_chunk(inputs, g: BandedGraph, topo: BandedTopo, frontier, n_valid,
                         first_chunk: bool, track_org: bool, mode: str, eps_depth: int = 1):
    """K17 for CUDA tensors: ``fused``, K13 (``bank_emission``) on the
    chunk then the DP kernel (``csrc/banded_forward.cu``) in its uniform
    chunk mode; ``general``, the DP's general chunk mode on the given bank
    emissions.  The plain version for CPU tensors.  Arguments and results
    as ``viterbi_banded_chunk_ref``."""
    if mode not in ("fused", "general"):
        raise ValueError(f"chunk mode {mode!r} is not 'fused' or 'general'")
    x = inputs[0] if mode == "fused" else inputs
    if not use_kernels(x):
        return viterbi_banded_chunk_ref(inputs, g, topo, frontier, n_valid, first_chunk,
                                        track_org, mode, eps_depth)
    dev = x.device
    if mode == "fused":
        _check_fused(g, topo, "the uniform chunk step")
        if eps_depth != 1:
            raise ValueError(f"the uniform chunk step runs eps depth 1, not {eps_depth}")
        xa, w, lw = inputs
        _check_fused_inputs(xa, w, lw, g, topo, n_valid)
        nll = bank_emission(xa, w, lw)  # [U, C, B] view of a [C, B, U] plane
    else:
        _check_general_inputs(x, g, topo, n_valid, eps_depth)
        nll = x
    b = x.shape[2]
    if (frontier.dtype != torch.float32 or frontier.shape != (g.n_states, b)
            or frontier.device != dev):
        raise ValueError(f"frontier must be a float32 [{g.n_states}, {b}] tensor on {dev}")
    return _banded_forward(nll, g, n_valid, eps_depth,
                           f"{mode}_chunk" + ("_org" if track_org else ""),
                           viterbi_banded_chunk, frontier=frontier, first=first_chunk,
                           topo=topo)


viterbi_banded_chunk.launches = 0


# ---------------------------------------------------------------------------
# K10: word-trace forward (K13 + the DP's word-trace mode)
# ---------------------------------------------------------------------------


def _wordtrace_dp(nll_bank, g: BandedGraph, n_frames):
    """K10's DP on given bank emissions ``nll_bank [U, T, B]``: K1's band
    (min-chain, largest d on ties), one eps pass (first minimum, strict
    improvement) and length mask, with an int32 entry-time carry tau
    that follows the band winner, is 0 at frame 0 and t where a re-entry
    improves a word start.  Returns ``(final [S, B], eps_u [T, R, B],
    eps_tau [T, R, B] int32, final_tau [S, B] int32)``.  The plain
    version of the DP kernel's word-trace mode."""
    _, t_len, b = nll_bank.shape
    dev = nll_bank.device
    s, r, l = g.n_states, g.n_words, g.n_ends
    n_frames = n_frames.to(dev)
    starts, ends = g.word_starts, g.word_ends
    bank_starts = g.bank_state[starts]
    cols = torch.arange(b, device=dev)
    u_dtype = _eps_u_dtype(l)
    eps_u = torch.empty((t_len, r, b), dtype=u_dtype, device=dev)
    eps_tau = torch.empty((t_len, r, b), dtype=torch.int32, device=dev)
    prev = torch.full((s, b), POS_INF, dtype=torch.float32, device=dev)
    tau = torch.zeros((s, b), dtype=torch.int32, device=dev)
    for t in range(t_len):
        emis_bank = nll_bank[:, t]  # [U, B]
        if t == 0:
            best = g.init_cost[:, None].expand(s, b)
            tau_b = torch.zeros((s, b), dtype=torch.int32, device=dev)
        else:
            cands = [g.band[d][:, None] + _shift_s(prev, d) for d in range(MAX_BAND + 1)]
            best = torch.minimum(torch.minimum(cands[0], cands[1]), cands[2])
            tau_b = torch.where(cands[2] == best, _shift_org(tau, 2),
                                torch.where(cands[1] == best, _shift_org(tau, 1), tau))
        cost = torch.clamp(best + emis_bank[g.bank_state], max=POS_INF)
        scores = g.eps_block[:, :, None] + cost[ends][None]  # [R, L, B]
        base, origin = scores.amin(1), torch.argmin(scores, 1)
        cand = torch.clamp(base + emis_bank[bank_starts], max=POS_INF)
        better = cand < cost[starts]
        origin_tau = tau_b[ends[origin], cols]  # [R, B]
        cost[starts] = torch.where(better, cand, cost[starts])
        tau_b[starts] = torch.where(better, t, tau_b[starts]).to(torch.int32)
        eps_u[t] = torch.where(better, origin, 0).to(u_dtype)
        eps_tau[t] = torch.where(better, origin_tau, 0)
        active = (t < n_frames)[None, :]
        prev = torch.where(active, cost, prev)
        tau = torch.where(active, tau_b, tau)
    return prev, eps_u, eps_tau, tau


def viterbi_banded_wordtrace_ref(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """Plain version of K10: K13's plain version, then ``_wordtrace_dp``.

    Inputs as ``viterbi_banded_fused_ref`` -> ``(final [S, B],
    eps_u [T, R, B], eps_tau [T, R, B] int32, final_tau [S, B] int32)``:
    at every re-entry the origin word slot and that word's entry time,
    and each state's entry time after the last frame.
    """
    _check_fused(g, topo, "the word-trace forward")
    return _wordtrace_dp(bank_emission_ref(xa, w, lw), g, n_frames)


def viterbi_banded_wordtrace(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """K10 for CUDA tensors: the emission kernel K13, then the DP kernel
    (``csrc/banded_forward.cu``) in its word-trace mode; the plain
    version for CPU tensors.  Arguments and results as
    ``viterbi_banded_wordtrace_ref``."""
    if not use_kernels(xa):
        return viterbi_banded_wordtrace_ref(xa, w, lw, g, topo, n_frames)
    _check_fused(g, topo, "the word-trace forward")
    _check_fused_inputs(xa, w, lw, g, topo, n_frames)
    nll = bank_emission(xa, w, lw)  # [U, T, B] view of a [T, B, U] plane
    return _banded_forward(nll, g, n_frames, 1, "wordtrace", viterbi_banded_wordtrace,
                           topo=topo)


viterbi_banded_wordtrace.launches = 0


def wordtrace_words_ref(eps_u, eps_tau, best_slot, entry_t, n_frames):
    """Plain version of K23: word recovery over K10's side planes, in
    tensor ops on their device.

    From each stream's final word (slot ``best_slot``, entered at
    ``entry_t``) follows the eps chain ``(t, v) -> (eps_tau[t, v],
    eps_u[t, v])`` until the word entered at frame 0, checking every 16
    steps whether any chain is still going.  The reference stops after
    ``T // W + 1`` steps, which skip arcs undercut; this walk drops no
    word.  Returns ``(words_rev [T + 1, B] int32, slots from the last word
    back, -1 past each stream's first word; n_words [B] int32)``: entry
    times fall each step, so T + 1 rows hold every chain.  Both are views
    of one ``[T + 2, B]`` buffer whose last row is ``n_words``, as
    ``wordtrace_words_device`` returns them.
    """
    t_len, r, b = eps_u.shape
    dev = eps_u.device
    flat_u, flat_t = eps_u.reshape(-1), eps_tau.reshape(-1)
    cols = torch.arange(b, device=dev)
    v = best_slot.to(dev, torch.int64)
    t = entry_t.to(dev, torch.int64)
    alive = n_frames.to(dev) > 0
    words = []
    while len(words) <= t_len:
        words.append(torch.where(alive, v, -1))
        idx = (t.clamp(0, max(t_len - 1, 0)) * r + v.clamp(0, r - 1)) * b + cols
        cont = alive & (t > 0)
        v = torch.where(cont, flat_u[idx].to(torch.int64), v)
        t = torch.where(cont, flat_t[idx].to(torch.int64), t)
        alive = cont
        if len(words) % 16 == 0 and not bool(alive.any()):
            break
    out = torch.full((t_len + 2, b), -1, dtype=torch.int32, device=dev)
    out[:len(words)] = torch.stack(words)
    out[t_len + 1] = (out[:t_len + 1] >= 0).sum(0)
    return out[:t_len + 1], out[t_len + 1]


def wordtrace_words_device(eps_u, eps_tau, best_slot, entry_t, n_frames):
    """K23 for CUDA planes (``csrc/word_walk.cu``: one thread a stream
    walks its chain to its end), the plain version ``wordtrace_words_ref``
    for CPU planes.

    ``eps_u [T, R, B]`` in the type ``_eps_u_dtype`` gives (int8 or
    int32) and ``eps_tau [T, R, B]`` int32, as K10 writes them (any
    strides); ``best_slot``, ``entry_t``, ``n_frames`` integer ``[B]``.
    Returns what the plain version returns: ``words_rev [T + 1, B]`` and
    ``n_words [B]``, views of one ``[T + 2, B]`` buffer, so
    ``wordtrace_words_host`` brings both to the host in one copy.  Nothing
    is read back here."""
    if eps_u.dim() != 3 or eps_u.dtype not in (torch.int8, torch.int32) \
            or eps_tau.dtype != torch.int32 or eps_tau.shape != eps_u.shape:
        raise ValueError(f"the word-trace walk takes eps_u [T, R, B] int8 or int32 and "
                         f"int32 eps_tau of its shape; got {eps_u.dtype} "
                         f"{tuple(eps_u.shape)} and {eps_tau.dtype} {tuple(eps_tau.shape)}")
    t_len, r, b = eps_u.shape
    dev = eps_u.device
    if eps_tau.device != dev:
        raise ValueError(f"eps_tau is on {eps_tau.device}, eps_u on {dev}")
    vecs = [_walk_vector(x, b, dev, name) for x, name in (
        (best_slot, "best_slot"), (entry_t, "entry_t"), (n_frames, "n_frames"))]
    if not (t_len and r):
        raise ValueError(f"the word-trace walk needs non-empty planes, got "
                         f"{tuple(eps_u.shape)}")
    if not use_kernels(eps_u):
        return wordtrace_words_ref(eps_u, eps_tau, best_slot, entry_t, n_frames)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    out = torch.empty((t_len + 2, b), dtype=torch.int32, device=dev)
    if b:
        lib = load_library()
        with torch.cuda.device(dev):
            rc = lib.wordtrace_walk_launch(
                eps_u.data_ptr(), int(eps_u.dtype == torch.int32), *eps_u.stride(),
                eps_tau.data_ptr(), *eps_tau.stride(), *(x.data_ptr() for x in vecs),
                out.data_ptr(), out[t_len + 1].data_ptr(), t_len, r, b,
                torch.cuda.current_stream(dev).cuda_stream)
        check(rc, "word-trace walk kernel")
        wordtrace_words_device.launches += 1
    return out[:t_len + 1], out[t_len + 1]


wordtrace_words_device.launches = 0


def wordtrace_words_host(words_rev, n_words):
    """``(words_rev, n_words)`` as ``wordtrace_words_device`` returns
    them, as numpy arrays from one device-to-host copy of the buffer they
    share (``n_words`` is its row after ``words_rev``)."""
    rows, b = words_rev.shape
    if not (words_rev.is_contiguous() and n_words.shape == (b,)
            and n_words.untyped_storage().data_ptr() == words_rev.untyped_storage().data_ptr()
            and n_words.storage_offset() == words_rev.storage_offset() + rows * b):
        raise ValueError("words_rev and n_words are not the rows of one buffer")
    both = words_rev.as_strided((rows + 1, b), (b, 1)).cpu().numpy()
    return both[:rows], both[rows]

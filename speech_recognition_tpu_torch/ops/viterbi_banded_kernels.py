"""Banded Viterbi kernels K1 (fused emission + forward) and K2 (value
backtrace), with their plain PyTorch versions.

Counterpart of ``speech_recognition_tpu/ops/viterbi_banded_pallas.py``
on the connected-decode path (``viterbi_banded_tb_pallas(...,
fuse_emission=True, emit_eps_prev=True)`` and
``banded_backtrace_tb_pallas(..., eps_prev=...)``).  Both kernels take
uniform composed word graphs (V words of W states, slot-major) with
eps depth 1 and disjoint word starts and ends: every graph
``build_word_graph`` / ``build_loop_graph`` composes from a bank of
equal-length words.  Neither kernel implements cross edges, so a graph
that carries them (a lexical tree) is refused here rather than decoded
without them; it goes to ``ops.viterbi_lex_kernels``.

Each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.gmm import gmm_emission_weights
from speech_recognition_tpu_torch.ops.viterbi_banded import (
    _EPS,
    MAX_BAND,
    BandedGraph,
    _eps_u_dtype,
    _shift_s,
    eps_ranges,
)
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["BandedTopo", "banded_topology", "use_kernels",
           "viterbi_banded_fused", "viterbi_banded_fused_ref",
           "banded_backtrace_val", "banded_backtrace_val_ref"]


class BandedTopo(NamedTuple):
    """Static facts about a BandedGraph that select and feed the kernels."""

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
    """Host-side topology of a banded graph."""
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
                      cross=g.cross_src is not None)


def use_kernels(t: torch.Tensor) -> bool:
    """The backend rule in one place: the CUDA kernels serve CUDA
    tensors; CPU tensors take the plain versions."""
    return t.is_cuda


# ---------------------------------------------------------------------------
# K1: fused emission + banded Viterbi forward
# ---------------------------------------------------------------------------


def _check_fused(g: BandedGraph, topo: BandedTopo):
    if not topo.fused_ok:
        raise ValueError("fused banded Viterbi needs a uniform word graph with "
                         "disjoint word starts and ends and no cross edges")
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")


def viterbi_banded_fused_ref(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """Plain version of K1.

    ``xa [A, T, B]`` augmented features (``ops.gmm.augment_dtb``),
    ``w [U, M, A]`` / ``lw [U, M]`` from ``gmm_emission_weights``,
    ``n_frames [B]`` -> ``(final [S, B], bp8 [T, S, B] int8,
    eps_u [T, R, B], eps_prev [T, R, B] int32)``.
    """
    _check_fused(g, topo)
    a, t_len, b = xa.shape
    u, m, _ = w.shape
    dev = xa.device
    s, r, l = g.n_states, g.n_words, g.n_ends
    n_frames = n_frames.to(dev)
    u_dtype = _eps_u_dtype(l)
    pm = torch.matmul(w.reshape(u * m, a), xa.reshape(a, t_len * b))
    z = lw.reshape(u, m, 1) - pm.reshape(u, m, t_len * b)
    zmax = z.amax(1, keepdim=True)
    nll_bank = -(torch.log(torch.exp(z - zmax).sum(1)) + zmax[:, 0])
    nll_bank = nll_bank.reshape(u, t_len, b)
    starts, ends = g.word_starts, g.word_ends
    bank_starts = g.bank_state[starts]

    bp8 = torch.empty((t_len, s, b), dtype=torch.int8, device=dev)
    eps_u = torch.empty((t_len, r, b), dtype=u_dtype, device=dev)
    eps_prev = torch.empty((t_len, r, b), dtype=torch.int32, device=dev)
    prev = torch.full((s, b), POS_INF, dtype=torch.float32, device=dev)
    for t in range(t_len):
        emis_bank = nll_bank[:, t]  # [U, B]
        if t == 0:
            best = g.init_cost[:, None].expand(s, b)
            dsel = torch.zeros((s, b), dtype=torch.int8, device=dev)
        else:
            cands = [g.band[d][:, None] + _shift_s(prev, d) for d in range(MAX_BAND + 1)]
            best = torch.minimum(torch.minimum(cands[0], cands[1]), cands[2])
            dsel = torch.where(cands[2] == best, 2,
                               torch.where(cands[1] == best, 1, 0)).to(torch.int8)
        cost = torch.clamp(best + emis_bank[g.bank_state], max=POS_INF)
        # eps: first-minimum origin per destination word
        end_vals = cost[ends]  # [L, B]
        scores = g.eps_block[:, :, None] + end_vals[None]  # [R, L, B]
        base, origin = scores.amin(1), torch.argmin(scores, 1)
        cand = torch.clamp(base + emis_bank[bank_starts], max=POS_INF)
        better = cand < cost[starts]
        pp = ends[origin] - dsel[ends].to(torch.int64).gather(0, origin)
        cost[starts] = torch.where(better, cand, cost[starts])
        dsel[starts] = torch.where(better, torch.full_like(dsel[starts], _EPS),
                                   dsel[starts])
        eps_u[t] = torch.where(better, origin, 0).to(u_dtype)
        eps_prev[t] = torch.where(better, pp, 0).to(torch.int32)
        bp8[t] = dsel
        prev = torch.where((t < n_frames)[None, :], cost, prev)
    return prev, bp8, eps_u, eps_prev


_K1_TILES = (32, 16, 8, 4)  # streams per CTA the kernel is built for


def _k1_launch_plan(b: int, n_sm: int, smem_bytes, limit: int) -> Tuple[int, bool]:
    """``(tile, stage_weights)`` for K1.  The tile is the largest that
    still gives every SM a CTA; when the shared memory
    ``smem_bytes(tile, stage)`` exceeds ``limit``, smaller tiles are
    tried, then the same without staging the emission weights.  Raises
    when even 4 unstaged streams per CTA do not fit."""
    first = next((t for t in _K1_TILES if -(-b // t) >= n_sm), _K1_TILES[-1])
    tiles = [t for t in _K1_TILES if t <= first]
    for stage in (True, False):
        for tile in tiles:
            if smem_bytes(tile, stage) <= limit:
                return tile, stage
    raise ValueError(f"banded Viterbi kernel: the frontier needs "
                     f"{smem_bytes(_K1_TILES[-1], False)} B of shared memory at "
                     f"{_K1_TILES[-1]} streams per CTA, over the {limit} B limit "
                     "(graph too wide; ROADMAP queue B item B1)")


def viterbi_banded_fused(xa, w, lw, g: BandedGraph, topo: BandedTopo, n_frames):
    """K1 for CUDA tensors (``csrc/viterbi_banded.cu``), the plain version
    for CPU tensors.  Arguments and results as ``viterbi_banded_fused_ref``."""
    if not use_kernels(xa):
        return viterbi_banded_fused_ref(xa, w, lw, g, topo, n_frames)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    _check_fused(g, topo)
    dev = xa.device
    a, t_len, b = xa.shape
    u, m, a_w = w.shape
    if a_w != a or lw.shape != (u, m):
        raise ValueError(f"emission weights {tuple(w.shape)}/{tuple(lw.shape)} "
                         f"do not match features [A={a}]")
    for name, x in (("xa", xa), ("w", w), ("lw", lw), ("n_frames", n_frames),
                    *((f, x) for f, x in zip(g._fields, g) if x is not None)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, features on {dev}")
    if xa.dtype != torch.float32 or not xa.is_contiguous():
        raise ValueError("xa must be a contiguous float32 [A, T, B] tensor")
    s, r, l = g.n_states, g.n_words, g.n_ends
    if topo.max_bank_state >= u:
        raise ValueError(f"graph reads bank state {topo.max_bank_state}, bank has {u}")
    wt = w.reshape(u * m, a).T.contiguous().float()
    row_lo, row_hi = (torch.from_numpy(x).to(dev) for x in topo.row_spans(r))
    args = [xa, wt, lw.reshape(-1).contiguous().float(), g.band.contiguous(),
            g.init_cost.contiguous(), g.bank_state.to(torch.int32),
            g.eps_block.contiguous(), row_lo, row_hi,
            n_frames.to(torch.int32).contiguous()]
    u_dtype = _eps_u_dtype(l)
    final = torch.empty((s, b), dtype=torch.float32, device=dev)
    bp8 = torch.empty((t_len, s, b), dtype=torch.int8, device=dev)
    eps_u = torch.empty((t_len, r, b), dtype=u_dtype, device=dev)
    eps_prev = torch.empty((t_len, r, b), dtype=torch.int32, device=dev)
    if b == 0 or t_len == 0:
        return final.fill_(POS_INF), bp8, eps_u, eps_prev
    lib = load_library()
    tile, stage = _k1_launch_plan(
        b, torch.cuda.get_device_properties(dev).multi_processor_count,
        lambda tl, st: lib.viterbi_banded_smem_bytes(a, u, m, s, tl, int(st)),
        lib.srt_smem_limit())
    with torch.cuda.device(dev):
        rc = lib.viterbi_banded_launch(
            *[x.data_ptr() for x in args], final.data_ptr(), bp8.data_ptr(),
            eps_u.data_ptr(), int(u_dtype == torch.int32), eps_prev.data_ptr(),
            a, t_len, b, u, m, s, r, l, topo.uniform_w, tile, int(stage),
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "banded Viterbi kernel")
    viterbi_banded_fused.launches += 1
    return final, bp8, eps_u, eps_prev


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
    """K2 for CUDA tensors (``csrc/banded_backtrace.cu``), the plain
    version for CPU tensors."""
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

"""The H100 bound model: the least time the card could take for a
kernel's work, and a report of measured times against it.

Counterpart of ``speech_recognition_tpu/utils/roofline.py``, whose peaks
and work models are a TPU v5e's (its MXU passes and lane padding have no
counterpart here).  A kernel's bound is the larger of two times: the
bytes it must move (each input read once, each output written once) over
the card's memory rate, and the operations it does on these inputs over
the card's f32 rate (exps and logs over the special function units'
rate, where they bind).  Where the work depends on the data (frames past
a stream's length, finite matrix entries), the models count what the
given inputs need.  ``chip_smoke.py`` prints each kernel's bound from
these models beside its measured time.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "SFU_PER_S", "SMEM_STEP_CYCLES", "SM_CLOCK_HZ",
           "bound", "nbytes", "graph_bytes", "dp_ops", "span_pairs", "ceps_ops", "dense_ops",
           "mfcc_ops", "tail_ops", "rescore_ops", "rescore_walk_work", "fb_steps", "fb_dense_work",
           "fb_banded_work", "dense_walk_work", "chain_walk_work", "gmm_fit_work",
           "token_beam_work", "token_beam_floor", "token_walk_work", "STEP_CYCLES",
           "TOKEN_BEAM_STEPS", "GMM_TILE_STEPS", "GMM_ITER_STEPS", "SM_BULK_BYTES_PER_CYCLE",
           "gmm_fit_floor", "report"]

# The card's published peaks (H100 SXM data sheet, at a 700 W limit):
# device memory bandwidth and f32 rate outside the tensor cores (the port
# keeps TF32 off); an add, min or compare counts as one operation.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# a serial walk's step: one dependent shared-memory load (~30 cycles on
# Hopper) at the H100 SXM's boost clock
SMEM_STEP_CYCLES = 30
SM_CLOCK_HZ = 1.98e9


# Latencies of one dependent step by kind, in SM cycles on the H100 80GB
# HBM3 (scripts/exp_r25_token_beam.py --lab: a pointer chase in shared
# memory 28.6, through L2 with ld.global.cg 283.2, a chain of 64-bit
# shuffles each feeding a min 44.3, a chain of block barriers at 256
# threads 74.8).
STEP_CYCLES = {"smem": 29, "l2": 283, "shfl": 44, "barrier": 75}
# K19's frame (csrc/token_beam.cu) as a chain of dependent steps at up to
# 8 runs of survivors: proposals (frontier, edge record through L2, row,
# the 64-bit atomicMin's load and swap, the list slot), the warp sort
# (touched, key, 15 shuffle stages, store), the ranking (a key, its 6-step
# search, the M step's store; its state record through L2), the eps pass
# (end list, slot, eps block through L2, two minima, a ballot and a
# shuffle, key table, cost, winner slot) and the ranks (winners, kill,
# M's key, store, reset); five barriers.
TOKEN_BEAM_STEPS = {"smem": 26, "l2": 3, "shfl": 19, "barrier": 5}


# K24 / K25 (csrc/gmm_fit.cu) as chains of dependent steps: a tile of a
# fit's frames (the ring's mbarrier wait, a frame's row and weights loads,
# its value stored; the statistics' loads; the tile's barrier), and an
# iteration's end (the owners' partial sums stored, loaded by the M-step,
# which stores the next weights; its two warp trees side by side; the
# partials' and the stop's barriers).  Arithmetic is left out, so no run
# can be shorter.
GMM_TILE_STEPS = {"smem": 4, "barrier": 1}
GMM_ITER_STEPS = {"smem": 3, "shfl": 5, "barrier": 2}
# bytes one SM's bulk copies bring from L2 a cycle, through a ring of four
# 44 KB stages (scripts/exp_r26_gmm_fit.py --lab on the H100 80GB HBM3)
SM_BULK_BYTES_PER_CYCLE = 63.96

# exp and log issue on the special function units, 16 a clock per SM: 132
# SMs at the boost clock give ~4.2e12 a second (the forward-backward
# kernels K15 / K16 are mostly exps and logs)
SFU_PER_S = 132 * 16 * SM_CLOCK_HZ


def bound(n_bytes: float, n_ops: float, n_sfu: float = 0.0):
    """``(ms, "bytes" | "operations")``: the least time the card could
    take to move ``n_bytes``, do ``n_ops`` f32 operations and ``n_sfu``
    exps and logs (the largest of the three; the SFU term counts as
    operations), and which sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    t_o = max(t_o, n_sfu / SFU_PER_S * 1e3)
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors if x is not None)


# Work models of the bounds: the bytes each kernel must move (every input
# read once, every output written once; a backtrace reads only the plane
# entries its walk visits) and the operations it does on this run's data
# (frames past a stream's length are not counted where the kernel skips
# them).  Per state and frame the banded DP does 3 band adds and compares,
# an emission add and a clamp (8), a trie's cross edge 3 more; the re-entry
# an add and a compare per (root, leaf) pair.


def graph_bytes(g) -> int:
    """The graph arrays a DP kernel reads, at 4 bytes an entry."""
    parts = (g.band, g.init_cost, g.bank_state, g.word_starts, g.word_ends, g.eps_block,
             g.cross_src, g.cross_cost)
    return 4 * sum(x.numel() for x in parts if x is not None)


def dp_ops(g, frames: int, eps_pairs: int = None, passes: int = 1) -> float:
    """Operations of ``frames`` (frame, stream) steps of the banded DP:
    ``passes`` re-entry passes over ``eps_pairs`` (word end, word start)
    pairs each (default: the whole eps block)."""
    per_state = 8 + (3 if g.cross_src is not None else 0)
    pairs = g.eps_block.numel() if eps_pairs is None else eps_pairs
    return frames * (g.n_states * per_state + passes * (2 * pairs + 2 * g.n_words))


def span_pairs(topo) -> int:
    """The (word start, word end) pairs a banded kernel visits: the finite
    spans of the eps block (``BandedTopo.ranges``)."""
    return sum((r_hi - r_lo) * (u_hi - u_lo) for r_lo, r_hi, u_lo, u_hi in topo.ranges)


def ceps_ops(cfg, n_frames: int) -> float:
    """Operations of the MFCC cepstra over ``n_frames`` frames: pre-emphasis
    and window, half a complex N-point FFT per real frame (5 N log2 N
    each), power, two triangular filters per bin, log, DCT, lifter."""
    import math

    n, half = cfg.n_fft, cfg.n_fft // 2 + 1
    return n_frames * (3 * cfg.frame_len + 2.5 * n * math.log2(n) + 3 * half + 4 * half
                       + cfg.n_mels + 2 * cfg.n_mels * cfg.n_ceps + cfg.n_ceps)


def dense_ops(steps: int, s: int, eps_depth: int) -> float:
    """Operations of ``steps`` (item, frame) steps of the dense Viterbi: an
    add and a compare per (to, from) pair for the frame edge and for each
    of ``eps_depth`` eps passes (0 without eps)."""
    return float(steps) * s * s * 2 * (1 + eps_depth)


def mfcc_ops(cfg, n_frames: int) -> float:
    """Operations of the fused MFCC-39 over ``n_frames`` frames: pre-emphasis
    and window, half a complex N-point FFT per real frame (5 N log2 N
    each), power, two triangular filters per bin, log, DCT, lifter, the
    two delta passes and the standardization."""
    import math

    n, half = cfg.n_fft, cfg.n_fft // 2 + 1
    per = (3 * cfg.frame_len + 2.5 * n * math.log2(n) + 3 * half + 4 * half + cfg.n_mels
           + 2 * cfg.n_mels * cfg.n_ceps + cfg.n_ceps + 2 * 10 * cfg.n_ceps
           + 4 * 3 * cfg.n_ceps)
    return n_frames * per


def tail_ops(cfg, n_frames: int) -> float:
    """Operations of the MFCC-39 tail over ``n_frames`` frames: the two
    delta passes and the standardization (mfcc_ops' last two terms)."""
    return n_frames * (2 * 10 * cfg.n_ceps + 4 * 3 * cfg.n_ceps)


def rescore_ops(t_len: int, b: int, l: int, k: int, dense: bool) -> float:
    """Operations of the rescoring DP over every frame of ``b`` streams:
    per leaf the D select and add, the backoff add and compare, K sparse
    adds and compares, the take and the ring store (6 + 2K), or the dense
    min-plus column (2L) plus 3."""
    per_leaf = 2 * l + 3 if dense else 6 + 2 * k
    return float(t_len) * b * l * per_leaf


def rescore_walk_work(in_bytes: int, t_len: int, b: int, l: int, k: int, dense: bool,
                      n_words, rows: int):
    """``(bytes, operations)`` of the bigram pipeline's K7 launch
    (``rescore_and_walk``): ``in_bytes`` of inputs read once (the lattice
    planes, the LM, start / end costs, the lengths; no q plane, the
    kernel makes q), the ``pred_w`` plane and ``[B]`` int32 cost, best
    leaf and truncation count written, and K22's walk folded in: its
    ``[rows, B]`` leaves and ``[B]`` word counts written (it reads K6's
    tau plane, already an input, and ``pred_w``, the launch's own
    output).  Operations: ``rescore_ops`` plus per leaf and frame q's
    minimum and the count's three compares and add (5), and 4 a word of
    the walk (``n_words [B]``)."""
    n_bytes = in_bytes + t_len * b * l * 4 + 3 * 4 * b + 4 * b * (rows + 1)
    return n_bytes, (rescore_ops(t_len, b, l, k, dense) + 5.0 * t_len * b * l
                     + 4.0 * int(n_words.sum()))


def fb_steps(nf, t_len: int):
    """Per item: the forward's steps (frames below its length, and frame 0
    of an empty item), the backward's (one fewer) and the frames gamma is
    computed on, as int64 tensors."""
    n = nf.clamp(min=0, max=t_len).long()
    return n.clamp(min=1), (n - 1).clamp(min=0), n


# The forward-backward work models count what this run's inputs need: an
# exp (and 5 f32 operations: the add, the max, the subtract, the sum) per
# finite matrix / band / eps entry of an LSE, a log a row that has one, a
# logaddexp (exp and log1p) a state an eps pass reaches, the cross edges',
# then gamma a state and frame and an xi term per finite edge and frame;
# NEG_INF entries, which add exactly nothing, are not counted.  Bytes:
# every input read once, every output written once (the alpha and beta
# planes are scratch).


def _fin(cost, b):
    """``cost < POS_INF / 2`` with a leading batch axis of ``b``."""
    fin = cost < 0.5e30
    return fin if fin.dim() == 3 else fin.expand((b,) + tuple(fin.shape))


def fb_dense_work(nll, trans, eps, init, end, nf, depth: int, out):
    """``(bytes, operations, exps and logs)`` of K16 on these inputs."""
    b, t_len, s = nll.shape
    fw, bw, nfc = fb_steps(nf, t_len)
    ft = _fin(trans, b)
    sfu = ((fw - 1) * (ft.sum((1, 2)) + ft.any(2).sum(1))
           + bw * (ft.sum((1, 2)) + ft.any(1).sum(1)))
    if eps is not None:
        fe = _fin(eps, b)
        sfu = sfu + depth * (fw * (fe.sum((1, 2)) + fe.any(2).sum(1) + 2 * s)
                             + bw * (fe.sum((1, 2)) + fe.any(1).sum(1) + 2 * s))
    if out.xi_sum.shape[1] == s:  # dense xi: a term per finite (to, from) pair
        xi_terms = ft.sum((1, 2))
    else:  # band xi: the finite entries trans[u + d, u]
        xi_terms = sum(ft[:, d:, :s - d].diagonal(dim1=1, dim2=2).sum(1) for d in range(3))
    comb = nfc * s + (nfc - 1).clamp(min=0) * xi_terms
    sfu_n = float((sfu + comb).sum())
    ops = 5 * sfu_n + 4 * s * float((fw + bw).sum()) * (1 + (depth if eps is not None else 0))
    return (nbytes(nll, trans, eps, init, end, nf, out.gamma, out.xi_sum, out.log_z), ops,
            sfu_n)


def fb_banded_work(nll, g, nf, depth: int, end, out):
    """``(bytes, operations, exps and logs)`` of K15 on these inputs."""
    import torch

    b, t_len, s = nll.shape
    fw, bw, nfc = fb_steps(nf, t_len)
    band = g.band if g.band.dim() == 3 else g.band.expand((b,) + tuple(g.band.shape))
    # the band's finite entries: edge s - d -> s for s >= d
    fb_ = torch.stack([(band[:, d] < 0.5e30) & (torch.arange(s, device=band.device) >= d)
                       for d in range(3)], 1)
    n_band, band_rows = fb_.sum((1, 2)), fb_.any(1).sum(1)
    fe = _fin(g.eps_block, b)
    n_eps = fe.sum((1, 2))
    is_start = g.is_start if g.is_start.dim() == 2 else g.is_start.expand(b, s)
    ends = g.word_ends if g.word_ends.dim() == 2 else g.word_ends.expand(b, -1)
    n_end = torch.zeros((b, s), dtype=torch.bool, device=ends.device).scatter_(
        1, ends.long(), True).sum(1)
    n_cross = 0
    if g.cross_src is not None:
        cc = g.cross_cost if g.cross_cost.dim() == 2 else g.cross_cost.expand(b, s)
        n_cross = (cc < 0.5e30).sum(1)
    sfu = ((fw - 1) * (n_band + band_rows + 2 * n_cross) + bw * (n_band + band_rows
                                                                 + 2 * n_cross)
           + depth * (fw * (n_eps + fe.any(2).sum(1) + 2 * is_start.sum(1))
                      + bw * (n_eps + fe.any(1).sum(1) + 2 * n_end))
           + nfc * s + (nfc - 1).clamp(min=0) * (n_band + n_cross))
    sfu_n = float(sfu.sum())
    ops = 5 * sfu_n + 4 * s * float((fw + bw).sum()) * (1 + depth)
    graph = [g.band, g.init_cost, g.eps_block, g.word_starts, g.word_ends, g.start_pos,
             g.is_start, g.cross_src, g.cross_cost]
    return (nbytes(nll, *graph, end, nf, out.gamma, out.xi_sum, out.xi_cross, out.log_z),
            ops, sfu_n)


# The walks K21-K23 read only the plane entries their chains visit; a
# stream's chain is serial, so beside this bound a walk also has a floor
# of its longest chain's dependent steps (``SMEM_STEP_CYCLES`` each at
# ``SM_CLOCK_HZ``, as for K5).


def dense_walk_work(states, eps_bp, n_frames, eps_depth: int):
    """``(bytes, operations)`` of K21 on these inputs: ``states`` ``[B, T]``
    (or ``[T]``) is the walk's result and ``eps_bp`` ``[B, T, S]`` (or
    ``[T, S]``) its plane.  Per stream, at every frame below its length,
    the ``eps_bp`` entries of its eps chain (one, and one more after each
    hop taken while fewer than ``eps_depth`` were), a ``bp`` entry at each
    of those frames but frame 0 (4 bytes each), the ``[B, T]`` states
    (int32) and flags (bytes) written and the end states and lengths read;
    4 operations a frame (two compares, two selects)."""
    import torch

    if states.dim() == 1:
        states, eps_bp = states[None], eps_bp[None]
    b, t_len = states.shape
    nf = torch.as_tensor(n_frames, device=states.device).reshape(b).clamp(min=0, max=t_len)
    going = torch.arange(t_len, device=states.device)[None, :] < nf[:, None]
    frames = int(going.sum())
    s, eps_reads = states.long(), 0
    for _ in range(eps_depth):
        eps_reads += int(going.sum())
        origin = eps_bp.gather(2, s[..., None])[..., 0].long()
        going = going & (origin >= 0)
        s = torch.where(origin >= 0, origin, s)
    reads = eps_reads + int((nf.long() - 1).clamp(min=0).sum())
    return 4 * reads + 5 * b * t_len + 8 * b, 4.0 * frames


def chain_walk_work(n_words, rows: int, word_bytes: int, step_bytes: int,
                    start_bytes: int):
    """``(bytes, operations)`` of K22 / K23 on these inputs: per word found
    ``word_bytes`` of plane entries, and per step from a word to the one
    before it (every word but a chain's first) ``step_bytes`` more; the
    ``[rows, B]`` int32 word plane and ``[B]`` int32 counts written;
    ``start_bytes`` a stream of inputs read; 4 operations a word."""
    words, b = int(n_words.sum()), n_words.numel()
    steps = words - int((n_words > 0).sum())
    return (words * word_bytes + steps * step_bytes + 4 * b * (rows + 1) + start_bytes * b,
            4.0 * words)


def gmm_fit_work(n_f, d: int, m: int, iters, staged: bool = True, n: int = 0,
                 kmeans: bool = False):
    """``(bytes, operations, exps and logs)`` of one K24 (``kmeans``) or
    K25 launch: fits of ``n_f[i]`` frames, each run for ``iters[i]``
    iterations, of ``d`` dimensions and ``m`` mixtures (clusters), over a
    buffer of ``n`` frames whose ``[F, n]`` bool mask rows are read.

    Bytes: each fit's frames once where they are staged in shared memory,
    else once an iteration (K24: every frame of the buffer once, for the
    last pass over the frames outside each fit); the mask rows; the
    parameters in and out (K24: the centroids in, centroids, variances and
    counts out, its ``[F, n]`` int64 draws read and assignment written;
    K25: means, variances and weights in and out, the iteration counts).
    Operations a (frame, iteration): the distance, ``m (2d + 1)``
    multiply-adds (a multiply-add is 2), and the statistics: for K25,
    whose responsibilities are dense, ``2 m d`` multiply-adds and ``m``
    adds; for K24, whose assignment is hard, the frame's ``x`` and ``x^2``
    added to its one cluster, ``3 d + 1`` (``d`` squares, ``2 d`` adds
    and the count).  K24 adds the initial assignment's statistics and the
    last pass's distances of the frames outside each fit.  K25's exps and
    logs: ``2 m + 1`` a (frame, iteration)."""
    n_f = [int(v) for v in n_f]
    iters = [int(v) for v in iters]
    f = len(n_f)
    dist = 2 * m * (2 * d + 1)
    stats = 3 * d + 1 if kmeans else 4 * m * d + m
    steps = sum(a * b for a, b in zip(n_f, iters))
    ops = float(steps) * (dist + stats)
    x_reads = (n if kmeans else sum(n_f)) + (0 if staged else steps - sum(n_f))
    n_bytes = 4 * d * x_reads + f * n
    if kmeans:
        ops += sum(n_f) * stats + sum(n - a for a in n_f) * dist
        n_bytes += 4 * f * (3 * m * d + m) + 16 * f * n
        return n_bytes, ops, 0.0
    n_bytes += 8 * f * (2 * m * d + m) + 4 * f
    return n_bytes, ops, float(steps) * (2 * m + 1)


def token_beam_work(tok_state, tables, n_frames, n_units: int, has_cross: bool = True,
                    bigram_cost=None):
    """``(bytes, operations)`` of one K19 launch from its token plane
    ``tok_state [B, T, k]`` (live slots >= 0) and its ``BeamTables``: per
    stream, frame 0 and each frame below its length, with n(t) the live
    tokens the frame keeps, e(t) those at word ends and c(t) its
    candidates (the init states at frame 0, else the proposals of the
    tokens kept at t - 1: their runs in ``ops.beam_kernels.beam_pack``).

    Bytes: the frame's emission row (4 U); the packed tables once (the
    edge records, the state records, the init states and word starts, 16
    bytes each) and the eps block; a bigram entry per end token and frame,
    at most the bigram's size; the three ``[B, T, k]`` int32 planes and
    the ``[B, k]`` final frontier written.  Operations: per candidate the
    two adds, the clamp, the live compare and the key's compare (5); the
    kept tokens' ranking, n log2 n compares (the fewest a comparison sort
    takes); per (word start, end token) pair an add and a compare (2, one
    more with the bigram); the second merge's rank compares, n(t) R."""
    import math

    import torch

    from speech_recognition_tpu_torch.ops.beam_kernels import beam_pack

    tb = tables
    b, t_len, k = tok_state.shape
    pack = beam_pack(tb, has_cross)
    deg = torch.from_numpy(pack.rec[:, 1].astype("int64"))
    n_edges = int(deg.sum())
    n_starts = tb.eps_block.shape[0]
    nf = torch.as_tensor(n_frames, device=tok_state.device).reshape(b).long()
    frames = torch.clamp(nf, min=1, max=t_len)
    going = (torch.arange(t_len, device=tok_state.device)[None, :] < frames[:, None]).cpu()
    ts = tok_state.long().cpu()
    live = ((ts >= 0).sum(2) * going)  # n(t) [B, T]
    ends = ((tb.end_slot.cpu()[ts.clamp(min=0)] >= 0) & (ts >= 0)).sum(2)
    n_ends = int((ends * going).sum())
    runs = torch.where(ts >= 0, deg[ts.clamp(min=0)], 0).sum(2)  # proposals of frame t's tokens
    cand = torch.cat([torch.zeros((b, 1), dtype=runs.dtype), runs[:, :-1]], 1) * going
    cand[:, 0] = tb.init_states.shape[0]
    sort_ops = sum(n * math.log2(n) for n in live.flatten().tolist() if n > 1)
    tables_bytes = 16 * (n_edges + len(pack.rec) + tb.init_states.shape[0] + n_starts) + \
        nbytes(tb.eps_block)
    big_bytes = 0 if bigram_cost is None else min(4 * n_ends, nbytes(bigram_cost))
    n_bytes = (4 * n_units * int(frames.sum()) + tables_bytes + big_bytes
               + 12 * b * t_len * k + 12 * b * k)
    n_ops = (5.0 * int(cand.sum()) + sort_ops
             + (2 if bigram_cost is None else 3) * n_ends * n_starts
             + int(live.sum()) * n_starts)
    return n_bytes, n_ops


def token_beam_floor(n_frames, rounds: int = 1) -> float:
    """K19's serial floor in seconds: the longest stream's frames times
    the dependent steps of one frame (``TOKEN_BEAM_STEPS``, its survivors
    ranked in one round; each more merge round adds its search, its move
    and two barriers) at their latencies (``STEP_CYCLES``) and the SM
    clock.  No frame of the kernel can be shorter: each step waits for the
    one before."""
    import torch

    frames = int(torch.as_tensor(n_frames).reshape(-1).clamp(min=1).max())
    steps = dict(TOKEN_BEAM_STEPS)
    steps["smem"] += 8 * (rounds - 1)
    steps["barrier"] += 2 * (rounds - 1)
    cycles = sum(n * STEP_CYCLES[kind] for kind, n in steps.items())
    return frames * cycles / SM_CLOCK_HZ


def gmm_fit_floor(n_f, iters, d: int, m: int, staged, kmeans: bool = False) -> float:
    """K24's (``kmeans``: one more pass, the initial assignment's
    statistics) or K25's serial floor in seconds: over the fits, the most
    passes x the cycles of one at the SM clock.  A pass over a staged fit
    is one tile of ``GMM_TILE_STEPS`` (no ring wait) and the iteration's
    end, ``GMM_ITER_STEPS``, at their latencies (``STEP_CYCLES``); a fit
    streamed through the ring takes a tile's steps for each of its
    ceil(n_f / 256) tiles, or, where longer, the ring's refills of its
    ``n_f`` rows of ``d`` rounded up to an odd number of float4s at one
    SM's bulk-copy rate (``SM_BULK_BYTES_PER_CYCLE``), the two overlapping.
    ``staged``: a bool for every fit, or one a fit; ``m`` is kept for the
    callers' symmetry with ``gmm_fit_work`` (the chains do not lengthen with
    it)."""
    import math

    n_f = [int(v) for v in n_f]
    iters = [int(v) for v in iters]
    staged = [bool(staged)] * len(n_f) if isinstance(staged, bool) else [bool(v) for v in staged]
    row_bytes = 16 * (((d + 3) // 4) | 1)

    def cyc(steps):
        return sum(n * STEP_CYCLES[kind] for kind, n in steps.items())

    tile = cyc(GMM_TILE_STEPS)
    end = cyc(GMM_ITER_STEPS)
    worst = 0.0
    for nf, it, st in zip(n_f, iters, staged):
        if st:
            per_pass = tile - STEP_CYCLES["smem"] + end
        else:
            per_pass = max(math.ceil(nf / 256) * tile,
                           nf * row_bytes / SM_BULK_BYTES_PER_CYCLE) + end
        worst = max(worst, (it + (1 if kmeans else 0)) * per_pass)
    return worst / SM_CLOCK_HZ


def token_walk_work(n_frames, t_len: int, k: int):
    """``(bytes, operations)`` of one K26 launch without a bigram: per
    stream its ``k`` final slots (state, cost and predecessor read, 12
    bytes; the end slot and word, 16, and the end bonus, 4), then a
    ``tok_word`` and a ``tok_prev`` entry (8) each frame below its length;
    the ``[B, T + 1]`` words and ``[B]`` costs written.  Operations: 4 a
    slot, 2 a frame."""
    import torch

    nf = torch.as_tensor(n_frames).reshape(-1).long().clamp(min=0, max=t_len)
    b, steps = nf.numel(), int(nf.sum())
    return (b * k * 32 + 8 * steps + 4 * b * (t_len + 1) + 4 * b,
            float(b * k * 4 + 2 * steps))


def report(stages: Dict[str, Tuple[float, str]], measured_s: float) -> str:
    """One line: the stages' bounds (``{name: bound(...)}``, ms and what
    sets each) summed against ``measured_s``, the share of the bound the
    measurement reached, and each stage's bound."""
    total_ms = sum(ms for ms, _ in stages.values())
    measured_ms = measured_s * 1e3
    pct = 100.0 * total_ms / measured_ms if measured_ms > 0 else float("nan")
    parts = ", ".join(f"{k}: {ms:.4f} ms by {by}" for k, (ms, by) in stages.items())
    return (f"bound {total_ms:.4f} ms vs measured {measured_ms:.4f} ms -> {pct:.1f}% of "
            f"the bound ({parts})")

"""Dense Viterbi: kernel K11 (``csrc/viterbi_dense.cu``) and its plain
version ``ops.viterbi.viterbi_batch``.

Counterpart of ``speech_recognition_tpu/ops/pallas_kernels.py``
``pallas_viterbi`` (shared or per-utterance graphs), with the semantics
of ``ops/viterbi.viterbi``, including ``final = POS_INF`` at
``n_frames`` 0, where the Pallas kernel leaves it unwritten.  The TPU
layout is not carried over: no padding of S to 128 lanes, no padding of
the frames to 8, no VMEM tiles.

``viterbi_dense`` runs the plain version for CPU tensors and launches
K11 for CUDA tensors (or raises); ``viterbi_dense.launches`` counts
launches.  ``dense_plan`` is the pure host function that picks K11's
form and sizes (packed narrow form for S <= 32, a thread block cluster
per batch slice for a shared matrix, CTAs sized to S for per-item
matrices, the 1,024-thread wide form where neither fits, and its
device-memory frontier above ~11,600 states); ``dense_smem_bytes``
mirrors the kernel's shared-memory layouts.

``dense_backtrace`` is kernel K21 (``csrc/dense_backtrace.cu``), the
backtrace over K11's planes that ``ops.viterbi.viterbi_backtrace`` runs
on CUDA tensors (it replaces the JAX package's ``viterbi_backtrace``
scan); its plain version is ``ops.viterbi.viterbi_backtrace_ref``, and
``dense_backtrace.launches`` counts its launches.  ``dense_backtrace_plan``
is the pure host function that picks its form: windows of frames x
states staged in shared memory for planes with a unit state stride, else
one thread a stream.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace_ref, viterbi_batch
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
    _n_sm,
    _walk_vector,
    use_kernels,
)
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["viterbi_dense", "viterbi_dense_ref", "max_dense_states", "DensePlan",
           "dense_plan", "dense_smem_bytes", "dense_backtrace", "dense_backtrace_ref",
           "BacktracePlan", "dense_backtrace_plan"]

# K11's and K21's plain versions
viterbi_dense_ref = viterbi_batch
dense_backtrace_ref = viterbi_backtrace_ref

# the kernel's forms (csrc/viterbi_dense.cu, enum Form)
FORMS = {"packed": 0, "cluster": 1, "item": 1, "wide": 2, "scratch": 3}
_WARP = 32
PACKED_WARPS = 4       # packed form: warps per CTA
CLUSTER_ITEMS = 4      # cluster form: items sharing each matrix read
CLUSTER_LANES = (8, 4)  # cluster form: lanes per destination row, by preference
ITEM_LANES = (4, 2)     # item form: lanes per destination row, by preference
MAX_CLUSTER = 8        # the portable cluster size
ROWS_MAX_THREADS = 544  # 17 warps: 120 registers a thread


class DensePlan(NamedTuple):
    """K11's form and launch sizes (see ``dense_plan``)."""

    form: str           # packed | cluster | item | wide | scratch
    items_per_warp: int  # packed: floor(32 / S); else 0
    warps: int          # warps per CTA
    cluster: int        # CTAs per cluster (row forms), else 1
    items: int          # items per CTA (row forms), else 0
    rows: int           # destination rows per CTA (row forms), else S
    lanes: int          # lanes per destination row (row forms), else 0
    grid: int           # CTAs
    smem: int           # dynamic shared memory per CTA, bytes

    @property
    def params(self):
        """``(p0, p1, p2)`` of the launcher for this form."""
        if self.form == "packed":
            return self.warps, 0, 0
        if self.form in ("cluster", "item"):
            return self.rows, self.lanes, self.items
        return 0, 0, 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows_layout(s: int, r: int, k: int, ki: int):
    """``(warps, floats of one frontier buffer, floats of one staged
    matrix)`` of the row forms (``RowsLayout`` in the kernel)."""
    rpw = _WARP // k
    cl = _cdiv(s, k)
    cs = cl * r
    cs += (rpw - cs) % _WARP if k > 1 else (-cs) % 4
    return _cdiv(r, rpw), k * (cl | 1) * ki, k * cs


def dense_smem_bytes(form: str, s: int, per_item: bool, use_eps: bool, p0: int = 0,
                     p1: int = 0, p2: int = 0) -> int:
    """Shared memory per CTA of a form, as ``viterbi_dense_smem_bytes`` in
    the kernel: none for the packed form (its matrices live in registers)
    and the scratch form; row forms ``p0`` rows, ``p1`` lanes per row,
    ``p2`` items; wide its frontier, five ``[S]`` rows."""
    if form in ("cluster", "item"):
        _, front, mat = _rows_layout(s, p0, p1, p2)
        return 4 * (2 * front + (1 + bool(use_eps)) * mat)
    if form == "wide":
        return 5 * s * 4
    return 0


MIN_CLUSTER_ROWS = 32  # a cluster grows only while each CTA keeps this many rows


def _rows_plan(form, b, s, per_item, use_eps, limit, n_sm, slots, ki):
    """The cluster form (shared matrix, ``ki`` items per cluster) or the
    item form (per-item matrices, one item per cluster).
    The cluster size is the smallest whose rows fit (a cluster barrier per
    phase costs more than the rows it saves on small graphs), grown up to
    ``MAX_CLUSTER`` while every CTA keeps ``MIN_CLUSTER_ROWS`` rows, the
    CTAs fit one per SM and the card holds all the clusters at once
    (``slots(c, threads, smem, items per CTA)``).  None if no size fits."""
    lanes = ITEM_LANES if per_item else CLUSTER_LANES
    clusters = _cdiv(b, ki)

    def plan(c):  # the first lane count whose CTA fits
        r = _cdiv(s, c)
        for k in lanes:
            warps = _rows_layout(s, r, k, ki)[0]
            smem = dense_smem_bytes(form, s, per_item, use_eps, r, k, ki)
            if warps * _WARP <= ROWS_MAX_THREADS and smem <= limit:
                return DensePlan(form, 0, warps, c, ki, r, k, clusters * c, smem)
        return None

    sizes = range(1, MAX_CLUSTER + 1)
    best = next((p for p in map(plan, sizes) if p is not None), None)
    if best is None:
        return None
    for c in range(best.cluster + 1, MAX_CLUSTER + 1):
        p = plan(c)
        if (p is not None and p.rows >= MIN_CLUSTER_ROWS and p.grid <= n_sm
                and slots(c, p.warps * _WARP, p.smem, ki) >= clusters):
            best = p
    return best


def dense_plan(b: int, s: int, per_item: bool, use_eps: bool, smem_limit: int,
               n_sm: int, cluster_slots) -> DensePlan:
    """K11's form for ``b`` items of ``s`` states, matrices shared or
    ``per_item``, with or without eps passes, under ``smem_limit`` bytes
    of shared memory per CTA on ``n_sm`` SMs.  No size is refused:

    * ``packed`` (S <= 32): floor(32 / S) items per warp,
      ``PACKED_WARPS`` warps per CTA;
    * ``cluster`` (shared matrix): ``CLUSTER_ITEMS`` items per cluster of
      up to ``MAX_CLUSTER`` CTAs that split the destination rows, or one
      item per cluster where the card holds one cluster per item at once;
    * ``item`` (per-item matrices): one item per cluster (usually of one
      CTA), 32 x ceil(rows / 16) threads;
    * the cluster size of either: see ``_rows_plan``; ``cluster_slots(c,
      threads, smem, items)`` counts the clusters the card holds at once
      (on the card ``_cluster_slots``, which asks the CUDA runtime);
    * ``wide`` where no cluster holds the rows, ``scratch`` where not
      even its frontier fits.
    """
    if b < 1 or s < 1:
        raise ValueError(f"dense plan needs b >= 1 and s >= 1, got {b}, {s}")
    if s <= _WARP:
        g = _WARP // s
        return DensePlan("packed", g, PACKED_WARPS, 1, 0, s, 0,
                         _cdiv(b, g * PACKED_WARPS),
                         dense_smem_bytes("packed", s, per_item, use_eps, PACKED_WARPS))
    if per_item:
        rows = _rows_plan("item", b, s, True, use_eps, smem_limit, n_sm, cluster_slots, 1)
    else:
        # one item per cluster where the card holds all of them at once (a
        # small batch: more SMs at work), else CLUSTER_ITEMS share each read
        rows = _rows_plan("cluster", b, s, False, use_eps, smem_limit, n_sm, cluster_slots, 1)
        if rows is None or rows.grid > n_sm or cluster_slots(
                rows.cluster, rows.warps * _WARP, rows.smem, 1) < b:
            rows = _rows_plan("cluster", b, s, False, use_eps, smem_limit, n_sm, cluster_slots,
                              CLUSTER_ITEMS)
    if rows is not None:
        return rows
    smem = dense_smem_bytes("wide", s, per_item, use_eps)
    if smem > smem_limit:
        return DensePlan("scratch", 0, 32, 1, 0, s, 0, b, 0)
    return DensePlan("wide", 0, 32, 1, 0, s, 0, b, smem)


@functools.lru_cache(maxsize=None)
def _card_cluster_slots(dev_index: int, c: int, threads: int, smem: int, items: int) -> int:
    from speech_recognition_tpu_torch.utils.build import load_library

    with torch.cuda.device(dev_index):
        return load_library().viterbi_dense_cluster_slots(c, threads, smem, items)


def _cluster_slots(dev):
    """The card's co-resident clusters of the row form
    (``viterbi_dense_cluster_slots``, asked once per device and shape)."""
    return lambda c, threads, smem, items: _card_cluster_slots(dev.index, c, threads, smem,
                                                               items)


def max_dense_states(lib) -> int:
    """The most states whose K11 frontier (five ``[S]`` rows of 4 bytes)
    fits in shared memory; above, it lives in a device-memory scratch."""
    return lib.srt_smem_limit() // 20


def viterbi_dense(nll, trans, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
                  planes: bool = True):
    """K11 for CUDA tensors, the plain version for CPU tensors.

    ``nll [B, T, S]`` f32; ``trans`` / ``eps_trans`` ``[S, S]`` (shared)
    or ``[B, S, S]`` (per item, as ``per_utterance_graph``); ``init_cost
    [S]`` or ``[B, S]``; ``n_frames [B]``.  Returns ``(final [B, S], bp
    [B, T, S] int32, eps_bp [B, T, S] int32)``; ``planes=False`` writes
    neither plane (``None``), as the isolated scorers need only
    ``final``.  Any S: ``dense_plan`` picks the form; above
    ``max_dense_states`` the frontier lives in a device-memory scratch."""
    if not nll.is_cuda:
        return viterbi_batch(nll, trans, init_cost, n_frames, eps_trans, eps_depth, planes)
    return _launch(nll, trans, init_cost, n_frames, eps_trans, eps_depth, planes)


def _launch(nll, trans, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
            planes: bool = True, plan: DensePlan = None, trace=None):
    """K11 on CUDA tensors in the form ``plan`` (default: ``dense_plan``'s
    for the card; the card tests and the timing lab force other forms).
    ``trace`` (int64 on the device, packed form ``[warps, 2]``, row forms
    ``[grid, 5]``) receives the kernel's clock64 counts (see the launcher
    in ``csrc/viterbi_dense.cu``)."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if not nll.is_cuda:
        raise ValueError(f"the dense Viterbi kernel runs on CUDA tensors, got {nll.device}")
    dev = nll.device
    if nll.dtype != torch.float32 or nll.dim() != 3:
        raise ValueError(f"dense Viterbi kernel takes float32 nll [B, T, S], got "
                         f"{nll.dtype} {tuple(nll.shape)}")
    b, t_len, s = nll.shape
    mats = [("trans", trans)] + ([("eps_trans", eps_trans)] if eps_trans is not None else [])
    for name, m in mats:
        if m.shape not in ((s, s), (b, s, s)) or m.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [S, S] or [B, S, S] with S={s}, "
                             f"B={b}; got {m.dtype} {tuple(m.shape)}")
    if eps_trans is not None and eps_trans.shape != trans.shape:
        raise ValueError("trans and eps_trans must both be shared or both per item")
    if init_cost.shape not in ((s,), (b, s)) or init_cost.dtype != torch.float32:
        raise ValueError(f"init_cost must be float32 [S] or [B, S], got "
                         f"{init_cost.dtype} {tuple(init_cost.shape)}")
    if n_frames.shape != (b,):
        raise ValueError(f"n_frames has shape {tuple(n_frames.shape)}, batch is {b}")
    for name, x in [("init_cost", init_cost), ("n_frames", n_frames), *mats]:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, emissions on {dev}")
    if eps_depth < 1:
        raise ValueError(f"eps_depth must be >= 1, got {eps_depth}")
    lib = load_library()
    use_eps = eps_trans is not None
    final = torch.empty((b, s), dtype=torch.float32, device=dev)
    bp = torch.empty((b, t_len, s), dtype=torch.int32, device=dev) if planes else None
    eps_bp = torch.empty_like(bp) if planes else None
    if b == 0 or t_len == 0 or s == 0:
        return final.fill_(POS_INF), bp, eps_bp
    per_item = trans.dim() == 3
    if plan is None:
        plan = dense_plan(b, s, per_item, use_eps, lib.srt_smem_limit(),
                          torch.cuda.get_device_properties(dev).multi_processor_count,
                          _cluster_slots(dev))
    # a frontier too wide for shared memory lives in a [B, 5, S] scratch
    scratch = (torch.empty((b, 5, s), dtype=torch.float32, device=dev)
               if plan.form == "scratch" else None)
    args = [nll.contiguous(), trans.contiguous(),
            eps_trans.contiguous() if use_eps else None,
            init_cost.contiguous(), n_frames.to(torch.int32).contiguous()]
    ptr = [x.data_ptr() if x is not None else None for x in args]
    with torch.cuda.device(dev):
        rc = lib.viterbi_dense_launch(
            *ptr, final.data_ptr(), bp.data_ptr() if planes else None,
            eps_bp.data_ptr() if planes else None,
            scratch.data_ptr() if scratch is not None else None, b, t_len, s,
            int(per_item), int(init_cost.dim() == 2), eps_depth, FORMS[plan.form],
            *plan.params, plan.cluster, plan.grid, plan.smem,
            trace.data_ptr() if trace is not None else None,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "dense Viterbi kernel")
    viterbi_dense.launches += 1
    return final, bp, eps_bp


viterbi_dense.launches = 0


# K21's window form (csrc/dense_backtrace.cu): at most WINDOW_STATES states
# and WINDOW_ROWS frames a window, at most BACKTRACE_WARPS warps a CTA, and
# no window of fewer than MIN_WINDOW_ROWS frames
WINDOW_STATES = 128
WINDOW_ROWS = 32
MIN_WINDOW_ROWS = 8
BACKTRACE_WARPS = 4


class BacktracePlan(NamedTuple):
    """K21's form and launch sizes (see ``dense_backtrace_plan``)."""

    form: str    # window | chain
    rows: int    # frames a window (W); chain: 0
    states: int  # states a window (R); chain: 0
    lanes: int   # lanes that walk one stream (32 / streams a warp); chain: 1
    warps: int   # warps a CTA
    grid: int    # CTAs
    smem: int    # dynamic shared memory a CTA, bytes
    block: bool = False  # a window's rows are one segment (R = S = frame stride)


def dense_backtrace_plan(b: int, t: int, s: int, strides, smem_limit: int, n_sm: int,
                         eps_depth: int = 1) -> BacktracePlan:
    """K21's form for ``b`` streams of ``t`` frames over ``s`` states,
    planes at ``strides`` (each plane's ``(b, t, s)`` element strides),
    under ``smem_limit`` bytes of shared memory a CTA on ``n_sm`` SMs:

    * ``window`` where every plane's state stride is 1 (K11's ``[B, T,
      S]`` planes, a ``[T, S]`` plane's view) and ``s`` is at most K11's
      shared-memory frontier (``smem_limit // 20``, ``max_dense_states``):
      windows of ``WINDOW_ROWS`` frames x every state in the block layout
      where the planes' rows are contiguous and two stages of them fit
      (S up to ~450: the sausage's 385), else x ``WINDOW_STATES`` states a
      row (``window_plan``);
    * ``chain`` otherwise: one thread a stream reading the planes in place.
      Past K11's frontier a window of 128 states covers about 1% of a row,
      so a walk that jumps across the graph would reload at every jump.

    Why (``scripts/exp_r20_dense_backtrace.py --sweep`` on an NVIDIA H100
    80GB HBM3 at 700 W): a window of every state is one bulk copy
    a plane and never misses on a state, so on the sausage at 64 x 500 it
    beats 128-state rows (a bulk copy a row) by ~1.8x though it stages 3x
    the bytes; 32 frames beat 16 (more window changes) and 64 (half the
    streams a warp's shared memory holds, at S = 5); 128 states a row hold
    the sausage's largest drop at a slot boundary (101 states)."""
    if b < 1 or t < 1 or s < 1:
        raise ValueError(f"backtrace plan needs b, t, s >= 1, got {b}, {t}, {s}")
    if all(st[2] == 1 for st in strides) and s <= smem_limit // 20:
        block = all(st[1] == s for st in strides)
        if block:
            plan = window_plan(b, t, s, eps_depth, WINDOW_ROWS, s, smem_limit, n_sm, block=True)
            if plan is not None and plan.rows == min(WINDOW_ROWS, t):
                return plan
        plan = window_plan(b, t, s, eps_depth, WINDOW_ROWS, WINDOW_STATES, smem_limit, n_sm,
                           block=block)
        if plan is not None:
            return plan
    return BacktracePlan("chain", 0, 0, 1, 4, _cdiv(b, 128), 0)


def window_smem(w: int, r: int, s: int, lanes: int, warps: int, eps_depth: int,
                block: bool) -> int:
    """Shared memory of a window-form CTA (bytes; ``window_smem`` in
    ``csrc/dense_backtrace.cu``): two stages a stream of each plane's rows,
    a row ``4 ceil((R + 3) / 4)`` words (16-byte chunks from the one
    holding the row's first state), or in the block layout one segment of
    ``W S`` words and its phase; and a ring of the stream's last 32 states
    and flags and the stages' two mbarriers (44 words)."""
    plane = 4 * ((w * s + 6) // 4) if block else w * 4 * ((r + 6) // 4)
    return warps * (_WARP // lanes) * (2 * plane * (2 if eps_depth > 0 else 1) + 44) * 4


def window_plan(b: int, t: int, s: int, eps_depth: int, rows: int, states: int,
                smem_limit: int, n_sm: int, block: bool = False):
    """The window form's sizes at up to ``rows`` frames x ``states``
    states a window, or ``None`` where fewer than ``MIN_WINDOW_ROWS``
    frames fit.  R = min(S, states); the lanes a stream are the largest
    power of two up to min(32, R) (S = 5: 4 lanes, 8 streams a warp),
    W = min(rows, T), halved until a warp's two stages fit; as many warps
    a CTA (up to ``BACKTRACE_WARPS``) as there are warps for each SM, so a
    small batch spreads over the SMs.  ``block`` (the planes' frame stride
    is S) takes the block layout where R = S."""
    r = min(s, states)
    block = block and r == s
    lanes = 1 << (min(_WARP, r).bit_length() - 1)
    groups = _WARP // lanes
    w = min(rows, t)
    while w > 1 and window_smem(w, r, s, lanes, 1, eps_depth, block) > smem_limit:
        w //= 2
    if w < min(MIN_WINDOW_ROWS, t):
        return None
    warp_bytes = window_smem(w, r, s, lanes, 1, eps_depth, block)
    n_warps = _cdiv(b, groups)
    warps = max(1, min(BACKTRACE_WARPS, n_warps // n_sm, smem_limit // warp_bytes))
    return BacktracePlan("window", w, r, lanes, warps, _cdiv(n_warps, warps),
                         warps * warp_bytes, block)


@functools.lru_cache(maxsize=256)
def _card_backtrace_plan(dev, b: int, t: int, s: int, strides, eps_depth: int) -> BacktracePlan:
    """``dense_backtrace_plan`` for the card ``dev``, once per shape."""
    from speech_recognition_tpu_torch.utils.build import load_library

    return dense_backtrace_plan(b, t, s, strides, load_library().srt_smem_limit(), _n_sm(dev),
                                eps_depth)


def dense_backtrace(bp, eps_bp, end_state, n_frames, eps_depth: int = 1):
    """K21 for CUDA planes (``csrc/dense_backtrace.cu`` in the form
    ``dense_backtrace_plan`` picks), the plain version
    ``viterbi_backtrace_ref`` for CPU planes.  Arguments and results as
    ``ops.viterbi.viterbi_backtrace``: int32 ``bp`` / ``eps_bp`` ``[T, S]``
    with scalar ``end_state`` / ``n_frames``, or ``[B, T, S]`` with ``[B]``
    ones (any strides)."""
    return _backtrace(bp, eps_bp, end_state, n_frames, eps_depth)


def _backtrace(bp, eps_bp, end_state, n_frames, eps_depth: int = 1,
               plan: BacktracePlan = None, stats=None):
    """``dense_backtrace`` with its form forced by ``plan`` (the card
    tests and the timing lab; default ``dense_backtrace_plan``'s) and, in
    the window form, ``stats`` (int64 ``[B, 7]`` on the device) given each
    stream's windows walked, windows taken from the load ahead, loads
    ahead dropped, words staged, cycles waiting for copies, cycles in
    window changes and cycles in all."""
    if bp.dim() not in (2, 3) or bp.dtype != torch.int32 or eps_bp.dtype != torch.int32 \
            or eps_bp.shape != bp.shape:
        raise ValueError(f"the dense backtrace takes int32 bp / eps_bp of one shape, [T, S] "
                         f"or [B, T, S]; got {bp.dtype} {tuple(bp.shape)} and {eps_bp.dtype} "
                         f"{tuple(eps_bp.shape)}")
    dev = bp.device
    if eps_bp.device != dev:
        raise ValueError(f"eps_bp is on {eps_bp.device}, bp on {dev}")
    if eps_depth < 0:
        raise ValueError(f"eps_depth must be >= 0, got {eps_depth}")
    single = bp.dim() == 2
    bp3, ep3 = (bp[None], eps_bp[None]) if single else (bp, eps_bp)
    b, t_len, s = bp3.shape
    end = _walk_vector(end_state, b, dev, "end_state")
    nf = _walk_vector(n_frames, b, dev, "n_frames")
    if t_len and not s:
        raise ValueError("the dense backtrace needs at least one state")
    if not use_kernels(bp):
        return viterbi_backtrace_ref(bp, eps_bp, end_state, n_frames, eps_depth)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    states = torch.empty((b, t_len), dtype=torch.int32, device=dev)
    flags = torch.empty((b, t_len), dtype=torch.bool, device=dev)
    if b and t_len:
        lib = load_library()
        if plan is None:
            plan = _card_backtrace_plan(dev, b, t_len, s, (bp3.stride(), ep3.stride()),
                                        eps_depth)
        if stats is not None and (plan.form != "window" or stats.shape != (b, 7)
                                  or stats.dtype != torch.int64 or stats.device != dev):
            raise ValueError("stats takes the window form's int64 [B, 7] counters")
        with torch.cuda.device(dev):
            rc = lib.dense_backtrace_launch(
                int(plan.form == "window"), bp3.data_ptr(), *bp3.stride(), ep3.data_ptr(),
                *ep3.stride(), end.data_ptr(), nf.data_ptr(), states.data_ptr(),
                flags.data_ptr(), t_len, s, b, eps_depth, plan.rows, plan.states, plan.lanes,
                plan.warps, plan.grid, plan.smem, int(plan.block),
                stats.data_ptr() if stats is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
        check(rc, f"dense backtrace kernel ({plan.form} form)")
        dense_backtrace.launches += 1
    if single:
        return states[0], flags[0]
    return states, flags


dense_backtrace.launches = 0

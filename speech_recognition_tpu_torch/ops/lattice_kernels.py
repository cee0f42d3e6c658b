"""Lattice kernels K6 (pass-1 lattice planes) and K7 (bigram rescoring),
with their plain PyTorch versions.

K6 (``csrc/viterbi_lex.cu``, the lattice mode of K4) replaces the TPU
kernel ``_lex_kernel(emit_lattice=True)`` behind
``viterbi_lex_pallas_lattice`` and its lane-major twin
``_lex_kernel_wide(emit_lattice=True)``; its plain version is
``ops.lattice.viterbi_lattice_tb``.  K7 (``csrc/lattice_rescore.cu``)
replaces ``ops/lattice.py``'s ``_hq_sweep_pallas``, the VMEM-resident
ring lookup of the rescorer; the ring exists because XLA would not keep
it resident across the scan, and on the card the lookup is one indexed
load, so K7 is the whole rescoring DP (plain version
``ops.lattice.rescore_tbl``).  K22 (``csrc/lattice_walk.cuh``) is the
word walk over K7's predecessors and K6's entry times; it replaces no
TPU kernel but the JAX package's ``lattice_words_device`` scan, and its
plain version is ``ops.lattice.lattice_words_ref``.  The bigram pipeline
runs it as K7's last step (``rescore_and_walk``, one launch that also
computes the per-frame minimum q and the truncation count);
``lattice_walk`` launches it alone (``csrc/word_walk.cu``) for
``ops.lattice.lattice_words_device`` on any strided planes.

Layouts: emissions ``nll [U, T, B]`` as K4 takes them; the lattice
planes ``ends_cost / ends_tau [T, B, L]`` and the predecessor plane
``pred_w [T, B, L]``, so one stream's row is contiguous.  The public
functions of ``ops.lattice`` keep the reference's ``[T, L, B]`` and
transpose around the plain versions.

Each wrapper runs its plain version for CPU tensors and launches its
CUDA kernel for CUDA tensors (or raises), counting launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.ops.lattice import (
    _lattice_truncation_counts,
    lattice_words_ref,
    rescore_tbl,
    viterbi_lattice_tb,
)
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import _walk_vector, use_kernels
from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import (
    LexTopo,
    lex_forward,
)

__all__ = ["viterbi_lattice", "viterbi_lattice_ref", "RescorePlan", "rescore_plan",
           "rescore_smem_bytes", "rescore_lattice", "rescore_lattice_ref", "rescore_and_walk",
           "rescore_and_walk_ref", "lattice_walk", "lattice_walk_ref"]


# ---------------------------------------------------------------------------
# K6: lattice pass 1
# ---------------------------------------------------------------------------


def viterbi_lattice_ref(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """Plain version of K6: ``nll [U, T, B]``, ``n_frames [B]`` ->
    ``(final [B, S], ends_cost [T, B, L], ends_tau [T, B, L] int32)``,
    ``viterbi_lattice_tb`` in K6's layouts."""
    if topo.n_states != g.n_states:
        raise ValueError(f"topology/graph mismatch: {topo.n_states} vs {g.n_states}")
    final, ec, et = viterbi_lattice_tb(nll.permute(1, 0, 2)[:, g.bank_state, :], g, n_frames)
    return (final.T.contiguous(), ec.transpose(1, 2).contiguous(),
            et.transpose(1, 2).contiguous())


def viterbi_lattice(nll, g: BandedGraph, topo: LexTopo, n_frames):
    """K6 for CUDA tensors, the plain version for CPU tensors; arguments
    and results as ``viterbi_lattice_ref``.  Every frame ``t < T`` of
    the planes is written: frames past a stream's length repeat its last
    frame, and a stream of length 0 still runs frame 0.  The same
    kernel and plan as K4 (``viterbi_lex_kernels.lex_forward``), with an
    entry-time frontier beside the costs."""
    if not use_kernels(nll):
        return viterbi_lattice_ref(nll, g, topo, n_frames)
    return lex_forward(nll, g, topo, n_frames, True, viterbi_lattice)


viterbi_lattice.launches = 0


# ---------------------------------------------------------------------------
# K7: bigram rescoring over the lattice
# ---------------------------------------------------------------------------


# Plain version of K7: the rescoring DP in the kernel's layouts
rescore_lattice_ref = rescore_tbl


class RescorePlan(NamedTuple):
    """K7's launch plan.  ``leaves`` per thread (1, 2, 4 or 8) selects the
    staged mode with ``threads`` threads per CTA, three frames of lattice
    rows in shared memory and the LM tables there when ``tables``;
    ``leaves == 0`` is the direct mode, 1,024 threads, its D rows in
    shared memory or, when ``scratch``, in device memory.  ``smem`` is
    the CTA's dynamic shared memory in bytes."""

    leaves: int
    threads: int
    tables: bool
    scratch: bool
    smem: int

    @property
    def mode(self) -> str:
        if self.leaves:
            return (f"staged, {self.leaves} leaves per thread"
                    + (", LM tables on chip" if self.tables else ""))
        return "direct, D in device memory" if self.scratch else "direct"


_K7_THREADS = 1024
_K7_LEAVES = (1, 2, 4, 8)
# the CTAs' static shared memory beside the dynamic rows: the staged
# mode's double-buffered argmin, q and count partials, the direct mode's
# argmin partials (which q and the count reuse), 32 warps each
_K7_STAGED_STATIC = 3 * 2 * 32 * 4
_K7_DIRECT_STATIC = 2 * 32 * 4


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def rescore_smem_bytes(l: int, k: int, tables: bool) -> int:
    """Shared memory of a staged K7 CTA (``lattice_rescore_staged_smem_bytes``):
    rows of ``l`` floats rounded up to 4, two D rows, three rows each of
    ends_cost and ends_tau, and with ``tables`` ``k`` rows each of pidx
    and pcost."""
    return 4 * _r4(l) * (8 + (2 * k if tables else 0))


def rescore_plan(l: int, k: int, dense: bool, limit: int) -> RescorePlan:
    """K7's plan for ``l`` leaves and ``k`` predecessors per target (the
    backoff LM; ``dense`` for the ``[L, L]`` one): the staged mode with the
    fewest leaves per thread that cover ``l`` with 1,024 threads, the LM
    tables in shared memory where they fit ``limit``, else read through
    L1; where even the rows do not fit beside the CTA's static partials
    (over ~7,200 leaves), the direct mode with its two D rows (``8 l``
    bytes) in shared memory where they fit beside its static partials,
    else in a device-memory scratch.  Every size gets a plan."""
    nl = next((n for n in _K7_LEAVES if n * _K7_THREADS >= l), 0)
    if nl:
        per_thread = -(-l // nl)
        threads = -(-per_thread // 32) * 32  # whole warps
        for tables in ((False,) if dense else (True, False)):
            smem = rescore_smem_bytes(l, k, tables)
            if smem + _K7_STAGED_STATIC <= limit:
                return RescorePlan(nl, threads, tables, False, smem)
    if 8 * l + _K7_DIRECT_STATIC <= limit:
        return RescorePlan(0, _K7_THREADS, False, False, 8 * l)
    return RescorePlan(0, _K7_THREADS, False, True, 0)


def _rescore_launch(ends_cost, ends_tau, start_l, end_l, n_frames, dmax, big_ll, backoff,
                    plan, trace, max_dur, max_words, q_out, extra=()):
    """Checks K7's arguments (and ``extra``, more ``(name, tensor, dtype,
    shape)`` to check), allocates its outputs and launches it on CUDA
    tensors: ``(cost, best_leaf, pred_w, n_trunc, leaves_rev, n_words)``
    and whether there was a stream to launch for."""
    from speech_recognition_tpu_torch.utils.build import check, load_library

    if (big_ll is None) == (backoff is None):
        raise ValueError("pass exactly one of big_ll and backoff")
    if ends_cost.dim() != 3:
        raise ValueError("ends_cost must be a [T, B, L] tensor")
    t_len, b, l = ends_cost.shape
    dev = ends_cost.device
    lm = (("big_ll", big_ll, torch.float32, (l, l)),) if backoff is None else (
        ("base_l", backoff[0], torch.float32, (l,)),
        ("pred_idx", backoff[1], torch.int32, (l, backoff[1].shape[-1])),
        ("pred_cost", backoff[2], torch.float32, (l, backoff[1].shape[-1])))
    opt = (("q_out", q_out, torch.float32, (t_len, b)),
           ("trace", trace, torch.int64, (b, 4)))
    for name, x, dtype, shape in (("ends_cost", ends_cost, torch.float32, (t_len, b, l)),
                                  ("ends_tau", ends_tau, torch.int32, (t_len, b, l)),
                                  *extra, *(x for x in opt if x[1] is not None),
                                  ("start_l", start_l, torch.float32, (l,)),
                                  ("end_l", end_l, torch.float32, (l,)),
                                  ("n_frames", n_frames, None, (b,)), *lm):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the lattice on {dev}")
        if (dtype is not None and x.dtype != dtype) or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if t_len == 0 or l == 0 or dmax < 1:
        raise ValueError(f"rescoring needs T, L, dmax >= 1 (got {t_len}, {l}, {dmax})")
    if max_dur < 1 or max_words < 0:
        raise ValueError(f"rescore_and_walk needs max_dur >= 1 and max_words >= 0 (got "
                         f"{max_dur}, {max_words})")
    cost = torch.empty((b,), dtype=torch.float32, device=dev)
    best = torch.empty((b,), dtype=torch.int32, device=dev)
    pred = torch.empty((t_len, b, l), dtype=torch.int32, device=dev)
    n_trunc = torch.empty((b,), dtype=torch.int32, device=dev)
    leaves_rev = torch.empty((max_words, b), dtype=torch.int32, device=dev)
    n_words = torch.empty((b,), dtype=torch.int32, device=dev)
    out = (cost, best, pred, n_trunc, leaves_rev, n_words)
    if b == 0:
        return out, False
    lib = load_library()
    k = 0 if backoff is None else backoff[1].shape[1]
    if plan is None:
        plan = rescore_plan(l, k, backoff is None, lib.srt_smem_limit())
    nf = n_frames.to(torch.int32).contiguous()
    # every ring row is written before it is read (a lookup needs
    # tau < t), so the ring starts uninitialized
    ring = torch.empty((b, dmax, l), dtype=torch.float32, device=dev)
    scratch = (torch.empty((b, 2, l), dtype=torch.float32, device=dev)
               if plan.scratch else None)
    lm_ptrs = ([big_ll.data_ptr(), None, None, None] if backoff is None
               else [None] + [x.data_ptr() for x in backoff])
    # the staged mode reads the backoff pairs target-minor: [K, L, 2] int32
    tab = None
    if plan.leaves and backoff is not None:
        tab = torch.stack((backoff[1].T, backoff[2].T.view(torch.int32)), -1).contiguous()

    def ptr(x):
        return None if x is None or x.numel() == 0 else x.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.lattice_rescore_launch(
            ends_cost.data_ptr(), ends_tau.data_ptr(), start_l.data_ptr(), end_l.data_ptr(),
            nf.data_ptr(), *lm_ptrs, ptr(tab), ring.data_ptr(), cost.data_ptr(),
            best.data_ptr(), pred.data_ptr(), t_len, b, l, k, dmax, plan.leaves,
            plan.threads, int(plan.tables), ptr(scratch), ptr(trace), ptr(q_out),
            n_trunc.data_ptr(), max_dur, ptr(leaves_rev), n_words.data_ptr(), max_words,
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "lattice rescoring kernel")
    return out, True


def rescore_lattice(ends_cost, ends_tau, q, start_l, end_l, n_frames, dmax: int,
                    big_ll=None, backoff=None, plan: RescorePlan = None, trace=None):
    """K7 for CUDA tensors, the plain version for CPU tensors; arguments
    and results as ``rescore_lattice_ref``.  ``q`` must be the per-frame
    minimum ``ends_cost.amin(2)``, as every caller passes it: the kernel
    computes that minimum itself (bit for bit), so on CUDA tensors ``q``
    is checked for its shape and not read.  The launch is
    ``rescore_and_walk``'s with a walk of no rows, its counts discarded.
    ``plan`` overrides ``rescore_plan``'s; ``trace``, a ``[B, 4]`` int64
    tensor, receives the staged mode's cycles per phase of the frame
    loop (row wait, D and the ring reads, barrier, recombination and
    stores; thread 0's clock).  The ``H - q`` rows live in a ``[B, dmax,
    L]`` device-memory ring."""
    if not use_kernels(ends_cost):
        return rescore_lattice_ref(ends_cost, ends_tau, q, start_l, end_l, n_frames, dmax,
                                   big_ll=big_ll, backoff=backoff)
    shape = tuple(ends_cost.shape[:2]) if ends_cost.dim() == 3 else None
    out, launched = _rescore_launch(ends_cost, ends_tau, start_l, end_l, n_frames, dmax,
                                    big_ll, backoff, plan, trace, dmax, 0, None,
                                    extra=(("q", q, torch.float32, shape),))
    rescore_lattice.launches += launched
    return out[:3]


rescore_lattice.launches = 0


def rescore_and_walk_ref(ends_cost, ends_tau, start_l, end_l, n_frames, dmax: int,
                         max_dur: int, max_words: int, big_ll=None, backoff=None, q_out=None):
    """Plain version of ``rescore_and_walk``: the per-frame minimum ``q =
    ends_cost.amin(2)`` (copied into ``q_out [T, B]`` when given), the
    truncation count of each stream, ``rescore_tbl`` and
    ``lattice_words_ref`` on its predecessors, in the kernels' layouts."""
    q = ends_cost.amin(2)
    if q_out is not None:
        q_out.copy_(q)
    et_v = ends_tau.transpose(1, 2)
    n_trunc = _lattice_truncation_counts(ends_cost.transpose(1, 2), et_v, n_frames, max_dur)
    cost, best, pred = rescore_tbl(ends_cost, ends_tau, q, start_l, end_l, n_frames, dmax,
                                   big_ll=big_ll, backoff=backoff)
    leaves_rev, n_words = lattice_words_ref(pred.transpose(1, 2), et_v, best, n_frames,
                                            max_words)
    return cost, best, pred, n_trunc, leaves_rev, n_words


def rescore_and_walk(ends_cost, ends_tau, start_l, end_l, n_frames, dmax: int, max_dur: int,
                     max_words: int, big_ll=None, backoff=None, plan: RescorePlan = None,
                     trace=None, q_out=None):
    """The bigram pipeline's one K7 launch for CUDA tensors, the plain
    ``rescore_and_walk_ref`` for CPU tensors: ``ends_cost / ends_tau [T,
    B, L]`` from K6, the LM as for ``rescore_lattice``, the ring depth
    ``dmax``, the raw ``max_dur`` of the truncation count and the walk's
    ``max_words`` -> ``(cost [B], best_leaf [B] int32, pred_w [T, B, L]
    int32, n_trunc [B] int32, leaves_rev [max_words, B] int32, n_words
    [B] int32)``.  The kernel computes q itself (``q_out``, a ``[T, B]``
    float32 tensor, receives it); ``plan`` and ``trace`` as for
    ``rescore_lattice``."""
    if not use_kernels(ends_cost):
        return rescore_and_walk_ref(ends_cost, ends_tau, start_l, end_l, n_frames, dmax,
                                    max_dur, max_words, big_ll=big_ll, backoff=backoff,
                                    q_out=q_out)
    out, launched = _rescore_launch(ends_cost, ends_tau, start_l, end_l, n_frames, dmax,
                                    big_ll, backoff, plan, trace, max_dur, max_words, q_out)
    rescore_and_walk.launches += launched
    return out


rescore_and_walk.launches = 0


# ---------------------------------------------------------------------------
# K22: the word walk
# ---------------------------------------------------------------------------

lattice_walk_ref = lattice_words_ref


def lattice_walk(pred_w, ends_tau, best_leaf, n_frames, max_words: int = 128):
    """K22 for CUDA planes (``csrc/word_walk.cu``: one thread a stream,
    reading the planes at their strides: the ``[T, L, B]`` views of K7's
    and K6's ``[T, B, L]`` planes are not copied), the plain version
    ``lattice_words_ref`` for CPU planes.  Arguments and results as
    ``ops.lattice.lattice_words_device``."""
    if pred_w.dim() != 3 or pred_w.dtype != torch.int32 or ends_tau.dtype != torch.int32 \
            or ends_tau.shape != pred_w.shape:
        raise ValueError(f"the word walk takes int32 pred_w / ends_tau [T, L, B] of one "
                         f"shape; got {pred_w.dtype} {tuple(pred_w.shape)} and "
                         f"{ends_tau.dtype} {tuple(ends_tau.shape)}")
    t_len, l, b = pred_w.shape
    dev = pred_w.device
    if ends_tau.device != dev:
        raise ValueError(f"ends_tau is on {ends_tau.device}, pred_w on {dev}")
    leaf = _walk_vector(best_leaf, b, dev, "best_leaf")
    nf = _walk_vector(n_frames, b, dev, "n_frames")
    if max_words < 0 or (b and not (t_len and l)):
        raise ValueError(f"the word walk needs max_words >= 0 and non-empty planes, got "
                         f"{max_words} and {tuple(pred_w.shape)}")
    if not use_kernels(pred_w):
        return lattice_words_ref(pred_w, ends_tau, best_leaf, n_frames, max_words)
    from speech_recognition_tpu_torch.utils.build import check, load_library

    out = torch.empty((max_words, b), dtype=torch.int32, device=dev)
    n_words = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        lib = load_library()
        with torch.cuda.device(dev):
            rc = lib.lattice_walk_launch(
                pred_w.data_ptr(), *pred_w.stride(), ends_tau.data_ptr(), *ends_tau.stride(),
                leaf.data_ptr(), nf.data_ptr(), out.data_ptr(), n_words.data_ptr(), t_len, l,
                b, max_words, torch.cuda.current_stream(dev).cuda_stream)
        check(rc, "lattice word walk kernel")
        lattice_walk.launches += 1
    return out, n_words


lattice_walk.launches = 0

"""Min-cost Viterbi over a dense transition matrix, and its backtrace.

Counterpart of ``speech_recognition_tpu/ops/viterbi.py``.  One frame
step is the min-plus product ``new[to] = min_from(T[to, from] +
prev[from]) + nll[t, to]``; non-emitting states are eliminated offline
(``models/graph.py``) into a same-column ``eps_trans`` matrix, relaxed
``eps_depth`` times per column.  The rules are the reference's: ``nll``
clamped to ``POS_INF`` first; the first minimum's origin is the
backpointer; each eps pass reads the whole pre-pass cost (Jacobi) and
applies strict improvements only; ``bp`` row 0 is -1, ``eps_bp`` -1
where no pass improved; frames ``>= n_frames`` keep the cost frozen but
still write their ``bp`` / ``eps_bp`` rows from it; ``final`` is the
cost at frame ``n_frames - 1`` (``POS_INF`` for ``n_frames`` 0).
``beam_width`` k > 0 prunes each column after its eps passes to the
costs ``<=`` its k-th smallest (``_beam_prune``: exact ties with the
k-th best survive, a column with fewer than k finite costs keeps them
all); the pruned column is the carry.

``viterbi_batch`` is the batched plain version of kernel K11
(``ops.viterbi_kernels.viterbi_dense``, ``csrc/viterbi_dense.cu``);
``viterbi`` runs one utterance through that wrapper, so a CUDA tensor
runs K11; with a beam it runs ``viterbi_batch`` (no kernel prunes, in
either package).  ``viterbi_backtrace`` (an XLA scan in JAX, not a
Pallas kernel) runs kernel K21 (``ops.viterbi_kernels.dense_backtrace``,
``csrc/dense_backtrace.cu``) on CUDA planes and its plain version
``viterbi_backtrace_ref``, one batched loop over the frames, on CPU ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["viterbi", "viterbi_batch", "viterbi_backtrace", "viterbi_backtrace_ref",
           "viterbi_path_cost", "ViterbiResult"]


class ViterbiResult(NamedTuple):
    final_cost: torch.Tensor  # [S] costs at the last valid frame
    bp: torch.Tensor  # [T, S] int32 frame-edge backpointers (-1 at t=0)
    eps_bp: torch.Tensor  # [T, S] int32 same-column origin, -1 if none


def _relax(prev, mat):
    """``prev [B, S]``, ``mat [B | 1, S, S]`` (``T[to, from]``) ->
    ``(min_from(mat + prev) [B, S], first minimizing origin [B, S] int32)``."""
    s = prev.shape[-1]
    scores = mat + prev[:, None, :]
    m = scores.amin(-1)
    iota = torch.arange(s, device=prev.device)
    idx = torch.where(scores == m[..., None], iota, s).amin(-1)
    return m, idx.to(torch.int32)


def _beam_prune(cost, beam_width: int, dim: int = -1):
    """Rank-threshold beam along ``dim`` (the states): costs above the
    ``beam_width``-th smallest become ``POS_INF`` (ties with it survive;
    a width past the axis keeps everything)."""
    k = min(beam_width, cost.shape[dim])
    thresh = torch.kthvalue(cost, k, dim=dim, keepdim=True).values
    return torch.where(cost <= thresh, cost, torch.full_like(cost, POS_INF))


def viterbi_batch(nll, trans, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
                  planes: bool = True, beam_width: int = 0):
    """Batched dense Viterbi in tensor ops (the plain version of K11).

    ``nll [B, T, S]``; ``trans`` / ``eps_trans`` ``[S, S]`` shared or
    ``[B, S, S]`` per item; ``init_cost [S]`` or ``[B, S]``; ``n_frames
    [B]``.  Returns ``(final [B, S], bp [B, T, S] int32, eps_bp [B, T, S]
    int32)``; with ``planes=False`` the planes are ``None`` (and frames
    past the longest item are not visited).  ``beam_width`` > 0 prunes
    every column of every item (``_beam_prune``).
    """
    b, t_len, s = nll.shape
    dev = nll.device
    nf = n_frames.to(dev)
    nll = torch.clamp(nll, max=POS_INF)
    mat = trans if trans.dim() == 3 else trans[None]
    emat = None if eps_trans is None else (eps_trans if eps_trans.dim() == 3
                                           else eps_trans[None])
    init = init_cost.expand(b, s) if init_cost.dim() == 1 else init_cost
    final = torch.full((b, s), POS_INF, dtype=torch.float32, device=dev)
    bp = torch.empty((b, t_len, s), dtype=torch.int32, device=dev) if planes else None
    eps_bp = torch.empty_like(bp) if planes else None
    if t_len == 0 or b == 0:
        return final, bp, eps_bp

    def column(base, emis):
        cost = torch.clamp(base + emis, max=POS_INF)
        ebp = torch.full((b, s), -1, dtype=torch.int32, device=dev)
        for _ in range(eps_depth if emat is not None else 0):
            cand_base, cand_bp = _relax(cost, emat)
            cand = torch.clamp(cand_base + emis, max=POS_INF)
            better = cand < cost
            cost = torch.where(better, cand, cost)
            ebp = torch.where(better, cand_bp, ebp)
        return cost, ebp

    prev, ebp = column(init, nll[:, 0])
    if beam_width:
        prev = _beam_prune(prev, beam_width)
    if planes:
        bp[:, 0] = -1
        eps_bp[:, 0] = ebp
    final = torch.where((nf == 1)[:, None], prev, final)
    t_stop = t_len if planes else min(t_len, int(nf.max()))
    for t in range(1, t_stop):
        base, arg = _relax(prev, mat)
        cost, ebp = column(base, nll[:, t])
        if beam_width:
            cost = _beam_prune(cost, beam_width)
        cost = torch.where((t < nf)[:, None], cost, prev)
        final = torch.where((t == nf - 1)[:, None], cost, final)
        prev = cost
        if planes:
            bp[:, t] = arg
            eps_bp[:, t] = ebp
    return final, bp, eps_bp


def viterbi(nll, trans_cost, init_cost, n_frames, eps_trans=None, eps_depth: int = 1,
            beam_width: int = 0) -> ViterbiResult:
    """Min-cost Viterbi over one utterance: ``nll [T, S]``, ``trans_cost
    [S, S]`` (``T[to, from]``, ``POS_INF`` where absent), ``init_cost
    [S]``, ``n_frames`` (frames >= it are ignored), optional ``eps_trans
    [S, S]`` with ``eps_depth`` passes.  A CUDA tensor runs K11;
    ``beam_width`` > 0 runs the pruned ``viterbi_batch`` on either device."""
    from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense

    nf = torch.as_tensor(n_frames, dtype=torch.int32, device=nll.device).reshape(1)
    if beam_width:
        final, bp, eps_bp = viterbi_batch(nll[None], trans_cost, init_cost, nf,
                                          eps_trans=eps_trans, eps_depth=eps_depth,
                                          beam_width=beam_width)
    else:
        final, bp, eps_bp = viterbi_dense(nll[None], trans_cost, init_cost, nf,
                                          eps_trans=eps_trans, eps_depth=eps_depth)
    return ViterbiResult(final[0], bp[0], eps_bp[0])


def viterbi_backtrace(bp, eps_bp, end_state, n_frames, eps_depth: int = 1):
    """Per-frame states from backpointers, walking back from ``(end_state,
    n_frames - 1)``: each column records its last state (after the eps
    hops), then the eps chain is unwound and the frame edge followed.

    ``bp`` / ``eps_bp`` ``[T, S]`` (one utterance) or ``[B, T, S]``,
    ``end_state`` and ``n_frames`` scalars or ``[B]``.  Returns ``(states
    int32, eps_entered bool)``, each ``[T]`` or ``[B, T]``:
    ``eps_entered[t]`` marks a word-boundary eps edge crossed at frame t.
    Entries >= ``n_frames`` repeat the end state / False.  CUDA planes run
    K21 (``ops.viterbi_kernels.dense_backtrace``), CPU planes
    ``viterbi_backtrace_ref``."""
    from speech_recognition_tpu_torch.ops.viterbi_kernels import dense_backtrace

    return dense_backtrace(bp, eps_bp, end_state, n_frames, eps_depth)


def viterbi_backtrace_ref(bp, eps_bp, end_state, n_frames, eps_depth: int = 1):
    """Plain version of K21: ``viterbi_backtrace`` as one batched loop of
    gathers over the frames (arguments and results as there)."""
    single = bp.dim() == 2
    if single:
        bp, eps_bp = bp[None], eps_bp[None]
    b, t_len, _ = bp.shape
    dev = bp.device
    st = torch.as_tensor(end_state, device=dev).reshape(b).to(torch.int64)
    nf = torch.as_tensor(n_frames, device=dev).reshape(b)
    states = torch.empty((b, t_len), dtype=torch.int32, device=dev)
    flags = torch.empty((b, t_len), dtype=torch.bool, device=dev)
    for t in range(t_len - 1, -1, -1):
        states[:, t] = st.to(torch.int32)
        s_eps = st
        used = torch.zeros(b, dtype=torch.bool, device=dev)
        for _ in range(eps_depth):
            origin = eps_bp[:, t].gather(1, s_eps[:, None])[:, 0].to(torch.int64)
            used = used | (origin >= 0)
            s_eps = torch.where(origin >= 0, origin, s_eps)
        prev = bp[:, t].gather(1, s_eps[:, None])[:, 0].to(torch.int64)
        flags[:, t] = used & (t < nf)
        st = torch.where((t > 0) & (t < nf), prev, st)
    if single:
        return states[0], flags[0]
    return states, flags


def viterbi_path_cost(nll, trans_cost, init_cost, n_frames, end_state=None, **kw):
    """Best-path cost only: the cost at the last state (or ``end_state``)
    and the last frame."""
    res = viterbi(nll, trans_cost, init_cost, n_frames, **kw)
    return res.final_cost[-1 if end_state is None else end_state]

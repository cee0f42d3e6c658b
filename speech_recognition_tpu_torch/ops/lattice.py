"""Word-lattice generation and exact bigram rescoring over the lattice.

Counterpart of ``speech_recognition_tpu/ops/lattice.py``.  Composing a
bigram onto the decoding graph is exact only on flat vocabularies, so
the deep-trie bigram decode runs in two passes:

Pass 1 (:func:`viterbi_lattice_tb`, kernel K6 on CUDA): the banded
lexical-tree Viterbi with an entry-time plane ``tau`` carried through
every band, cross and re-entry decision.  Per frame it emits the leaf
arc end costs ``S0`` and their entry times: for each (frame t, leaf l)
the arc "word(l) spans (tau, t] with pass-1 score S0".  With the
re-entry cost ``Q[tau] = wic + min_l' S0[tau, l']``, the arc's acoustic
score is ``S0[t, l] - Q[tau]``.

Pass 2 (:func:`lattice_rescore_ref`, kernel K7 on CUDA): exact bigram
Viterbi over the lattice arcs::

    D[t, l] = S0[t, l] + (H[tau, l] - q[tau])   (0 < tau, t - tau <= dmax)
              S0[t, l] + start_cost[word(l)]    (tau <= 0)
    H[t, w] = min_w' (D[t, w'] + bigram(w', w))
    answer  = min_l (D[nf-1, l] + end_cost[word(l)])

with ``q[t] = min_l S0[t, l]`` (the word-insertion cost cancels) and
the stored, rounded ``H - q`` looked up for arcs of at most ``dmax``
frames (``_ring_depth``; longer arcs see POS_INF).  The recombination
is the dense ``[L, L]`` first minimum or, for an LM with backoff
structure (:func:`rescore_backoff`), one global backoff minimum plus a
sparse minimum over each word's seen predecessors.

The public functions keep the reference's layouts (``[T, L, B]``
planes); the kernels work in ``[T, B, L]`` (one stream's row
contiguous), and the pipeline :func:`decode_lextree_bigram` keeps that
layout from K6 to the word walk, which on CUDA is K7's last step.  The
reference's TPU-only forms (the sliced-take backoff with its lane
permutation, the VMEM ring blocking, the batch chunking and backend
choice) are not carried over.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import (
    MAX_BAND,
    BandedGraph,
    _select_band,
    _shift_org,
    _shift_s,
)
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["viterbi_lattice_tb", "RescoreResult", "lattice_rescore_ref", "rescore_tbl",
           "lattice_words", "lattice_words_device", "lattice_words_ref", "rescore_backoff",
           "lattice_lm", "decode_lextree_bigram"]


# ---------------------------------------------------------------------------
# pass 1: the lattice planes
# ---------------------------------------------------------------------------


def viterbi_lattice_tb(nll_tb, g: BandedGraph, n_frames):
    """Banded lexical-tree Viterbi (``viterbi_banded_tb`` semantics, eps
    depth 1) that carries entry times and emits the lattice planes.

    ``nll_tb [T, S, B]``, ``n_frames [B]`` -> ``(final [S, B],
    ends_cost [T, L, B], ends_tau [T, L, B] int32)`` with L indexing
    ``g.word_ends``.  As the reference's XLA scan: frame 0 is computed
    for every stream (``n_frames = 0`` included); later frames
    ``t >= n_frames`` freeze cost and ``tau`` and still emit the planes;
    ``tau`` follows the band winner, then the cross edge (ties go to it,
    so a dead state takes its cross source's ``tau``), then a strict
    re-entry improvement sets it to ``t``.  The graph must carry no LM
    (a row-constant eps block) for the rescorer's identity to hold."""
    t_len, s, b = nll_tb.shape
    if t_len == 0:
        raise ValueError("viterbi_lattice_tb needs at least one frame")
    dev = nll_tb.device
    nll_tb = torch.clamp(nll_tb, max=POS_INF)
    n_frames = n_frames.to(dev)
    ends = g.word_ends
    ends_cost = torch.empty((t_len, g.n_ends, b), dtype=torch.float32, device=dev)
    ends_tau = torch.empty((t_len, g.n_ends, b), dtype=torch.int32, device=dev)

    def reenter(cost, tau, emis, t):
        eb = (g.eps_block[:, :, None] + cost[ends][None]).amin(1)  # [R, B]
        cand = torch.clamp(eb + emis[g.word_starts], max=POS_INF)[g.start_pos]
        better = g.is_start[:, None] & (cand < cost)
        return torch.where(better, cand, cost), torch.where(better, t, tau)

    cost = torch.clamp(g.init_cost[:, None] + nll_tb[0], max=POS_INF)
    cost, tau = reenter(cost, torch.zeros((s, b), dtype=torch.int32, device=dev),
                        nll_tb[0], 0)
    final = torch.where((n_frames == 1)[None, :], cost, torch.full_like(cost, POS_INF))
    ends_cost[0], ends_tau[0] = cost[ends], tau[ends]
    for t in range(1, t_len):
        prev, tprev = cost, tau
        base, d_sel = _select_band([g.band[d][:, None] + _shift_s(prev, d)
                                    for d in range(MAX_BAND + 1)])
        tau_new = tprev
        for d in range(1, MAX_BAND + 1):
            tau_new = torch.where(d_sel == d, _shift_org(tprev, d), tau_new)
        if g.cross_src is not None:
            cand = torch.clamp(prev[g.cross_src] + g.cross_cost[:, None], max=POS_INF)
            take = cand <= base
            base = torch.where(take, cand, base)
            tau_new = torch.where(take, tprev[g.cross_src], tau_new)
        cost = torch.clamp(base + nll_tb[t], max=POS_INF)
        cost, tau_new = reenter(cost, tau_new, nll_tb[t], t)
        active = (t < n_frames)[None, :]
        cost = torch.where(active, cost, prev)
        tau = torch.where(active, tau_new, tprev)
        final = torch.where((t == n_frames - 1)[None, :], cost, final)
        ends_cost[t], ends_tau[t] = cost[ends], tau[ends]
    return final, ends_cost, ends_tau


# ---------------------------------------------------------------------------
# pass 2: rescoring
# ---------------------------------------------------------------------------


class RescoreResult(NamedTuple):
    cost: torch.Tensor  # [B] best rescored sentence cost
    best_leaf: torch.Tensor  # [B] int32 final leaf slot
    pred_w: torch.Tensor  # [T, L, B] int32 first-minimum predecessor leaf
    ends_tau: torch.Tensor  # [T, L, B] int32 pass-1 entry times, echoed


def _ring_depth(t_len: int, max_dur: int) -> int:
    """Lookup window of the rescorer: the reference's ring depth
    ``ceil8(min(max_dur, ceil8(T)))`` (rows in frame blocks of 8)."""
    if max_dur < 1:
        raise ValueError(f"max_dur must be >= 1, got {max_dur}")
    t_pad = (t_len + 7) // 8 * 8
    return (min(max_dur, t_pad) + 7) // 8 * 8


def _first_min_index(x, m, dim, n):
    """Index of the first entry of ``x`` equal to ``m`` along ``dim``."""
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    iota = torch.arange(x.shape[dim], device=x.device).view(shape)
    return torch.where(x == m, iota, n).amin(dim)


def _recombine(d, big_ll=None, backoff=None, block: int = 128):
    """One frame's H row and first-minimum predecessors from ``d [B, L]``
    (``h [B, L]`` clamped to POS_INF, ``p [B, L]`` int64 leaf slots)."""
    b, l = d.shape
    if backoff is not None:
        base_l, pidx, pcost = backoff
        pidx = pidx.to(torch.int64)
        db = d + base_l[None, :]
        m_all = db.amin(1, keepdim=True)
        arg_all = _first_min_index(db, m_all, 1, l)[:, None]
        h_sp = torch.full_like(d, POS_INF)
        p_sp = torch.zeros((b, l), dtype=torch.int64, device=d.device)
        for k in range(pidx.shape[1]):  # ties keep the smallest k
            cand = d[:, pidx[:, k]] + pcost[None, :, k]
            tk = cand < h_sp
            h_sp = torch.where(tk, cand, h_sp)
            p_sp = torch.where(tk, pidx[None, :, k], p_sp)
        take = h_sp < m_all
        return (torch.clamp(torch.where(take, h_sp, m_all), max=POS_INF),
                torch.where(take, p_sp, arg_all))
    hs, ps = [], []
    for j0 in range(0, l, block):  # bounds the [B, L, block] transient
        sc = d[:, :, None] + big_ll[None, :, j0:j0 + block]
        m = sc.amin(1)
        ps.append(_first_min_index(sc, m[:, None, :], 1, l))
        hs.append(torch.clamp(m, max=POS_INF))
    return torch.cat(hs, 1), torch.cat(ps, 1)


def rescore_tbl(ends_cost, ends_tau, q, start_l, end_l, n_frames, dmax: int,
                big_ll=None, backoff=None):
    """The rescoring DP in the kernels' layout, a per-frame loop.

    ``ends_cost / ends_tau [T, B, L]`` (leaf slots), ``q [T, B]`` (the
    per-frame minimum of ``ends_cost``), ``start_l / end_l [L]`` and
    either ``big_ll [L, L]`` (source leaf, target leaf) or ``backoff =
    (base_l [L], pred_idx [L, K], pred_cost [L, K])``, all in leaf-slot
    order -> ``(cost [B], best_leaf [B] int32, pred_w [T, B, L] int32)``.
    ``H - q`` rows live in a ring of ``dmax`` rows; a lookup is live
    only for ``tau < t`` and ``t - tau <= dmax``."""
    if (big_ll is None) == (backoff is None):
        raise ValueError("pass exactly one of big_ll and backoff")
    t_len, b, l = ends_cost.shape
    dev = ends_cost.device
    ring = torch.full((dmax, b, l), POS_INF, dtype=torch.float32, device=dev)
    d_fin = torch.full((b, l), POS_INF, dtype=torch.float32, device=dev)
    nf_last = torch.clamp(n_frames.to(dev, torch.int64) - 1, 0, t_len - 1)
    pred = torch.empty((t_len, b, l), dtype=torch.int32, device=dev)
    for t in range(t_len):
        s0, tau = ends_cost[t], ends_tau[t].to(torch.int64)
        live = (tau < t) & (t - tau <= dmax)
        hq = torch.gather(ring, 0, (torch.clamp(tau, min=0) % dmax)[None])[0]
        hq = torch.where(live, hq, POS_INF)
        d = torch.where(tau <= 0, s0 + start_l[None, :], s0 + hq)
        h, p = _recombine(d, big_ll, backoff)
        pred[t] = p.to(torch.int32)
        ring[t % dmax] = h - q[t][:, None]
        d_fin = torch.where((nf_last == t)[:, None], d, d_fin)
    final = d_fin + end_l[None, :]
    cost = final.amin(1)
    best = _first_min_index(final, cost[:, None], 1, l)
    return cost, best.to(torch.int32), pred


def lattice_rescore_ref(ends_cost, ends_tau, leaf_word, bigram_cost, start_cost,
                        end_cost, n_frames, max_dur: int = 128,
                        backoff=None) -> RescoreResult:
    """Exact bigram Viterbi over the lattice planes (the reference's
    ``lattice_rescore`` without its TPU options).

    ``ends_cost / ends_tau [T, L, B]`` from :func:`viterbi_lattice_tb`,
    ``leaf_word [L]``, word-indexed ``bigram_cost [V, V]``,
    ``start_cost / end_cost [V]``; ``backoff`` (from
    :func:`rescore_backoff`, leaf-slot order) selects the backoff
    recombination, else the dense one.  The planes are transposed to
    ``[T, B, L]`` for :func:`rescore_tbl` and ``pred_w`` back."""
    dev = ends_cost.device
    lw = torch.as_tensor(np.asarray(leaf_word), dtype=torch.int64, device=dev)
    start_l, end_l = start_cost.to(dev)[lw], end_cost.to(dev)[lw]
    big_ll = None
    if backoff is None:
        big_ll = bigram_cost.to(dev)[lw][:, lw].contiguous()
    else:
        backoff = tuple(x.to(dev) for x in backoff)
    ec = ends_cost.permute(0, 2, 1).contiguous()
    cost, best, pred = rescore_tbl(ec, ends_tau.permute(0, 2, 1).contiguous(), ec.amin(2),
                                   start_l, end_l, n_frames,
                                   _ring_depth(ec.shape[0], max_dur), big_ll, backoff)
    return RescoreResult(cost=cost, best_leaf=best,
                         pred_w=pred.permute(0, 2, 1).contiguous(), ends_tau=ends_tau)


def rescore_backoff(lm, leaf_word) -> Optional[Tuple[torch.Tensor, ...]]:
    """Leaf-slot backoff arrays ``(base_l [L], pred_idx [L, K] int32,
    pred_cost [L, K])`` as CPU tensors, or None when the LM has no
    backoff structure (the rescorer then runs the dense recombination)."""
    from speech_recognition_tpu_torch.langmodel.bigram import bigram_backoff

    leaf_word = np.asarray(leaf_word)
    bo = bigram_backoff(np.asarray(lm.cost)[leaf_word][:, leaf_word])
    if bo is None:
        return None
    return (torch.from_numpy(bo.base), torch.from_numpy(bo.pred_idx.astype(np.int32)),
            torch.from_numpy(bo.pred_cost))


# ---------------------------------------------------------------------------
# word recovery
# ---------------------------------------------------------------------------


def lattice_words(res: RescoreResult, leaf_word, n_frames) -> List[List[int]]:
    """Host word backtrace through the rescore DP: follow (entry time,
    predecessor leaf) chains from the best final leaf."""
    pred = res.pred_w.cpu().numpy()  # [T, L, B]
    taus = res.ends_tau.cpu().numpy()
    leaf_word = np.asarray(leaf_word)
    best = res.best_leaf.cpu().numpy()
    nfs = np.asarray(n_frames.cpu() if torch.is_tensor(n_frames) else n_frames)
    out: List[List[int]] = []
    t_len = pred.shape[0]
    for i in range(pred.shape[2]):
        words: List[int] = []
        t = min(int(nfs[i]) - 1, t_len - 1)
        leaf = int(best[i])
        for _ in range(t_len + 1):  # bounded walk
            words.append(int(leaf_word[leaf]))
            tau = int(taus[t, leaf, i])
            if tau <= 0:
                break
            # the predecessor of this word is the argmin recorded for
            # H[tau, leaf], stored at frame tau
            leaf = int(pred[tau, leaf, i])
            t = tau
        out.append(words[::-1])
    return out


def lattice_words_device(pred_w, ends_tau, best_leaf, n_frames, max_words: int = 128):
    """Word backtrace on the planes' device: ``pred_w / ends_tau [T, L,
    B]`` int32 (any strides) -> ``(leaves_rev [max_words, B] int32, -1
    past the first word, n_words [B] int32)``; reverse per stream and map
    through ``leaf_word``.  CUDA planes run kernel K22
    (``ops.lattice_kernels.lattice_walk``), CPU planes
    :func:`lattice_words_ref`."""
    from speech_recognition_tpu_torch.ops.lattice_kernels import lattice_walk

    return lattice_walk(pred_w, ends_tau, best_leaf, n_frames, max_words)


def lattice_words_ref(pred_w, ends_tau, best_leaf, n_frames, max_words: int = 128):
    """Plain version of K22: :func:`lattice_words_device` as a loop of
    ``max_words`` batched gathers (the JAX scan's steps)."""
    t_len, l, b = pred_w.shape
    dev = pred_w.device
    cols = torch.arange(b, device=dev)
    n_frames = n_frames.to(dev)
    leaf = best_leaf.to(dev, torch.int64)
    t = torch.clamp(n_frames.to(torch.int64) - 1, 0, t_len - 1)
    alive = n_frames > 0
    out = torch.empty((max_words, b), dtype=torch.int32, device=dev)
    for k in range(max_words):
        out[k] = torch.where(alive, leaf, -1).to(torch.int32)
        lc = torch.clamp(leaf, 0, l - 1)
        tau = ends_tau[t, lc, cols].to(torch.int64)
        nxt = pred_w[torch.clamp(tau, 0, t_len - 1), lc, cols].to(torch.int64)
        cont = alive & (tau > 0)
        leaf = torch.where(cont, nxt, leaf)
        t = torch.where(cont, tau, t)
        alive = cont
    return out, (out >= 0).sum(0).to(torch.int32)


def _lattice_truncation_counts(ends_cost, ends_tau, n_frames, max_dur: int = 128):
    """Per stream, the live lattice arcs (``[T, L, B]`` planes) spanning
    more than ``max_dur`` frames, which the rescorer drops: ``[B]``
    int32.  The test is on the raw ``max_dur``, not the rescorer's
    rounded ``dmax``, as in the reference."""
    ts = torch.arange(ends_cost.shape[0], device=ends_cost.device)[:, None, None]
    live = (ends_cost < POS_INF / 2) & (ts < n_frames.to(ends_cost.device)[None, None, :])
    return (live & ((ts - ends_tau) > max_dur)).sum((0, 1), dtype=torch.int32)


def _lattice_truncation_count(ends_cost, ends_tau, n_frames, max_dur: int = 128):
    """The reference's count: :func:`_lattice_truncation_counts` summed
    over the streams."""
    return _lattice_truncation_counts(ends_cost, ends_tau, n_frames, max_dur).sum()


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def lattice_lm(lm, leaf_word, device):
    """The LM in leaf-slot order on ``device``: ``(start_l [L], end_l
    [L], big_ll, backoff)`` with ``backoff`` from :func:`rescore_backoff`
    where the LM has that structure (``big_ll`` None), else the dense
    ``big_ll [L, L]`` (``backoff`` None)."""
    lw = torch.as_tensor(np.asarray(leaf_word), dtype=torch.int64, device=device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    backoff = rescore_backoff(lm, leaf_word)
    big_ll = None
    if backoff is None:
        big_ll = f32(lm.cost)[lw][:, lw].contiguous()
    else:
        backoff = tuple(x.to(device) for x in backoff)
    return f32(lm.start_cost)[lw], f32(lm.end_cost)[lw], big_ll, backoff


def _decode_lattice_batch(bank, feats, n_frames, g: BandedGraph, topo, lm_l, su: int,
                          max_dur: int = 128):
    """The device part of :func:`decode_lextree_bigram`: ``feats [B, T,
    D]``, ``n_frames [B]``, the trie ``g`` and its ``LexTopo``, ``lm_l``
    from :func:`lattice_lm`, all on one device -> ``(leaves_rev
    [W, B], n_words [B], costs [B], n_truncated [B])`` on that device:
    ``bank_nll_ubt``, K6 and one ``rescore_and_walk`` (K7 with q, the
    truncation count and the word walk)."""
    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt
    from speech_recognition_tpu_torch.ops.lattice_kernels import (
        rescore_and_walk,
        viterbi_lattice,
    )

    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    n_frames = n_frames.to(dev)
    t_len = feats.shape[1]
    nll = bank_nll_ubt(bank, feats, n_frames)  # [U, T, B]
    _, ends_cost, ends_tau = viterbi_lattice(nll, g, topo, n_frames)  # [T, B, L]
    start_l, end_l, big_ll, backoff = lm_l
    # every unit dwells >= 1 frame, so a word takes at least su frames
    cost, _, _, n_trunc, leaves_rev, n_words = rescore_and_walk(
        ends_cost, ends_tau, start_l, end_l, n_frames, _ring_depth(t_len, max_dur), max_dur,
        min(t_len, t_len // max(su, 1) + 1), big_ll=big_ll, backoff=backoff)
    return leaves_rev, n_words, cost, n_trunc


def decode_lextree_bigram(bank, lexg, lm, feats, n_frames, max_dur: int = 128
                          ) -> Tuple[List[List[int]], np.ndarray]:
    """Bigram decode over a deep lexical tree: the no-LM pass-1 lattice
    plus exact bigram rescoring, on the device of ``feats``.

    ``bank`` is the unit bank, ``lexg`` a trie built with no LM (a word
    insertion cost is allowed), ``lm`` anything with ``cost [V, V]``,
    ``start_cost [V]`` and ``end_cost [V]``; ``feats [B, T, D]`` and
    ``n_frames [B]`` are tensors.  Runs ``models.hmm.bank_nll_ubt``, K6
    (``ops.lattice_kernels.viterbi_lattice``) and K7 with its extras
    (``rescore_and_walk``: the backoff recombination where the LM has
    one, else the dense; the truncation count, a ``RuntimeWarning`` when
    live arcs exceed ``max_dur``; the word walk); the leaves map to words
    on the host.  Returns ``(word sequences, costs)``."""
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology

    dev = feats.device
    leaves_rev, n_words, cost, n_trunc = _decode_lattice_batch(
        bank, feats, n_frames, lexg.banded.to(dev), lex_topology(lexg.banded),
        lattice_lm(lm, lexg.leaf_word, dev), lexg.n_states // lexg.n_arcs, max_dur)
    # the walk's rows, its word counts and the truncation counts in one copy
    w, b = leaves_rev.shape
    host = torch.cat((leaves_rev.reshape(-1), n_words, n_trunc)).cpu().numpy()
    lr, nw = host[: w * b].reshape(w, b), host[w * b: w * b + b]
    n_trunc = int(host[w * b + b:].sum())
    if n_trunc:
        warnings.warn(
            f"lattice_rescore: {n_trunc} live lattice arc(s) span more "
            f"than max_dur={max_dur} frames and were dropped from the "
            "lattice; raise max_dur for slow speech / long words",
            RuntimeWarning, stacklevel=2)
    leaf_word = np.asarray(lexg.leaf_word)
    seqs = [leaf_word[lr[: nw[i], i][::-1]].tolist() for i in range(feats.shape[0])]
    return seqs, cost.cpu().numpy()

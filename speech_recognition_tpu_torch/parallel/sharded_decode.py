"""State-sharded decoding: the graph's states spread over the ranks of
one mesh axis.

Counterpart of ``speech_recognition_tpu/parallel/sharded_decode.py``
(``shard_map`` over the 'model' axis there).  For graphs too large for
one card, each rank holds ``C = S_pad / n`` consecutive states of the
banded graph and relaxes its own columns frame by frame; what crosses a
shard boundary moves by collectives over the axis's process group:

* per frame, the band's reach into the previous shard: every rank's last
  ``MAX_BAND`` (=2) frontier values, ``all_gather``ed (shard 0 reads
  ``POS_INF``, as the single-device oracle's shift fills it); a graph
  with cross edges (a trie) gathers the whole frontier instead, since a
  cross edge's origin can be any state;
* per eps pass, a ``MIN`` ``all_reduce`` of the ``[L, B]`` word-end
  values; the origins and candidates then come out the same on every
  rank (the first minimum of the replicated scores);
* with a beam, each rank's ``min(k, C)`` smallest costs per stream,
  ``all_gather``ed: the global k-th smallest is among them, and every
  rank keeps its costs ``<=`` it (the collective beam merge);
* once per call, before the frames: a ``MIN`` ``all_reduce`` of the
  emissions at the word starts of every frame ``[T, R, B]``; after them:
  a ``MAX`` ``all_reduce`` of the per-pass "a start improved" verdicts
  ``[T, depth, R, B]`` (int32, whatever the side plane's type), which
  the replicated eps side plane is built from.

The JAX version reduces the start emissions and the verdicts in every
pass (``pmin`` / ``pmax``); they feed nothing later in the frame, so
here each is one collective per call.  The output is bit-identical to
``ops.viterbi_banded.viterbi_banded_tb`` on the unpadded graph (tested
against it and against the JAX ``viterbi_banded``).  No kernel runs the
sharded frame step: it is tensor ops and collectives, as the JAX one is
a ``lax.scan`` under ``shard_map``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.nn import functional as F

from speech_recognition_tpu_torch.ops.viterbi_banded import (
    _CROSS,
    _EPS,
    MAX_BAND,
    BandedGraph,
    _eps_u_dtype,
    _first_min,
    _select_band,
)
from speech_recognition_tpu_torch.parallel.mesh import all_gather
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["pad_banded_for_sharding", "make_sharded_banded_viterbi", "state_slice",
           "gather_planes"]


def pad_banded_for_sharding(g: BandedGraph, n_shards: int) -> Tuple[BandedGraph, int]:
    """Pad the state axis to a multiple of ``n_shards``; padding states
    are unreachable (``POS_INF`` band and init, no start, no cross edge).
    Returns ``(graph, S)`` with ``S`` the unpadded state count."""
    s = g.n_states
    pad = -s % n_shards
    if pad == 0:
        return g, s

    def grow(x, value=0):
        return None if x is None else F.pad(x, (0, pad), value=value)

    return (g._replace(band=grow(g.band, POS_INF), init_cost=grow(g.init_cost, POS_INF),
                       start_pos=grow(g.start_pos), is_start=grow(g.is_start, False),
                       bank_state=grow(g.bank_state), cross_src=grow(g.cross_src),
                       cross_cost=grow(g.cross_cost, POS_INF)), s)


def _group(mesh_or_group, axis: str):
    """The process group of ``axis`` of a DeviceMesh, or the group given
    (None: the default group)."""
    if hasattr(mesh_or_group, "get_group"):
        return mesh_or_group.get_group(axis)
    return mesh_or_group


def state_slice(mesh_or_group, s_pad: int, axis: str = "model") -> slice:
    """The states ``[d C, (d + 1) C)`` this rank holds of a padded graph of
    ``s_pad`` states."""
    group = _group(mesh_or_group, axis)
    n, d = dist.get_world_size(group), dist.get_rank(group)
    if s_pad % n:
        raise ValueError(f"{s_pad} states do not divide {n} shards: pad the graph first")
    c = s_pad // n
    return slice(d * c, (d + 1) * c)


def gather_planes(mesh_or_group, final, bp8, axis: str = "model"):
    """Every rank's ``final [C, B]`` and ``bp8 [T, C, B]`` gathered to
    ``[S_pad, B]`` and ``[T, S_pad, B]`` (for ``banded_backtrace_tb``)."""
    group = _group(mesh_or_group, axis)
    return (torch.cat(all_gather(final, group), 0), torch.cat(all_gather(bp8, group), 1))


def make_sharded_banded_viterbi(mesh_or_group, g: BandedGraph, eps_depth: int = 1,
                                axis: str = "model", beam_width: int = 0):
    """A state-sharded banded Viterbi over the ranks of ``axis`` of a
    DeviceMesh (or over a process group; None: the default group).

    ``g`` is the whole graph padded by :func:`pad_banded_for_sharding`, on
    this rank's device.  Returns ``run(nll_local [T, C, B], n_frames [B])
    -> (final [C, B], bp8 [T, C, B] int8, eps_u [T, R, B])``: this rank's
    columns of the state-major emissions (``nll_tb[:, state_slice(...)]``;
    B = 1 is the JAX per-utterance case) in, this rank's columns of the
    final costs and backpointers and the replicated eps side plane out,
    as ``viterbi_banded_tb`` gives them on the unpadded graph.
    ``beam_width`` k > 0 prunes each column to the global k best (ties
    kept).  ``run.collectives_per_frame`` counts the per-frame ones."""
    group = _group(mesh_or_group, axis)
    d = dist.get_rank(group)
    sl = state_slice(group, g.n_states, axis)
    c, off = sl.stop - sl.start, sl.start
    has_cross = g.cross_src is not None
    u_dtype = _eps_u_dtype(g.n_ends)
    band_l = g.band[:, sl]
    init_l, is_start_l, start_pos_l = g.init_cost[sl], g.is_start[sl], g.start_pos[sl]
    cross_src_l = g.cross_src[sl] if has_cross else None
    cross_cost_l = g.cross_cost[sl] if has_cross else None

    def local(states):
        """``(index into the shard, owned)`` of global states."""
        pos = states - off
        own = (pos >= 0) & (pos < c)
        return pos.clamp(0, c - 1), own

    end_pos, end_own = local(g.word_ends)
    start_loc, start_own = local(g.word_starts)

    def reach(prev):
        """``(the two states before this shard [MAX_BAND, B], the whole
        frontier [S_pad, B] or None)``."""
        if has_cross:
            full = torch.cat(all_gather(prev, group), 0)
            halo = full[max(off - MAX_BAND, 0):off]
        else:
            tails = all_gather(prev[-min(c, MAX_BAND):], group)
            full, halo = None, torch.cat(tails[:d], 0)[-MAX_BAND:] if d else prev[:0]
        fill = torch.full((MAX_BAND - halo.shape[0], prev.shape[1]), POS_INF,
                          dtype=prev.dtype, device=prev.device)
        return torch.cat([fill, halo], 0), full

    def column(base, d_sel, emis, emis_starts):
        cost = torch.clamp(base + emis, max=POS_INF)
        bp8 = d_sel
        verdicts, origins = [], []
        for _ in range(eps_depth):
            ev = torch.where(end_own[:, None], cost[end_pos], POS_INF)
            dist.all_reduce(ev, op=dist.ReduceOp.MIN, group=group)
            base_e, origin = _first_min(g.eps_block[:, :, None] + ev[None], 1)
            cand = torch.clamp(base_e + emis_starts, max=POS_INF)
            cand_dense = cand[start_pos_l]
            better = is_start_l[:, None] & (cand_dense < cost)
            cost = torch.where(better, cand_dense, cost)
            bp8 = torch.where(better, torch.full_like(bp8, _EPS), bp8)
            verdicts.append(start_own[:, None] & better[start_loc])
            origins.append(origin)
        if beam_width:
            local_k = torch.topk(cost, min(beam_width, c), dim=0, largest=False).values
            pool = torch.cat(all_gather(local_k, group), 0)
            thresh = torch.kthvalue(pool, min(beam_width, pool.shape[0]), dim=0,
                                    keepdim=True).values
            cost = torch.where(cost <= thresh, cost, torch.full_like(cost, POS_INF))
        return cost, bp8, torch.stack(verdicts), torch.stack(origins)

    def run(nll_local, n_frames):
        t_len, c_in, b = nll_local.shape
        if c_in != c:
            raise ValueError(f"this rank holds {c} states, got emissions of {c_in}")
        dev = nll_local.device
        nll_local = torch.clamp(nll_local, max=POS_INF)
        n_frames = n_frames.to(dev)
        emis_starts = torch.where(start_own[None, :, None], nll_local[:, start_loc], POS_INF)
        dist.all_reduce(emis_starts, op=dist.ReduceOp.MIN, group=group)
        bp8 = torch.empty((t_len, c, b), dtype=torch.int8, device=dev)
        verdicts = torch.empty((t_len, eps_depth, g.n_words, b), dtype=torch.int32,
                               device=dev)
        origins = torch.empty((t_len, eps_depth, g.n_words, b), dtype=torch.int64,
                              device=dev)
        cost, bp8[0], verdicts[0], origins[0] = column(
            init_l[:, None].expand(c, b), torch.zeros((c, b), dtype=torch.int8, device=dev),
            nll_local[0], emis_starts[0])
        final = torch.where((n_frames == 1)[None, :], cost, torch.full_like(cost, POS_INF))
        for t in range(1, t_len):
            prev = cost
            halo, full = reach(prev)
            ext = torch.cat([halo, prev], 0)
            base, d_sel = _select_band([band_l[k][:, None] + ext[MAX_BAND - k:MAX_BAND - k + c]
                                        for k in range(MAX_BAND + 1)])
            if has_cross:
                cand = torch.clamp(full[cross_src_l] + cross_cost_l[:, None], max=POS_INF)
                take = cand <= base
                base = torch.where(take, cand, base)
                d_sel = torch.where(take, torch.full_like(d_sel, _CROSS), d_sel)
            cost, bp8[t], verdicts[t], origins[t] = column(base, d_sel, nll_local[t],
                                                           emis_starts[t])
            cost = torch.where((t < n_frames)[None, :], cost, prev)
            final = torch.where((t == n_frames - 1)[None, :], cost, final)
        dist.all_reduce(verdicts, op=dist.ReduceOp.MAX, group=group)
        eps_u = torch.zeros((t_len, g.n_words, b), dtype=u_dtype, device=dev)
        for p in range(eps_depth):
            eps_u = torch.where(verdicts[:, p] > 0, origins[:, p].to(u_dtype), eps_u)
        return final, bp8, eps_u

    run.collectives_per_frame = 1 + eps_depth + int(bool(beam_width))
    return run

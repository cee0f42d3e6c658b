"""Fixed-width token-passing beam over a banded (lexical-tree or word)
graph.

Counterpart of ``speech_recognition_tpu/ops/beam.py``.  The live frontier
of each stream is k ``(state, cost)`` tokens; emissions are gathered per
candidate token from the compact unit-bank row, so the ``[T, S]`` graph
plane never exists.  Per frame, each token at state s with cost c
proposes:

* band moves to ``s + d`` (d = 0..2) at ``c + band[d, s + d]``;
* cross moves to every child-arc start of s (``child_starts``, padded to
  the trie's largest fan-out) at ``c + child_costs``;
* after the emission add and a merge, the same-column eps re-entry: each
  word start r takes the best end token through ``eps_block [R, L]``
  (first minimum in end-slot order, then token order), as R more
  candidates.

Candidates are deduplicated by state with the dense decoder's tie rule
(a stable sort by state, cost, then tie rank: the lowest origin state
wins, an eps arrival loses ties) and pruned to the k cheapest by a
stable cost sort (``_merge_topk``).  With k at least the reachable state
count the result equals the exact banded decode; narrower beams are the
classic approximation.  Backpointers are per-frame token planes
``[B, T, k]`` (state, previous token index, ended word), so the
backtrace is an index chain.

A bigram (``bigram_cost [V + 1, V]``, row V the sentence start) rides on
each token's predecessor word: a token exiting the leaf of word v with
predecessor u pays ``bigram_cost[u, v]`` at the eps hop, and the
re-entered token's predecessor becomes v.  Tokens merging in a shared
prefix keep the cheaper one's predecessor: the single-tree
token-passing approximation, exact on a flat tree.

``beam_search`` and ``beam_backtrace`` are gates (``ops.viterbi_banded_
kernels.use_kernels``): on CUDA tensors each is one launch of a hand
kernel, K19 (the whole frame loop, ``csrc/token_beam.cu``, reading the
tables packed once per graph by ``ops.beam_kernels.beam_pack``) and K26
(the walk, ``csrc/word_walk.cu``), launched by ``ops.beam_kernels`` and
counted in ``<gate>.launches``; on CPU tensors their plain versions
``beam_search_ref`` and ``beam_backtrace_ref``, frame loops of tensor ops
over the whole batch (in JAX both are ``lax.scan``s).  No ``try`` falls
back.  Every token plane of the plain version, garbage slots included,
equals the reference's, bit for bit, on the same emissions.  K19 equals
the plain version bit for bit on every live slot (state >= 0) of its
planes and final frontier and writes -1 (final cost POS_INF) on dead
slots, where the plain version keeps the order of dropped duplicates;
the walk reads only live tokens, so K26 gives the plain walk's words and
costs from either's planes.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from speech_recognition_tpu_torch.ops import beam_kernels as bk
from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND, BandedGraph
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import use_kernels
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["BeamTables", "beam_tables", "beam_search", "beam_backtrace", "beam_search_ref",
           "beam_backtrace_ref"]

_NO_WORD = -1


class BeamTables(NamedTuple):
    """Static per-state lookup tables for token expansion, on one device."""

    band: torch.Tensor  # [MAX_BAND+1, S] arrival costs (band[d, s] from s-d)
    child_starts: torch.Tensor  # [S, C] int64 child-arc start states (-1 pad)
    child_costs: torch.Tensor  # [S, C] cross-edge costs
    end_slot: torch.Tensor  # [S] int64 leaf slot l, or -1
    end_word: torch.Tensor  # [S] int64 word id ending at this state, or -1
    word_starts: torch.Tensor  # [R] int64
    eps_block: torch.Tensor  # [R, L]
    init_states: torch.Tensor  # [R0] int64 states with a finite init cost
    init_costs: torch.Tensor  # [R0]
    bank_state: torch.Tensor  # [S] int64 emission row per state
    end_bonus: torch.Tensor  # [E] (indexed by leaf slot: end_states == word_ends)
    n_states: int
    n_children: int  # finite cross edges in all (0: no child expansion)


_TABLES: "collections.OrderedDict" = collections.OrderedDict()
_TABLES_KEPT = 8


def beam_tables(g: BandedGraph, leaf_word=None, device=None) -> BeamTables:
    """Expansion tables of a (lexical-tree or word) banded graph, built on
    the host and returned on ``device``.

    ``leaf_word [L]`` maps leaves to word ids (lexical trees); word graphs
    default to the end slot (the vocabulary position in loop graphs).
    Built once per graph (its tensors and their versions), leaf words and
    device, and kept for the last few: a call on the same graph returns
    the same tables.  An entry holds its graph, so the graph's memory is
    not reused while it is kept."""
    key = (tuple((t.data_ptr(), t._version, tuple(t.shape), str(t.device))
                 for t in g if isinstance(t, torch.Tensor)),
           None if leaf_word is None else np.asarray(leaf_word, np.int64).tobytes(),
           None if device is None else str(torch.device(device)))
    ent = _TABLES.get(key)
    if ent is None:
        ent = _TABLES[key] = (g, _build_tables(g, leaf_word, device))
        while len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return ent[1]


def _build_tables(g: BandedGraph, leaf_word, device) -> BeamTables:
    ends = g.word_ends.cpu().numpy()
    if not np.array_equal(g.end_states.cpu().numpy(), ends):
        raise ValueError("token beam expects end_states == word_ends "
                         "(loop and lex graphs)")
    band = g.band.cpu().numpy()
    s = band.shape[1]
    children = [[] for _ in range(s)]
    cross_cost = None
    if g.cross_src is not None:
        cross_src = g.cross_src.cpu().numpy()
        cross_cost = g.cross_cost.cpu().numpy()
        for st in np.nonzero(cross_cost < POS_INF / 2)[0]:
            children[int(cross_src[st])].append(int(st))
    c_max = max(1, max(len(c) for c in children))
    child_starts = np.full((s, c_max), -1, np.int64)
    child_costs = np.full((s, c_max), POS_INF, np.float32)
    for src, cs in enumerate(children):
        for i, st in enumerate(cs):
            child_starts[src, i] = st
            child_costs[src, i] = cross_cost[st]

    end_slot = np.full(s, -1, np.int64)
    end_slot[ends] = np.arange(len(ends))
    end_word = np.full(s, _NO_WORD, np.int64)
    end_word[ends] = np.arange(len(ends)) if leaf_word is None else np.asarray(leaf_word)
    init = g.init_cost.cpu().numpy()
    init_states = np.nonzero(init < POS_INF / 2)[0]

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return BeamTables(
        band=t(band, torch.float32),
        child_starts=t(child_starts),
        child_costs=t(child_costs),
        end_slot=t(end_slot),
        end_word=t(end_word, torch.int64),
        word_starts=g.word_starts.to(device=device, dtype=torch.int64),
        eps_block=g.eps_block.to(device=device, dtype=torch.float32),
        init_states=t(init_states, torch.int64),
        init_costs=t(init[init_states], torch.float32),
        bank_state=g.bank_state.to(device=device, dtype=torch.int64),
        end_bonus=g.end_bonus.to(device=device, dtype=torch.float32),
        n_states=s,
        n_children=int(sum(map(len, children))),
    )


def _take(x, idx):
    """``x[b, idx[b, j]]`` for every row b."""
    return x.gather(1, idx)


def _merge_topk(state, cost, tie, payload, k: int):
    """Dedup ``[B, N]`` candidates by state, keeping the (cost, tie)-first
    entry of each, and prune to the k cheapest.

    The reference's three-key stable sort (state, then cost, then tie) is
    three stable sorts, least significant key first; the first entry of a
    state keeps its cost, later ones get POS_INF; a stable cost sort and
    ``[:k]`` prune.  Returns ``(state, cost, tie, payload)`` of width k,
    dropped slots with cost POS_INF."""
    perm = torch.argsort(tie, dim=1, stable=True)
    perm = _take(perm, torch.argsort(_take(cost, perm), dim=1, stable=True))
    perm = _take(perm, torch.argsort(_take(state, perm), dim=1, stable=True))
    st, co = _take(state, perm), _take(cost, perm)
    first = torch.ones_like(st, dtype=torch.bool)
    first[:, 1:] = st[:, 1:] != st[:, :-1]
    co = torch.where(first, co, torch.full_like(co, POS_INF))
    order = torch.argsort(co, dim=1, stable=True)[:, :k]
    perm = _take(perm, order)
    return (_take(st, order), _take(co, order), _take(tie, perm),
            tuple(_take(p, perm) for p in payload))


def _check_width(tables: BeamTables, k: int) -> None:
    r0 = tables.init_states.shape[0]
    if k < r0:
        raise ValueError(f"beam k={k} smaller than {r0} init states")


def beam_search(nll_bank, tables: BeamTables, n_frames, k: int, has_cross: bool = True,
                bigram_cost=None):
    """Token-passing beam over a batch of utterances: one K19 launch on
    CUDA tensors (no host read), ``beam_search_ref`` on CPU tensors; the
    arguments and results are :func:`beam_search_ref`'s, K19's dead slots
    -1 (module docstring)."""
    if not use_kernels(nll_bank):
        return beam_search_ref(nll_bank, tables, n_frames, k, has_cross=has_cross,
                               bigram_cost=bigram_cost)
    _check_width(tables, k)
    n_frames = torch.as_tensor(n_frames, device=nll_bank.device)
    bk.check_search(nll_bank, tables, n_frames, bigram_cost)
    out = bk.launch_search(nll_bank, tables, n_frames, k, has_cross, bigram_cost)
    beam_search.launches += int(nll_bank.shape[0] > 0)  # an empty batch launches nothing
    return out


beam_search.launches = 0


def beam_search_ref(nll_bank, tables: BeamTables, n_frames, k: int, has_cross: bool = True,
                    bigram_cost=None):
    """Token-passing beam over a batch of utterances (the plain version
    of K19).

    Args:
      nll_bank: ``[B, T, U]`` unit-bank emission costs.
      n_frames: ``[B]`` true lengths.
      k: beam capacity (tokens per frame); at least the number of states
        with a finite init cost.
      has_cross: False skips the child expansion (graphs without cross
        edges).
      bigram_cost: optional ``[V + 1, V]`` word-boundary costs, row V the
        sentence start: ``bigram_cost[u, v]`` is added when a token exits
        word v's leaf carrying predecessor u.  Build the graph without an
        LM then.

    Returns ``(final_state [B, k], final_cost [B, k], final_pred [B, k],
    tok_state [B, T, k], tok_prev [B, T, k], tok_word [B, T, k])`` (int32
    but the costs): the frontier at each stream's last frame, with each
    token's predecessor word, and the per-frame token planes for
    :func:`beam_backtrace`.
    """
    b, t_len, _ = nll_bank.shape
    dev = nll_bank.device
    tb = tables
    smax, r = tb.n_states, tb.word_starts.shape[0]
    n_ends = tb.eps_block.shape[1]
    r0 = tb.init_states.shape[0]
    _check_width(tb, k)
    nf = n_frames.to(dev).to(torch.int64)
    n_vocab = 0 if bigram_cost is None else bigram_cost.shape[1]
    big_flat = None if bigram_cost is None else bigram_cost.reshape(-1)
    i64 = dict(dtype=torch.int64, device=dev)

    def clip_s(states):
        return states.clamp(0, smax - 1)

    def emis_at(states, nll_t):
        rows = tb.bank_state[clip_s(states)]
        return torch.where(states >= 0, _take(nll_t, rows), torch.full_like(nll_t[:, :1],
                                                                              POS_INF))

    def eps_expand(state, cost, prev_idx, pred, nll_t):
        """Same-column re-entry candidates from end tokens: for each start
        r the best of ``eps_block[r, end_slot(token)] + cost (+ bigram)``
        (first minimum in end-slot order, then token order), plus the
        start's emission; the source token's prev index and word ride
        along (the eps hop consumes no frame)."""
        sc = clip_s(state)
        slot = torch.where(state >= 0, tb.end_slot[sc], -1)
        word = tb.end_word[sc]
        eps_cols = tb.eps_block.t()[slot.clamp(min=0)]  # [B, K, R]
        exit_cost = cost
        if bigram_cost is not None:
            flat = pred.clamp(0, n_vocab) * n_vocab + word.clamp(0, n_vocab - 1)
            exit_cost = cost + torch.where(word >= 0, big_flat[flat],
                                           torch.full_like(cost, POS_INF))
        scores = torch.where((slot >= 0)[..., None], eps_cols + exit_cost[..., None],
                             torch.full_like(eps_cols, POS_INF))
        order = torch.argsort(torch.where(slot >= 0, slot, n_ends), dim=1, stable=True)
        scores_o = scores.gather(1, order[..., None].expand(-1, -1, r))
        best = scores.amin(1)  # [B, R]
        besti = _take(order, torch.argmin(scores_o, 1))  # first minimum
        starts = tb.word_starts.expand(b, r)
        cand_cost = torch.clamp(best + emis_at(starts, nll_t), max=POS_INF)
        cand_word = tb.end_word[clip_s(_take(state, besti))]
        cand_pred = cand_word if bigram_cost is not None else torch.full_like(cand_word,
                                                                                n_vocab)
        # eps loses ties to frame arrivals: a tie rank above any state id
        cand_tie = torch.full((b, r), smax + 1, **i64)
        return starts, cand_cost, cand_tie, _take(prev_idx, besti), cand_word, cand_pred

    def column(cand_state, cand_cost, cand_tie, cand_prev, cand_pred, nll_t):
        """Emission add -> merge -> eps -> final top-k."""
        cand_cost = torch.clamp(cand_cost + emis_at(cand_state, nll_t), max=POS_INF)
        cand_word = torch.full_like(cand_state, _NO_WORD)
        st, co, tie, (pr, wd, pd) = _merge_topk(cand_state, cand_cost, cand_tie,
                                                (cand_prev, cand_word, cand_pred), k)
        e_st, e_co, e_tie, e_pr, e_wd, e_pd = eps_expand(st, co, pr, pd, nll_t)
        st2, co2, _, (pr2, wd2, pd2) = _merge_topk(
            torch.cat([st, e_st], 1), torch.cat([co, e_co], 1), torch.cat([tie, e_tie], 1),
            (torch.cat([pr, e_pr], 1), torch.cat([wd, e_wd], 1), torch.cat([pd, e_pd], 1)),
            k)
        st2 = torch.where(co2 < POS_INF / 2, st2, -1)
        return st2, co2, pr2, wd2, pd2

    idx = torch.arange(k, **i64).expand(b, k)

    def expand(state, cost, pred):
        """Band (d = 0..2, each a block of k) then cross (each child slot a
        block of k) proposals from the frontier ``[B, k]``."""
        live = state >= 0
        origin = torch.where(live, state, smax)
        d = torch.arange(MAX_BAND + 1, **i64)[:, None, None]
        tgt = torch.where(live, state + d, -1)  # [3, B, k]
        tgt = torch.where(tgt < smax, tgt, -1)
        w = tb.band.gather(1, clip_s(tgt).reshape(MAX_BAND + 1, -1)).view_as(tgt)
        ss, cs = [tgt], [torch.where(tgt >= 0, cost + w, POS_INF)]
        n_blocks = MAX_BAND + 1
        if has_cross:
            src = clip_s(state)
            ctgt = torch.where(live[..., None], tb.child_starts[src], -1)  # [B, k, C]
            cw = tb.child_costs[src]
            ss.append(ctgt.permute(2, 0, 1))
            cs.append(torch.where(ctgt >= 0, cost[..., None] + cw, POS_INF).permute(2, 0, 1))
            n_blocks += ctgt.shape[2]

        def flat(x):  # [blocks, B, k] -> [B, blocks * k]
            return x.permute(1, 0, 2).reshape(b, -1)

        return (flat(torch.cat(ss)), flat(torch.cat(cs)), origin.repeat(1, n_blocks),
                idx.repeat(1, n_blocks), pred.repeat(1, n_blocks))

    # column 0: the init tokens
    pad = k - r0
    st0 = torch.cat([tb.init_states, torch.full((pad,), -1, **i64)]).expand(b, k)
    co0 = torch.cat([tb.init_costs, torch.full((pad,), POS_INF, dtype=torch.float32,
                                               device=dev)]).expand(b, k)
    tie0 = torch.where(st0 >= 0, st0, smax)
    state, cost, pr0, wd0, pred = column(st0, co0, tie0, torch.full((b, k), -1, **i64),
                                         torch.full((b, k), n_vocab, **i64), nll_bank[:, 0])
    one = (nf == 1)[:, None]
    fst = torch.where(one, state, -1)
    fco = torch.where(one, cost, POS_INF)
    fpd = pred
    tok_state = torch.full((b, t_len, k), -1, dtype=torch.int32, device=dev)
    tok_prev = torch.full_like(tok_state, -1)
    tok_word = torch.full_like(tok_state, _NO_WORD)
    tok_state[:, 0], tok_prev[:, 0], tok_word[:, 0] = state, pr0, wd0
    # frames past every stream's end change nothing and write -1 rows
    t_stop = min(t_len, int(nf.max())) if b else 0
    for t in range(1, t_stop):
        cst, cco, ctie, cprev, cpred = expand(state, cost, pred)
        nst, nco, nprev, nwd, npred = column(cst, cco, ctie, cprev, cpred, nll_bank[:, t])
        active = (t < nf)[:, None]
        state = torch.where(active, nst, state)
        cost = torch.where(active, nco, cost)
        pred = torch.where(active, npred, pred)
        last = (t == nf - 1)[:, None]
        fst = torch.where(last, state, fst)
        fco = torch.where(last, cost, fco)
        fpd = torch.where(last, pred, fpd)
        tok_state[:, t] = torch.where(active, state, -1)
        tok_prev[:, t] = torch.where(active, nprev, -1)
        tok_word[:, t] = torch.where(active, nwd, _NO_WORD)
    i32 = torch.int32
    return fst.to(i32), fco, fpd.to(i32), tok_state, tok_prev, tok_word


def beam_backtrace(final_state, final_cost, tok_prev, tok_word, tables: BeamTables,
                   n_frames, final_pred=None, bigram_cost=None, bigram_end=None):
    """Best final token and the index-chain backtrace, for a batch: one
    K26 launch on CUDA tensors, ``beam_backtrace_ref`` on CPU tensors;
    the arguments and results are :func:`beam_backtrace_ref`'s."""
    if not use_kernels(tok_prev):
        return beam_backtrace_ref(final_state, final_cost, tok_prev, tok_word, tables,
                                  n_frames, final_pred=final_pred, bigram_cost=bigram_cost,
                                  bigram_end=bigram_end)
    n_frames = torch.as_tensor(n_frames, device=tok_prev.device)
    bk.check_walk(final_state, final_cost, tok_prev, tok_word, tables, n_frames, final_pred,
                  bigram_cost, bigram_end)
    out = bk.launch_walk(final_state, final_cost, tok_prev, tok_word, tables, n_frames,
                         final_pred, bigram_cost, bigram_end)
    beam_backtrace.launches += int(tok_prev.shape[0] > 0)
    return out


beam_backtrace.launches = 0


def beam_backtrace_ref(final_state, final_cost, tok_prev, tok_word, tables: BeamTables,
                       n_frames, final_pred=None, bigram_cost=None, bigram_end=None):
    """Best final token and the index-chain backtrace, for a batch (the
    plain version of K26).

    With ``bigram_cost`` (and ``bigram_end``) the final token also pays
    ``bigram_cost[pred, word] + bigram_end[word]``: it never exited its
    word.  Returns ``(best_cost [B], words_rev [B, T + 1] int32)``: column
    0 the final token's word, then the words ended along the best path
    from the last frame back, -1 where none (callers reverse and filter,
    then append column 0)."""
    tb = tables
    smax = tb.n_states
    b, t_len, _ = tok_prev.shape
    dev = tok_prev.device
    fs = final_state.to(torch.int64)
    slot = tb.end_slot[fs.clamp(0, smax - 1)]
    is_end = (fs >= 0) & (slot >= 0)
    bonus = tb.end_bonus[slot.clamp(0, tb.end_bonus.shape[0] - 1)]
    word = tb.end_word[fs.clamp(0, smax - 1)]
    if bigram_cost is not None:
        nv = bigram_cost.shape[1]
        flat = final_pred.to(torch.int64).clamp(0, nv) * nv + word.clamp(0, nv - 1)
        bonus = bonus + bigram_cost.reshape(-1)[flat]
        if bigram_end is not None:
            bonus = bonus + bigram_end[word.clamp(0, nv - 1)]
    tot = torch.where(is_end, final_cost + bonus, torch.full_like(final_cost, POS_INF))
    best = torch.argmin(tot, 1)[:, None]  # [B, 1], the first minimum
    best_cost = _take(tot, best)[:, 0]
    nf = n_frames.to(dev).to(torch.int64)
    words_rev = torch.full((b, t_len + 1), _NO_WORD, dtype=torch.int32, device=dev)
    words_rev[:, 0] = _take(word, best)[:, 0].to(torch.int32)
    ix = best
    t_start = min(t_len, int(nf.max())) if b else 0
    for t in range(t_start - 1, -1, -1):
        active = (t < nf)[:, None] & (ix >= 0)
        safe = ix.clamp(min=0)
        words_rev[:, t_len - t] = torch.where(active, _take(tok_word[:, t], safe),
                                              _NO_WORD)[:, 0]
        if t > 0:
            ix = torch.where(active, _take(tok_prev[:, t], safe).to(torch.int64), ix)
    return best_cost, words_rev

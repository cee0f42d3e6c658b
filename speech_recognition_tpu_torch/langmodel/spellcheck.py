"""Text Viterbi over a lexical tree, and a spell checker.

Counterpart of ``speech_recognition_tpu/langmodel/spellcheck.py``: an
edit-distance Viterbi of an input string against the flattened trie,
with the cost model deletion 1, substitution 1 (match 0), insertion 1,
space 0 and a word-end -> root loop of 1.  A synthetic space node
follows the trie's nodes.  Each input character is one relaxation over
every trie node; the same-column insertion chain (parent -> child) is
closed by ``max_depth`` bounded passes (``_text_viterbi_device``, one
string) or by one ordered sweep over depth-sorted levels
(``_text_viterbi_levels``, a batch of strings as ``[N, B]`` columns).
The column loop and the level sweep run as tensor ops on the chosen
device (CUDA unless the caller passes a CPU device); no kernel backs
them (in JAX they are ``lax.scan``s).  The backtrace and the word
recovery run on the host.  Costs are small integers, equal on every
device and to the reference's; between exact-cost ties the first
minimum wins, as in the reference.

``SpellChecker`` fits a dictionary and corrects text to whole
dictionary words; its ``beam`` is stored and unused, as in the
reference.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.langmodel.lextree import LexTree, lextree_from_words
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["text_viterbi", "text_viterbi_batch", "SpellChecker"]

# the cost model
DELETION_COST = 1.0
INSERTION_COST = 1.0
MATCH_COST = 0.0
SPACE_COST = 0.0
LOOP_COST = 1.0

# backpointer move kinds
_MOVE_DEL = 0  # (r, c-1)
_MOVE_MATCH = 1  # (parent, c-1)
_MOVE_INS = 2  # (parent, c) same column
_MOVE_LOOP = 3  # (word_end/space, c-1)


def _text_viterbi_device(codes, val, parent, is_root_child, is_word_end, max_depth: int):
    """One string: ``codes [C]`` (``codes[0]`` the '*' sentinel), the
    node tables ``[N]`` with the space node last -> ``(costs [C-1, N],
    bp_r [C-1, N] int64, bp_kind [C-1, N] int64)``, one row per input
    character."""
    n = val.shape[0]
    dev = val.device
    space = n - 1
    has_parent = parent >= 0
    parent_c = parent.clamp(min=0)
    m_ok = has_parent & ~is_root_child
    inf = torch.full((n,), POS_INF, dtype=torch.float32, device=dev)

    # column 0 (the sentinel): only the insertion chain from the root
    cost = inf.clone()
    cost[0] = 0.0
    dist0 = (codes[0] != val).to(torch.float32)
    for _ in range(max_depth):
        i_cost = cost[parent_c] + INSERTION_COST + dist0
        cost = torch.where(has_parent & (i_cost < cost), i_cost, cost)

    rows = ([], [], [])
    arange = torch.arange(n, device=dev)
    for c in range(1, codes.shape[0]):
        prev = cost
        dist = (codes[c] != val).to(torch.float32)
        # deletion: stay on the node (not the root, not the space node)
        cost = prev + DELETION_COST + dist
        cost[0] = POS_INF
        cost[space] = POS_INF
        bp_r = arange.clone()
        kind = torch.full((n,), _MOVE_DEL, dtype=torch.int64, device=dev)
        # match from the parent (root children have no match branch)
        m_cost = prev[parent_c] + MATCH_COST + dist
        better = m_ok & (m_cost < cost)
        cost = torch.where(better, m_cost, cost)
        bp_r = torch.where(better, parent_c, bp_r)
        kind = torch.where(better, _MOVE_MATCH, kind)
        # the space node: from the best word end
        we_prev = torch.where(is_word_end, prev, inf)
        best_we = torch.argmin(we_prev, 0)
        sp_cost = we_prev[best_we] + SPACE_COST + dist[space]
        take = sp_cost < cost[space]
        cost[space] = torch.where(take, sp_cost, cost[space])
        bp_r[space] = torch.where(take, best_we, bp_r[space])
        kind[space] = torch.where(take, _MOVE_LOOP, kind[space])
        # the root: loop restart from the best word end or the space node
        loop_prev = we_prev.clone()
        loop_prev[space] = prev[space]
        best_loop = torch.argmin(loop_prev, 0)
        lp_cost = loop_prev[best_loop] + LOOP_COST + dist[0]
        take = lp_cost < cost[0]
        cost[0] = torch.where(take, lp_cost, cost[0])
        bp_r[0] = torch.where(take, best_loop, bp_r[0])
        kind[0] = torch.where(take, _MOVE_LOOP, kind[0])
        # insertion: from the parent in the same column, max_depth passes
        for _ in range(max_depth):
            i_cost = cost[parent_c] + INSERTION_COST + dist
            better = has_parent & (i_cost < cost)
            cost = torch.where(better, i_cost, cost)
            bp_r = torch.where(better, parent_c, bp_r)
            kind = torch.where(better, _MOVE_INS, kind)
        for out, x in zip(rows, (cost, bp_r, kind)):
            out.append(x)
    if not rows[0]:
        empty = torch.empty((0, n), device=dev)
        return empty, empty.long(), empty.long()
    return tuple(torch.stack(r) for r in rows)


class _LevelPlan:
    """Host-side depth-sorted arrays for the level sweep: the root first,
    each trie level a contiguous row slice, the space node last."""

    def __init__(self, tree: LexTree):
        n_real = tree.n_nodes
        depth = np.asarray(tree.depth)
        perm = np.argsort(depth, kind="stable")
        self.perm = np.concatenate([perm, [n_real]])
        self.inv = np.empty(n_real + 1, np.int64)
        self.inv[self.perm] = np.arange(n_real + 1)
        self.n = n_real + 1
        self.space = n_real

        val = np.zeros(self.n, np.int32)
        val[:n_real] = np.asarray(tree.val)[perm]
        val[self.space] = ord(" ")
        par_orig = np.concatenate([np.asarray(tree.parent), [-1]])
        par_sorted = par_orig[self.perm]
        self.parent = np.where(par_sorted >= 0, self.inv[np.maximum(par_sorted, 0)],
                               -1).astype(np.int32)
        self.val = val
        self.is_word_end = np.zeros(self.n, bool)
        self.is_word_end[:n_real] = np.asarray(tree.prop)[perm] == 2
        self.is_root_child = self.parent == 0
        d_sorted = np.concatenate([depth[perm], [0]])
        self.max_depth = int(depth.max())
        # level d = rows [off[d], off[d+1]) of the real-node prefix
        self.off = tuple(int(np.searchsorted(d_sorted[:n_real], d))
                         for d in range(self.max_depth + 2))

    def device_args(self, device):
        return tuple(torch.as_tensor(a, device=device) for a in
                     (self.val, self.parent.astype(np.int64), self.is_root_child,
                      self.is_word_end))


def _text_viterbi_levels(codes, val, parent, is_root_child, is_word_end, off):
    """A batch of strings: ``codes [C, B]`` (row 0 the sentinel), the
    depth-sorted node tables ``[N]`` (space node last) and the level
    offsets -> per input column ``(ends_min [C-1, B], ends_arg [C-1, B],
    kinds [C-1, N, B] int8, we_src [C-1, B], loop_src [C-1, B])``: the
    best (word end | space) cost and row, each node's move, and the
    origins of the space node's and the root's loop moves."""
    n = val.shape[0]
    b = codes.shape[1]
    dev = codes.device
    space = n - 1
    par_c = parent.clamp(min=0)
    valc = val[:, None]
    row = torch.arange(n, device=dev)[:, None]
    can_del = (row != 0) & (row != space)
    can_match = ((parent >= 0) & ~is_root_child)[:, None]
    we_col = is_word_end[:, None]
    end_col = we_col | (row == space)
    n_levels = len(off) - 1
    inf = torch.full((n, b), POS_INF, dtype=torch.float32, device=dev)

    def sweep(cost, dist, kind=None):
        """The exact insertion closure: one ordered pass over levels."""
        for d in range(1, n_levels):
            lo, hi = off[d], off[d + 1]
            if lo >= hi:
                continue
            cand = cost[par_c[lo:hi]] + INSERTION_COST + dist[lo:hi]
            take = cand < cost[lo:hi]
            cost[lo:hi] = torch.where(take, cand, cost[lo:hi])
            if kind is not None:
                kind[lo:hi] = torch.where(take, _MOVE_INS, kind[lo:hi])
        return cost, kind

    cost = inf.clone()
    cost[0] = 0.0
    cost, _ = sweep(cost, (codes[0][None, :] != valc).to(torch.float32))
    outs = ([], [], [], [], [])
    for c in range(1, codes.shape[0]):
        prev = cost
        dist = (codes[c][None, :] != valc).to(torch.float32)
        # deletion (root / space have none)
        cost = torch.where(can_del, prev + DELETION_COST + dist, inf)
        kind = torch.full((n, b), _MOVE_DEL, dtype=torch.int8, device=dev)
        # match from the parent (root children excluded)
        cand = prev[par_c] + MATCH_COST + dist
        take = can_match & (cand < cost)
        cost = torch.where(take, cand, cost)
        kind = torch.where(take, _MOVE_MATCH, kind)
        # the space node from the best word end; the root from the best of
        # the word ends and the space node
        we_prev = torch.where(we_col, prev, inf)
        best_we = torch.argmin(we_prev, 0)
        sp_cand = we_prev.amin(0) + SPACE_COST + dist[space]
        take_sp = sp_cand < cost[space]
        cost[space] = torch.where(take_sp, sp_cand, cost[space])
        kind[space] = torch.where(take_sp, _MOVE_LOOP, kind[space])
        loop_prev = we_prev.clone()
        loop_prev[space] = prev[space]
        best_loop = torch.argmin(loop_prev, 0)
        lp_cand = loop_prev.amin(0) + LOOP_COST + dist[0]
        take_lp = lp_cand < cost[0]
        cost[0] = torch.where(take_lp, lp_cand, cost[0])
        kind[0] = torch.where(take_lp, _MOVE_LOOP, kind[0])
        cost, kind = sweep(cost, dist, kind)
        # each stream reads its own last column's best end
        end_masked = torch.where(end_col, cost, inf)
        for out, x in zip(outs, (end_masked.amin(0), torch.argmin(end_masked, 0), kind,
                                 best_we, best_loop)):
            out.append(x)
    return tuple(torch.stack(o) for o in outs)


def text_viterbi_batch(texts, tree: LexTree, plan: _LevelPlan = None, device="cuda"):
    """Batched :func:`text_viterbi`: corrects B texts in one level sweep
    on ``device`` (costs equal to the per-string DP; between exact-cost
    ties the chosen path may differ).  Texts pad to a common length with
    '*' sentinel columns; each stream reads its own last real column.

    Returns ``[(best_cost, matched_string), ...]``."""
    if plan is None:
        plan = _LevelPlan(tree)
    lens = [len(t) for t in texts]
    codes = np.full((max(lens) + 1, len(texts)), ord("*"), np.int32)
    for i, t in enumerate(texts):
        codes[1:1 + len(t), i] = np.frombuffer(t.encode("latin-1"), np.uint8)
    ends_min, ends_arg, kinds, we_src, loop_src = (
        x.cpu().numpy() for x in _text_viterbi_levels(
            torch.as_tensor(codes, device=device), *plan.device_args(device), plan.off))
    parent, val = plan.parent, plan.val
    out = []
    for i, li in enumerate(lens):
        c = li - 1  # kinds[c] <-> input char c+1 (the sentinel at 0)
        r = int(ends_arg[c, i])
        cost = float(ends_min[c, i])
        visited = []
        while c >= 0:
            if r != 0:
                visited.append(r)
            k = int(kinds[c, r, i])
            if k == _MOVE_INS:
                r = int(parent[r])  # same column
            elif k == _MOVE_LOOP:
                r = int(loop_src[c, i]) if r == 0 else int(we_src[c, i])
                c -= 1
            elif k == _MOVE_MATCH:
                r = int(parent[r])
                c -= 1
            else:  # _MOVE_DEL
                c -= 1
        visited.reverse()
        out.append((cost, "".join(chr(val[r]) for r in visited)))
    return out


def _viterbi_path(x: str, tree: LexTree, device="cuda") -> Tuple[float, List[int], np.ndarray]:
    """The per-string DP on ``device`` and its host backtrace: ``(best_cost,
    visited_nodes, val)``, ``visited_nodes`` the forward-order trie nodes
    on the best path (insertion hops included, the root left out)."""
    n = tree.n_nodes + 1  # + the synthetic space node
    val = np.zeros(n, dtype=np.int32)
    val[:-1] = tree.val
    val[-1] = ord(" ")
    parent = np.full(n, -1, dtype=np.int64)
    parent[:-1] = tree.parent
    is_root_child = np.zeros(n, dtype=bool)
    is_root_child[:-1] = tree.parent == 0
    is_word_end = np.zeros(n, dtype=bool)
    is_word_end[:-1] = tree.prop == 2
    codes = np.frombuffer(("*" + x).encode("latin-1"), dtype=np.uint8).astype(np.int32)

    costs, bp_r, bp_kind = (a.cpu().numpy() for a in _text_viterbi_device(
        *(torch.as_tensor(a, device=device) for a in (codes, val, parent, is_root_child,
                                                      is_word_end)), tree.max_depth))
    # the endpoint: the best word end (or the space node) at the last column
    ends = np.concatenate([np.nonzero(is_word_end)[0], [n - 1]])
    last = costs[-1]
    best_end = int(ends[np.argmin(last[ends])])
    best_cost = float(last[best_end])

    visited = []
    r, c = best_end, len(codes) - 2
    while c >= 0:
        if r != 0:
            visited.append(r)
        kind = bp_kind[c, r]
        r = int(bp_r[c, r])
        if kind != _MOVE_INS:
            c -= 1
    visited.reverse()
    return best_cost, visited, val


def text_viterbi(x: str, tree: LexTree, device="cuda") -> Tuple[float, str]:
    """Best dictionary match for an input string: ``(best_cost,
    matched_string)``, the string the chars of the trie nodes on the best
    path (an insertion-chain entry shows only the suffix of the first
    word's nodes visited: 'aple' -> 'pple', as in the reference)."""
    cost, visited, val = _viterbi_path(x, tree, device)
    return cost, "".join(chr(val[r]) for r in visited)


class SpellChecker:
    """Fit on a dictionary, then correct text to a sequence of whole
    dictionary words (one continuous string through the loop arc).  The
    DP runs on ``device``."""

    def __init__(self, beam: int = 0, device="cuda"):
        self.beam = beam
        self.device = device
        self.tree: LexTree = None

    def fit(self, dictionary) -> "SpellChecker":
        self.tree = lextree_from_words(list(dictionary))
        return self

    def spell_check(self, text: str) -> str:
        """Correct ``text``: each word comes from the word-end leaf the
        best path crosses (every leaf is one dictionary word), so a path
        entering mid-word still names the whole word."""
        if self.tree is None:
            raise ValueError("call fit() first")
        _, visited, _ = _viterbi_path(text, self.tree, self.device)
        ends = set(int(e) for e in self.tree.word_ends)
        words, prev = [], -1
        for r in visited:
            if r in ends and r != prev:
                words.append(self.tree.word_of(r))
            prev = r
        return " ".join(words)

"""Lexical-tree decoding graph: the prefix trie as banded arrays.

Counterpart of ``speech_recognition_tpu/models/lexgraph.py`` (same
arithmetic; the graph is a port ``BandedGraph`` of CPU tensors):

* every trie arc carries one unit HMM's states, enumerated in trie
  preorder (arc-major, states consecutive), so shared prefixes share
  states;
* parent-arc-end -> child-arc-start transitions are static cross frame
  edges (``BandedGraph.cross_src`` / ``cross_cost``), the 0-cost
  boundary step of a concatenated word HMM;
* each word-final unit gets a dedicated leaf arc, so every leaf is one
  word: ``word_ends`` are the leaf arc ends, and leaf -> root-arc
  re-entry is the ``[R, L]`` epsilon block.

Language models: ``lm=`` (anything with ``.cost [V, V]``,
``.start_cost [V]``, ``.end_cost [V]``) is exact only on flat
vocabularies (every word one unit), where it gives the per-row
``eps_block[r, l] = wic + cost[word(l), word(r)]``; a deep tree raises
(its bigram runs in the token beam, ``beam_decode_lextree(..., lm=lm)``).
``unigram_cost=`` is exact on any tree by min-smearing: each arc
carries the minimum word cost below it, a root entry charges its
smear, and each cross edge the increment ``smear(child) -
smear(parent)``.  Costs are summed in float64 and stored float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from speech_recognition_tpu_torch.langmodel.lextree import lextree_from_words
from speech_recognition_tpu_torch.ops.viterbi_banded import MAX_BAND, BandedGraph
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["LexGraph", "build_lex_graph", "lex_words_from_path",
           "lex_words_from_path_batch"]


@dataclasses.dataclass
class LexGraph:
    """Banded lexical-tree graph plus host-side path metadata."""

    banded: BandedGraph
    words: List[str]
    leaf_word: np.ndarray  # [L] word id of each leaf arc (leaf order)
    arc_of_state: np.ndarray  # [S] arc index per state
    arc_leaf_word: np.ndarray  # [A] word id if the arc is a leaf else -1
    arc_unit: np.ndarray  # [A] unit model id per arc
    eps_depth: int = 1

    @property
    def n_states(self) -> int:
        return int(self.arc_of_state.shape[0])

    @property
    def n_arcs(self) -> int:
        return int(self.arc_unit.shape[0])

    @property
    def n_words(self) -> int:
        return len(self.words)


def build_lex_graph(
    words: Sequence[str],
    unit_trans: Sequence[np.ndarray],
    unit_ids: Dict[str, int],
    lm=None,
    unigram_cost: np.ndarray = None,
    word_insertion_cost: float = 0.0,
) -> LexGraph:
    """Compose the prefix-tree decoding graph over unit HMMs.

    ``words``: the vocabulary, each word a sequence of unit symbols
    (keys of ``unit_ids``).  ``unit_trans``: per-unit ``[S, S]``
    frame-edge costs (T[to, from], inf/POS_INF where absent), >= 2
    states each and banded (diagonals 0..2).  ``unit_ids``: symbol ->
    unit model index.  ``lm`` (flat vocabularies only) and
    ``unigram_cost [V]`` are exclusive.
    """
    words = list(words)
    if lm is not None and unigram_cost is not None:
        raise ValueError("pass either lm or unigram_cost, not both")
    if lm is not None and any(len(w) > 1 for w in words):
        raise ValueError(
            "exact bigram on a deep lexical tree needs predecessor-carried "
            "token passing: build the graph without lm and decode with "
            "decode.lextree.beam_decode_lextree(..., lm=lm)")

    tree = lextree_from_words(words)
    word_id = {w: i for i, w in enumerate(words)}
    if len(word_id) != len(words):
        raise ValueError("duplicate words in the lexicon")

    # arcs = trie nodes minus the root, in preorder (node index - 1)
    n_arcs = tree.n_nodes - 1
    arc_unit = np.empty(n_arcs, np.int64)
    arc_parent = np.asarray(tree.parent[1:], np.int64) - 1  # -1 = root
    arc_is_leaf = np.asarray(tree.prop[1:]) == 2
    for a in range(n_arcs):
        sym = chr(tree.val[a + 1])
        if sym not in unit_ids:
            raise ValueError(f"unit symbol {sym!r} not in unit_ids")
        arc_unit[a] = unit_ids[sym]

    # per-unit blocks, cast like models/graph.build_loop_graph so a flat
    # vocabulary gives the loop graph's arrays
    unit_blk, unit_k = [], []
    for ui, t in enumerate(unit_trans):
        t32 = np.asarray(t, dtype=np.float32)
        unit_blk.append(np.where(np.isfinite(t32), t32, POS_INF))
        unit_k.append(t32.shape[0])
        if t32.shape[0] < 2:
            raise ValueError("lexical trees need units with >= 2 states")
        # a finite transition outside diagonals 0..MAX_BAND would be
        # dropped by the band; raise instead
        j, i = np.nonzero(unit_blk[-1] < POS_INF / 2)
        if np.any((j < i) | (j - i > MAX_BAND)):
            raise ValueError(
                f"unit {ui}: transition matrix is not banded "
                f"(finite entries outside diagonals 0..{MAX_BAND})")
    su = max(unit_k)

    arc_k = np.array([unit_k[u] for u in arc_unit], np.int64)
    arc_start = np.concatenate([[0], np.cumsum(arc_k)[:-1]]).astype(np.int64)
    arc_end = arc_start + arc_k - 1
    n_states = int(arc_k.sum())

    arc_leaf_word = np.full(n_arcs, -1, np.int64)
    for a in np.nonzero(arc_is_leaf)[0]:
        arc_leaf_word[a] = word_id[tree.word_of(int(a) + 1)]

    # min-smear of the unigram, leaf-up (reverse preorder visits
    # children first)
    sigma = np.zeros(n_arcs, np.float64)
    if unigram_cost is not None:
        unigram_cost = np.asarray(unigram_cost, np.float64)
        sigma[:] = np.inf
        for a in range(n_arcs - 1, -1, -1):
            if arc_is_leaf[a]:
                sigma[a] = unigram_cost[arc_leaf_word[a]]
            p = arc_parent[a]
            if p >= 0:
                sigma[p] = min(sigma[p], sigma[a])

    band = np.full((MAX_BAND + 1, n_states), POS_INF, np.float32)
    cross_src = np.zeros(n_states, np.int64)
    cross_cost = np.full(n_states, POS_INF, np.float32)
    bank_state = np.empty(n_states, np.int64)
    arc_of_state = np.empty(n_states, np.int32)
    for a in range(n_arcs):
        u, s0, k = int(arc_unit[a]), int(arc_start[a]), int(arc_k[a])
        blk = unit_blk[u]
        for d in range(MAX_BAND + 1):
            j = np.arange(d, k)
            band[d, s0 + j] = blk[j, j - d]
        bank_state[s0 : s0 + k] = u * su + np.arange(k)
        arc_of_state[s0 : s0 + k] = a
        p = arc_parent[a]
        if p >= 0:
            # parent-end -> child-start: the concatenated word HMM's
            # 0-cost boundary step, plus the smear increment
            cross_src[s0] = arc_end[p]
            cross_cost[s0] = np.float32(sigma[a] - sigma[p])

    roots = np.nonzero(arc_parent < 0)[0]
    leaves = np.nonzero(arc_is_leaf)[0]
    word_starts = arc_start[roots]
    word_ends = arc_end[leaves]
    leaf_word = arc_leaf_word[leaves].astype(np.int32)

    start_pos = np.zeros(n_states, np.int64)
    start_pos[word_starts] = np.arange(len(roots))
    is_start = np.zeros(n_states, bool)
    is_start[word_starts] = True

    # re-entry block and initial costs: float64 sums stored as float32
    eps_block = np.empty((len(roots), len(leaves)), np.float32)
    init_cost = np.full(n_states, POS_INF, np.float32)
    end_bonus = np.zeros(len(leaves), np.float32)
    for ri, r in enumerate(roots):
        c = float(word_insertion_cost) + sigma[r]
        if lm is not None:
            # flat vocabulary: root arc r is the word leaf_word over itself
            v = arc_leaf_word[r]
            eps_block[ri] = [c + float(lm.cost[arc_leaf_word[l], v]) for l in leaves]
            init_cost[arc_start[r]] = float(lm.start_cost[v])
        else:
            eps_block[ri] = c
            init_cost[arc_start[r]] = sigma[r]
    if lm is not None:
        end_bonus = np.asarray([float(lm.end_cost[w]) for w in leaf_word], np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    banded = BandedGraph(
        band=t(band, torch.float32),
        init_cost=t(init_cost, torch.float32),
        word_starts=t(word_starts, torch.int64),
        word_ends=t(word_ends, torch.int64),
        eps_block=t(eps_block, torch.float32),
        start_pos=t(start_pos, torch.int64),
        is_start=t(is_start, torch.bool),
        end_states=t(word_ends, torch.int64),
        end_bonus=t(end_bonus, torch.float32),
        bank_state=t(bank_state, torch.int64),
        cross_src=t(cross_src, torch.int64),
        cross_cost=t(cross_cost, torch.float32),
    )
    return LexGraph(
        banded=banded,
        words=words,
        leaf_word=leaf_word,
        arc_of_state=arc_of_state,
        arc_leaf_word=arc_leaf_word.astype(np.int32),
        arc_unit=arc_unit.astype(np.int32),
        eps_depth=1,
    )


def lex_words_from_path(lexg: LexGraph, states: np.ndarray, n_frames: int,
                        eps_flags: np.ndarray) -> List[int]:
    """Per-frame trie states -> word-id sequence.

    A word completes exactly when a re-entry epsilon fires (or at the
    final frame): the frame before an epsilon at ``t`` lies inside the
    completed word's dedicated leaf arc."""
    return lex_words_from_path_batch(
        lexg, np.asarray(states)[None], np.asarray([n_frames]),
        np.asarray(eps_flags)[None])[0]


def lex_words_from_path_batch(lexg: LexGraph, states: np.ndarray, n_frames,
                              eps_flags: np.ndarray) -> List[List[int]]:
    """Batched :func:`lex_words_from_path` on the host: ``states [B, T]``,
    ``eps_flags [B, T]`` -> per-utterance word-id lists (one numpy
    gather over the batch)."""
    states = np.asarray(states)
    eps_flags = np.asarray(eps_flags)
    nfs = np.asarray(n_frames)
    word_at = lexg.arc_leaf_word[lexg.arc_of_state[states]]  # [B, T]
    out: List[List[int]] = []
    for i in range(states.shape[0]):
        n = int(nfs[i])
        ts = np.nonzero(eps_flags[i, 1:n])[0]  # eps fires at t = ts + 1
        out.append(word_at[i, ts].tolist() + [int(word_at[i, n - 1])])
    return out

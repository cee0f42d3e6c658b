"""Lexical tree (character trie) as flat preorder arrays (host numpy).

Counterpart of ``speech_recognition_tpu/langmodel/lextree.py``, carried
over unchanged: ``val`` / ``parent`` / ``prop`` / ``depth`` arrays in
trie preorder.  Every word-final character gets a *dedicated* leaf node
(so each leaf is exactly one word); non-final characters share prefix
nodes.  All words are kept, including words that end where another
word continues.

Node properties: 0 = normal, 1 = root, 2 = end-of-word.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Sequence

import numpy as np

__all__ = ["LexTree", "lextree_from_words"]


@dataclasses.dataclass
class LexTree:
    """Flat preorder trie."""

    val: np.ndarray  # [N] uint32 char codes ('*' for the root)
    parent: np.ndarray  # [N] int32 parent index (-1 for root)
    prop: np.ndarray  # [N] int8: 0 normal, 1 root, 2 word end
    depth: np.ndarray  # [N] int32 distance from root

    @property
    def n_nodes(self) -> int:
        return len(self.val)

    @property
    def word_ends(self) -> np.ndarray:
        return np.nonzero(self.prop == 2)[0].astype(np.int32)

    @property
    def max_depth(self) -> int:
        return int(self.depth.max())

    def chars(self) -> List[str]:
        return [chr(c) for c in self.val]

    def word_of(self, leaf: int) -> str:
        """Reconstruct the word ending at a word-end node."""
        out = []
        n = leaf
        while n > 0:
            out.append(chr(self.val[n]))
            n = int(self.parent[n])
        return "".join(reversed(out))


def lextree_from_words(words: Sequence[str]) -> LexTree:
    """Build the trie: words are space-padded to equal length, and a
    char is word-final when the next padded char is ' '."""
    words = [w for w in words if w]
    max_len = max(len(w) for w in words)
    padded = [w.ljust(max_len, " ") for w in words]

    val = [ord("*")]
    parent = [-1]
    prop = [1]
    depth = [0]

    def build(parent_idx: int, group: List[str], i: int):
        if i >= max_len:
            return
        is_end = [
            w[i] != " " and (i + 1 >= max_len or w[i + 1] == " ") for w in group
        ]
        enders = [w for w, e in zip(group, is_end) if e]
        rest = [w for w, e in zip(group, is_end) if not e]
        for w in enders:
            val.append(ord(w[i]))
            parent.append(parent_idx)
            prop.append(2)
            depth.append(i + 1)
        counts = Counter(w[i] for w in rest if w[i] != " ")
        for ch in counts:
            node_idx = len(val)
            val.append(ord(ch))
            parent.append(parent_idx)
            prop.append(0)
            depth.append(i + 1)
            build(node_idx, [w for w in rest if w[i] == ch], i + 1)

    build(0, padded, 0)
    return LexTree(
        val=np.asarray(val, dtype=np.uint32),
        parent=np.asarray(parent, dtype=np.int32),
        prop=np.asarray(prop, dtype=np.int8),
        depth=np.asarray(depth, dtype=np.int32),
    )

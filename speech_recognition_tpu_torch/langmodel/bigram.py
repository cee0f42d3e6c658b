"""Bigram word language model in cost space (host numpy).

Counterpart of ``speech_recognition_tpu/langmodel/bigram.py``, carried
over unchanged: ``cost[u, v] = -log P(v | u)`` plus sentence start and
end costs, estimated from label sequences with add-k smoothing, and the
backoff decomposition the lattice rescorer uses.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

__all__ = ["BigramLM", "uniform_bigram", "fit_bigram", "scale", "sequence_cost",
           "BigramBackoff", "bigram_backoff"]


class BigramLM(NamedTuple):
    """Cost-space bigram: everything is ``-log P``."""

    cost: np.ndarray  # [V, V] cost[u, v] = -log P(v | u)
    start_cost: np.ndarray  # [V] -log P(v | <s>)
    end_cost: np.ndarray  # [V] -log P(</s> | u)

    @property
    def vocab_size(self) -> int:
        return self.cost.shape[0]


def uniform_bigram(vocab_size: int, flat: bool = True) -> BigramLM:
    """No-information LM: all-zero costs (``flat=True``) or the uniform
    distribution ``-log(1/V)``."""
    c = 0.0 if flat else float(np.log(vocab_size))
    return BigramLM(
        cost=np.full((vocab_size, vocab_size), c, dtype=np.float32),
        start_cost=np.full((vocab_size,), c, dtype=np.float32),
        end_cost=np.zeros((vocab_size,), dtype=np.float32),
    )


def fit_bigram(sequences: Sequence[List[int]], vocab_size: int,
               add_k: float = 1.0) -> BigramLM:
    """Maximum-likelihood bigram with add-k smoothing over word-id
    sequences (float64 counts, float32 costs)."""
    counts = np.full((vocab_size, vocab_size), add_k, dtype=np.float64)
    start = np.full((vocab_size,), add_k, dtype=np.float64)
    end = np.full((vocab_size,), add_k, dtype=np.float64)
    for seq in sequences:
        if not seq:
            continue
        start[seq[0]] += 1
        for u, v in zip(seq[:-1], seq[1:]):
            counts[u, v] += 1
        end[seq[-1]] += 1
    # each occurrence of u is followed by exactly one event (word or </s>)
    row_tot = counts.sum(axis=1) + end
    cost = -np.log(counts / row_tot[:, None])
    end_cost = -np.log(end / row_tot)
    start_cost = -np.log(start / start.sum())
    return BigramLM(
        cost=cost.astype(np.float32),
        start_cost=start_cost.astype(np.float32),
        end_cost=end_cost.astype(np.float32),
    )


def scale(lm: BigramLM, weight: float) -> BigramLM:
    """Apply an LM scale (the acoustic/LM balance knob)."""
    return BigramLM(cost=lm.cost * weight, start_cost=lm.start_cost * weight,
                    end_cost=lm.end_cost * weight)


def sequence_cost(lm: BigramLM, seq: List[int]) -> float:
    """Total -log P of a word sequence under the LM."""
    if not seq:
        return 0.0
    c = float(lm.start_cost[seq[0]])
    for u, v in zip(seq[:-1], seq[1:]):
        c += float(lm.cost[u, v])
    return c + float(lm.end_cost[seq[-1]])


class BigramBackoff(NamedTuple):
    """Backoff decomposition of a bigram cost matrix (host arrays).

    With add-k (or any backoff) smoothing every unseen pair's cost is
    row-constant, ``cost[u, v] = base[u]``, and seen pairs are cheaper,
    so the rescoring recursion ``H[w] = min_u (D[u] + cost[u, w])`` is

        H[w] = min( min_u (D[u] + base[u]),
                    min_{u: (u,w) seen} (D[u] + cost[u, w]) )

    one global backoff minimum shared by every w plus a per-word sparse
    minimum over at most K seen predecessors.  ``pred_idx`` /
    ``pred_cost`` are ``[V, K]`` padded with index 0 / 1e30."""

    base: np.ndarray  # [V] row-constant unseen cost
    pred_idx: np.ndarray  # [V, K] seen predecessor ids (dest-major)
    pred_cost: np.ndarray  # [V, K] full pair costs (1e30 pad)
    k: int


def bigram_backoff(cost: np.ndarray, tol: float = 1e-5, k_cap: int = None):
    """Backoff structure of ``cost [V, V]``, or None when some word has
    more than ``k_cap`` (default V/8, at least 16) below-level
    predecessors (the dense recombination is the better form there).
    Each row's max is its backoff level, which makes the decomposition
    exact for any matrix."""
    cost = np.asarray(cost)
    v = cost.shape[0]
    if k_cap is None:
        k_cap = max(16, v // 8)
    base = cost.max(axis=1)
    seen = (cost - base[:, None]) < -tol
    nnz_per_w = seen.sum(axis=0)
    k = int(nnz_per_w.max()) if v else 0
    if k > k_cap:
        return None
    if k == 0:
        return BigramBackoff(base=base.astype(np.float32),
                             pred_idx=np.zeros((v, 1), np.int32),
                             pred_cost=np.full((v, 1), 1e30, np.float32), k=1)
    pred_idx = np.zeros((v, k), np.int32)
    pred_cost = np.full((v, k), 1e30, np.float32)
    for w in range(v):
        us = np.flatnonzero(seen[:, w])
        pred_idx[w, : len(us)] = us
        pred_cost[w, : len(us)] = cost[us, w]
    return BigramBackoff(base=base.astype(np.float32), pred_idx=pred_idx,
                         pred_cost=pred_cost, k=k)

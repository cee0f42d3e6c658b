"""Seeded synthetic lexicons for the lexical-tree decoder, in numpy.

``bench_lexicon`` follows the recipe of the JAX package's lexical-tree
benchmark (``bench.py`` ``bench_lextree``): seed 7, eight 3-state
left-to-right units ``a``..``h`` (self and step arcs only) and 1,000
random words of 3-8 units, a trie of 9,588 states, 8 roots and 1,000
leaves.  ``dict1_shaped_lexicon`` is a dictionary-scale stand-in of the
reference dictionary's shape: 6,250 random words of 3-10 symbols over
31 units of 3 states, ~87k states.  ``flat_lm_lexicon`` is a flat
vocabulary (every word one unit) with random bigram costs, so its
re-entry block differs from cell to cell and it has as many roots as
words.  ``large_bank_lexicon`` is a trie over a bank of 2,000 units
(8,000 bank rows), past the bank the lexical-tree kernels hold in shared
memory.  ``planted_emissions`` plants random words of a lexicon into
unit-bank emissions, speech-like input for the trie decoders.
"""

from __future__ import annotations

import string
import types
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["random_words", "unit_transitions", "bench_lexicon", "dict1_shaped_lexicon",
           "flat_lm_lexicon", "large_bank_lexicon", "planted_emissions"]


def random_words(rng: np.random.Generator, units: Sequence[str], n_words: int,
                 min_len: int, max_len: int) -> List[str]:
    """``n_words`` distinct random strings over ``units``, sorted."""
    vocab = set()
    while len(vocab) < n_words:
        n = int(rng.integers(min_len, max_len + 1))
        vocab.add("".join(rng.choice(list(units), n)))
    return sorted(vocab)


def unit_transitions(rng: np.random.Generator, n_units: int, n_states: int = 3):
    """Per-unit ``[S, S]`` left-to-right costs (T[to, from], inf where
    absent): self and step arcs drawn from U(0.1, 1)."""
    trans = []
    for _ in range(n_units):
        t = np.full((n_states, n_states), np.inf)
        for i in range(n_states):
            t[i, i] = rng.uniform(0.1, 1)
            if i + 1 < n_states:
                t[i + 1, i] = rng.uniform(0.1, 1)
        trans.append(t)
    return trans


def bench_lexicon(n_words: int = 1000, seed: int = 7
                  ) -> Tuple[List[str], list, Dict[str, int], np.random.Generator]:
    """``(words, unit_trans, unit_ids, rng)`` of the 1,000-word benchmark
    trie; ``rng`` is left where the recipe leaves it (the benchmark
    draws its emissions from it next)."""
    rng = np.random.default_rng(seed)
    units = list("abcdefgh")
    trans = unit_transitions(rng, len(units))
    words = random_words(rng, units, n_words, 3, 8)
    return words, trans, {ch: i for i, ch in enumerate(units)}, rng


def dict1_shaped_lexicon(n_words: int = 6250, n_units: int = 31, seed: int = 11
                         ) -> Tuple[List[str], list, Dict[str, int], np.random.Generator]:
    """``(words, unit_trans, unit_ids, rng)``: ``n_words`` random words of
    3-10 symbols over ``n_units`` 3-state units."""
    rng = np.random.default_rng(seed)
    units = list((string.ascii_lowercase + string.ascii_uppercase)[:n_units])
    trans = unit_transitions(rng, len(units))
    words = random_words(rng, units, n_words, 3, 10)
    return words, trans, {ch: i for i, ch in enumerate(units)}, rng


def flat_lm_lexicon(n_words: int = 100, n_states: int = 2, seed: int = 13):
    """``(words, unit_trans, unit_ids, lm, rng)``: ``n_words`` one-unit
    words, one ``n_states``-state unit each, and an ``lm`` with random
    ``cost [V, V]`` (previous word, next word), ``start_cost [V]`` and
    ``end_cost [V]``, as ``build_lex_graph(..., lm=lm)`` takes it."""
    rng = np.random.default_rng(seed)
    words = [chr(0x100 + i) for i in range(n_words)]
    trans = unit_transitions(rng, n_words, n_states)
    lm = types.SimpleNamespace(cost=rng.uniform(0.1, 3.0, (n_words, n_words)),
                               start_cost=rng.uniform(0.1, 2.0, n_words),
                               end_cost=rng.uniform(0.1, 2.0, n_words))
    return words, trans, {w: i for i, w in enumerate(words)}, lm, rng


def large_bank_lexicon(n_units: int = 2000, n_states: int = 4, n_prefixes: int = 8,
                       seed: int = 17):
    """``(words, unit_trans, unit_ids, rng)``: ``n_units`` units of
    ``n_states`` states (8,000 bank rows by default) and one two-unit
    word per unit, the unit after one of the first ``n_prefixes`` units,
    so the trie has ``n_prefixes`` roots and ``n_units`` leaves."""
    rng = np.random.default_rng(seed)
    units = [chr(0x100 + i) for i in range(n_units)]
    trans = unit_transitions(rng, n_units, n_states)
    words = [units[i % n_prefixes] + units[i] for i in range(n_units)]
    return words, trans, {u: i for i, u in enumerate(units)}, rng


def planted_emissions(rng: np.random.Generator, words: Sequence[str], unit_ids: Dict[str, int],
                      su: int, n_rows: int, b: int, t_len: int, dwell: int = 2):
    """``(nll [n_rows, t_len, b] float32, n_frames [b] int32, word ids)``:
    unit-bank emissions that plant random words of ``words`` one after
    another in each stream (cost 0.05 on each of the ``su`` states of each
    planted unit for ``dwell`` frames, 8.0 elsewhere, as the reference's
    lattice tests plant them), each stream as long as its words."""
    e = np.full((n_rows, t_len, b), 8.0, np.float32)
    nf = np.zeros(b, np.int32)
    seqs = []
    for i in range(b):
        rows, seq = [], []
        while True:
            w = int(rng.integers(len(words)))
            r = [unit_ids[ch] * su + j for ch in words[w] for j in range(su)
                 for _ in range(dwell)]
            if len(rows) + len(r) > t_len:
                break
            rows += r
            seq.append(w)
        e[rows, np.arange(len(rows)), i] = 0.05
        nf[i] = len(rows)
        seqs.append(seq)
    return e, nf, seqs

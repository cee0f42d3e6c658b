"""A trie-shaped banded graph built by hand, for the beam and K9 tests
(CPU and card; this module imports no jax): arcs of 1, 2 and 3 states,
which ``models.lexgraph.build_lex_graph`` cannot make (its units have at
least 2 states), cross edges from each parent-arc end to each child-arc
start, and a 1-state root leaf that is both a word start and a word
end."""

import numpy as np
import torch

from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.utils.numerics import POS_INF


def trie_arrays(seed, arc_lens=(1, 2, 3), n_roots=3, depth=3):
    """A trie-shaped banded graph built directly (``build_lex_graph`` takes
    units of >= 2 states): arcs of 1, 2 and 3 states in preorder, a 0-2
    cost band inside each arc, a cross edge from each parent-arc end to
    each child-arc start, leaves as word ends, a random finite eps block.
    A 1-state leaf root is both a word start and a word end, so eps
    chains need depth 2.  Returns ``(arrays, eps_depth, n_bank_rows)``,
    the arrays numpy, named as ``BandedGraph``'s fields."""
    rng = np.random.default_rng(seed)
    arcs = []  # (parent arc, n states)

    def grow(parent, level):
        a = len(arcs)
        arcs.append((parent, int(rng.choice(arc_lens))))
        if level < depth:
            for _ in range(int(rng.integers(0, 3 if level else 2) + (level == 0))):
                grow(a, level + 1)

    for _ in range(n_roots):
        grow(-1, 1)
    arcs.append((-1, 1))  # a 1-state root that is a leaf: a start that is an end
    lens = np.array([n for _, n in arcs])
    start = np.r_[0, np.cumsum(lens)[:-1]]
    end = start + lens - 1
    s = int(lens.sum())
    has_child = np.zeros(len(arcs), bool)
    for p, _ in arcs:
        if p >= 0:
            has_child[p] = True
    band = np.full((3, s), POS_INF, np.float32)
    cross_src = np.zeros(s, np.int64)
    cross_cost = np.full(s, POS_INF, np.float32)
    for a, (p, n) in enumerate(arcs):
        for j in range(n):
            for d in range(min(j, 2) + 1):
                band[d, start[a] + j] = rng.uniform(0.1, 1.5)
        if p >= 0:
            cross_src[start[a]] = end[p]
            cross_cost[start[a]] = rng.uniform(0.0, 0.5)
    roots = [a for a, (p, _) in enumerate(arcs) if p < 0]
    leaves = [a for a in range(len(arcs)) if not has_child[a]]
    starts, ends = start[roots], end[leaves]
    start_pos = np.zeros(s, np.int64)
    start_pos[starts] = np.arange(len(roots))
    is_start = np.zeros(s, bool)
    is_start[starts] = True
    init = np.full(s, POS_INF, np.float32)
    init[starts] = rng.uniform(0, 1, len(roots))
    eps_block = rng.uniform(0.2, 2.0, (len(roots), len(leaves))).astype(np.float32)
    n_bank = 12
    arrs = dict(band=band, init_cost=init, word_starts=starts, word_ends=ends,
                eps_block=eps_block, start_pos=start_pos, is_start=is_start, end_states=ends,
                end_bonus=rng.uniform(0, 1, len(leaves)).astype(np.float32),
                bank_state=rng.integers(0, n_bank, s), cross_src=cross_src,
                cross_cost=cross_cost)
    assert {1, 2, 3} <= set(lens.tolist()) and bool(set(starts) & set(ends))
    return arrs, 2, n_bank


def port_graph(arrs, device=None) -> BandedGraph:
    """The port's ``BandedGraph`` of ``trie_arrays``' arrays."""
    return BandedGraph(**{k: torch.as_tensor(v, device=device) for k, v in arrs.items()})

"""The packed graph tables of the lexical-tree kernels K4 / K6
(``ops.viterbi_lex_kernels.lex_pack``) and their launch plan.

The kernels read each state's band costs, bank row and cross edge from a
32-bit record, a per-bank-row band table (or, in the general mode,
per-state band rows) and a compact cross table.  Unpacked here on the
CPU, they must give back ``band``, ``bank_state``, ``cross_src`` and
``cross_cost`` bit for bit on the 1,000-word benchmark trie, the
dictionary-shaped trie and the flat bigram vocabulary, and each leaf
slot its word end; a perturbed band must be flagged as not factorising
and a repeated word end must select the gather mode.  A graph whose bank
rows and links overflow 31 bits packs in the wide form (two words per
state) and unpacks as exactly, and the plan takes any bank: past the room
of the per-frame row tables it keeps none.
"""

import numpy as np
import pytest
import torch

from speech_recognition_tpu_torch.data.lexicon import (
    bench_lexicon,
    dict1_shaped_lexicon,
    flat_lm_lexicon,
    large_bank_lexicon,
)
from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

LIMIT = 227 * 1024  # shared memory a CTA may use on the card


def _graph(kind):
    if kind == "flat_lm_100":
        words, trans, ids, lm, _ = flat_lm_lexicon(100)
        return build_lex_graph(words, trans, ids, lm=lm, word_insertion_cost=0.3).banded
    if kind == "large_bank":
        words, trans, ids, _ = large_bank_lexicon()
        return build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded
    words, trans, ids, rng = dict1_shaped_lexicon() if kind == "dict1" else bench_lexicon()
    if kind == "1k_wide":
        # a unigram gives ~3,200 arcs their own cross pair, and bank rows
        # spread to ~2^20 leave 11 bits for them: the wide form
        g = build_lex_graph(words, trans, ids, unigram_cost=rng.uniform(0.1, 2.0, len(words)),
                            word_insertion_cost=0.5).banded
        return g._replace(bank_state=g.bank_state * 45000)
    return build_lex_graph(words, trans, ids, word_insertion_cost=0.5).banded


def _unpack(p: lk.LexPack, n_leaves: int):
    """``(band [3, S], bank_state, cross_src, cross_cost, leaf_state [L])``
    as the kernel reads them from the packed tables (-1: a leaf slot no
    record names)."""
    rec = p.rec.view(np.uint32).astype(np.int64)
    if p.wide:
        bank, rec = rec[:, 0], rec[:, 1]
    else:
        bank = rec & ((1 << p.shift) - 1)
    leaf = (rec >> 31).astype(bool)
    link = (rec & 0x7FFFFFFF) >> p.shift
    band = (p.rows[bank, :3] if p.factorised else p.band_s[:, :3]).T
    entry = p.cross[np.where(leaf, 0, link)]  # entry 0: the default pair
    src, cost = entry[:, 0], entry[:, 1].view(np.float32)
    leaf_state = np.full(n_leaves, -1, np.int64)
    leaf_state[link[leaf]] = np.nonzero(leaf)[0]
    return band, bank, src, cost, leaf_state


def _assert_unpacks(g, p):
    band, bank, src, cost, leaf_state = _unpack(p, g.n_ends)
    np.testing.assert_array_equal(band.view(np.int32), g.band.numpy().view(np.int32))
    np.testing.assert_array_equal(bank, g.bank_state.numpy())
    np.testing.assert_array_equal(src, g.cross_src.numpy())
    np.testing.assert_array_equal(cost.view(np.int32), g.cross_cost.numpy().view(np.int32))
    if not p.gather:
        np.testing.assert_array_equal(leaf_state, g.word_ends.numpy())
    else:
        assert (leaf_state == -1).all()


@pytest.mark.parametrize("kind", ["1k", "dict1", "flat_lm_100"])
def test_packed_tables_unpack_exactly(kind):
    g = _graph(kind)
    p = lk.lex_topology(g).pack
    assert p.factorised and not p.gather and not p.wide
    _assert_unpacks(g, p)
    # the cross table holds the default pair, then only the states whose
    # pair differs from it
    src_d, cost_d = p.cross[0, 0], p.cross[0, 1:].view(np.float32)[0]
    own = (g.cross_src.numpy() != src_d) | (g.cross_cost.numpy() != cost_d)
    assert p.cross.shape[0] == 1 + int(own.sum())
    assert p.rows.shape[0] == int(g.bank_state.max()) + 1
    # the eps block, stored once per row where its rows are constant
    eps = g.eps_block.numpy()
    got = np.broadcast_to(p.eps[:, None], eps.shape) if p.eps.ndim == 1 else p.eps
    np.testing.assert_array_equal(got.view(np.int32), eps.view(np.int32))
    assert (p.eps.ndim == 1) == (kind != "flat_lm_100")


def test_perturbed_band_does_not_factorise():
    g = _graph("1k")
    band = g.band.clone()
    v = int(torch.nonzero(band[1] < 1e29)[50])
    band[1, v] += 0.125
    g = g._replace(band=band)
    p = lk.lex_pack(g)
    assert not p.factorised and p.band_s.shape == (g.n_states, 4)
    _assert_unpacks(g, p)


def test_repeated_word_end_gathers():
    g = _graph("flat_lm_100")
    g = g._replace(word_ends=torch.cat([g.word_ends, g.word_ends[:1]]),
                   eps_block=torch.cat([g.eps_block, g.eps_block[:, :1]], 1))
    p = lk.lex_pack(g)
    assert p.gather
    _assert_unpacks(g, p)


@pytest.mark.parametrize("kind,lattice,want", [
    # the 1k trie: everything on chip, K6's tau frontier too (the eps block
    # is one value per root)
    ("1k", False, (True, False, True, True, False)),
    ("1k", True, (True, True, True, True, False)),
    # 86,520 states: frontier and tables in device memory
    ("dict1", False, (False, False, False, True, False)),
    ("dict1", True, (False, False, False, True, False)),
    # the flat bigram vocabulary: a full [100, 100] eps block, on chip
    ("flat_lm_100", True, (True, True, True, True, False)),
])
def test_lex_plan_places_the_main_path_graphs(kind, lattice, want):
    topo = lk.lex_topology(_graph(kind))
    plan = lk.lex_plan(lattice, topo, LIMIT)
    assert (plan.front, plan.tau, plan.tables, plan.eps, plan.gather) == want
    assert plan.rep == 8
    assert plan.smem <= LIMIT
    assert plan.frontier == ("shared" if want[0] else "device")


def test_lex_plan_falls_back_to_gathered_leaf_ends():
    """With only the two per-frame row tables' room, the plan keeps
    everything in device memory and gathers the leaf ends per root; with
    less, it keeps no row tables either (the band phase reads the bank
    rows and emissions through L1), down to no shared memory at all."""
    topo = lk.lex_topology(_graph("1k"))
    p = topo.pack
    least = lk.lex_smem_bytes(False, *topo.dims, False, False, False, False, True, 1)
    assert least == 2 * 16 * p.rows.shape[0]
    plan = lk.lex_plan(False, topo, least)
    assert (plan.front, plan.tables, plan.eps, plan.gather, plan.rep, plan.smem) == (
        False, False, False, True, 1, least)
    plan = lk.lex_plan(False, topo, least - 16)
    assert (plan.front, plan.tables, plan.rep) == (False, False, 0)
    assert plan.smem == lk.lex_smem_bytes(False, *topo.dims, False, False, False, plan.eps,
                                          plan.gather, 0) <= least - 16
    for lattice in (False, True):
        plan = lk.lex_plan(lattice, topo, 0)
        assert (plan.front, plan.tau, plan.tables, plan.eps, plan.gather, plan.rep,
                plan.smem) == (False, False, False, False, True, 0, 0)


@pytest.mark.parametrize("lattice", [False, True])
def test_lex_plan_keeps_large_banks_rows_in_device_memory(lattice):
    """8,000 bank rows: the two row tables alone pass a CTA's shared
    memory, so the plan keeps no row tables (the tier past ~7,000 rows)
    and the frontier and tables in device memory."""
    topo = lk.lex_topology(_graph("large_bank"))
    assert topo.pack.rows.shape[0] == 8000 and not topo.pack.wide
    assert lk.lex_smem_bytes(lattice, *topo.dims, False, False, False, False, True, 1) > LIMIT
    plan = lk.lex_plan(lattice, topo, LIMIT)
    assert (plan.front, plan.tables, plan.eps, plan.gather, plan.rep) == (
        False, False, True, False, 0)
    assert plan.tau == lattice
    assert plan.smem == lk.lex_smem_bytes(lattice, *topo.dims, False, plan.tau, False, True,
                                          False, 0) <= LIMIT


def test_wide_records_unpack_exactly():
    """~1M bank rows (20 bits) and ~3,200 cross links overflow a 32-bit
    record: the pack takes two words per state and unpacks bit-exactly;
    the plan reads them through L1 with the frontier in device memory."""
    g = _graph("1k_wide")
    topo = lk.lex_topology(g)
    p = topo.pack
    assert p.wide and p.shift == 0 and p.rec.shape == (g.n_states, 2)
    assert p.cross.shape[0] - 1 >= 1 << (31 - (p.rows.shape[0] - 1).bit_length())
    _assert_unpacks(g, p)
    for lattice in (False, True):
        plan = lk.lex_plan(lattice, topo, LIMIT)
        assert not plan.front and not plan.tables and plan.rep == 0

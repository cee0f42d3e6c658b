"""Large-vocabulary connected decoding over a lexical-tree graph.

Counterpart of ``speech_recognition_tpu/decode/lextree.py``
(``decode_lextree``): emissions are computed once against the *unit*
bank (``models.hmm.bank_nll_ubt``, one GEMM independent of the
vocabulary size), then kernel K4 (``ops.viterbi_lex_kernels.viterbi_lex``)
relaxes the trie's banded, cross and re-entry edges, the best leaf end
is picked with its ``end_bonus``, kernel K5 (``lex_backtrace_val``)
walks the planes back, and ``models.lexgraph.lex_words_from_path_batch``
reads the words off the path on the host.  The device of ``feats``
picks the kernels (CUDA) or their plain versions (CPU).

``decode_lextree(beam_width=k)`` takes the rank-threshold beam route:
``bank_nll_ubt``, the pruned plain forward ``viterbi_banded_tb`` over the
trie's banded graph (cross edges included; no kernel prunes, in either
package), the best leaf and kernel K9, which walks the cross edges.
``beam_decode_lextree`` is the token-passing beam of ``ops.beam`` (k
tokens a frame, emissions gathered per token from the unit bank), with
an optional bigram carried on each token's predecessor word.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.decode.connected import _decode_banded_batch, _warn_no_path
from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll_ubt
from speech_recognition_tpu_torch.models.lexgraph import LexGraph, lex_words_from_path_batch
from speech_recognition_tpu_torch.ops.beam import beam_backtrace, beam_search, beam_tables
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import (
    LexTopo,
    lex_backtrace_val,
    lex_topology,
    viterbi_lex,
)

__all__ = ["decode_lextree", "beam_decode_lextree"]


def _decode_lex_batch(bank: HMMBank, feats, n_frames, g: BandedGraph, topo: LexTopo):
    """``feats [B, T, D]``, ``n_frames [B]``, the trie ``g`` on the device
    of ``feats`` -> ``(states [T, B] int32, eps_flags [T, B] bool,
    costs [B])`` on that device."""
    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    n_frames = n_frames.to(dev)
    nll = bank_nll_ubt(bank, feats, n_frames)  # [U, T, B]
    final, bp8, _, eps_prev = viterbi_lex(nll, g, topo, n_frames)
    end_costs = final[:, g.end_states] + g.end_bonus[None, :]  # [B, L]
    best = torch.argmin(end_costs, dim=1)  # first minimum in leaf order
    states, eps_flags = lex_backtrace_val(bp8, eps_prev, g, g.end_states[best], n_frames,
                                          topo=topo)
    costs = end_costs.gather(1, best[:, None])[:, 0]
    return states, eps_flags, costs


def decode_lextree(bank: HMMBank, lexg: LexGraph, feats, n_frames,
                   beam_width: int = 0) -> Tuple[List[List[int]], np.ndarray]:
    """Decode a batch of utterances to word-id sequences over the trie.

    ``bank`` is the *unit* bank (the models ``lexg`` was built from, in
    the order of its ``unit_trans``); ``feats [B, T, D]`` and
    ``n_frames [B]`` are tensors and the decode runs on their device.
    ``beam_width`` > 0 prunes each frame to the costs within the k best
    (the reference's XLA beam route).  Returns ``(word_sequences,
    costs)`` with word ids indexing ``lexg.words``."""
    if beam_width:
        states, eps_flags, costs = _decode_banded_batch(
            bank, feats, n_frames, lexg.banded, eps_depth=lexg.eps_depth,
            beam_width=beam_width)
    else:
        states, eps_flags, costs = _decode_lex_batch(
            bank, feats, n_frames, lexg.banded.to(feats.device), lex_topology(lexg.banded))
        states, eps_flags = states.T, eps_flags.T
    costs = costs.cpu().numpy()
    _warn_no_path(costs)
    seqs = lex_words_from_path_batch(lexg, states.cpu().numpy(), n_frames.cpu().numpy(),
                                     eps_flags.cpu().numpy())
    return seqs, costs


def _beam_batch(bank: HMMBank, feats, n_frames, tables, k: int, has_cross: bool,
                bigram_cost=None, bigram_end=None):
    """Token beam over a batch: unit-bank emissions, ``beam_search`` and
    ``beam_backtrace`` -> ``(costs [B], words_rev [B, T + 1])``."""
    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    n_frames = n_frames.to(dev)
    nll = bank_nll_ubt(bank, feats, n_frames).permute(2, 1, 0)  # [B, T, U]
    fst, fco, fpd, _, tok_p, tok_w = beam_search(nll, tables, n_frames, k,
                                                 has_cross=has_cross,
                                                 bigram_cost=bigram_cost)
    return beam_backtrace(fst, fco, tok_p, tok_w, tables, n_frames, final_pred=fpd,
                          bigram_cost=bigram_cost, bigram_end=bigram_end)


def beam_decode_lextree(bank: HMMBank, lexg: LexGraph, feats, n_frames, k: int,
                        lm=None) -> Tuple[List[List[int]], np.ndarray]:
    """Fixed-width token-passing beam decode (``ops.beam``): per frame
    only the k best tokens survive, and emissions are gathered per token
    from the unit bank.  Exact for k >= the reachable state count;
    narrower beams are the classic approximation.

    ``lm`` (a bigram over word ids: ``.cost [V, V]``, ``.start_cost
    [V]``, ``.end_cost [V]``) is carried on each token's predecessor word
    and charged at word exits, on any tree shape (``ops.beam``); build
    ``lexg`` without an LM then.  ``feats [B, T, D]`` and ``n_frames
    [B]`` are tensors and the decode runs on their device.  Returns
    ``(word_sequences, costs)`` with word ids indexing ``lexg.words``."""
    dev = feats.device
    tables = beam_tables(lexg.banded, leaf_word=lexg.leaf_word, device=dev)
    has_cross = lexg.banded.cross_src is not None and tables.n_children > 0
    bigram_cost = bigram_end = None
    if lm is not None:
        bigram_cost = torch.as_tensor(np.concatenate(
            [np.asarray(lm.cost, np.float32), np.asarray(lm.start_cost, np.float32)[None]]),
            device=dev)
        bigram_end = torch.as_tensor(np.asarray(lm.end_cost, np.float32), device=dev)
    costs, words_rev = _beam_batch(bank, feats, n_frames, tables, k, has_cross,
                                   bigram_cost=bigram_cost, bigram_end=bigram_end)
    costs = costs.cpu().numpy()
    seqs = _word_lists(words_rev.cpu().numpy())
    _warn_no_path(costs)
    return seqs, costs


def _word_lists(words_rev: np.ndarray) -> List[List[int]]:
    """``beam_backtrace``'s ``words_rev [B, T + 1]`` -> each stream's words:
    the words ended along the path in time order (columns T..1, -1 left
    out), then the final token's word (column 0).  The whole plane is
    reversed and filtered at once; the streams are cut by their counts."""
    fwd = words_rev[:, :0:-1]
    keep = fwd >= 0
    ends = np.cumsum(keep.sum(1)).tolist()
    flat = fwd[keep].tolist()
    last = words_rev[:, 0].tolist()
    return [flat[a:e] + [w] for a, e, w in zip([0] + ends[:-1], ends, last)]

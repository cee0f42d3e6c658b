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

Not ported yet: beam pruning and ``beam_decode_lextree`` (ROADMAP queue
A item 6).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.decode.connected import _warn_no_path
from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll_ubt
from speech_recognition_tpu_torch.models.lexgraph import LexGraph, lex_words_from_path_batch
from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph
from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import (
    LexTopo,
    lex_backtrace_val,
    lex_topology,
    viterbi_lex,
)

__all__ = ["decode_lextree"]


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
    Returns ``(word_sequences, costs)`` with word ids indexing
    ``lexg.words``."""
    if beam_width:
        raise NotImplementedError("beam pruning and beam_decode_lextree are not "
                                  "ported yet (ROADMAP queue A item 6)")
    states, eps_flags, costs = _decode_lex_batch(
        bank, feats, n_frames, lexg.banded.to(feats.device), lex_topology(lexg.banded))
    costs = costs.cpu().numpy()
    _warn_no_path(costs)
    seqs = lex_words_from_path_batch(lexg, states.T.cpu().numpy(),
                                     n_frames.cpu().numpy(), eps_flags.T.cpu().numpy())
    return seqs, costs

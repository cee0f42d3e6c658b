"""Connected-word decoding over composed word graphs.

Counterpart of ``speech_recognition_tpu/decode/connected.py``, banded
path only.  On uniform word graphs with eps depth 1 and disjoint word
starts and ends (every loop graph, and every sausage over words of one
length >= 2) a batch runs through kernel K1 (GMM emission fused into the
banded Viterbi forward) and kernel K2 (value backtrace).  Every other
banded graph (1-state words, words of different lengths, transcript
graphs, eps depth > 1) runs ``models.hmm.bank_nll_ubt`` (one GEMM), then
kernel K8 (the forward on bank emissions) and kernel K9 (the general
backtrace).  Words come out of ``states_to_words_device``.
``backend="wordtrace"`` runs kernel K10 (entry-time side planes, no
backpointer plane) and the chain walk ``wordtrace_words_device``.
``backend="dense"``, and ``auto`` on a graph that is not banded, runs the
dense decoder: the bank emissions gathered to graph states, kernel K11
(``ops.viterbi_kernels.viterbi_dense``) with eps passes and planes, the
end-state select and ``ops.viterbi.viterbi_backtrace``.  CPU tensors
take every kernel's plain version.

``beam_width`` k > 0 runs the rank-threshold beam on any banded graph:
``bank_nll_ubt``, the pruned plain forward ``viterbi_banded_tb(...,
beam_width=k)`` (no kernel prunes, in either package) on either device,
the end-state select and kernel K9 (its plain version on the CPU).  Two
of the reference's rules are kept: ``backend="wordtrace"`` with a beam
runs this banded beam route, and ``backend="dense"`` (or ``auto`` on a
graph that is not banded) ignores ``beam_width``.
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np
import torch

from speech_recognition_tpu_torch.models.graph import WordGraph, build_word_graph
from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll, bank_nll_ubt
from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace
from speech_recognition_tpu_torch.ops.viterbi_banded import (
    BandedGraph,
    banded_arrays,
    viterbi_banded_tb,
)
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
    banded_backtrace_general,
    banded_backtrace_val,
    banded_route,
    banded_topology,
    fused_forward,
    viterbi_banded_general,
    viterbi_banded_wordtrace,
    wordtrace_words_device,
    wordtrace_words_host,
)
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["connected_graph_arrays", "decode_connected", "states_to_words",
           "states_to_words_device"]


def connected_graph_arrays(bank: HMMBank, n_slots: int, vocab=None) -> WordGraph:
    """The n_slots-layer sausage over ``vocab`` (default: every model)."""
    vocab = list(range(bank.n_models)) if vocab is None else list(vocab)
    model_trans = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    return build_word_graph(model_trans, [vocab] * n_slots)


def _decode_graph_batch(bank: HMMBank, feats, n_frames, trans, eps_trans, init_cost,
                        end_states, end_bonus, bank_state, eps_depth: int = 1):
    """Batched dense graph Viterbi: ``feats [B, T, D]``, the graph's
    arrays as tensors on the device of ``feats`` -> ``(states [B, T]
    int32, eps_flags [B, T] bool, costs [B])``."""
    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    t = feats.shape[1]
    n_frames = n_frames.to(dev)
    mask = torch.arange(t, device=dev)[None, :] < n_frames[:, None]
    nll = bank_nll(bank, feats, mask)[:, :, bank_state.to(torch.int64)]  # [B, T, S]
    final, bp, eps_bp = viterbi_dense(nll.contiguous(), trans, init_cost, n_frames,
                                      eps_trans=eps_trans, eps_depth=eps_depth)
    end_costs = final[:, end_states.to(torch.int64)] + end_bonus  # [B, E]
    best = torch.argmin(end_costs, dim=1)
    states, eps_flags = viterbi_backtrace(bp, eps_bp, end_states.to(torch.int64)[best],
                                          n_frames, eps_depth=eps_depth)
    return states, eps_flags, end_costs.gather(1, best[:, None])[:, 0]


def _decode_banded_batch(bank: HMMBank, feats, n_frames, g: BandedGraph,
                         eps_depth: int = 1, topo=None, beam_width: int = 0):
    """Batched banded decode: ``feats [B, T, D]``, ``n_frames [B]`` ->
    ``(states [B, T] int32, eps_flags [B, T] bool, costs [B])``, on the
    device of ``feats``.  ``beam_width`` > 0 takes the pruned plain
    forward and K9 on any banded graph, cross edges included (the
    lexical-tree beam route shares it)."""
    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    g = g.to(dev)
    n_frames = n_frames.to(dev)
    if beam_width:
        fused = False
        nll = bank_nll_ubt(bank, feats, n_frames)  # [U, T, B]
        final, bp8, eps_u = viterbi_banded_tb(nll.permute(1, 0, 2)[:, g.bank_state, :], g,
                                              n_frames, eps_depth, beam_width=beam_width)
    else:
        topo = banded_topology(g) if topo is None else topo
        fused = banded_route(topo, eps_depth) == "fused"
        if fused:
            final, bp8, _, eps_prev = fused_forward(bank, feats, n_frames, g, topo)
        else:
            nll = bank_nll_ubt(bank, feats, n_frames)  # [U, T, B]
            final, bp8, eps_u = viterbi_banded_general(nll, g, topo, n_frames, eps_depth)
    end_costs = final[g.end_states, :] + g.end_bonus[:, None]  # [E, B]
    best = torch.argmin(end_costs, dim=0)
    end_state = g.end_states[best]
    if fused:
        states, eps_flags = banded_backtrace_val(bp8, eps_prev, end_state,
                                                 n_frames, topo.uniform_w)
    else:
        states, eps_flags = banded_backtrace_general(bp8, eps_u, g, end_state,
                                                     n_frames, eps_depth)
    costs = end_costs.gather(0, best[None, :])[0]
    return states.T, eps_flags.T, costs


def _decode_banded_words(bank: HMMBank, graph: WordGraph, g: BandedGraph, feats,
                         n_frames, topo):
    """Backtrace-free decode of a uniform word graph with eps depth 1: K10
    carries entry times and records (origin word, entry time) at every
    re-entry, so the words come from an O(#words) chain walk; the
    ``[T, S, B]`` backpointer plane and the backtrace never exist.
    Returns ``(word_sequences, costs [B])`` with the costs on the host:
    their copy is queued before the walk, and the walk's one blocking
    copy of its words waits for both."""
    dev = feats.device
    if bank.means.device != dev:
        raise ValueError(f"bank is on {bank.means.device}, features on {dev}")
    g = g.to(dev)
    n_frames = n_frames.to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    final, eps_u, eps_tau, ftau = viterbi_banded_wordtrace(augment_dtb(feats), w, lw, g,
                                                           topo, n_frames)
    end_costs = final[g.end_states, :] + g.end_bonus[:, None]  # [E, B]
    best = torch.argmin(end_costs, dim=0)
    costs = end_costs.gather(0, best[None, :])[0].to("cpu", non_blocking=True)
    end_state = g.end_states[best]
    entry = ftau.gather(0, end_state[None, :])[0]
    # one blocking copy after the walk: the words and counts share a buffer
    words_rev, n_words = wordtrace_words_host(*wordtrace_words_device(
        eps_u, eps_tau, end_state // topo.uniform_w, entry, n_frames))
    # root slot -> word id, from the host graph (``g.word_starts`` are the
    # states where the slot changes)
    slot = np.asarray(graph.slot)
    labels = graph.slot_label[slot[np.r_[True, slot[1:] != slot[:-1]]]]
    seqs = [labels[words_rev[: n_words[i], i][::-1]].tolist()
            for i in range(words_rev.shape[1])]
    return seqs, costs


def decode_connected(bank: HMMBank, graph: WordGraph, feats, n_frames,
                     backend: str = "auto", drop_labels=None,
                     beam_width: int = 0) -> Tuple[List[List[int]], np.ndarray]:
    """Decode a batch of utterances to word-id sequences.

    ``feats [B, T, D]`` and ``n_frames [B]`` are tensors; the decode runs
    on their device.  ``backend``: 'banded' (states path), 'wordtrace'
    (the backtrace-free path; uniform word graphs with eps depth 1, else
    ``ValueError``), 'dense' (the dense decoder), or 'auto' (banded when
    the graph is banded, else dense).  ``beam_width`` > 0 prunes each
    frame to the costs within the k best on the banded routes (the
    states path; 'wordtrace' takes it too, as the reference does) and is
    ignored by the dense decoder, as the reference ignores it.  Returns
    ``(word_sequences, costs)``; each sequence is the consecutive-deduped
    slot labels along the best path.
    """
    if backend not in ("auto", "banded", "wordtrace", "dense"):
        raise ValueError(f"unknown backend {backend!r}")
    bg = None
    if backend != "dense":
        try:
            bg = banded_arrays(graph, device=feats.device)
        except ValueError:
            if backend != "auto":
                raise
    if bg is None:
        dev = feats.device
        arr = {k: torch.as_tensor(getattr(graph, k), device=dev)
               for k in ("trans", "eps_trans", "init_cost", "end_states", "end_bonus",
                         "bank_state")}
        states, eps_flags, costs = _decode_graph_batch(bank, feats, n_frames,
                                                       eps_depth=graph.eps_depth, **arr)
        return _words_out(graph, states, eps_flags, costs, n_frames, 0, drop_labels)
    if beam_width:
        states, eps_flags, costs = _decode_banded_batch(
            bank, feats, n_frames, bg, eps_depth=graph.eps_depth, beam_width=beam_width)
        return _words_out(graph, states, eps_flags, costs, n_frames, 0, drop_labels)
    topo = banded_topology(bg)
    if backend == "wordtrace":
        if not (topo.fused_ok and graph.eps_depth == 1):
            raise ValueError("wordtrace backend needs a uniform word graph")
        seqs, costs = _decode_banded_words(bank, graph, bg, feats, n_frames, topo)
        costs = costs.numpy()
        _warn_no_path(costs)
        if drop_labels:
            seqs = [[w for w in s if w not in drop_labels] for s in seqs]
        return seqs, costs
    states, eps_flags, costs = _decode_banded_batch(
        bank, feats, n_frames, bg, eps_depth=graph.eps_depth, topo=topo)
    return _words_out(graph, states, eps_flags, costs, n_frames, topo.uniform_w,
                      drop_labels)


def _words_out(graph: WordGraph, states, eps_flags, costs, n_frames, uniform_w: int,
               drop_labels):
    """Best paths ``states / eps_flags [B, T]`` -> ``(word_sequences,
    costs)`` as numpy: ``states_to_words_device`` on the decode's device,
    or the host ``states_to_words`` when labels are dropped."""
    costs = costs.cpu().numpy()
    _warn_no_path(costs)
    if not drop_labels:
        uw = uniform_w if np.array_equal(
            graph.slot, np.arange(graph.n_states) // max(uniform_w, 1)) else 0
        label_tbl = graph.slot_label if uw else graph.slot_label[graph.slot]
        dev = states.device
        words, n_words = states_to_words_device(
            torch.as_tensor(graph.slot, device=dev),
            torch.as_tensor(label_tbl, device=dev),
            states, eps_flags, n_frames, uniform_w=uw)
        words = words.cpu().numpy()
        n_words = n_words.cpu().numpy()
        return [words[i, : n_words[i]].tolist() for i in range(words.shape[0])], costs
    states = states.cpu().numpy()
    eps_flags = eps_flags.cpu().numpy()
    nf = n_frames.cpu().numpy()
    seqs = [states_to_words(graph, states[i], int(nf[i]), eps_flags[i],
                            drop_labels=drop_labels)
            for i in range(states.shape[0])]
    return seqs, costs


def _warn_no_path(costs):
    """Warn when no path reaches an end state."""
    bad = np.asarray(costs) >= POS_INF / 2
    if np.any(bad):
        warnings.warn(f"decode: cannot find a path for {int(bad.sum())} utterance(s)")


def states_to_words_device(slot_of_state, label_of_state, states, eps_flags,
                           n_frames, max_words: int = None, uniform_w: int = 0):
    """Batched :func:`states_to_words` in tensor ops.

    A word starts where the slot changes or a word-boundary epsilon fired
    (at t > 0).  ``slot_of_state`` / ``label_of_state`` are ``[S]`` tables
    (with ``uniform_w``, slot = state // uniform_w and ``label_of_state``
    is indexed by slot); ``states`` / ``eps_flags`` are ``[B, T]``.

    ``max_words`` defaults to the batch's own largest boundary count, so
    no word is ever dropped (the reference sizes the plane from
    ``t // min_dwell + 1``, which skip arcs undercut).  Returns
    ``(words [B, W] int32, -1 past each end; n_words [B] int32)``.
    """
    b, t = states.shape
    dev = states.device
    states = states.to(torch.int64)
    if uniform_w:
        slot_t = states // uniform_w
        label_t = label_of_state.to(dev)[slot_t]
    else:
        slot_t = slot_of_state.to(dev)[states]
        label_t = label_of_state.to(dev)[states]
    prev = torch.cat([torch.full((b, 1), -1, dtype=slot_t.dtype, device=dev),
                      slot_t[:, :-1]], dim=1)
    ti = torch.arange(t, device=dev)[None, :]
    valid = ti < n_frames.to(dev)[:, None]
    boundary = valid & ((slot_t != prev) | ((ti > 0) & eps_flags.to(dev).bool()))
    n_words = boundary.sum(1).to(torch.int32)
    if max_words is None:
        max_words = int(n_words.max()) if b else 0
    idx = torch.cumsum(boundary.to(torch.int64), dim=1) - 1
    keep = boundary & (idx < max_words)
    words = torch.full((b, max_words + 1), -1, dtype=torch.int32, device=dev)
    # non-boundary frames scatter into a spill column that is dropped
    col = torch.where(keep, idx, torch.full_like(idx, max_words))
    words.scatter_(1, col, torch.where(keep, label_t, -1).to(torch.int32))
    return words[:, :max_words], n_words


def states_to_words(graph: WordGraph, states: np.ndarray, n_frames: int,
                    eps_flags: np.ndarray = None, drop_labels=None) -> List[int]:
    """Per-frame states -> word ids: a new word starts when the slot
    changes or a word-boundary epsilon fired at that frame;
    ``drop_labels`` filters non-lexical arcs (e.g. silence)."""
    slots = graph.slot[states[:n_frames]]
    out: List[int] = []
    prev = -1
    for t, s in enumerate(slots):
        if s != prev or (eps_flags is not None and t > 0 and eps_flags[t]):
            label = int(graph.slot_label[s])
            if not (drop_labels and label in drop_labels):
                out.append(label)
            prev = s
    return out

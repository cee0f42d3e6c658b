"""Word-graph composition with offline epsilon closure (host numpy).

Counterpart of ``speech_recognition_tpu/models/graph.py`` (that module
imports jax through its numerics, so the builders are carried over
here unchanged).  NES states are eliminated at composition time: every
NES-mediated path between emitting states is min-plus closed into a
same-column ``eps_trans`` matrix, the initial NES becomes
``init_cost``, and per-state ``slot`` labels recover word boundaries.

``bank_state`` (= model * S + state) indexes the bank's flat states, so
emission costs are computed once per frame against the whole bank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from speech_recognition_tpu_torch.utils.numerics import NEG_INF, POS_INF

__all__ = ["WordGraph", "build_word_graph", "build_loop_graph", "transcript_graph",
           "pad_graphs", "pad_graphs_banded", "pad_graphs_auto", "BANDED_FB_MIN_STATES"]


@dataclasses.dataclass
class WordGraph:
    """Epsilon-free composed decoding graph (host-side numpy)."""

    trans: np.ndarray  # [S, S] frame-edge costs, T[to, from]
    eps_trans: np.ndarray  # [S, S] same-column costs (NES chains closed)
    init_cost: np.ndarray  # [S]
    end_states: np.ndarray  # [E] emitting final states (last layer word ends)
    end_bonus: np.ndarray  # [E] added to final costs (e.g. -log P(</s>|w))
    bank_state: np.ndarray  # [S] index into HMMBank flat states (model*S + j)
    slot: np.ndarray  # [S] word-slot id (layer-major, unique per word copy)
    slot_label: np.ndarray  # [n_slots] model id of each slot
    slot_layer: np.ndarray  # [n_slots] layer of each slot
    state_in_word: np.ndarray  # [S] position within the word model
    eps_depth: int  # same-column relaxation passes needed

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]


def _close_nes(nes_cost: np.ndarray) -> np.ndarray:
    """Min-plus transitive closure over NES-only edges (tiny matrices)."""
    n = nes_cost.shape[0]
    c = nes_cost.copy()
    np.fill_diagonal(c, 0.0)
    for k in range(n):
        c = np.minimum(c, c[:, [k]] + c[[k], :])
    return c


def build_word_graph(
    model_trans: Sequence[np.ndarray],
    label_matrix: List[List[int]],
    lm=None,
    word_insertion_cost: float = 0.0,
    allow_early_exit: bool = False,
    optional_layers=None,
    layer_skip_cost: float = 0.0,
    end_layers=None,
) -> WordGraph:
    """Compose a layered word graph.

    Args:
      model_trans: per-model ``[S, S]`` frame-edge transition costs
        (T[to, from], inf/POS_INF where absent).
      label_matrix: ``label_matrix[layer]`` lists the model ids allowed in
        that layer — ``[[l] for l in labels]`` gives the linear
        forced-alignment graph of one transcript
        (``continuous_speech.py:80``); ``[[0..10]] * 7`` gives the
        7-slot connected-digit sausage (``main.py:35``).
      lm: optional :class:`~speech_recognition_tpu_torch.langmodel.BigramLM`;
        its costs are added onto the closed word-boundary epsilon edges
        (the LM the reference planned but never wired in, SURVEY.md §1
        note on L4).
      word_insertion_cost: extra cost per word transition.
      allow_early_exit: accept word ends of *every* layer as final states
        (variable-length strings in a fixed-depth sausage).
      optional_layers: layer indices that may be skipped entirely (an
        NES -> NES epsilon edge bypasses the layer at ``layer_skip_cost``)
        — e.g. optional inter-word silence in forced-alignment graphs.
      end_layers: layers whose word ends are accepted as final states
        (default: last layer only) — needed when trailing optional
        layers may be skipped.

    Topology matches the reference exactly: an NES before layer 0, one
    after every layer; NES -> word-start and word-end -> NES edges cost 0
    (``continuous_speech.py:43-51``).
    """
    # Enumerate emitting states layer-major, preserving reference order.
    states_model = []  # model id per emitting state
    states_slot = []
    states_j = []  # position within word
    slot_label, slot_layer = [], []
    word_start, word_end = [], []  # per slot: emitting-state indices
    for layer, labels in enumerate(label_matrix):
        for l in labels:
            s = np.asarray(model_trans[l]).shape[0]
            slot_id = len(slot_label)
            start = len(states_model)
            states_model += [l] * s
            states_slot += [slot_id] * s
            states_j += list(range(s))
            slot_label.append(l)
            slot_layer.append(layer)
            word_start.append(start)
            word_end.append(start + s - 1)

    n_emit = len(states_model)
    n_layers = len(label_matrix)
    trans = np.full((n_emit, n_emit), POS_INF, dtype=np.float32)
    for slot_id in range(len(slot_label)):
        l = slot_label[slot_id]
        s0 = word_start[slot_id]
        t = np.asarray(model_trans[l], dtype=np.float32)
        s = t.shape[0]
        blk = np.where(np.isfinite(t), t, POS_INF)
        trans[s0 : s0 + s, s0 : s0 + s] = blk

    # NES graph: NES_0 .. NES_{n_layers}.  Edges (all cost 0, ref
    # continuous_speech.py:43-51): NES_l -> starts(layer l);
    # ends(layer l) -> NES_{l+1}.  No NES->NES edges exist in the
    # reference, but closure handles them if a caller adds any.
    n_nes = n_layers + 1
    nes_nes = np.full((n_nes, n_nes), POS_INF)
    for l in optional_layers or ():
        # skip layer l: NES_l -> NES_{l+1}
        nes_nes[l + 1, l] = layer_skip_cost
    nes_closure = _close_nes(nes_nes)

    # emitting -> NES and NES -> emitting cost tables.
    emit_to_nes = np.full((n_nes, n_emit), POS_INF)
    nes_to_emit = np.full((n_emit, n_nes), POS_INF)
    for slot_id in range(len(slot_label)):
        layer = slot_layer[slot_id]
        emit_to_nes[layer + 1, word_end[slot_id]] = 0.0
        nes_to_emit[word_start[slot_id], layer] = 0.0

    # eps_trans[v, u] = min over NES chains u -> ... -> v.
    a = _min_plus(nes_to_emit, nes_closure)  # [n_emit, n_nes]
    eps_trans = _min_plus(a, emit_to_nes).astype(np.float32)  # [n_emit, n_emit]

    # Initial NES (index 0): init_cost[v] = closure(NES_0 -> v).
    init_cost = a[:, 0].astype(np.float32)

    # Language-model weighting on the closed word-boundary edges.
    n_slots = len(slot_label)
    if lm is not None or word_insertion_cost:
        for us in range(n_slots):
            ue = word_end[us]
            for vs in range(n_slots):
                vstart = word_start[vs]
                if eps_trans[vstart, ue] < POS_INF / 2:
                    eps_trans[vstart, ue] += word_insertion_cost + (
                        float(lm.cost[slot_label[us], slot_label[vs]]) if lm else 0.0
                    )
        if lm is not None:
            for vs in range(n_slots):
                vstart = word_start[vs]
                if init_cost[vstart] < POS_INF / 2:
                    init_cost[vstart] += float(lm.start_cost[slot_label[vs]])

    if allow_early_exit:
        end_slots = list(range(n_slots))
    elif end_layers is not None:
        end_slots = [s for s in range(n_slots) if slot_layer[s] in end_layers]
    else:
        end_slots = [s for s in range(n_slots) if slot_layer[s] == n_layers - 1]
    end_states = np.array([word_end[s] for s in end_slots], dtype=np.int32)
    end_bonus = np.array(
        [float(lm.end_cost[slot_label[s]]) if lm else 0.0 for s in end_slots],
        dtype=np.float32,
    )

    # eps_depth: longest chain in the emitting-level eps DAG.
    eps_depth = _eps_depth(eps_trans)

    n_states_ref = [np.asarray(model_trans[l]).shape[0] for l in slot_label]
    bank_s = max(n_states_ref)
    bank_state = np.array(
        [states_model[i] * bank_s + states_j[i] for i in range(n_emit)],
        dtype=np.int32,
    )
    return WordGraph(
        trans=trans,
        eps_trans=eps_trans,
        init_cost=init_cost,
        end_states=end_states,
        end_bonus=end_bonus,
        bank_state=bank_state,
        slot=np.asarray(states_slot, dtype=np.int32),
        slot_label=np.asarray(slot_label, dtype=np.int32),
        slot_layer=np.asarray(slot_layer, dtype=np.int32),
        state_in_word=np.asarray(states_j, dtype=np.int32),
        eps_depth=eps_depth,
    )


def transcript_graph(
    model_trans: Sequence[np.ndarray],
    labels: List[int],
    sil: int = None,
    edge_sil: bool = True,
) -> WordGraph:
    """Forced-alignment graph for one transcript, optionally with
    skippable silence between (and, with ``edge_sil``, around) the words.
    With ``sil=None`` it is the reference's linear graph."""
    if sil is None:
        return build_word_graph(model_trans, [[l] for l in labels])
    layers: List[List[int]] = []
    optional = set()
    if edge_sil:
        optional.add(len(layers))
        layers.append([sil])
    for i, l in enumerate(labels):
        layers.append([l])
        if i + 1 < len(labels):
            optional.add(len(layers))
            layers.append([sil])
    end_layers = {len(layers) - 1}
    if edge_sil:
        optional.add(len(layers))
        layers.append([sil])
        end_layers.add(len(layers) - 1)
    return build_word_graph(
        model_trans, layers, optional_layers=optional, end_layers=end_layers
    )


def build_loop_graph(
    model_trans: Sequence[np.ndarray],
    vocab: Sequence[int] = None,
    lm=None,
    word_insertion_cost: float = 0.0,
) -> WordGraph:
    """Unbounded-length word-loop graph: one copy of every word, word
    ends feed every word start through LM-weighted epsilon edges.

    This is the production connected decoder's graph — it supplants the
    reference's fixed 7-slot sausage (``main.py:35``) with
    variable/unbounded-length recognition, and is where a bigram LM
    becomes exact (each boundary edge carries ``-log P(v|u)``).  Word
    boundaries for repeated words are recovered from epsilon-hop flags
    in the backtrace (``ops/viterbi.viterbi_backtrace``), since slot
    labels alone cannot separate \"9 9\".
    """
    vocab = list(range(len(model_trans))) if vocab is None else list(vocab)
    states_model, states_slot, states_j = [], [], []
    word_start, word_end = [], []
    for slot_id, l in enumerate(vocab):
        s = np.asarray(model_trans[l]).shape[0]
        if s < 2:
            raise ValueError("loop graphs need words with >= 2 states")
        start = len(states_model)
        states_model += [l] * s
        states_slot += [slot_id] * s
        states_j += list(range(s))
        word_start.append(start)
        word_end.append(start + s - 1)

    n_emit = len(states_model)
    trans = np.full((n_emit, n_emit), POS_INF, dtype=np.float32)
    for slot_id, l in enumerate(vocab):
        t = np.asarray(model_trans[l], dtype=np.float32)
        s = t.shape[0]
        s0 = word_start[slot_id]
        trans[s0 : s0 + s, s0 : s0 + s] = np.where(np.isfinite(t), t, POS_INF)

    eps_trans = np.full((n_emit, n_emit), POS_INF, dtype=np.float32)
    init_cost = np.full((n_emit,), POS_INF, dtype=np.float32)
    for us, ul in enumerate(vocab):
        for vs, vl in enumerate(vocab):
            c = word_insertion_cost + (float(lm.cost[ul, vl]) if lm else 0.0)
            eps_trans[word_start[vs], word_end[us]] = c
    for vs, vl in enumerate(vocab):
        init_cost[word_start[vs]] = float(lm.start_cost[vl]) if lm else 0.0

    end_states = np.asarray(word_end, dtype=np.int32)
    end_bonus = np.array(
        [float(lm.end_cost[l]) if lm else 0.0 for l in vocab], dtype=np.float32
    )
    return WordGraph(
        trans=trans,
        eps_trans=eps_trans,
        init_cost=init_cost,
        end_states=end_states,
        end_bonus=end_bonus,
        bank_state=np.array(
            [
                states_model[i] * max(np.asarray(t).shape[0] for t in model_trans)
                + states_j[i]
                for i in range(n_emit)
            ],
            dtype=np.int32,
        ),
        slot=np.asarray(states_slot, dtype=np.int32),
        slot_label=np.asarray(list(vocab), dtype=np.int32),
        slot_layer=np.zeros(len(vocab), dtype=np.int32),
        state_in_word=np.asarray(states_j, dtype=np.int32),
        eps_depth=1,
    )


def _min_plus(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(A min+ B)[i, j] = min_k A[i, k] + B[k, j], inf-safe."""
    out = np.min(a[:, :, None] + b[None, :, :], axis=1)
    return np.minimum(out, POS_INF)


def _eps_depth(eps_trans: np.ndarray) -> int:
    """Longest path (in edges) through the emitting eps graph; each edge
    is one same-column relaxation pass.  Standard word graphs (words with
    >= 2 states) have no chains -> depth 1."""
    n = eps_trans.shape[0]
    adj = eps_trans < POS_INF / 2
    depth = np.zeros(n, dtype=np.int64)
    # DAG longest path by repeated relaxation; bail if cyclic.
    for it in range(n + 1):
        new = depth.copy()
        srcs, dsts = np.nonzero(adj.T)  # edge u -> v: adj[v, u]
        for u, v in zip(srcs, dsts):
            new[v] = max(new[v], depth[u] + 1)
        if np.array_equal(new, depth):
            return max(1, int(depth.max()))
        depth = new
    raise ValueError("epsilon cycle in word graph")


def _end_scores(g: WordGraph, smax: int) -> np.ndarray:
    """``[smax]`` terminal log-probabilities: ``-end_bonus`` at the end
    states, ``NEG_INF`` elsewhere."""
    out = np.full((smax,), NEG_INF, dtype=np.float32)
    out[g.end_states] = -g.end_bonus
    return out


def pad_graphs(graphs: List[WordGraph]):
    """Pad a batch of graphs to a common state count for one batched
    decode (forced alignment: one graph per utterance).

    Padding states are unreachable (POS_INF in and out, POS_INF init) and
    read bank row 0; end-state lists are padded by repeating the first.
    Returns ``(dict of stacked numpy arrays, the largest eps_depth)``."""
    smax = max(g.n_states for g in graphs)
    emax = max(len(g.end_states) for g in graphs)
    depth = max(g.eps_depth for g in graphs)

    def pad_mat(m, fill):
        out = np.full((smax, smax), fill, dtype=np.float32)
        s = m.shape[0]
        out[:s, :s] = m
        return out

    def pad_vec(v, fill, n, dtype=np.float32):
        out = np.full((n,), fill, dtype=dtype)
        out[: len(v)] = v
        return out

    batch = {
        "trans": np.stack([pad_mat(g.trans, POS_INF) for g in graphs]),
        "eps_trans": np.stack([pad_mat(g.eps_trans, POS_INF) for g in graphs]),
        "init_cost": np.stack([pad_vec(g.init_cost, POS_INF, smax) for g in graphs]),
        "end_states": np.stack(
            [pad_vec(g.end_states, g.end_states[0], emax, np.int32) for g in graphs]
        ),
        "end_bonus": np.stack(
            [pad_vec(g.end_bonus, g.end_bonus[0], emax) for g in graphs]
        ),
        "end_scores": np.stack([_end_scores(g, smax) for g in graphs]),
        "bank_state": np.stack(
            [pad_vec(g.bank_state, 0, smax, np.int32) for g in graphs]
        ),
        "slot": np.stack([pad_vec(g.slot, -1, smax, np.int32) for g in graphs]),
        "n_states": np.array([g.n_states for g in graphs], dtype=np.int32),
    }
    return batch, depth


def pad_graphs_banded(graphs: List[WordGraph]):
    """Banded twin of :func:`pad_graphs`: each graph's
    ``ops.viterbi_banded.BandedGraph`` arrays padded to a common (S, R, L),
    so soft EM runs the banded forward-backward (kernel K15) with O(3S)
    arrays per utterance instead of the dense [S, S] pair.

    Padding rows and columns of ``eps_block`` are POS_INF; padded
    ``word_starts`` / ``word_ends`` entries point at state 0 with
    ``is_start`` false.  Returns ``(dict of stacked numpy arrays,
    eps_depth)`` with the BandedGraph field names plus ``end_scores`` /
    ``bank_state`` (int32 indices, as the JAX package's)."""
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays

    bgs = [banded_arrays(g) for g in graphs]
    smax = max(bg.band.shape[1] for bg in bgs)
    rmax = max(bg.word_starts.shape[0] for bg in bgs)
    lmax = max(bg.word_ends.shape[0] for bg in bgs)
    depth = max(g.eps_depth for g in graphs)

    def pad_vec(v, fill, n, dtype=np.float32):
        out = np.full((n,), fill, dtype=dtype)
        out[: len(v)] = v
        return out

    cols = {k: [] for k in ("band", "init_cost", "eps_block", "word_starts", "word_ends",
                            "start_pos", "is_start", "end_scores", "bank_state")}
    for g, bg in zip(graphs, bgs):
        band, blk = bg.band.numpy(), bg.eps_block.numpy()
        cols["band"].append(np.pad(band, ((0, 0), (0, smax - band.shape[1])),
                                   constant_values=POS_INF))
        cols["init_cost"].append(pad_vec(bg.init_cost.numpy(), POS_INF, smax))
        cols["eps_block"].append(np.pad(blk, ((0, rmax - blk.shape[0]), (0, lmax - blk.shape[1])),
                                        constant_values=POS_INF))
        cols["word_starts"].append(pad_vec(bg.word_starts.numpy(), 0, rmax, np.int32))
        cols["word_ends"].append(pad_vec(bg.word_ends.numpy(), 0, lmax, np.int32))
        cols["start_pos"].append(pad_vec(bg.start_pos.numpy(), 0, smax, np.int32))
        cols["is_start"].append(pad_vec(bg.is_start.numpy(), False, smax, bool))
        cols["end_scores"].append(_end_scores(g, smax))
        cols["bank_state"].append(pad_vec(bg.bank_state.numpy(), 0, smax, np.int32))
    return {k: np.stack(v) for k, v in cols.items()}, depth


#: State count from which :func:`pad_graphs_auto` picks the banded batch
#: (kernel K15) over the dense one (kernel K16) for sum-product training.
#: The JAX package's 256 is a TPU measurement.  On an NVIDIA H100 80GB HBM3
#: at 700.00 W, 256 padded transcript graphs with optional silence arcs
#: (as ``continuous_train`` composes them) at 300 frames: K16 is faster up
#: to 100 states (0.83 ms against 0.87), K15 from 132 on (0.89 against
#: 0.93; 1.06 against 1.53 at 196); without silence arcs K15 wins from 192
#: (``chip_smoke.py``'s crossover sweep; PERF.md).  Only
#: :func:`pad_graphs_auto` reads it, and no CLI path calls that:
#: ``continuous_train --algo soft`` composes dense graphs, as the JAX CLI
#: does, so the constant serves callers of the API.
BANDED_FB_MIN_STATES = 132


def pad_graphs_auto(graphs: List[WordGraph]):
    """The graph batch for sum-product training by size: dense
    (:func:`pad_graphs`) below :data:`BANDED_FB_MIN_STATES`, banded
    (:func:`pad_graphs_banded`) from it on; ``embedded_step_soft`` takes
    either."""
    if max(g.n_states for g in graphs) >= BANDED_FB_MIN_STATES:
        return pad_graphs_banded(graphs)
    return pad_graphs(graphs)

"""Streaming (long-audio) connected decoding with a carried frontier.

Counterpart of ``speech_recognition_tpu/decode/streaming.py``.  The cost
frontier of each stream is the only state carried between fixed-size
chunks; each ``push`` is one chunk step on the device:

* word graphs: kernel K17 (``ops.viterbi_banded_kernels
  .viterbi_banded_chunk``), routed as ``decode.connected`` routes a whole
  utterance: on a graph K1 takes (uniform words, eps depth 1) the
  emission kernel K13 on the chunk then K1's DP from the carry, with the
  eps_prev plane for the value backtrace K2; on any other banded graph
  ``bank_nll_ubt`` then K8's DP from the carry, backtraced by K9;
* lexical trees: ``bank_nll_ubt`` then kernel K18
  (``ops.viterbi_lex_kernels.viterbi_lex_chunk``, K4 from the carry),
  backtraced by K5.

The int8 backpointer planes stay on the device as chunks in the kernels'
layouts; ``finish`` concatenates them along time and backtraces every
stream in one launch, so only the ``[T, B]`` paths reach the host.
``emit_incremental`` also carries an ancestor map per chunk (state ->
the state at the chunk start its best token descends from); where every
live hypothesis of every stream shares one ancestor at a buffered chunk
boundary, the path up to there is immortal: it is backtraced from that
ancestor, its words are returned by ``push`` and its planes are dropped,
so device memory stays bounded whatever the audio length.  Chunked
output equals the monolithic decode's (asserted in tests).  CPU tensors
run every kernel's plain version.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from speech_recognition_tpu_torch.decode.connected import states_to_words_device
from speech_recognition_tpu_torch.models.hmm import HMMBank
from speech_recognition_tpu_torch.models.lexgraph import LexGraph, lex_words_from_path_batch
from speech_recognition_tpu_torch.ops.gmm import (
    augment_dtb,
    gmm_emission_weights,
    gmm_neg_log_lik_ubt,
)
from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays
from speech_recognition_tpu_torch.ops.viterbi_banded_kernels import (
    banded_backtrace_general,
    banded_backtrace_val,
    banded_route,
    banded_topology,
    viterbi_banded_chunk,
)
from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import (
    lex_backtrace_val,
    lex_topology,
    viterbi_lex_chunk,
)
from speech_recognition_tpu_torch.utils.numerics import POS_INF

__all__ = ["StreamingDecoder"]

_NV_SLOTS = 8  # pinned n_valid slots a decoder rotates through


def _immortal_scan(org_stack, alive):
    """Compose chunk ancestor maps newest to oldest.

    ``org_stack [N, B, S]`` (chunk k's map: end-of-chunk state -> state
    at the last frame of chunk k-1), ``alive [B, S]`` -> packed ``[N, B,
    2] int32`` where row j refers to boundary ``N-1-j``: ``[..., 0]`` is 1
    where every live state shares one ancestor there, ``[..., 1]`` that
    ancestor.  Packed so that a flush attempt reads one tensor."""
    n, b, s = org_stack.shape
    a = torch.arange(s, dtype=torch.int64, device=org_stack.device)[None].expand(b, s)
    rows = []
    for k in range(n - 1, -1, -1):
        a = org_stack[k].to(torch.int64).gather(1, a)
        mn = torch.where(alive, a, s).amin(1)
        mx = torch.where(alive, a, -1).amax(1)
        rows.append(torch.stack([(mn == mx).to(torch.int64), mn], dim=-1))
    return torch.stack(rows).to(torch.int32)


class StreamingDecoder:
    """Push-based long-audio decoder over a word graph or a lexical tree.

    ``batch`` > 1 decodes that many independent streams in lock-step
    (each ``push`` takes ``[B, C, D]`` chunks with per-stream valid
    counts).  The decoder runs on the bank's device; the graph goes
    there once."""

    def __init__(self, bank: HMMBank, graph, chunk_frames: int = 256, batch: int = 1,
                 emit_incremental: bool = False, window_chunks: int = 8,
                 flush_every: int = 2):
        """``graph`` is a WordGraph or a LexGraph (whose words are read off
        the path at re-entry epsilons).  ``emit_incremental``: bounded-
        memory mode for unbounded audio (see the module docstring);
        needs full-width pushes (only the final one may be partial).
        ``window_chunks``: buffered chunks before flushes are tried;
        ``flush_every``: try a flush every this many pushes once the
        window is full (each attempt reads one small tensor to the
        host)."""
        self.bank = bank
        self.device = bank.means.device
        self.graph = graph
        self._is_lex = isinstance(graph, LexGraph)
        bg = graph.banded if self._is_lex else banded_arrays(graph)
        if self._is_lex:
            self.topo = lex_topology(bg)
            self.mode = "lex"
        else:
            self.topo = banded_topology(bg)
            self.mode = banded_route(self.topo, graph.eps_depth)
        self.bg = bg.to(self.device)
        # the bank's emission weights, once (bank_nll_ubt would recompute
        # them every push)
        self._w, self._lw = gmm_emission_weights(*bank.flat_states())
        self.chunk_frames = chunk_frames
        self.batch = batch
        self.emit_incremental = emit_incremental
        self.window_chunks = max(2, int(window_chunks))
        self.flush_every = max(1, int(flush_every))
        self._ends = self.bg.end_states
        self._ends_np = self._ends.cpu().numpy()
        self._xa = {}  # chunk width -> the K13 input buffer (fused route)
        # n_valid's way to the device: pinned host slots, each copied
        # without blocking into its device slot; a slot is written again
        # only once the event after its last copy has passed
        self._nv_slot = 0
        if self.device.type == "cuda":
            self._nv_host = [torch.empty(batch, dtype=torch.int32).pin_memory()
                             for _ in range(_NV_SLOTS)]
            self._nv_dev = [torch.empty(batch, dtype=torch.int32, device=self.device)
                            for _ in range(_NV_SLOTS)]
            self._nv_done = [torch.cuda.Event() for _ in range(_NV_SLOTS)]
        self.reset()

    def reset(self):
        b, s = self.batch, self.bg.n_states
        # the carried frontier in the chunk kernel's layout: [S, B] for word
        # graphs, [B, S] for lexical trees
        init = self.bg.init_cost
        self._frontier = (init[None].expand(b, s) if self._is_lex
                          else init[:, None].expand(s, b)).contiguous()
        self._bp_chunks: List[torch.Tensor] = []  # bp8 per chunk, on the device
        self._eps_chunks: List[torch.Tensor] = []  # eps_prev (K2, K5) or eps_u (K9)
        self._org_chunks: List[torch.Tensor] = []  # [B, S] ancestor maps
        self._nv_history: List[np.ndarray] = []
        self._n_frames = np.zeros((b,), dtype=np.int64)
        self._flushed = 0  # frames already emitted (uniform across streams)
        self._emitted: List[List[int]] = [[] for _ in range(b)]
        self._prev_slot = [-1] * b
        self._prev_wa = [-1] * b  # lex: word id at the last frame
        self._since_flush = 0
        self._saw_partial = False
        self._first = True

    def _frontier_bs(self):
        """The carried frontier as ``[B, S]``."""
        return self._frontier if self._is_lex else self._frontier.T

    def _as_batch(self, x):
        """A push's features as a float32 ``[B, C, D]`` tensor on the
        decoder's device: numpy is copied there, a tensor must be there
        already."""
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"features are on {x.device}, the decoder on {self.device}")
        else:
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)
        if x.dim() == 2:  # unbatched convenience for batch == 1
            x = x[None]
        if x.shape[0] != self.batch:
            raise ValueError(f"push of {x.shape[0]} streams to a decoder of {self.batch}")
        return x.to(torch.float32)  # any strides: only _augmented reads it

    def push(self, feats_chunk, n_valid=None):
        """Feed ``[C, D]`` (batch 1) or ``[B, C, D]`` feature frames, numpy
        or a tensor on the decoder's device; ``n_valid`` is a scalar or
        ``[B]`` for partial chunks.  Returns the words each stream emitted
        (incremental mode; else empty lists)."""
        x = self._as_batch(feats_chunk)
        c = x.shape[1]
        if n_valid is None:
            nv = np.full((self.batch,), c, np.int32)
        else:
            nv = np.broadcast_to(np.asarray(n_valid, np.int32), (self.batch,)).copy()
        if self.emit_incremental:
            if self._saw_partial:
                raise ValueError("emit_incremental needs full-width pushes "
                                 "(only the final chunk may be partial)")
            if int(nv.min()) != c:
                self._saw_partial = True
        nv_t = self._n_valid_on_device(nv)
        track = self.emit_incremental
        if self.mode == "lex":
            nll = self._bank_nll(x, nv_t)  # [U, C, B]
            self._frontier, bp8, _, eps_prev, org = viterbi_lex_chunk(
                nll, self.bg, self.topo, self._frontier, nv_t, self._first, track)
            planes = eps_prev
        elif self.mode == "fused":
            inputs = (self._augmented(x), self._w, self._lw)
            self._frontier, bp8, _, eps_prev, org = viterbi_banded_chunk(
                inputs, self.bg, self.topo, self._frontier, nv_t, self._first, track, "fused")
            planes = eps_prev
        else:
            nll = self._bank_nll(x, nv_t)
            self._frontier, bp8, eps_u, _, org = viterbi_banded_chunk(
                nll, self.bg, self.topo, self._frontier, nv_t, self._first, track, "general",
                self.graph.eps_depth)
            planes = eps_u
        if track:
            self._org_chunks.append(org if self._is_lex else org.T)
        self._first = False
        self._bp_chunks.append(bp8)
        self._eps_chunks.append(planes)
        self._nv_history.append(nv)
        self._n_frames += nv
        if (self.emit_incremental and len(self._bp_chunks) > self.window_chunks
                and int(nv.min()) == c):
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._since_flush = 0
                return self._try_flush()
        return [[] for _ in range(self.batch)]

    def _n_valid_on_device(self, nv):
        """``nv [B]`` int32 as a tensor on the decoder's device.  A
        pageable host-to-device copy would wait for the previous push's
        kernels; from a pinned slot it queues behind them instead.  The
        slots rotate, and a slot's event (recorded after its copy) has
        passed long before the slot comes round again."""
        if self.device.type != "cuda":
            return torch.from_numpy(nv)
        k = self._nv_slot
        self._nv_slot = (k + 1) % _NV_SLOTS
        self._nv_done[k].synchronize()  # the slot's previous copy has left it
        self._nv_host[k].numpy()[:] = nv
        out = self._nv_dev[k].copy_(self._nv_host[k], non_blocking=True)
        self._nv_done[k].record()
        return out

    def _augmented(self, x):
        """``[B, C, D]`` features -> K13's ``[2D+1, C, B]`` input in a
        buffer kept per chunk width (``augment_dtb(x, out=)``; its row of
        ones is written once).  The next push's writes queue behind this
        push's kernels on the stream."""
        b, c, d = x.shape
        out = self._xa.get(c)
        if out is None:
            out = self._xa[c] = torch.empty((2 * d + 1, c, b), dtype=torch.float32,
                                            device=x.device)
            out[2 * d].fill_(1.0)
        return augment_dtb(x, out=out)

    def _bank_nll(self, x, nv_t):
        """``models.hmm.bank_nll_ubt`` of the push, ``[U, C, B]``, from the
        cached weights and the push's augmented features."""
        return gmm_neg_log_lik_ubt(x, self._w, self._lw, nv_t, xa=self._augmented(x))

    def _backtrace(self, bp8, planes, end_state, n_frames):
        """One backtrace launch over concatenated planes ->
        ``(states [B, T] int32, eps flags [B, T] bool)`` on the device."""
        if self.mode == "lex":
            st, fl = lex_backtrace_val(bp8, planes, self.bg, end_state, n_frames,
                                       topo=self.topo)
        elif self.mode == "fused":
            st, fl = banded_backtrace_val(bp8, planes, end_state, n_frames,
                                          self.topo.uniform_w)
        else:
            st, fl = banded_backtrace_general(bp8, planes, self.bg, end_state, n_frames,
                                              self.graph.eps_depth)
        return st.T, fl.T

    def _extend_words(self, i, states, eps_flags):
        """Continue stream ``i``'s word state machine over a new path
        segment (``states_to_words``' boundary rule: a word starts where
        the slot changes or, after the first frame, an epsilon fired;
        the slot carries across flushes)."""
        if not len(states):
            return []
        slots = self.graph.slot[states]
        prev = np.r_[self._prev_slot[i], slots[:-1]]
        later = self._flushed + np.arange(len(states)) > 0
        new = self.graph.slot_label[slots[(slots != prev) | (later & eps_flags)]].tolist()
        self._prev_slot[i] = int(slots[-1])
        self._emitted[i].extend(new)
        return new

    def _extend_words_lex(self, i, states, eps_flags):
        """Lexical-tree twin of :meth:`_extend_words`: a word completes
        where a re-entry epsilon fires (its id is the previous frame's
        leaf arc's, ``lex_words_from_path``'s rule), so the machine
        carries the last frame's word across flushes; the word under
        construction at the segment's end is not emitted."""
        if not len(states):
            return []
        wa = self.graph.arc_leaf_word[self.graph.arc_of_state[states]]
        prev = np.r_[self._prev_wa[i], wa[:-1]]
        later = self._flushed + np.arange(len(states)) > 0
        new = prev[eps_flags & later].tolist()
        self._prev_wa[i] = int(wa[-1])
        self._emitted[i].extend(new)
        return new

    def _try_flush(self):
        """Emit every word whose path is immortal and drop its planes: the
        newest buffered boundary where every live hypothesis of every
        stream shares one ancestor is a fixed point of the final
        backtrace, so the segment before it decodes now."""
        n = len(self._org_chunks)
        out: List[List[int]] = [[] for _ in range(self.batch)]
        alive = self._frontier_bs() < POS_INF / 2
        packed = _immortal_scan(torch.stack(self._org_chunks), alive).cpu().numpy()
        imm, sig = packed[..., 0], packed[..., 1]
        for j in range(n):
            k = n - 1 - j
            if k >= 1 and bool(imm[j].all()):
                break
        else:
            return out
        seg_bp = torch.cat(self._bp_chunks[:k])
        seg_eps = torch.cat(self._eps_chunks[:k])
        t_seg = int(seg_bp.shape[0])
        dev = self.device
        states, flags = (x.cpu().numpy() for x in self._backtrace(
            seg_bp, seg_eps, torch.from_numpy(sig[j].astype(np.int64)).to(dev),
            torch.full((self.batch,), t_seg, dtype=torch.int32, device=dev)))
        extend = self._extend_words_lex if self._is_lex else self._extend_words
        for i in range(self.batch):
            out[i] = extend(i, states[i], flags[i])
        del self._bp_chunks[:k]
        del self._eps_chunks[:k]
        del self._org_chunks[:k]
        del self._nv_history[:k]
        self._flushed += t_seg
        return out

    def _end_costs(self):
        """``[B, E]`` end-state costs with their bonuses, on the host."""
        f = self._frontier_bs()[:, self._ends] + self.bg.end_bonus[None]
        return f.cpu().numpy()

    def best_cost(self):
        costs = self._end_costs().min(axis=1)
        return float(costs[0]) if self.batch == 1 else costs

    def _planes(self):
        """The buffered planes concatenated along time, each stream's
        valid frames first: directly where they already are (every
        stream's partial chunks at its own end, as in a ragged batch),
        else by an index gather on the device."""
        if not self._bp_chunks:
            return None, None
        bp, eps = torch.cat(self._bp_chunks), torch.cat(self._eps_chunks)
        nv = np.stack(self._nv_history)  # [N, B]
        widths = np.array([c.shape[0] for c in self._bp_chunks])
        short = nv < widths[:, None]
        # a stream's frames are a prefix where no chunk after its first
        # short one holds a valid frame
        after = np.cumsum(short, axis=0) - short > 0
        if not (after & (nv > 0)).any():
            return bp, eps
        t_max = int(nv.sum(0).max())
        starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
        idx = np.zeros((t_max, self.batch), np.int64)
        for i in range(self.batch):
            frames = np.concatenate([s0 + np.arange(n) for s0, n in zip(starts, nv[:, i])])
            idx[: len(frames), i] = frames
        idx = torch.from_numpy(idx).to(self.device)

        def gather(x):  # x [T, S, B] (word graphs) or [T, B, S] (tries)
            ix = idx[:, None, :] if not self._is_lex else idx[:, :, None]
            return x.gather(0, ix.expand(t_max, *x.shape[1:]))

        return gather(bp), gather(eps)

    def finish(self):
        """Backtrace over all pushed audio, every stream in one launch.
        Returns ``(word_ids, states, cost)`` for batch 1, else a list of
        them."""
        ends, end_costs = self._ends_np, self._end_costs()
        best = np.argmin(end_costs, axis=1)
        costs = end_costs[np.arange(self.batch), best]
        end_states = ends[best].astype(np.int64)
        nf_bt = (self._n_frames - self._flushed).astype(np.int32)
        bp, eps = self._planes()
        dev = self.device
        nf_t = torch.from_numpy(nf_bt).to(dev)
        if bp is None:
            st_t = torch.zeros((self.batch, 0), dtype=torch.int32, device=dev)
            fl_t = torch.zeros((self.batch, 0), dtype=torch.bool, device=dev)
        else:
            st_t, fl_t = self._backtrace(bp, eps, torch.from_numpy(end_states).to(dev), nf_t)
        states_all, eps_all = st_t.cpu().numpy(), fl_t.cpu().numpy()
        if self.emit_incremental:  # the word machine continues below
            words_all = [None] * self.batch
        elif self._is_lex:
            words_all = lex_words_from_path_batch(self.graph, states_all, nf_bt, eps_all)
        else:  # the batched word walk on the device (states_to_words' rule)
            g = self.graph
            w_t, n_w = states_to_words_device(torch.as_tensor(g.slot, device=dev),
                                              torch.as_tensor(g.slot_label[g.slot], device=dev),
                                              st_t, fl_t, nf_t)
            w_np, n_np = w_t.cpu().numpy(), n_w.cpu().numpy()
            words_all = [w_np[b, : n_np[b]].tolist() for b in range(self.batch)]
        results = []
        for b in range(self.batch):
            t_total = int(nf_bt[b])
            states = states_all[b, :t_total].astype(np.int32)
            if self.emit_incremental:
                # the residual segment continues the incremental machine;
                # emitted + residual == the monolithic word sequence
                if self._is_lex:
                    self._extend_words_lex(b, states, eps_all[b, :t_total])
                    self._emitted[b].append(int(self._prev_wa[b]))  # the word in flight
                else:
                    self._extend_words(b, states, eps_all[b, :t_total])
                words_all[b] = list(self._emitted[b])
            results.append((words_all[b], states, float(costs[b])))
        return results[0] if self.batch == 1 else results

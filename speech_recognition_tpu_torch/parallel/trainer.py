"""Sharded training and classification over a (data, model) mesh.

Counterpart of ``speech_recognition_tpu/parallel/trainer.py``.  The JAX
step is ``jax.jit`` with shardings, GSPMD inserting the ``psum``s of the
sufficient statistics; here every rank calls the step on its own shard
and the collectives are explicit:

* ``'data'``: each rank aligns (hard step: K11 and the backtrace) or runs
  the forward-backward (soft step: K15 / K16) over its utterances and
  computes their statistics (``embedded_shard_stats`` /
  ``soft_shard_stats``); one ``all_reduce(SUM)`` over ``'data'`` adds
  ``frame_counts``, the run (or self and exit) counts, ``r_sum``, ``rx``,
  ``rxx`` and the total cost; the M-step then runs on every rank;
* ``'model'`` (``shard_models``): each rank holds ``N / n_model`` models,
  computes their emission columns and ``all_gather``s them for the
  alignment, accumulates and re-estimates its own states only, and
  ``all_gather``s the new bank and the statistics, so the outputs are
  replicated, as the JAX step's ``out_shardings`` make them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll
from speech_recognition_tpu_torch.parallel.mesh import (
    all_gather,
    axis_rank,
    bank_shard,
    batch_shard,
)
from speech_recognition_tpu_torch.train.embedded_step import (
    GRAPH_KEYS,
    EmbeddedStats,
    embedded_shard_stats,
    embedded_update,
    soft_shard_stats,
    soft_update,
)

__all__ = ["GRAPH_KEYS", "SOFT_GRAPH_KEYS", "shard_embedded_inputs",
           "make_sharded_embedded_step", "make_sharded_classifier"]

#: the banded graph batch (models.graph.pad_graphs_banded): the soft
#: step's O(3S)-a-frame forward-backward (K15)
SOFT_GRAPH_KEYS = ("band", "init_cost", "eps_block", "word_starts", "word_ends", "start_pos",
                   "is_start", "end_scores", "bank_state")


def shard_embedded_inputs(mesh, bank: HMMBank, feats, n_frames, graph_batch,
                          shard_models: bool = False):
    """This rank's step inputs on the mesh's device: its bank (whole, or
    its models with ``shard_models``), its utterances of ``feats`` /
    ``n_frames`` and of the per-utterance graph arrays (``SOFT_GRAPH_KEYS``
    of a banded dict; of a dense dict those of ``GRAPH_KEYS`` and
    ``end_scores`` it holds: the hard step's or the soft step's).  Raises
    where the batch or the model count does not divide its axis."""
    keys = SOFT_GRAPH_KEYS if "band" in graph_batch else \
        [k for k in GRAPH_KEYS + ("end_scores",) if k in graph_batch]
    return (bank_shard(mesh, bank, shard_models),
            batch_shard(mesh, torch.as_tensor(feats, dtype=torch.float32)),
            batch_shard(mesh, torch.as_tensor(n_frames, dtype=torch.int32)),
            {k: batch_shard(mesh, graph_batch[k]) for k in keys})


def make_sharded_embedded_step(mesh, eps_depth: int = 1, var_floor: float = 1e-2,
                               shard_models: bool = False, soft: bool = False,
                               frame_chunk: int = 65536):
    """``step(bank, feats, n_frames, graph_batch) -> (new_bank, stats)``
    on this rank's inputs (:func:`shard_embedded_inputs`), the outputs
    replicated on every rank.  ``soft`` runs the Baum-Welch step (the
    dense dict of ``compose_graphs(..., end_scores=True)`` or the banded
    dict of ``pad_graphs_banded``), else Viterbi-EM.  Every rank of the
    mesh calls the step together."""
    data = mesh.get_group("data")
    model = mesh.get_group("model") if shard_models else None
    shard_stats = soft_shard_stats if soft else embedded_shard_stats

    def step(bank: HMMBank, feats, n_frames, graph_batch):
        b, t, d = feats.shape
        ns_local, m = bank.n_models * bank.n_states, bank.n_mix
        nll = first = None
        if shard_models:
            mask = torch.arange(t, device=feats.device)[None, :] < n_frames.to(
                feats.device)[:, None]
            nll = torch.cat(all_gather(bank_nll(bank, feats, mask), model), 2)
            first = axis_rank(mesh, "model") * ns_local
        stats = shard_stats(bank, feats, n_frames, graph_batch, eps_depth, frame_chunk,
                            nll=nll, first_state=first or 0)
        # the psum over 'data': one buffer, one all_reduce
        flat = torch.cat([x.reshape(-1) for x in stats])
        dist.all_reduce(flat, group=data)
        stats = [y.reshape(x.shape) for x, y in
                 zip(stats, flat.split([x.numel() for x in stats]))]
        if soft:
            frame_counts, self_counts, run_counts, r_sum, rx, rxx, total = stats
            new_bank = soft_update(bank, frame_counts, self_counts, run_counts, r_sum, rx, rxx,
                                   var_floor)
        else:
            frame_counts, run_counts, r_sum, rx, rxx, total = stats
            new_bank = embedded_update(bank, frame_counts, run_counts, r_sum, rx, rxx,
                                       var_floor)
        parts = [new_bank.means, new_bank.log_vars, new_bank.log_weights, new_bank.trans_cost,
                 r_sum.reshape(ns_local, m), rx.reshape(ns_local, m, d),
                 rxx.reshape(ns_local, m, d), frame_counts, run_counts]
        if shard_models:  # every rank's models, in model order: one all_gather
            flat = torch.cat([x.reshape(-1) for x in parts])
            pieces = [p.split([x.numel() for x in parts]) for p in all_gather(flat, model)]
            parts = [torch.cat([p[i].reshape(x.shape) for p in pieces]) for i, x in
                     enumerate(parts)]
        return HMMBank(*parts[:4]), EmbeddedStats(*parts[4:], total)

    return step


def make_sharded_classifier(mesh):
    """Data-parallel isolated-word classification:
    ``classify(bank, feats, n_frames) -> (pred [B], costs [B, N])`` on
    this rank's utterances (the bank whole), the outputs of the whole
    batch gathered over ``'data'`` in batch order."""
    from speech_recognition_tpu_torch.decode.isolated import classify_batch

    data = mesh.get_group("data")

    def classify(bank: HMMBank, feats, n_frames):
        pred, costs = classify_batch(bank, feats, n_frames)
        return torch.cat(all_gather(pred, data)), torch.cat(all_gather(costs, data))

    return classify

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``speech_recognition_tpu_torch``).

Builds the port's CUDA kernels from ``speech_recognition_tpu_torch/csrc``
(one nvcc per source, in parallel), holds each kernel against its plain
PyTorch version on the card at its path's shapes, and drives both paths
through the CLI with the launch counters reset just before each:

* connected digits, ``cli connected_test --graph loop|sausage --device
  cuda``: wavs -> MFCC-39 (K3 = the frame-parallel cepstra kernel + the
  tail kernel K14) -> fused emission + banded Viterbi (K1 = the emission
  kernel K13 + the banded DP) -> backtrace (K2) -> word ids; and
  ``--graph loop`` with a 25 s ``--max-samples`` cap (2,499 frames);
* lexical tree, ``cli connected_test --graph lextree --device cuda``:
  wavs -> MFCC-39 (K3) -> unit-bank emissions -> lexical-tree Viterbi
  (K4) -> backtrace (K5) -> word ids;
* bigram LM composed onto the graph, ``--lm bigram`` with ``--graph
  loop|sausage`` (K3 + K1 + K2) and ``--graph lextree --decoder compose``
  (K3 + K4 + K5);
* bigram LM over word lattices, ``--graph lextree --lm bigram --decoder
  lattice``: wavs -> MFCC-39 (K3) -> unit-bank emissions -> lattice pass
  (K6) -> one K7 launch (``rescore_and_walk``: the per-frame minimum q,
  the truncation count, bigram rescoring and, as its last step, K22's
  word walk) -> word ids;
* general word graphs, ``cli connected_test --graph sausage --device
  cuda`` with a bank of 1-state words (every word start is also a word
  end, eps depth up to 6): wavs -> MFCC-39 (K3) -> unit-bank emissions ->
  banded forward on bank emissions (K8) -> general backtrace (K9) -> word
  ids;
* the word-trace backend, ``decode_connected(backend="wordtrace")`` on
  the CLI corpus's features (K3), at 512 x 500 on the 385-state sausage
  and at 64 x 100 on a 1,500-word loop (7,500 states): the emission
  kernel K13 + the banded DP's word-trace mode (together K10, entry-time
  planes) -> chain walk -> word ids, equal to the states path's words;
* isolated words, ``cli isolated_test --device cuda`` on a synthetic
  isolated corpus with a 12-model bank (11 digits of 5 states x 4
  mixtures x 39 dims, and a silence model that is left out): wavs ->
  MFCC-39 (K3) -> one emission GEMM -> dense Viterbi per (utterance,
  model) without planes (K11) -> argmin;
* forced alignment, ``cli align --device cuda`` with the same bank:
  padded transcript graphs with optional silence -> K11 with
  per-utterance matrices -> backtrace -> word segments;
* the dense decoder, ``decode_connected(backend="dense")`` on the CLI
  corpus's features (K3 + K11), words equal to the banded path's;
* ``ops.frontend.mfcc`` on CUDA tensors (K12, whose kernel is K3's
  first launch);
* training, through the CLI at full width: ``synth`` (20 training and 5
  test utterances a digit, 200 training strings), ``isolated_train
  --silence`` (11 digits + silence, 5 states x 4 mixtures x 39 dims:
  MFCC-39 by K3 -> segmental K-means, every template of a word aligned by
  one K11 launch an iteration -> mixture splitting, a word's 5 states as
  one batch: one launch of the k-means kernel K24 and one of the EM kernel
  K25 a split level),
  ``isolated_test``, ``continuous_train --algo hard --iterations 3``
  (embedded Viterbi-EM: K11 with per-utterance transcript graphs) and
  ``connected_test`` on the result, once with ``--device cuda`` and once
  with ``--device cpu``;
* soft EM, ``continuous_train --algo soft --iterations 3`` from that
  isolated bank (Baum-Welch: bank emissions -> the dense forward-backward
  K16 on the transcript graphs -> statistics GEMMs -> M-step) and
  ``connected_test`` of its last bank, on cuda and on cpu (costs at rtol
  1e-4, the same number of test wavs right);
* word confidence, ``connected_test --graph loop --confidence``: K3 -> K1
  -> K2 -> bank emissions -> the banded forward-backward K15 -> word
  averages, on cuda and on cpu (the same words, confidences within
  ``CONF_ATOL``);
* streaming, ``cli stream --device cuda`` with ``--graph loop``, ``loop
  --incremental`` and ``lextree``, and ``StreamingDecoder`` on a sausage
  of 1-state words: wavs -> MFCC-39 (K3) -> per pushed chunk K13 + K17
  (K1's DP from the carried frontier), bank emissions + K18 (K4's), or
  bank emissions + K17's general mode (K8's) -> one backtrace at finish
  and at each mid-stream flush (K2, K5, K9) -> words, equal to ``--device
  cpu``'s (costs at rtol 1e-5).  K17 and K18 are held bit for bit to
  their plain versions chunk by chunk from their own carry (with and
  without the ancestor map) on the CLI's loop graph at 256 x 500 in
  64-frame and 1-frame chunks, the 1-state sausage at 512 x 500, the
  7,500-state loop (the work area in device memory at 300 streams), the
  1k trie at 128 x 500 on planted words, the dictionary-shaped trie and
  the 8,000-bank-row trie; the concatenated planes equal the monolithic
  DP's.  Then each is timed per push, and whole streams through the push
  API (pushes, finish, a flush attempt, idle share) beside the
  monolithic decode.  ``device_ms`` holds each profiler window's kernel
  count to the wrappers' launch counts and reports NaN ("not measured")
  for a reading whose window lost kernels three times.

K21 (the dense backtrace behind ``viterbi_backtrace``), K22 (the bigram
lattice's word walk) and K23 (the word-trace walk) replace the JAX
package's backtrace scans.  K21 is held bit for bit to
``viterbi_backtrace_ref`` on K11's planes of each K11 case below (the
385-state sausage at 64 x 500, the isolated shape, the transcript
graphs, the integer-tie batch: eps depth 2, lengths 0, 1 and T), batched
and one stream, in each form ``dense_backtrace_plan`` picks (its window
form, the window form at 8 frames x 8 states and the chain form forced
on the same planes), on a strided view of the sausage's planes and on
K11's planes at 11,623 states (both the plan's chain form); K22 to
``lattice_words_ref`` in every K6 + K7 check, at the decode's max_words
and one word short of the longest chain, standalone and as K7's last
step (``rescore_and_walk`` against ``rescore_and_walk_ref``: q, the
truncation counts, cost, best leaf, pred_w, the walk's leaves and word
counts bit for bit, in every plan K7 is run in); K23 to ``wordtrace_words_ref``
on the sausage's word trace at 512 x 500 and on a skip-arc loop graph
whose chains outgrow the reference's T / W + 1 rows, its T + 1 rows
included, under CUDA's sync debug mode (the wrapper reads nothing
back).  The align, dense, training and section 8 paths count K21, the
bigram lattice path and section 8 K7 with K22 as its last step (and no
standalone K7 or K22 launch), the word-trace path K23; each is
timed beside its plain version, its bound and its serial floor (K22 as
K7's device time less the same launch's at max_words 0, where the walk
takes no step, and standalone); K21's
two forms on each dense case in one call (the chain form as parent).

K19 (``csrc/token_beam.cu``: the token beam's whole frame loop in one
launch) and K26 (``csrc/word_walk.cu``: its walk) replace the JAX
package's two ``lax.scan``s of ``ops/beam.py``.  In 7c they are held to
``beam_search_ref`` / ``beam_backtrace_ref`` on the card's own tensors
(every live slot of the token planes and the final frontier, costs and
words bit for bit; dead slots -1) on the 1k trie at 32 x 500 planted
frames, k = 64, with and without a bigram, and on the dictionary-shaped
trie (their device-scratch tier); ``beam_decode_lextree`` at k = S (the
device tier) gives K4 + K5's words and costs; each token beam path is one
K19 and one K26 launch, timed beside the plain route and the exact one.

Each CLI output is checked against the same command on the CPU (plain
versions); the training path's, which sum GEMMs in other orders on the
two devices, by accuracy: ``isolated_test`` within one file, and
``connected_test`` within one wav decoded right.  K24 (k-means) and K25
(EM), ``csrc/gmm_fit.cu``, replace the JAX package's two
``lax.while_loop``s of mixture training; each launch runs a batch of fits
to convergence with no host read.  They are held to their plain versions
(``kmeans_batch_ref`` / ``em_fit_batch_ref``) for one iteration at every
call ``isolated_train --silence`` made on the card (frames at a near-tie
of the plain distances may go to the other cluster: such fits are
counted and left out), and for one iteration and whole fits on planted
mixtures at ``fit_hmm``'s shape, at a fit of 8,000 frames (past the
frames a CTA stages in shared memory) and at 3,000 feature dimensions
(the parameters in device memory), with and without the covariance
quirk (assignments, counts and iteration counts exact, the rest at
``GMM_TOL``), two launches bit for bit.  K11 is held
bit-identical to its plain version at the two training shapes the cuda
run gave it (a word's segmental K-means batch, the embedded step's
transcript graphs), and ``isolated_train`` is timed per digit (with its
K24 and K25 calls, the EM iterations a fit and the launches a digit, and
segmental K-means' K11 and backtrace; the 11 digits' ``fit_hmm`` with its
device idle share) and one
``continuous_train`` iteration by stage (graph composition, then inside
``embedded_step``: ``bank_nll``, K11, ``viterbi_backtrace``, the
statistics GEMMs, the M-step), with CUDA events around the calls the
training code makes.  K14 (the MFCC-39 tail) is held to its plain version on
K12's cepstra (deltas bit-identical, standardized features at rtol 1e-4
/ atol 1e-4: the mean and variance summed in another order).  K13 (the
emission kernel) is held to its plain version at rtol 1e-5 / atol 1e-4,
and K1's DP alone to its plain version bit for
bit on K13's emissions.  Past the old size limits: K1 + K2 and K10 on a
1,500-word loop graph (7,500 states) and K8 + K9 on a 2,000-word loop of
2-5-state words (7,000 states), K3 at 64 x 25 s (2,499 frames), K11 at
one state past its shared-memory frontier.  K8 and K9 are held bit-identical to their plain versions at
512 x 500 on the 7-slot sausage of 1-state words (77 states, eps depth
6) and on a 7-slot sausage of words of 3 to 6 states, with uniform and
tie-forcing integer emissions; K10's DP (final, eps_u, eps_tau,
final_tau) bit-identical to its plain DP on K13's own plane at 512 x 500
on the 385-state sausage with a random bank and with a bank whose last 5
words copy the first 5 (exact ties), its final costs within rtol 1e-5 of
the whole plain version and of K1's.  K11 is held bit-identical to its plain version (final
costs and every frame of both planes) at the isolated shape (512 x 500 x
11 models of 5 states, with and without planes), on the 385-state
sausage at 64 x 500 (eps depth 1), on 256 padded transcript graphs and
on a batch of integer (tie-forcing) emissions and costs with lengths 0,
1 and T, and in every form its plan ``dense_plan`` picks (packed,
cluster, item, wide; S from 1 to 477 over the plan's boundaries, shared
and per-item matrices, eps depth 1-3, tie batches, lengths 0, 1 and T,
planes on and off; the scratch form at 11,623 states); K12 within rtol
2e-3 / atol 5e-4 of its plain version at 256 x 5 s.  K4 and K5 are also held against their plain versions on the
1,000-word benchmark trie (128 x 500), on the same trie with a random
eps block, on a flat 100-word vocabulary with bigram costs (more roots
than one re-entry pass takes), and on a dictionary-shaped ~87k-state
trie (32 x 500), on the 1k trie with one state's band perturbed (the
general mode), and on a trie over 8,000 bank rows (16 x 500), whose two
per-frame row tables pass shared memory (the plan without row tables);
K5 (one warp per stream, windows of frames x the chain of states its
walk can reach) is timed on the 1k and the dictionary-shaped tries with
its clock64 trace, beside its serial floor; K6 and K7 on the 1,000-word trie (128 x 500) and the
dictionary-shaped trie (16 x 500), with uniform-random and planted-word
emissions, the backoff and the dense LM, and K6 in the general mode; K7
also in every plan ``rescore_plan`` can give (staged with its LM tables on
chip or through L1, direct with its D rows in shared memory or in device
memory) on both tries.  K2 (one warp per stream, windows of frames x
reachable states) is also held to its plain version at B = 500 (not a
multiple of 16) and, after K1, on the 1,500-word loop; K1 then K2 is
timed as one number beside K2 alone, and so is K8 then K9 beside K8; K9
also at B = 500.  K9's and K11's clock64 traces give their cycles by
phase (K9: windows and walks per stream; K11: the packed form's frame
step, the cluster form's scans, publishing and cluster barriers).
K4 and K6 run the plan ``lex_plan`` picks (frontier and tables in shared
memory on the 1k trie, in device memory on the dictionary-shaped trie);
their cycles per frame step by phase come from the kernel's trace.
K15 (the banded forward-backward) is held to its plain version on the
loop graph, on the 385-state sausage at 256 x 500 (lengths T, 1, 0 and
mixed), on a sausage of 1-state words (eps depth 4), on the 1k trie's
lexgraph (cross edges, -inf end scores), on 419 padded per-item
banded transcript graphs and at the confidence path's own call; K16 (the dense one) at 419 x 319 on transcript
graphs in both xi modes, at the soft-EM path's own call and on a
170-state loop past its shared-memory tier (log Z at rtol 1e-5, gamma at
atol 1e-4, xi at rtol 1e-4 / atol 1e-3); one soft iteration is timed by
stage like the hard one, K15 and K16 alone beside their plain versions
and their bounds (bytes, f32 operations and the SFU's exps and logs),
and K15 against K16 on padded transcript graphs of 30-400 states (the
crossover ``models.graph.BANDED_FB_MIN_STATES`` is set from).
Every kernel, its plain version, the 256 x 5 s connected pipeline and
the 128 x 5 s lexical-tree and bigram-lattice pipelines are timed with
CUDA events, K13 and K10 also with torch.profiler's device time (and
torch.matmul of K13's product alone as a yardstick), and each kernel's
least possible time on the card (its bound) is computed from the bytes
and operations of this run's inputs (``utils/roofline.py``).  Past the
old size limits, K13 at 512 and 1,024 feature dimensions (its chunked
form), K15 on a 30,000-state loop and K16 on a 19,500-state loop (their
device-row tier) are held to their plain versions and timed.

Section 8 (the counterpart of ``__graft_entry__.dryrun_multichip``)
spawns one NCCL rank per visible card and holds the sharded paths of
``parallel/`` to the single-process results on card 0: the hard and soft
training steps, the state-sharded banded Viterbi (bit for bit), the
classifier and a data-sharded bigram decode; their launches count
toward the kernels' totals.

Run from the repository root with one GPU:  python3 chip_smoke.py
(``--parallel``: the build and section 8 alone, on every visible card)

The last three lines of stdout are the kernels JSON, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
Any failure raises and exits nonzero; without CUDA, or outside the
repository, it exits nonzero before printing a result.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))

K3_TOL = dict(rtol=2e-3, atol=5e-4)  # f32 spectral chains, different sum orders
K1_RTOL = 1e-5  # emission GEMM summation order
K13_TOL = dict(rtol=1e-5, atol=1e-4)  # 79-term f32 dot products, another order
# K4 / K5 / K6 / K7 take the plain version's own inputs: everything is
# compared bit for bit
# K15 / K16 against their plain versions: the same IEEE expf / logf on both
# sides; only sums over frames (xi) and over a row's origins (K16) run in
# other orders (measured: log Z equal, gamma within 4e-14, xi within 4e-6
# of itself on an H100)
FB_TOL = {"log_z_rtol": 1e-5, "gamma_atol": 1e-4}
FB_XI_TOL = {"rtol": 1e-4, "atol": 1e-3}
# word confidences of connected_test --confidence, cuda against cpu: the
# two devices' features differ within K3_TOL, and a posterior exp(alpha +
# beta - log Z) carries float32 rounding of |log Z| (~1e4 here: an ulp of
# 1e-3); the JAX CLI's own float32 confidences are 9.6e-3 from float64 on
# the CPU test corpus (scripts/exp_r13_float32_noise.py)
CONF_ATOL = 1e-2
# K24 / K25 (the k-means and EM fits) against their plain versions: the
# same quadratic-form NLL and M-step, sums over up to ~8,000 frames in
# another order (the plain GEMMs' blocking against the kernels' blocked
# Kahan sums); whole fits at GMM_TOL, one iteration at GMM_STEP_TOL;
# assignments, counts and iteration counts exactly
GMM_TOL = dict(rtol=1e-4, atol=1e-4)
GMM_STEP_TOL = dict(rtol=1e-5, atol=2e-5)
# ... and at 3,000 feature dimensions (24,000 parameters, the float32 plain
# version itself up to ~2.3e-5 off float64 in a variance), one iteration
# as accurate as the plain version: the kernel's largest difference from
# the plain version run in float64 on the same inputs at most
# GMM_AS_ACCURATE times the float32 plain version's (gmm_f64_errors)
GMM_AS_ACCURATE = 2.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one
    warm-up run, in ms (``utils.profiling.timed``)."""
    from speech_recognition_tpu_torch.utils.profiling import timed

    return timed(fn, warmup=1, iters=reps)[0] * 1e3


def queued_ms(fn, reps: int = 10) -> float:
    """Device ms per call of ``fn()`` from CUDA events alone: a sleep
    kernel holds the stream while the host enqueues ``reps`` calls
    between two events, so the events' distance is the device's time for
    the calls (the gaps between their launches included), not the
    host's.  The least of three readings, after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # ~20 ms: longer than the calls' enqueue
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


# The streaming figures before the chunk kernels' warp form and cached
# launch tables (PERF.md §6, the K17 / K18 rows' earlier times; NVIDIA H100
# 80GB HBM3, 700 W), printed beside this run's in 7b.
STREAM_PARENT = {"K17": 0.625, "K17 DP": 0.492, "K17 DP device": 0.143, "K18": 0.435,
                 "K18 device": 0.332, "push": 0.900, "idle": 0.779, "rate": 110486}


# The kernel wrappers whose launch counts device_ms holds the profiler's
# trace to, each with the kernels one counted launch starts (K15 and K16:
# a scan and a combine); filled in main() once the port is importable.
COUNTED = []
DEVICE_READINGS = {"readings": 0, "rerun": 0, "failed": []}


def kernel_names() -> list:
    """The names of the port's ``__global__`` functions, from the sources."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join(HERE, "speech_recognition_tpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(", f.read()))
    return sorted(names)


def device_ms(fn, reps: int = 5, what: str = "a timed call") -> float:
    """Mean device time per call of ``fn()`` (ms): the kernels it launches,
    summed, from torch.profiler's CUPTI trace, after one warm-up run.

    A profiler window can lose kernels from its trace (seen as device
    times below event times).  So each reading counts the port's kernels
    the trace holds against the launches the wrappers counted in the
    window; short sleep kernels on both sides of the counted calls keep
    them off the window's edges and are left out of the sum.  Where the
    trace holds fewer of the port's kernels (or no device time at all),
    the window runs again; after three short windows the reading fails:
    it is NaN ("not measured"), never a low time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    pat = re.compile(r"\b(" + "|".join(kernel_names()) + r")\b")

    def pad():
        for _ in range(3):
            torch.cuda._sleep(2000)
        torch.cuda.synchronize()

    DEVICE_READINGS["readings"] += 1
    for attempt in range(3):
        # a warm-up step first: its events are discarded, and the tracer is
        # running before the counted window starts
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            pad()
            prof.step()
            pad()
            before = sum(w.launches * k for w, k in COUNTED)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            launched = sum(w.launches * k for w, k in COUNTED) - before
            pad()
            prof.step()
        events = [e for e in prof.key_averages() if "spin_kernel" not in e.key]
        seen = sum(e.count for e in events if pat.search(e.key))
        total = sum(e.self_device_time_total for e in events)
        if total > 0 and seen >= launched:
            return total / reps / 1e3
        DEVICE_READINGS["rerun"] += 1
        print(f"chip_smoke: device_ms of {what}: the trace holds {seen} of {launched} kernel "
              f"launches (device time {total / 1e3:.3f} ms); run {attempt + 1} of 3",
              file=sys.stderr)
    DEVICE_READINGS["failed"].append(what)
    return float("nan")


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Record the arguments of every call of ``module.name`` (a kernel
    wrapper as a training module calls it) while the block runs."""
    orig = getattr(module, name)

    def rec(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def random_bank(n_states: int, seed: int = 0, dup: int = 0, n_models: int = 11):
    """``n_models`` models x ``n_states`` states x 4 mixtures x 39 dims from
    the port's ``random_gmm_hmm`` (seed 0 and 5 states: as the reference
    bench builds its bank).  With ``dup`` the last ``dup`` models copy the
    first ones, so paths through a model and its copy tie exactly."""
    import numpy as np

    from speech_recognition_tpu_torch.data.synthetic import random_gmm_hmm
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

    rng = np.random.default_rng(seed)
    ps = [random_gmm_hmm(rng, n_states=n_states, n_mix=4, dim=39, sep=3.0)
          for _ in range(n_models - dup)]
    ps += ps[:dup]
    return HMMBank.from_numpy(
        np.stack([p["means"] for p in ps]),
        np.log(np.stack([p["variances"] for p in ps])),
        np.log(np.stack([p["weights"] for p in ps])),
        np.stack([to_cost_matrix(p["trans"]) for p in ps]))


def make_bank(tmp: str, n_states: int = 5, name: str = "bank.npz", n_models: int = 11,
              meta=None):
    """``random_bank(n_states, n_models=n_models)`` round-tripped through
    the port's npz checkpoint with ``meta``."""
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank, save_bank

    bank = random_bank(n_states, n_models=n_models)
    path = os.path.join(tmp, name)
    save_bank(path, bank, {"norm": "utterance", **(meta or {})})
    loaded, meta = load_bank(path)
    for f in ("means", "log_vars", "log_weights", "trans_cost"):
        if not bool((getattr(loaded, f) == getattr(bank, f)).all()):
            fail(f"bank npz round trip changed {f}")
    return loaded, path


def check_lex(name, lexg, g, nll, nf):
    """K4 against ``viterbi_lex_ref`` (final, bp8, eps_u, eps_prev
    bit-identical on valid frames), K5 on K4's planes against
    ``lex_backtrace_val_ref`` on the plain planes, and the words read off
    both paths.  Returns ``(k4 max |d|, k5 max |d|, planes of the plain
    version, best end states)``."""
    import torch

    from speech_recognition_tpu_torch.models.lexgraph import lex_words_from_path_batch
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    g = lexg.banded.to(nll.device) if g is None else g
    topo = lk.lex_topology(g)
    got = lk.viterbi_lex(nll, g, topo, nf)
    want = lk.viterbi_lex_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        fail(f"K4 final costs differ from the plain version on {name}: "
             f"max |d| {float((got[0] - want[0]).abs().max())}")
    t_len = nll.shape[1]
    valid = torch.arange(t_len, device=nll.device)[:, None] < nf[None, :]  # [T, B]
    for k, plane in ((1, "bp8"), (2, "eps_u"), (3, "eps_prev")):
        if not bool(((got[k] == want[k]) | ~valid[:, :, None]).all()):
            fail(f"K4 {plane} differs from the plain version on {name}")
    ends = g.end_states[torch.argmin(want[0][:, g.end_states] + g.end_bonus, 1)]
    sk, fk = lk.lex_backtrace_val(got[1], got[3], g, ends, nf, topo=topo)
    sp, fp = lk.lex_backtrace_val_ref(want[1], want[3], g, ends, nf)
    torch.cuda.synchronize()
    if not bool(((sk == sp) & (fk == fp) | ~valid).all()):
        fail(f"K5 (on K4's planes) differs from the plain versions on {name}")
    host = [(s.T.cpu().numpy(), f.T.cpu().numpy()) for s, f in ((sk, fk), (sp, fp))]
    nf_h = nf.cpu().numpy()
    wk, wp = (lex_words_from_path_batch(lexg, s, nf_h, f) for s, f in host)
    if wk != wp:
        fail(f"words differ between the kernels and the plain versions on {name}")
    k5_err = float(((sk - sp).abs() * valid).max())
    phase("K4+K5", f"{name} ({g.n_states} states, R={g.n_words}, L={g.n_ends}; "
                   f"{plan_text(topo, False)}) at {nll.shape[2]}x{t_len}: final, bp8, eps_u, "
                   f"eps_prev == plain (bit-identical); K5 states, "
                   f"flags and words identical; mean words/utt "
                   f"{sum(map(len, wk)) / len(wk):.2f}")
    return float((got[0] - want[0]).abs().max()), k5_err, want, ends


def plan_text(topo, lattice: bool) -> str:
    """Where the K4 (K6 with ``lattice``) plan for ``topo`` keeps the
    frontier, the tables and the eps block, and the graph's band mode."""
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_plan
    from speech_recognition_tpu_torch.utils.build import load_library

    plan = lex_plan(lattice, topo, load_library().srt_smem_limit())
    where = {True: "shared", False: "device"}
    rows = f"{plan.rep} copies of each bank row" if plan.rep else "no row tables"
    return (f"frontier {where[plan.front]}, tables {where[plan.tables]}, eps "
            f"{where[plan.eps]}{', leaf ends gathered' if plan.gather else ''}, {rows}, "
            f"{'factorised' if topo.pack.factorised else 'general'} band"
            f"{', wide records' if topo.pack.wide else ''}, {plan.smem} B shared")


def perturbed_band(g):
    """A copy of a trie whose band no longer factorises over bank rows
    (one state's step cost moved by 0.125): the kernels' general mode."""
    import torch

    band = g.band.clone()
    band[1, int(torch.nonzero(band[1] < 1e29)[50])] += 0.125
    return g._replace(band=band)


def check_rescore_and_walk(name, args, kw, max_dur, max_words, plan=None, want=None):
    """The pipeline's K7 launch (``rescore_and_walk``) on ``args`` (K6's
    planes, start / end costs, lengths, dmax) against its plain version
    (``want``, its outputs on the same arguments, where already made):
    the q it computed against ``ends_cost.amin(2)``, each stream's
    truncation count, cost, best leaf, pred_w at t < nf, the walk's
    leaves and word counts, all bit for bit.  Returns ``(its outputs,
    the plain version's)``."""
    import torch

    from speech_recognition_tpu_torch.ops import lattice_kernels as lt

    ec, et, nf = args[0], args[1], args[4]
    q_k = torch.empty(ec.shape[:2], dtype=torch.float32, device=ec.device)
    got = lt.rescore_and_walk(*args, max_dur, max_words, **kw, plan=plan, q_out=q_k)
    if want is None:
        want = lt.rescore_and_walk_ref(*args, max_dur, max_words, **kw)
    q_p = ec.amin(2)
    torch.cuda.synchronize()
    valid = torch.arange(ec.shape[0], device=ec.device)[:, None, None] < nf[None, :, None]
    if not torch.equal(q_k.view(torch.int32), q_p.view(torch.int32)):
        fail(f"K7's own q differs from ends_cost.amin(2) on {name}")
    for i, part in ((0, "cost"), (1, "best leaf"), (3, "truncation counts"),
                    (4, "walk's leaves"), (5, "walk's word counts")):
        if not torch.equal(got[i], want[i]):
            fail(f"rescore_and_walk's {part} differ from the plain version on {name} "
                 f"({'plan ' + plan.mode if plan else 'its plan'})")
    if not bool(((got[2] == want[2]) | ~valid).all()):
        fail(f"rescore_and_walk's pred_w differs from the plain version on {name}")
    return got, want


def check_lattice(name, lexg, g, nll, nf, lm_l, max_dur=128):
    """K6 against ``viterbi_lattice_ref`` (final, ends_cost and ends_tau
    bit-identical in every frame, frozen ones included), K7 on K6's
    planes against ``rescore_lattice_ref`` (cost and best leaf
    bit-identical, pred_w at t < nf), the pipeline's K7 launch
    (``check_rescore_and_walk``), and the words all walks read.  Returns
    ``(words, K6 max |d| of ends_cost, K7 max |d| of cost, K22's
    arguments with its max_words)``."""
    import torch

    from speech_recognition_tpu_torch.ops import lattice as lat
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops.viterbi_lex_kernels import lex_topology

    topo = lex_topology(g)
    got = lt.viterbi_lattice(nll, g, topo, nf)
    want = lt.viterbi_lattice_ref(nll, g, topo, nf)
    torch.cuda.synchronize()
    for k, plane in enumerate(("final", "ends_cost", "ends_tau")):
        if not torch.equal(got[k], want[k]):
            fail(f"K6 {plane} differs from the plain version on {name}")
    start_l, end_l, big, bo = lm_l
    t_len = nll.shape[1]
    args = (got[1], got[2], got[1].amin(2), start_l, end_l, nf,
            lat._ring_depth(t_len, max_dur))
    kw = dict(big_ll=big, backoff=bo)
    rk = lt.rescore_lattice(*args, **kw)
    rp = lt.rescore_lattice_ref(*args, **kw)
    torch.cuda.synchronize()
    valid = torch.arange(t_len, device=nll.device)[:, None, None] < nf[None, :, None]
    if not (torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1])):
        fail(f"K7 cost / best leaf differ from the plain version on {name}: max |d| "
             f"{float((rk[0] - rp[0]).abs().max())}")
    if not bool(((rk[2] == rp[2]) | ~valid).all()):
        fail(f"K7 pred_w differs from the plain version on {name}")
    su = lexg.n_states // lexg.n_arcs
    mw = min(t_len, t_len // su + 1)
    walks = [lat.lattice_words_device(r[2].transpose(1, 2), got[2].transpose(1, 2), r[1],
                                      nf, max_words=mw) for r in (rk, rp)]
    rw = check_rescore_and_walk(name, (got[1], got[2], start_l, end_l, nf, args[-1]), kw,
                                max_dur, mw)[0]
    walks.append(rw[4:])
    n_trunc = int(rw[3].sum())
    if n_trunc != int(lat._lattice_truncation_count(got[1].transpose(1, 2),
                                                    got[2].transpose(1, 2), nf, max_dur)):
        fail(f"rescore_and_walk's truncation counts do not sum to the count on {name}")
    # K22 against its plain version on K7's planes (the [T, L, B] views of
    # [T, B, L]): at the decode's max_words and one word short of the
    # longest chain
    k22_args = (rk[2].transpose(1, 2), got[2].transpose(1, 2), rk[1], nf)
    cut = max(int(walks[0][1].max()) - 1, 1)
    for mw_ in (mw, cut):
        k22 = lat.lattice_words_device(*k22_args, max_words=mw_)
        p22 = lat.lattice_words_ref(*k22_args, max_words=mw_)
        torch.cuda.synchronize()
        if not (torch.equal(k22[0], p22[0]) and torch.equal(k22[1], p22[1])):
            fail(f"K22 differs from lattice_words_ref on {name} at max_words {mw_}")
    lw = lexg.leaf_word
    words = []
    for lr, nw in walks:
        lr, nw = lr.cpu().numpy(), nw.cpu().numpy()
        words.append([lw[lr[: nw[i], i][::-1]].tolist() for i in range(lr.shape[1])])
    if not words[0] == words[1] == words[2]:
        fail(f"words differ between K7, its plain version and rescore_and_walk on {name}")
    live = float((got[1] < 1e29).float().mean())
    phase("K6+K7", f"{name} ({g.n_states} states, L={g.n_ends}; {plan_text(topo, True)}, "
                   f"{'dense' if big is not None else 'backoff'} LM) at "
                   f"{nll.shape[2]}x{t_len}: K6 planes == plain (bit-identical, frozen "
                   f"frames included); K7 cost, best leaf, pred_w == plain; rescore_and_walk "
                   f"(q, {n_trunc} truncated arcs, DP, walk) == plain; words identical; K22 "
                   f"== plain at max_words {mw} and {cut} (the longest chain cut); live arcs "
                   f"{live:.3f}; mean words/utt "
                   f"{sum(map(len, words[0])) / len(words[0]):.2f}")
    return (words[0], float((got[1] - want[1]).abs().max()),
            float((rk[0] - rp[0]).abs().max()), (*k22_args, mw))


def make_lex_pipeline(dev, batch=128, samples=80000):
    """``bench.py`` ``bench_lex_pipeline``'s setup: an 8-unit bank (3
    states, 4 mixtures, 39 dims; seed 7), the 1,000-word trie over it,
    and ``batch`` random 5 s signals."""
    import numpy as np
    import torch

    from speech_recognition_tpu_torch.data.lexicon import random_words
    from speech_recognition_tpu_torch.data.synthetic import random_gmm_hmm
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops.frontend import FrontendConfig, padded_length
    from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

    units = list("abcdefgh")
    rng = np.random.default_rng(7)
    ps = [random_gmm_hmm(rng, n_states=3, n_mix=4, dim=39, sep=4.0) for _ in units]
    bank = HMMBank.from_numpy(
        np.stack([p["means"] for p in ps]), np.log(np.stack([p["variances"] for p in ps])),
        np.log(np.stack([p["weights"] for p in ps])),
        np.stack([to_cost_matrix(p["trans"]) for p in ps])).to(dev)
    words = random_words(rng, units, 1000, 3, 8)
    lexg = build_lex_graph(words, [p["trans"] for p in ps],
                           {c: i for i, c in enumerate(units)}, word_insertion_cost=0.5)
    cfg = FrontendConfig()
    L = ((padded_length(cfg, samples) + 159) // 160 + 8) * 160
    sig = torch.from_numpy((rng.standard_normal((batch, L)) * 3000).astype(np.float32)).to(dev)
    lens = torch.full((batch,), samples, dtype=torch.int32, device=dev)
    return bank, lexg, cfg, sig, lens


def planted_features(bank, b: int, t_len: int, rng, units=None, dwell=(2, 5), noise=0.3):
    """``([B, T, D] features, n_frames [B])`` on the bank's device that
    walk random unit sequences (``units``: lists of bank models to draw
    from; default single models) through a few frames at each state's
    first-mixture mean plus noise, each stream up to ``t_len`` frames:
    speech-like input whose paths become immortal as real audio's do."""
    import numpy as np
    import torch

    means = bank.means.cpu().numpy()[:, :, 0, :]  # [N, S, D]
    n_models, n_states, d = means.shape
    x = np.zeros((b, t_len, d), np.float32)
    nf = np.zeros(b, np.int32)
    for i in range(b):
        rows = []
        while True:
            seq = units[int(rng.integers(len(units)))] if units else [int(rng.integers(n_models))]
            r = [means[u, s] for u in seq for s in range(n_states)
                 for _ in range(int(rng.integers(*dwell)))]
            if len(rows) + len(r) > t_len:
                break
            rows += r
        x[i, : len(rows)] = np.asarray(rows) + noise * rng.standard_normal((len(rows), d))
        nf[i] = len(rows)
    dev = bank.means.device
    return torch.from_numpy(x).to(dev), torch.from_numpy(nf).to(dev)


def hold_chunks(name, launch, plain, frontier, nf, t_len: int, chunk: int, batch_axis: int):
    """A chunk kernel (K17 or K18) against its plain version, chunk by
    chunk from the kernel's own carry: ``launch`` and ``plain`` take
    ``(t0, c, frontier, n_valid, first)``; every output must be
    bit-identical and a frozen stream's carry unchanged.  Returns the
    kernel's outputs per chunk."""
    import torch

    outs = []
    for t0 in range(0, t_len, chunk):
        c = min(chunk, t_len - t0)
        nv = (nf - t0).clamp(0, c).to(torch.int32)
        got = launch(t0, c, frontier, nv, t0 == 0)
        want = plain(t0, c, frontier, nv, t0 == 0)
        torch.cuda.synchronize()
        for k, (a, b_) in enumerate(zip(got, want)):
            if (a is None) != (b_ is None) or (a is not None and not torch.equal(a, b_)):
                fail(f"{name}: output {k} of the chunk at frame {t0} differs from the plain "
                     f"version")
        frozen = torch.nonzero(nv == 0)[:, 0]
        if not torch.equal(got[0].index_select(batch_axis, frozen),
                           frontier.index_select(batch_axis, frozen)):
            fail(f"{name}: a frozen stream's carry moved in the chunk at frame {t0}")
        outs.append(got)
        frontier = got[0]
    return outs


def stream_lines(out: str) -> dict:
    """``{file: (words, emitted counts or None, cost)}`` from ``cli stream``."""
    import re

    got = {}
    for line in out.splitlines():
        m = re.match(r"(\S+): (\[.*\]) \((?:(\d+/\d+) words emitted mid-stream, )?"
                     r"cost (\S+)\)$", line)
        if m:
            got[m.group(1)] = (m.group(2), m.group(3), float(m.group(4)))
    return got


def planted_fits(seed: int, sizes, dev, d: int = 39, k: int = 4, n_pad: int = 64,
                 sep: float = 3.0):
    """One frame buffer and a fit a size in ``sizes`` for K24 / K25: each
    fit's frames drawn from its own ``k`` well-separated Gaussians
    (unit-scale variances), the fits' frames interleaved, ``n_pad`` frames
    in no fit, starts near the planted centres.  Returns CUDA tensors
    ``(x [N, d], masks [F, N], centroids0 [F, k, d], init [F, N])``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = sum(sizes) + n_pad
    owner = rng.permutation(np.repeat(np.arange(len(sizes) + 1), list(sizes) + [n_pad]))
    x = rng.standard_normal((n, d)).astype(np.float32)
    masks = np.stack([owner == i for i in range(len(sizes))])
    c0 = np.zeros((len(sizes), k, d), np.float32)
    for i in range(len(sizes)):
        centres = sep * rng.standard_normal((k, d))
        scale = rng.uniform(0.5, 1.5, (k, d))
        lab = rng.integers(0, k, n)
        x[masks[i]] = (centres[lab] + scale[lab] * rng.standard_normal((n, d)))[masks[i]]
        c0[i] = centres + 0.3 * rng.standard_normal((k, d))
    init = rng.integers(0, k, (len(sizes), n))
    return tuple(torch.from_numpy(a).to(dev) for a in (x, masks, c0, init))


def gmm_f64_errors(kernel, plain, args, kw, close):
    """K24's or K25's ``kernel`` and its float32 ``plain`` version against
    ``plain`` in float64 on the same inputs (``args``' float tensors
    upcast).  Returns, for each output index in ``close``, the pair
    (kernel's largest difference, plain's), and whether every other output
    equals the float64 run's."""
    import torch

    args64 = tuple(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                   for a in args)
    got, ref, truth = kernel(*args, **kw), plain(*args, **kw), plain(*args64, **kw)
    errs, exact = [], True
    for j, (a, b, t) in enumerate(zip(got, ref, truth)):
        t = t.to(a.device)
        if j in close:
            errs.append((float((a.double() - t).abs().max()),
                         float((b.to(a.device).double() - t).abs().max())))
        else:
            exact = exact and torch.equal(a, t.to(a.dtype))
    return errs, exact


def token_beam_agrees(tag: str, got, want, walk, want_walk) -> int:
    """Fail unless K19's outputs ``got`` equal the plain version's
    ``want`` on every live slot (state >= 0) of the final frontier and the
    token planes, with -1 (final cost POS_INF) on the dead slots, and
    K26's ``walk`` the plain walk's costs, and its words on every stream
    whose best token ends a word.  Returns the count of such streams."""
    import torch

    live_f = want[0] >= 0
    if not torch.equal(got[0] >= 0, live_f) or not all(
            torch.equal(g_[live_f], w_[live_f]) for g_, w_ in zip(got[:3], want[:3])) or \
            not bool((got[1][~live_f] == 1e30).all()):
        fail(f"{tag}: the final frontier differs from the plain version's on live slots")
    live = want[3] >= 0
    if not torch.equal(got[3] >= 0, live) or not all(
            torch.equal(g_[live], w_[live]) and bool((g_[~live] == -1).all())
            for g_, w_ in zip(got[3:], want[3:])):
        fail(f"{tag}: the token planes differ from the plain version's on live slots")
    found = want_walk[0] < 5e29
    if not torch.equal(walk[0], want_walk[0]) or \
            not torch.equal(walk[1][found], want_walk[1][found]):
        fail(f"{tag}: K26's costs or words differ from the plain walk's")
    return int(found.sum())


def kernel_counters() -> tuple:
    """Every kernel wrapper of the port, each counting its launches in
    ``<wrapper>.launches``."""
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fbk
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk
    from speech_recognition_tpu_torch.ops.beam import beam_backtrace, beam_search
    from speech_recognition_tpu_torch.ops.frontend_kernel import (
        mfcc39_fused,
        mfcc_fused,
        mfcc_tail,
    )
    from speech_recognition_tpu_torch.ops.viterbi_kernels import dense_backtrace, viterbi_dense
    from speech_recognition_tpu_torch.train.em import em_fit_batch
    from speech_recognition_tpu_torch.train.kmeans import kmeans_batch

    return (mfcc39_fused, mfcc_tail, vk.bank_emission, vk.viterbi_banded_fused,
            vk.banded_backtrace_val,
            lk.viterbi_lex, lk.lex_backtrace_val, lt.viterbi_lattice, lt.rescore_lattice,
            vk.viterbi_banded_general, vk.banded_backtrace_general,
            vk.viterbi_banded_wordtrace, viterbi_dense, mfcc_fused, fbk.fb_banded,
            fbk.fb_dense, vk.viterbi_banded_chunk, lk.viterbi_lex_chunk, dense_backtrace,
            lt.lattice_walk, vk.wordtrace_words_device, lt.rescore_and_walk, kmeans_batch,
            em_fit_batch, beam_search, beam_backtrace)


# ---- section 8: the sharded paths, one NCCL rank per card ---------------------
# The counterpart of __graft_entry__.dryrun_multichip: the sharded hard and
# soft training steps on its shapes (a (world/2, 2) grid with 12 models when
# the world is even, else (world, 1) with 11), the state-sharded banded
# Viterbi on a (1, world) line, the data-sharded classifier and bigram
# decode on a (world, 1) mesh.  The parent builds the inputs and the
# single-process results on card 0; each rank loads the inputs, runs the
# paths with its launch counters reset before each (their launches count
# toward the kernels' totals) and times them; the parent compares.

PAR_TRAIN = {"hard step (K11)": ("g_hard", False), "soft step, dense dict (K16)":
             ("g_dense", True), "soft step, banded dict (K15)": ("g_band", True)}
PAR_BEAMS = (0, 8)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def parallel_rank(rank: int, world: int, workdir: str, port: int) -> None:
    """One NCCL rank of section 8 (``torch.multiprocessing.spawn``'s
    target): writes ``rank_<rank>.pt`` with its outputs, launch counts,
    times and collectives per frame."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from speech_recognition_tpu_torch import parallel
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.ops.lattice import decode_lextree_bigram
    from speech_recognition_tpu_torch.parallel.sharded_decode import (
        gather_planes,
        make_sharded_banded_viterbi,
        pad_banded_for_sharding,
        state_slice,
    )
    from speech_recognition_tpu_torch.utils.build import load_library
    from speech_recognition_tpu_torch.utils.numerics import POS_INF

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    load_library()
    parallel.init_distributed(backend="nccl", init_method=f"tcp://localhost:{port}",
                              rank=rank, world_size=world)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    counters = kernel_counters()
    out = {"launches": {c.__name__: 0 for c in counters}, "ms": {}, "collectives": {},
           "train": {}, "decode": {}}

    def counted(fn):
        for c in counters:
            c.launches = 0
        res = fn()
        torch.cuda.synchronize()
        for c in counters:
            out["launches"][c.__name__] += c.launches
        return res

    def ms_of(name, fn):
        dist.barrier()
        out["ms"][name] = cuda_ms(fn)

    grid_shape = inp["grid"]
    shard = grid_shape[1] > 1
    grid = parallel.make_mesh(grid_shape)
    bank = HMMBank(*inp["train_bank"])
    for name, (gkey, soft) in PAR_TRAIN.items():
        step = parallel.make_sharded_embedded_step(grid, eps_depth=inp["depth"],
                                                   shard_models=shard, soft=soft)
        args = parallel.shard_embedded_inputs(grid, bank, inp["feats"], inp["nf"], inp[gkey],
                                              shard_models=shard)
        new, stats = counted(lambda: step(*args))
        out["train"][name] = ([x.cpu() for x in (new.means, new.log_vars, new.log_weights,
                                                  new.trans_cost)], float(stats.total_cost))
        ms_of(name, lambda: step(*args))
    line = parallel.make_mesh((1, world))
    for name, (g, nll_tb, nf, depth) in inp["decode"].items():
        gp, s = pad_banded_for_sharding(g.to(dev), world)
        pad = torch.full((nll_tb.shape[0], gp.n_states - s, nll_tb.shape[2]), POS_INF)
        local = torch.cat([nll_tb, pad], 1)[:, state_slice(line, gp.n_states)].to(dev)
        nf = nf.to(dev)
        for beam in PAR_BEAMS:
            run = make_sharded_banded_viterbi(line, gp, depth, beam_width=beam)
            fin, bp8, eps_u = counted(lambda: run(local, nf))
            fin, bp8 = gather_planes(line, fin, bp8)
            out["decode"][name, beam] = (fin[:s].cpu(), bp8[:, :s].cpu(), eps_u.cpu())
            out["collectives"][name, beam] = run.collectives_per_frame
            ms_of(f"decode {name}, k = {beam}", lambda: run(local, nf))
    data = parallel.make_mesh((world, 1))
    classify = parallel.make_sharded_classifier(data)
    cbank = parallel.bank_shard(data, HMMBank(*inp["cls_bank"]))
    cx, cn = (parallel.batch_shard(data, inp[k]) for k in ("cls_feats", "cls_nf"))
    out["classify"] = counted(lambda: classify(cbank, cx, cn))[0].cpu()
    ms_of("classifier", lambda: classify(cbank, cx, cn))
    ubank = parallel.bank_shard(data, HMMBank(*inp["lex_bank"]))
    lx, ln = (parallel.batch_shard(data, inp[k]) for k in ("lex_feats", "lex_nf"))
    words = counted(lambda: decode_lextree_bigram(ubank, inp["lexg"], inp["lm"], lx, ln))[0]
    parts = [None] * world
    dist.all_gather_object(parts, words, group=data.get_group("data"))
    out["bigram"] = [w for part in parts for w in part]
    ms_of("bigram decode", lambda: decode_lextree_bigram(ubank, inp["lexg"], inp["lm"], lx,
                                                         ln))
    torch.save(out, os.path.join(workdir, f"rank_{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def parallel_section(dev, tmp: str, card: str) -> dict:
    """Section 8: builds the inputs and the single-process results on
    ``dev``, spawns one NCCL rank per card, holds every rank's outputs to
    the single-process ones and prints the times.  Returns the ranks'
    launch counts, summed."""
    import numpy as np
    import torch

    from speech_recognition_tpu_torch.data.synthetic import random_gmm_hmm
    from speech_recognition_tpu_torch.decode.connected import connected_graph_arrays
    from speech_recognition_tpu_torch.decode.isolated import classify_batch
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.models.graph import (
        build_word_graph,
        pad_graphs,
        pad_graphs_banded,
    )
    from speech_recognition_tpu_torch.models.hmm import HMMBank, bank_nll_ubt
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.frontend import mfcc39_auto
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.lattice import decode_lextree_bigram
    from speech_recognition_tpu_torch.ops.viterbi_banded import banded_arrays, viterbi_banded_tb
    from speech_recognition_tpu_torch.train.embedded_step import (
        embedded_step,
        embedded_step_soft,
    )
    from speech_recognition_tpu_torch.utils.numerics import to_cost_matrix

    world = torch.cuda.device_count()
    grid = (world // 2, 2) if world % 2 == 0 else (world, 1)
    n_models = 12 if grid[1] > 1 else 11
    rng = np.random.default_rng(0)
    # dryrun_multichip's training shapes: 5 states x 2 mixtures x 16 dims,
    # 2 utterances a data rank of 64 frames, 3-word transcripts
    ps = [random_gmm_hmm(rng, n_states=5, n_mix=2, dim=16, sep=3.0) for _ in range(n_models)]
    tbank = HMMBank.from_numpy(np.stack([p["means"] for p in ps]),
                               np.log(np.stack([p["variances"] for p in ps])),
                               np.log(np.stack([p["weights"] for p in ps])),
                               np.stack([to_cost_matrix(p["trans"]) for p in ps]))
    trans_np = [tbank.trans_cost[i].numpy() for i in range(n_models)]
    b_tr, t_tr = grid[0] * 2, 64
    labels = [[int(rng.integers(0, n_models)) for _ in range(3)] for _ in range(b_tr)]
    graphs = [build_word_graph(trans_np, [[w_] for w_ in ls]) for ls in labels]
    dense, depth = pad_graphs(graphs)
    banded, depth_b = pad_graphs_banded(graphs)
    if depth_b != depth:
        fail(f"the banded dict's eps depth {depth_b} is not the dense one's {depth}")
    gt = lambda keys, src: {k: torch.as_tensor(src[k]) for k in keys}  # noqa: E731
    inp = {"grid": grid, "depth": depth,
           "train_bank": [tbank.means, tbank.log_vars, tbank.log_weights, tbank.trans_cost],
           "feats": torch.from_numpy(rng.standard_normal((b_tr, t_tr, 16)).astype(np.float32)),
           "nf": torch.full((b_tr,), t_tr, dtype=torch.int32),
           "g_hard": gt(("trans", "eps_trans", "init_cost", "end_states", "bank_state"), dense),
           "g_dense": gt(("trans", "eps_trans", "init_cost", "end_scores", "bank_state"), dense),
           "g_band": gt(tuple(banded), banded)}
    # the decodes: the 385-state sausage over the CLI-shaped bank (K13's
    # emissions, 64 streams x 200 frames) and the 8-word lexgraph
    cbank = random_bank(5).to(dev)
    w, lw = gmm_emission_weights(*cbank.flat_states())
    graph7 = connected_graph_arrays(cbank, 7)
    bg7 = banded_arrays(graph7, device=dev)
    b_d, t_d = 64, 200
    feats_d = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b_d, t_d, 39)).astype(np.float32)).to(dev)
    nf_d = torch.from_numpy(np.r_[t_d, 1, np.random.default_rng(2).integers(
        2, t_d + 1, b_d - 2)].astype(np.int32)).to(dev)
    u_plane = vk.bank_emission(augment_dtb(feats_d), w, lw)  # [U, T, B]
    words8 = ["aa", "ab", "abb", "ba", "b", "cab", "ca", "c"]
    units8 = sorted(set("".join(words8)))
    lrng = np.random.default_rng(3)

    def ltr3(skip):
        t_ = np.full((3, 3), np.inf)
        for i in range(3):
            t_[i, i] = lrng.uniform(0.1, 1)
            if i + 1 < 3:
                t_[i + 1, i] = lrng.uniform(0.1, 1)
            if skip and i + 2 < 3:
                t_[i + 2, i] = lrng.uniform(0.5, 2)
        return t_

    lex8 = build_lex_graph(words8, [ltr3(i % 2 == 0) for i in range(len(units8))],
                           {c: i for i, c in enumerate(units8)},
                           unigram_cost=lrng.uniform(0.5, 3.0, len(words8)).astype(np.float32),
                           word_insertion_cost=0.4)
    g8 = lex8.banded.to(dev)
    e8 = torch.from_numpy(lrng.uniform(0, 5, (37, len(units8) * 3, 8)).astype(np.float32))
    nf8_ = torch.tensor([37, 19, 1, 37, 30, 2, 11, 36], dtype=torch.int32)
    decode = {"385-state sausage7 64x200": (bg7, u_plane[bg7.bank_state].permute(1, 0, 2),
                                            nf_d, graph7.eps_depth),
              f"8-word lexgraph ({lex8.n_states} states, cross edges) 8x37":
                  (g8, e8[:, g8.bank_state.cpu()].to(dev), nf8_.to(dev), lex8.eps_depth)}
    inp["decode"] = {k: (g_.to("cpu"), x_.contiguous().cpu(), n_.cpu(), d_)
                     for k, (g_, x_, n_, d_) in decode.items()}
    # the classifier: the CLI-shaped bank, 64 x world utterances of 200 frames
    b_c = 64 * world
    inp["cls_bank"] = [x.cpu() for x in (cbank.means, cbank.log_vars, cbank.log_weights,
                                         cbank.trans_cost)]
    inp["cls_feats"] = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (b_c, 200, 39)).astype(np.float32))
    inp["cls_nf"] = torch.from_numpy(np.random.default_rng(5).integers(
        100, 201, b_c).astype(np.int32))
    # the bigram decode: the lex pipeline's 8-unit bank and 1k trie, 32 x
    # world 5 s signals, an add-k LM of 200 random 12-word sentences
    lbank, lexg, lcfg, lsig, llens = make_lex_pipeline(dev, batch=32 * world)
    lfeats, lnf = mfcc39_auto(lsig, llens, lcfg)
    prng = np.random.default_rng(9)
    lm = fit_bigram([[int(x) for x in prng.integers(0, len(lexg.words), 12)]
                     for _ in range(200)], len(lexg.words))
    inp.update(lex_bank=[x.cpu() for x in (lbank.means, lbank.log_vars, lbank.log_weights,
                                           lbank.trans_cost)],
               lex_feats=lfeats.cpu(), lex_nf=lnf.cpu(), lexg=lexg, lm=lm)
    workdir = os.path.join(tmp, "parallel")
    os.makedirs(workdir)
    torch.save(inp, os.path.join(workdir, "inputs.pt"))

    # the single-process results on the card, and their times
    single_ms = {}
    tb = tbank.to(dev)
    fx, fn_ = inp["feats"].to(dev), inp["nf"].to(dev)
    single_train = {}
    for name, (gkey, soft) in PAR_TRAIN.items():
        g_ = {k: v.to(dev) for k, v in inp[gkey].items()}
        fn = (lambda g_=g_, soft=soft: (embedded_step_soft if soft else embedded_step)(
            tb, fx, fn_, g_, eps_depth=depth))
        single_train[name] = fn()
        single_ms[name] = cuda_ms(fn)
    single_dec = {}
    for name, (g_, x_, n_, d_) in decode.items():
        for beam in PAR_BEAMS:
            single_dec[name, beam] = viterbi_banded_tb(x_, g_, n_, d_, beam_width=beam)
            single_ms[f"decode {name}, k = {beam}"] = cuda_ms(
                lambda: viterbi_banded_tb(x_, g_, n_, d_, beam_width=beam), 3)
    k8 = vk.viterbi_banded_general(u_plane.contiguous(), bg7, vk.banded_topology(bg7), nf_d,
                                   graph7.eps_depth)
    cx, cn = inp["cls_feats"].to(dev), inp["cls_nf"].to(dev)
    cpred = classify_batch(cbank, cx, cn)[0]
    single_ms["classifier"] = cuda_ms(lambda: classify_batch(cbank, cx, cn))
    lwords = decode_lextree_bigram(lbank, lexg, lm, lfeats, lnf)[0]
    single_ms["bigram decode"] = cuda_ms(lambda: decode_lextree_bigram(lbank, lexg, lm, lfeats,
                                                                       lnf))
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    torch.multiprocessing.spawn(parallel_rank, args=(world, workdir, free_port()),
                                nprocs=world, join=True)
    spawn_s = time.perf_counter() - t0
    outs = [torch.load(os.path.join(workdir, f"rank_{r}.pt"), weights_only=False)
            for r in range(world)]
    for r, o in enumerate(outs):
        for name, (params, total) in o["train"].items():
            want_bank, want_stats = single_train[name]
            for f_, x_ in zip(("means", "log_vars", "log_weights", "trans_cost"), params):
                if not torch.allclose(x_, getattr(want_bank, f_).cpu(), rtol=1e-4, atol=1e-4):
                    fail(f"rank {r}: the sharded {name} disagrees on {f_}: max |d| "
                         f"{float((x_ - getattr(want_bank, f_).cpu()).abs().max())}")
            if abs(total - float(want_stats.total_cost)) > 1e-5 * abs(float(
                    want_stats.total_cost)):
                fail(f"rank {r}: the sharded {name}'s total cost {total} is not "
                     f"{float(want_stats.total_cost)}")
        for key, got in o["decode"].items():
            want = single_dec[key]
            for plane, a_, b_ in zip(("final", "bp8", "eps_u"), got, want):
                if not torch.equal(a_, b_.cpu()):
                    fail(f"rank {r}: the state-sharded decode of {key[0]} (k = {key[1]}) "
                         f"differs from viterbi_banded_tb on {plane}")
            if key[1] == 0 and key[0].startswith("385"):
                for plane, a_, b_ in zip(("final", "bp8", "eps_u"), got, k8):
                    if not torch.equal(a_, b_.cpu()):
                        fail(f"rank {r}: the state-sharded decode differs from K8 on {plane}")
        if not torch.equal(o["classify"], cpred.cpu()):
            fail(f"rank {r}: the sharded classifier's predictions differ")
        if o["bigram"] != lwords:
            fail(f"rank {r}: the data-sharded bigram decode's words differ")
    launched = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
    for k in ("viterbi_dense", "dense_backtrace", "fb_dense", "fb_banded", "viterbi_lattice",
              "rescore_and_walk"):
        if not launched[k]:
            fail(f"section 8 launched no {k}: {launched}")
    if launched["rescore_lattice"] or launched["lattice_walk"]:
        fail(f"section 8's bigram decode launched a standalone K7 or K22: {launched}")
    phase("parallel", f"world {world} (NCCL, one rank a card; spawned and done in "
                      f"{spawn_s:.1f} s); grid {grid} with {n_models} models: sharded hard "
                      f"and soft steps == single-process (rtol / atol 1e-4, total cost rtol "
                      f"1e-5); state-sharded decode on (1, {world}) == viterbi_banded_tb bit "
                      f"for bit (k = 0 and 8), == K8's planes on the sausage; classifier "
                      f"predictions and bigram words on ({world}, 1) identical")
    for name in outs[0]["ms"]:
        ms = max(o["ms"][name] for o in outs)
        coll = [v for (n_, b_), v in outs[0]["collectives"].items()
                if name == f"decode {n_}, k = {b_}"]
        extra = f", {coll[0]} collectives a frame" if coll else ""
        phase("parallel", f"{name}: {ms:.3f} ms a call (the slowest rank), single process "
                          f"{single_ms[name]:.3f} ms{extra} (world {world}; {card})")
    phase("parallel", f"launches: {launched}")
    return launched


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the port's chip smoke test (one card by "
                                             "default)")
    ap.add_argument("--parallel", action="store_true",
                    help="build the kernels and run section 8 alone (the sharded paths, "
                         "one NCCL rank on each visible card)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "speech_recognition_tpu_torch")):
        fail("run from a checkout of the repository (speech_recognition_tpu_torch/ missing)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    phase("device", f"{card} | torch {torch.__version__} | cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    from speech_recognition_tpu_torch.utils import build
    from speech_recognition_tpu_torch.utils.roofline import (
        SM_CLOCK_HZ,
        SMEM_STEP_CYCLES,
        bound,
        ceps_ops,
        chain_walk_work,
        dense_ops,
        dense_walk_work,
        dp_ops,
        fb_banded_work,
        fb_dense_work,
        gmm_fit_work,
        graph_bytes,
        mfcc_ops,
        nbytes,
        rescore_ops,
        rescore_walk_work,
        span_pairs,
        tail_ops,
        STEP_CYCLES,
        TOKEN_BEAM_STEPS,
        token_beam_floor,
        token_beam_work,
        token_walk_work,
    )

    t0 = time.perf_counter()
    lib_path = build.build()
    build.load_library()
    build_s = time.perf_counter() - t0
    with open(lib_path + ".log") as f:
        ptxas = [l.strip() for l in f if "registers" in l or "spill" in l]
    phase("build", f"{os.path.relpath(lib_path, HERE)} in {build_s:.2f} s "
                   f"(built or found at first use)")
    for line in ptxas:
        phase("build", line)

    from speech_recognition_tpu_torch.decode.connected import (
        _decode_banded_batch,
        connected_graph_arrays,
        states_to_words_device,
    )
    from speech_recognition_tpu_torch.models.graph import build_loop_graph, build_word_graph
    from speech_recognition_tpu_torch.ops import viterbi_banded_kernels as vk
    from speech_recognition_tpu_torch.ops.frontend import (
        FrontendConfig,
        _stack39,
        mfcc39_auto,
        padded_length,
    )
    from speech_recognition_tpu_torch.ops.frontend_kernel import (
        mfcc39_fused,
        mfcc39_fused_ref,
        mfcc_fused,
        mfcc_fused_ref,
        mfcc_tail,
    )
    from speech_recognition_tpu_torch.ops.gmm import augment_dtb, gmm_emission_weights
    from speech_recognition_tpu_torch.ops.viterbi_banded import _eps_u_dtype, banded_arrays

    report = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    device_line = json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    if args.parallel:  # section 8 alone
        parallel_section(dev, tmp, card)
        print(card)
        print(device_line)
        return 0

    # ---- 3. K3 vs its plain version --------------------------------------
    cfg = FrontendConfig()
    n_samp = 80000  # 5 s at 16 kHz
    L = ((padded_length(cfg, n_samp) + 159) // 160 + 8) * 160
    rng = np.random.default_rng(0)
    sig = torch.from_numpy((rng.standard_normal((256, L)) * 3000).astype(np.float32)).to(dev)
    lens = torch.full((256,), n_samp, dtype=torch.int32, device=dev)
    # variable lengths: one single-frame utterance, the rest >= 3 frames
    # (two frames make a delta column constant, where standardization
    # only amplifies rounding)
    var_lens = np.r_[300, rng.integers(561, n_samp + 1, 63)].astype(np.int32)
    var_sig = sig[:64].clone()
    var_sig[torch.arange(L, device=dev)[None, :]
            >= torch.from_numpy(var_lens).to(dev)[:, None]] = 0.0
    k3_err = 0.0
    for name, (s, ln) in {"256x5s": (sig, lens),
                          "64 varlen": (var_sig, torch.from_numpy(var_lens).to(dev))}.items():
        for norm in ("utterance", "none"):
            got, nf_k = mfcc39_fused(s, ln, cfg, norm=norm)
            want, nf_p = mfcc39_fused_ref(s, ln, cfg, norm=norm)
            torch.cuda.synchronize()
            if not torch.equal(nf_k, nf_p):
                fail(f"K3 frame counts differ ({name}, norm={norm})")
            if not bool(torch.isfinite(got).all()):
                fail(f"K3 output not finite ({name}, norm={norm})")
            scale = 1.0 if norm == "utterance" else want.abs().amax((0, 1)).clamp(min=1.0)
            if not torch.allclose(got / scale, want / scale, **K3_TOL):
                fail(f"K3 disagrees with its plain version ({name}, norm={norm}): "
                     f"max |d| {float(((got - want) / scale).abs().max())}")
            if norm == "utterance":
                k3_err = max(k3_err, float((got - want).abs().max()))
    phase("K3", f"mfcc39 kernel == plain version at 256x80000 and 64 varlen "
                f"(rtol 2e-3, atol 5e-4; raw features scaled per column); "
                f"max |d| standardized {k3_err:.3g}")
    report["K3"] = {"max_abs_err": k3_err}
    # K14 alone: the tail kernel on K12's cepstra against its plain version
    ceps_k, nf_c = mfcc_fused(sig, lens, cfg)
    k14_err = 0.0
    for norm in ("utterance", "none"):
        got = mfcc_tail(ceps_k, nf_c, norm)
        want = _stack39(ceps_k, nf_c, norm)
        torch.cuda.synchronize()
        if norm == "none" and not torch.equal(got, want):
            fail("K14 raw features (cepstra and deltas) differ from the plain version")
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            fail(f"K14 disagrees with its plain version (norm={norm}): max |d| "
                 f"{float((got - want).abs().max())}")
        k14_err = max(k14_err, float((got - want).abs().max()))
    phase("K14", f"mfcc tail kernel on K12's 256x5s cepstra == plain (_stack39): raw "
                 f"bit-identical, standardized within rtol 1e-4 / atol 1e-4 (max |d| "
                 f"{k14_err:.3g})")
    report["K14"] = {"max_abs_err": k14_err}

    # ---- 4. K1 + K2 vs their plain versions -------------------------------
    bank, bank_path = make_bank(tmp)
    bank = bank.to(dev)
    w, lw = gmm_emission_weights(*bank.flat_states())
    trans = [bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)]
    graphs = {"sausage7": connected_graph_arrays(bank, 7),
              "loop": build_loop_graph(trans, word_insertion_cost=2.0)}
    if graphs["sausage7"].n_states != 385:
        fail(f"sausage graph has {graphs['sausage7'].n_states} states, expected 385")
    B, T = 512, 500
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, T, 39)).astype(np.float32)).to(dev)
    nf = torch.from_numpy(np.r_[T, 1, np.random.default_rng(2).integers(
        2, T + 1, B - 2)].astype(np.int32)).to(dev)
    xa = augment_dtb(feats)
    valid = torch.arange(T, device=dev)[:, None] < nf[None, :]  # [T, B]
    k1_err, k2_err, planes = 0.0, 0.0, {}
    for gname, graph in graphs.items():
        bg = banded_arrays(graph, device=dev)
        topo = vk.banded_topology(bg)
        got = vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)
        want = vk.viterbi_banded_fused_ref(xa, w, lw, bg, topo, nf)
        torch.cuda.synchronize()
        if not torch.allclose(got[0], want[0], rtol=K1_RTOL, atol=0.0):
            fail(f"K1 final costs disagree on {gname}: "
                 f"max |d| {float((got[0] - want[0]).abs().max())}")
        k1_err = max(k1_err, float((got[0] - want[0]).abs().max()))
        ends = bg.end_states[torch.argmin(want[0][bg.end_states], 0)]
        sk, fk = vk.banded_backtrace_val(got[1], got[3], ends, nf, topo.uniform_w)
        sp, fp = vk.banded_backtrace_val_ref(want[1], want[3], ends, nf, topo.uniform_w)
        torch.cuda.synchronize()
        if not bool(((sk == sp) & (fk == fp) | ~valid).all()):
            fail(f"K1 + K2 decoded states differ from the plain versions on {gname}")
        # K2 alone: the kernel and its plain version on the same planes
        s2, f2 = vk.banded_backtrace_val(want[1], want[3], ends, nf, topo.uniform_w)
        torch.cuda.synchronize()
        if not bool(((s2 == sp) & (f2 == fp) | ~valid).all()):
            fail(f"K2 disagrees with its plain version on {gname}")
        k2_err = max(k2_err, float(((s2 - sp).abs() * valid).max()))
        label = torch.as_tensor(graph.slot_label, device=dev)
        slot = torch.as_tensor(graph.slot, device=dev)
        wk, nk = states_to_words_device(slot, label, sk.T, fk.T, nf, uniform_w=topo.uniform_w)
        wp, np_ = states_to_words_device(slot, label, sp.T, fp.T, nf, uniform_w=topo.uniform_w)
        if not (torch.equal(wk, wp) and torch.equal(nk, np_)):
            fail(f"decoded words differ on {gname}")
        planes[gname] = (bg, topo, want, ends)
        phase("K1+K2", f"{gname} ({graph.n_states} states) at {B}x{T}: final == plain "
                       f"(rtol 1e-5, max |d| {float((got[0] - want[0]).abs().max()):.3g}); "
                       f"states and words identical; mean words/utt "
                       f"{float(nk.float().mean()):.2f}")
    # K2 on a batch that is not a multiple of 16: the first 500 streams
    bg5, topo5, want5, ends5 = planes["sausage7"]
    sub = (want5[1][:, :, :500].contiguous(), want5[3][:, :, :500].contiguous(), ends5[:500],
           nf[:500], topo5.uniform_w)
    s5, f5 = vk.banded_backtrace_val(*sub)
    sp5, fp5 = vk.banded_backtrace_val_ref(*sub)
    torch.cuda.synchronize()
    if not bool(((s5 == sp5) & (f5 == fp5) | ~valid[:, :500]).all()):
        fail("K2 disagrees with its plain version at B = 500")
    phase("K2", f"sausage7 planes at 500x{T} (B % 16 = 4): states and flags == plain")
    report["K1"] = {"max_abs_err": k1_err}
    report["K2"] = {"max_abs_err": k2_err}
    # K13 alone, and K1's DP alone on K13's emissions against its plain DP
    nll13 = vk.bank_emission(xa, w, lw)
    want13 = vk.bank_emission_ref(xa, w, lw)
    bg, topo = planes["sausage7"][:2]
    dp_got = vk._banded_forward(nll13, bg, nf, 1, "fused", vk.viterbi_banded_fused)
    dp_want = vk.fused_dp_ref(nll13, bg, nf)
    torch.cuda.synchronize()
    if not torch.allclose(nll13, want13, **K13_TOL):
        fail(f"K13 disagrees with its plain version: max |d| "
             f"{float((nll13 - want13).abs().max())}")
    for k, plane in enumerate(("final", "bp8", "eps_u", "eps_prev")):
        if not torch.equal(dp_got[k], dp_want[k]):
            fail(f"K1's DP {plane} differs from its plain version on K13's emissions")
    report["K13"] = {"max_abs_err": float((nll13 - want13).abs().max())}
    phase("K13", f"bank emission kernel == plain version at {B}x{T} (rtol 1e-5, atol "
                 f"1e-4; max |d| {report['K13']['max_abs_err']:.3g}); K1's DP on its "
                 f"[T, B, U] plane == plain DP (final, bp8, eps_u, eps_prev bit-identical, "
                 f"every frame)")

    # ---- 4b. K8 + K9 vs their plain versions ---------------------------------
    bank1, bank1_path = make_bank(tmp, n_states=1, name="bank1.npz")
    bank1 = bank1.to(dev)
    bank6 = random_bank(6, seed=10).to(dev)
    sizes = (3, 4, 5, 6, 3, 4, 5, 6, 3, 4, 5)  # a 7-slot sausage of 336 states
    gen_graphs = {
        "1-state sausage7": build_word_graph(
            [bank1.trans_cost[i].cpu().numpy() for i in range(11)], [list(range(11))] * 7),
        "3-6-state sausage7": build_word_graph(
            [bank6.trans_cost[i].cpu().numpy()[:k, :k] for i, k in enumerate(sizes)],
            [list(range(11))] * 7)}
    g1s = gen_graphs["1-state sausage7"]
    if (g1s.n_states, g1s.eps_depth) != (77, 6):
        fail(f"1-state sausage has {g1s.n_states} states, eps depth {g1s.eps_depth}")
    erng = np.random.default_rng(11)
    nf8 = torch.from_numpy(np.r_[T, 1, 0, erng.integers(2, T + 1, B - 3)]
                           .astype(np.int32)).to(dev)
    k8_err, k9_err, gen_planes = 0.0, 0.0, {}
    for gname, graph in gen_graphs.items():
        bg = banded_arrays(graph, device=dev)
        topo = vk.banded_topology(bg)
        if topo.fused_ok:
            fail(f"the fused kernels take the {gname}")
        u = int(graph.bank_state.max()) + 1
        for ename, e in (("uniform(0, 5)", erng.uniform(0, 5, (u, T, B))),
                         ("integer 0..2 (ties)", erng.integers(0, 3, (u, T, B)))):
            nll = torch.from_numpy(e.astype(np.float32)).to(dev)
            got = vk.viterbi_banded_general(nll, bg, topo, nf8, graph.eps_depth)
            want = vk.viterbi_banded_general_ref(nll, bg, topo, nf8, graph.eps_depth)
            torch.cuda.synchronize()
            for k, plane in enumerate(("final", "bp8", "eps_u")):
                if not torch.equal(got[k], want[k]):
                    fail(f"K8 {plane} differs from the plain version on the {gname}, "
                         f"{ename} emissions")
            k8_err = max(k8_err, float((got[0] - want[0]).abs().max()))
            ends = bg.end_states[torch.argmin(want[0][bg.end_states]
                                              + bg.end_bonus[:, None], 0)]
            sk, fk = vk.banded_backtrace_general(got[1], got[2], bg, ends, nf8,
                                                 graph.eps_depth)
            sp, fp = vk.banded_backtrace_general_ref(want[1], want[2], bg, ends, nf8,
                                                     graph.eps_depth)
            torch.cuda.synchronize()
            if not (torch.equal(sk, sp) and torch.equal(fk, fp)):
                fail(f"K9 (on K8's planes) differs from the plain version on the {gname}, "
                     f"{ename} emissions")
            k9_err = max(k9_err, float((sk - sp).abs().max()))
            if gname not in gen_planes:
                gen_planes[gname] = (bg, topo, nll, want, ends, graph, int(fk.sum()))
            phase("K8+K9", f"{gname} ({graph.n_states} states, eps depth "
                           f"{graph.eps_depth}), {ename} emissions at {B}x{T}: final, bp8, "
                           f"eps_u == plain (bit-identical, frozen frames included); K9 "
                           f"states and flags == plain; eps unwinds on the best paths "
                           f"{int(fk.sum())}")
    # K9 at B = 500 (not a multiple of its 4 streams per CTA) on the
    # 1-state sausage's planes (int8 eps_u; int32 on the 2,000-word loop below)
    bg, topo, nll, want, ends, graph, _ = gen_planes["1-state sausage7"]
    sub = (want[1][:, :, :500].contiguous(), want[2][:, :, :500].contiguous(), bg,
           ends[:500], nf8[:500], graph.eps_depth)
    sk, fk = vk.banded_backtrace_general(*sub)
    sp, fp = vk.banded_backtrace_general_ref(*sub)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(fk, fp)):
        fail("K9 differs from the plain version at B = 500 on the 1-state sausage")
    phase("K8+K9", f"K9 at 500x{T} on the 1-state sausage's planes (int8 eps_u, eps depth "
                   f"{graph.eps_depth}): states and flags == plain")
    report["K8"] = {"max_abs_err": k8_err}
    report["K9"] = {"max_abs_err": k9_err}

    # ---- 4c. K10 vs its plain version -----------------------------------------
    def check_k10(name, xa_, ww, ll, bg_, topo_, nf_):
        """K10 (one K13 launch + one word-trace DP launch): its DP's outputs
        bit-identical to the plain DP on K13's own plane, its final costs
        within rtol 1e-5 of the whole plain version and of K1's.  Returns
        ``(max |d| against the plain version, K10's outputs)``."""
        before = (vk.bank_emission.launches, vk.viterbi_banded_wordtrace.launches)
        got = vk.viterbi_banded_wordtrace(xa_, ww, ll, bg_, topo_, nf_)
        torch.cuda.synchronize()
        if (vk.bank_emission.launches, vk.viterbi_banded_wordtrace.launches) != \
                (before[0] + 1, before[1] + 1):
            fail(f"K10 on {name} did not make one K13 and one DP launch")
        dp = vk._wordtrace_dp(vk.bank_emission(xa_, ww, ll), bg_, nf_)
        want = vk.viterbi_banded_wordtrace_ref(xa_, ww, ll, bg_, topo_, nf_)
        k1 = vk.viterbi_banded_fused(xa_, ww, ll, bg_, topo_, nf_)
        torch.cuda.synchronize()
        for k, plane in enumerate(("final", "eps_u", "eps_tau", "final_tau")):
            if not torch.equal(got[k], dp[k]):
                fail(f"K10 {plane} differs from the plain DP on K13's plane on {name}")
        for other, ref in (("the plain version", want[0]), ("K1", k1[0])):
            if not torch.allclose(got[0], ref, rtol=K1_RTOL, atol=0.0):
                fail(f"K10 final costs disagree with {other} on {name}: max |d| "
                     f"{float((got[0] - ref).abs().max())}")
        err = float((got[0] - want[0]).abs().max())
        phase("K10", f"{name} at {xa_.shape[2]}x{xa_.shape[1]}: final, eps_u, eps_tau, "
                     f"final_tau == the plain DP on K13's plane (bit-identical, every "
                     f"frame); final within rtol 1e-5 of the plain version (max |d| "
                     f"{err:.3g}) and of K1's (max |d| "
                     f"{float((got[0] - k1[0]).abs().max()):.3g}); re-entries recorded "
                     f"{int((got[2] > 0).sum())}")
        return err, got

    bank_dup = random_bank(5, seed=12, dup=5).to(dev)  # models 6-10 copy 0-4
    w_d, lw_d = gmm_emission_weights(*bank_dup.flat_states())
    k10_err, k10_out = 0.0, {}
    for bname, bk, ww, ll in (("random bank", bank, w, lw),
                              ("bank with 5 copied models (ties)", bank_dup, w_d, lw_d)):
        graph = connected_graph_arrays(bk, 7)
        bg = banded_arrays(graph, device=dev)
        err, k10_out[bname] = check_k10(f"sausage7 ({graph.n_states} states), {bname}", xa,
                                        ww, ll, bg, vk.banded_topology(bg), nf)
        k10_err = max(k10_err, err)

    # ---- 4c'. K23 (the word-trace walk) vs its plain version ------------------
    def wordtrace_walk_args(fwd_, bg_, nf_):
        """The walk's arguments as ``decode.connected`` builds them from
        K10's outputs: the side planes, each stream's final slot and its
        entry time."""
        end_ = bg_.end_states[torch.argmin(fwd_[0][bg_.end_states]
                                           + bg_.end_bonus[:, None], 0)]
        return (fwd_[1], fwd_[2], end_ // vk.banded_topology(bg_).uniform_w,
                fwd_[3].gather(0, end_[None])[0], nf_)

    def check_k23(name, args_):
        """K23 against ``wordtrace_words_ref`` on the same CUDA planes: the
        words plane (its T + 1 rows included) and n_words bit for bit; the
        call runs under CUDA's sync debug mode, which raises on any read
        back to the host."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got_ = vk.wordtrace_words_device(*args_)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want_ = vk.wordtrace_words_ref(*args_)
        torch.cuda.synchronize()
        if got_[0].shape != (args_[0].shape[0] + 1, args_[0].shape[2]) \
                or got_[0].shape != want_[0].shape or not (torch.equal(got_[0], want_[0])
                                                   and torch.equal(got_[1], want_[1])):
            fail(f"K23 differs from the plain walk on {name}: rows {got_[0].shape[0]} / "
                 f"{want_[0].shape[0]}")
        phase("K23", f"{name}: words plane ({want_[0].shape[0]} rows) and n_words == plain "
                     f"(bit-identical), no host read (sync debug mode); eps_u "
                     f"{str(args_[0].dtype).split('.')[-1]}, longest chain "
                     f"{int(want_[1].max())} words, {int(want_[1].sum())} in all")
        return want_

    # the sausage's word trace at 512 x 500, and the skip-arc loop graph (3
    # words of 5 states with cheap skips, word insertion -1000: more words
    # than T / 5 + 1, which the reference's plane would drop) at 64 x 300
    bg7_ = banded_arrays(connected_graph_arrays(bank, 7), device=dev)
    wt_args7 = wordtrace_walk_args(k10_out["random bank"], bg7_, nf)
    check_k23(f"sausage7 word trace {B}x{T}", wt_args7)
    bank_skip = random_bank(5, seed=17, n_models=3)
    for tr_ in bank_skip.trans_cost:
        for i_ in range(3):
            tr_[i_ + 2, i_] = 0.05
    bank_skip = bank_skip.to(dev)
    g_skip = banded_arrays(build_loop_graph([x.cpu().numpy() for x in bank_skip.trans_cost],
                                            word_insertion_cost=-1000.0), device=dev)
    w_s, lw_s = gmm_emission_weights(*bank_skip.flat_states())
    xa_s = xa[:, :300, :64].contiguous()
    nf_s = nf[:64].clamp(max=300)
    fwd_s = vk.viterbi_banded_wordtrace(xa_s, w_s, lw_s, g_skip, vk.banded_topology(g_skip),
                                        nf_s)
    k23_skip_args = wordtrace_walk_args(fwd_s, g_skip, nf_s)
    want_s = check_k23("skip-arc loop graph 64x300", k23_skip_args)
    if int(want_s[1].max()) <= 300 // 5 + 1:
        fail("the skip-arc graph's longest chain fits the reference's T / W + 1 rows")
    report["K23"] = {"max_abs_err": 0.0}

    # ---- 4d. K11 vs its plain version -----------------------------------------
    from speech_recognition_tpu_torch.models.graph import pad_graphs, transcript_graph
    from speech_recognition_tpu_torch.models.hmm import bank_nll, linear_init_cost
    from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace
    from speech_recognition_tpu_torch.ops.viterbi_kernels import (
        viterbi_dense,
        viterbi_dense_ref,
    )
    from speech_recognition_tpu_torch.utils.numerics import POS_INF

    def on_dev(x):
        return torch.as_tensor(x, device=dev)

    mask = torch.arange(T, device=dev)[None, :] < nf[:, None]  # [B, T]
    nll_bank = bank_nll(bank, feats, mask)  # [B, T, 55]
    n_m, n_s = bank.n_models, bank.n_states
    g7 = graphs["sausage7"]
    # 256 transcripts of 2-7 digits over a 12-model bank whose model 11 is
    # silence, optional between and around the words
    bank_sil, bank_sil_path = make_bank(tmp, name="bank_sil.npz", n_models=12,
                                        meta={"silence_index": 11})
    bank_sil = bank_sil.to(dev)
    trng = np.random.default_rng(13)
    trans_sil = [bank_sil.trans_cost[i].cpu().numpy() for i in range(12)]
    gb, depth_tr = pad_graphs([transcript_graph(
        trans_sil, [int(x) for x in trng.integers(0, 11, trng.integers(2, 8))], sil=11)
        for _ in range(256)])
    bstate = on_dev(gb["bank_state"]).long()
    nll_sil = bank_nll(bank_sil, feats[:256], mask[:256])
    nll_sil = nll_sil.gather(2, bstate[:, None, :].expand(256, T, bstate.shape[1]))
    # integer emissions and costs (every minimum ties), lengths T, 0 and 1
    s_tie, t_tie = 48, 200
    trans_tie = trng.integers(0, 3, (2, s_tie, s_tie)).astype(np.float32)
    trans_tie[0][trng.uniform(size=(s_tie, s_tie)) < 0.5] = POS_INF
    trans_tie[1][trng.uniform(size=(s_tie, s_tie)) < 0.8] = POS_INF
    init_tie = np.where(np.arange(s_tie) < 12, trng.integers(0, 3, s_tie), POS_INF)
    dense_cases = {
        "isolated 512x500, 11 models x 5 states": dict(
            nll=nll_bank.reshape(B, T, n_m, n_s).permute(0, 2, 1, 3)
            .reshape(B * n_m, T, n_s).contiguous(),
            trans=bank.trans_cost[None].expand(B, n_m, n_s, n_s)
            .reshape(B * n_m, n_s, n_s).contiguous(),
            init_cost=on_dev(linear_init_cost(n_s)), n_frames=nf.repeat_interleave(n_m),
            eps_trans=None, eps_depth=1),
        "385-state sausage7 64x500": dict(
            nll=nll_bank[:64][:, :, on_dev(g7.bank_state).long()].contiguous(),
            trans=on_dev(g7.trans), init_cost=on_dev(g7.init_cost), n_frames=nf[:64],
            eps_trans=on_dev(g7.eps_trans), eps_depth=g7.eps_depth),
        f"256 transcript graphs ({bstate.shape[1]} states, per item)": dict(
            nll=nll_sil.contiguous(), trans=on_dev(gb["trans"]),
            init_cost=on_dev(gb["init_cost"]), n_frames=nf[:256],
            eps_trans=on_dev(gb["eps_trans"]), eps_depth=depth_tr),
        f"integer ties {s_tie} states 64x{t_tie}": dict(
            nll=on_dev(trng.integers(0, 3, (64, t_tie, s_tie)).astype(np.float32)),
            trans=on_dev(trans_tie[0]), init_cost=on_dev(init_tie.astype(np.float32)),
            n_frames=on_dev(np.r_[t_tie, 0, 1, trng.integers(2, t_tie + 1, 61)]
                            .astype(np.int32)),
            eps_trans=on_dev(trans_tie[1]), eps_depth=2)}
    from speech_recognition_tpu_torch.ops import viterbi_kernels as dk

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = dk._cluster_slots(dev)

    def dense_form(kw):
        """The plan K11 runs at these inputs, as text."""
        b_, _, s_ = kw["nll"].shape
        p = dk.dense_plan(b_, s_, kw["trans"].dim() == 3, kw["eps_trans"] is not None,
                          build.load_library().srt_smem_limit(), n_sm, slots)
        if p.form in ("cluster", "item"):
            return (f"{p.form} form, {p.cluster} CTAs x {p.rows} rows, {p.lanes} lanes a row, "
                    f"{p.items} items a cluster")
        return f"{p.form} form" + (f", {p.items_per_warp} items a warp" if p.form == "packed"
                                   else "")

    dense_out = {}
    for name, kw in dense_cases.items():
        got = viterbi_dense(**kw)
        want = viterbi_dense_ref(**kw)
        torch.cuda.synchronize()
        for k, plane in enumerate(("final", "bp", "eps_bp")):
            if not torch.equal(got[k], want[k]):
                fail(f"K11 {plane} differs from the plain version on {name}")
        dense_out[name] = want
        extra = ""
        if kw["eps_trans"] is None:
            lean = viterbi_dense(**kw, planes=False)
            torch.cuda.synchronize()
            if not (torch.equal(lean[0], want[0]) and lean[1] is None):
                fail(f"K11 without planes disagrees with K11 with planes on {name}")
            extra = "; without planes: final identical"
        live = float((want[0] < 1e29).float().mean())
        phase("K11", f"{name} ({dense_form(kw)}): final, bp, eps_bp == plain "
                     f"(bit-identical, every frame, frozen ones included){extra}; live "
                     f"final states {live:.3f}")
    if not bool((dense_out[f"integer ties {s_tie} states 64x{t_tie}"][0][1] == POS_INF).all()):
        fail("K11 final at n_frames 0 is not POS_INF")
    # K11 in every form dense_plan picks: S over the plan's boundaries
    # (packed up to 32 states, the cluster size growing from 63 states at
    # B = 5, the wide form past the largest cluster), B not a multiple of
    # the items per warp or cluster (4 items a cluster at B = 150, one below
    # the card's SMs), shared and per-item matrices, eps
    # depth 1-3, integer (tie-forcing) emissions and costs with POS_INF
    # holes, lengths T, 0, 1; planes on and off
    frng = np.random.default_rng(17)
    forms_seen = {}
    for s_, b_, per_item, use_eps, depth, ties in (
            (1, 37, True, False, 1, True), (5, 37, True, False, 1, False),
            (5, 29, False, True, 3, True), (6, 11, True, True, 2, True),
            (16, 9, False, True, 1, False), (31, 7, True, True, 3, True),
            (32, 5, True, True, 2, False), (33, 9, False, True, 2, True),
            (33, 5, True, True, 1, True), (63, 5, False, True, 3, True),
            (64, 6, True, False, 1, True), (249, 5, False, True, 2, True),
            (385, 6, False, True, 1, False), (385, 3, True, True, 2, True),
            (465, 5, False, True, 1, False), (477, 3, True, True, 1, True),
            (40, 150, False, True, 2, True)):
        t_ = 24 if s_ > 100 else 40
        lead = (b_,) if per_item else ()

        def mat(p_hole):
            m = (frng.integers(0, 3, lead + (s_, s_)) if ties
                 else frng.uniform(0, 3, lead + (s_, s_))).astype(np.float32)
            m[frng.uniform(size=m.shape) < p_hole] = POS_INF
            return on_dev(m)

        init_f = frng.uniform(0, 2, s_).astype(np.float32)
        init_f[max(1, s_ // 4):] = POS_INF
        kw = dict(nll=on_dev((frng.integers(0, 3, (b_, t_, s_)) if ties else
                              frng.uniform(0, 5, (b_, t_, s_))).astype(np.float32)),
                  trans=mat(0.5), init_cost=on_dev(init_f),
                  n_frames=on_dev(np.r_[t_, 0, 1, frng.integers(2, t_ + 1, b_)][:b_]
                                  .astype(np.int32)),
                  eps_trans=mat(0.8) if use_eps else None, eps_depth=depth)
        form = dense_form(kw).split(" form")[0]
        want = viterbi_dense_ref(**kw)
        got = viterbi_dense(**kw)
        lean = viterbi_dense(**kw, planes=False)
        torch.cuda.synchronize()
        for k, plane in enumerate(("final", "bp", "eps_bp")):
            if not torch.equal(got[k], want[k]):
                fail(f"K11 {plane} differs from the plain version at S={s_}, B={b_} "
                     f"({form} form)")
        if not torch.equal(lean[0], want[0]):
            fail(f"K11 final without planes differs at S={s_}, B={b_} ({form} form)")
        forms_seen.setdefault(form, []).append(str(s_))
    if set(forms_seen) != {"packed", "cluster", "item", "wide"}:
        fail(f"the K11 sweep missed a form: {sorted(forms_seen)}")
    phase("K11", "every form dense_plan picks == plain (final, bp, eps_bp bit-identical, "
                 "every frame; final without planes identical), states per form: "
                 + "; ".join(f"{k} {', '.join(v)}" for k, v in forms_seen.items()))
    report["K11"] = {"max_abs_err": 0.0}

    # ---- 4d'. K21 (the dense backtrace) vs its plain version ------------------
    # on K11's planes of every case above: the 385-state sausage at 64 x 500
    # (the dense decode), the isolated / skmeans shape (5 states), the
    # transcript graphs (the hard training step and align), the integer-tie
    # batch (eps depth 2, lengths T, 0 and 1); end states: the last state
    # (the isolated shape, as segmental K-means walks) or each item's best.
    # Each in the form dense_backtrace_plan picks (the window form), the
    # window form at 8 frames x 8 states (many reloads) and at 32 x 128 (a
    # bulk copy a row) and the chain form, forced on the same planes; then
    # a strided view of the sausage's
    # planes, and after K11's scratch case its planes at 11,623 states (the
    # plan's chain form both)
    from speech_recognition_tpu_torch.ops.viterbi import viterbi_backtrace_ref
    from speech_recognition_tpu_torch.ops.viterbi_kernels import dense_backtrace

    smem_lim = build.load_library().srt_smem_limit()

    def k21_plans(bp_, depth_):
        """The plan's form for these planes, and the other forms forced
        (the window form only where the state stride is 1)."""
        b_, t_, s_ = bp_.shape
        plans_ = {"plan": dk.dense_backtrace_plan(b_, t_, s_, [bp_.stride()] * 2, smem_lim,
                                                   n_sm, depth_),
                  "chain": dk.BacktracePlan("chain", 0, 0, 1, 4, -(-b_ // 128), 0)}
        if bp_.stride()[2] == 1:
            plans_["window 8x8"] = dk.window_plan(b_, t_, s_, depth_, 8, 8, smem_lim, n_sm)
            plans_["window 32x128 rows"] = dk.window_plan(b_, t_, s_, depth_, 32, 128, smem_lim,
                                                          n_sm)
        return plans_

    k21_forms = {}  # form -> the cases it ran on
    k21_picked = {}  # case -> the plan's own form

    def check_k21(name, args_):
        """K21 in each form of ``k21_plans`` against viterbi_backtrace_ref,
        states and flags bit for bit."""
        want_ = viterbi_backtrace_ref(*args_)
        for label, plan_ in k21_plans(args_[0], args_[4]).items():
            got_ = dk._backtrace(*args_, plan=plan_)
            torch.cuda.synchronize()
            if not (torch.equal(got_[0], want_[0]) and torch.equal(got_[1], want_[1])):
                fail(f"K21 ({label}: {plan_.form} form) differs from viterbi_backtrace_ref "
                     f"on {name}")
            k21_forms.setdefault(plan_.form, []).append(name)
            if label == "plan":
                k21_picked[name] = plan_
        return want_

    k21_args = {}
    for name, kw in dense_cases.items():
        fin_, bp_, ebp_ = dense_out[name]
        end_ = (torch.full((fin_.shape[0],), fin_.shape[1] - 1, device=dev)
                if kw["eps_trans"] is None else torch.argmin(fin_, 1))
        k21_args[name] = (bp_, ebp_, end_, kw["n_frames"], kw["eps_depth"])
        want_ = check_k21(name, k21_args[name])
        got_ = dense_backtrace(*k21_args[name])
        one_ = dense_backtrace(bp_[1], ebp_[1], int(end_[1]), int(kw["n_frames"][1]),
                               kw["eps_depth"])
        torch.cuda.synchronize()
        if not (torch.equal(got_[0], want_[0]) and torch.equal(got_[1], want_[1])):
            fail(f"K21 differs from viterbi_backtrace_ref on {name}")
        if not (torch.equal(one_[0], want_[0][1]) and torch.equal(one_[1], want_[1][1])):
            fail(f"K21's single-stream form differs from the batched walk on {name}")
        p_ = k21_picked[name]
        phase("K21", f"{name} (eps depth {kw['eps_depth'] if kw['eps_trans'] is not None else 0}"
                     f", lengths {int(kw['n_frames'].min())}-{int(kw['n_frames'].max())}): "
                     f"states and flags == viterbi_backtrace_ref (bit-identical, batched and "
                     f"one stream) in the plan's {p_.form} form ({p_.rows} frames x "
                     f"{p_.states} states, {'block' if p_.block else 'row'} layout, "
                     f"{32 // p_.lanes} streams a warp), the window form at 8 x 8 and "
                     f"32 x 128 (row layout) and the chain form; eps hops "
                     f"{int(want_[1].sum())}")
    s_name, view_name = "385-state sausage7 64x500", "the sausage's planes as [B, S, T] views"
    bp_v = k21_args[s_name][0].transpose(1, 2).contiguous().transpose(1, 2)
    ebp_v = k21_args[s_name][1].transpose(1, 2).contiguous().transpose(1, 2)
    check_k21(view_name, (bp_v, ebp_v, *k21_args[s_name][2:]))
    del bp_v, ebp_v
    phase("K21", f"{view_name}: states and flags == viterbi_backtrace_ref in the plan's "
                 f"{k21_picked[view_name].form} form and the chain form")
    report["K21"] = {"max_abs_err": 0.0}

    # ---- 4e. K12 vs its plain version -----------------------------------------
    k12_err = 0.0
    for name, (s_, ln) in {"256x5s": (sig, lens),
                           "64 varlen": (var_sig, torch.from_numpy(var_lens).to(dev))}.items():
        got, nf_k = mfcc_fused(s_, ln, cfg)
        want, nf_p = mfcc_fused_ref(s_, ln, cfg)
        torch.cuda.synchronize()
        if not torch.equal(nf_k, nf_p):
            fail(f"K12 frame counts differ ({name})")
        if not bool(torch.isfinite(got).all()):
            fail(f"K12 output not finite ({name})")
        if not torch.allclose(got, want, **K3_TOL):
            fail(f"K12 disagrees with its plain version ({name}): max |d| "
                 f"{float((got - want).abs().max())}")
        k12_err = max(k12_err, float((got - want).abs().max()))
    phase("K12", f"mfcc cepstra kernel == plain version at 256x80000 and 64 varlen "
                 f"(rtol 2e-3, atol 5e-4), frame counts equal; max |d| {k12_err:.3g}")
    report["K12"] = {"max_abs_err": k12_err}

    # ---- 4f. past the old size limits ------------------------------------------
    from speech_recognition_tpu_torch.models.graph import build_loop_graph
    from speech_recognition_tpu_torch.ops.viterbi_kernels import max_dense_states
    from speech_recognition_tpu_torch.utils.build import load_library

    lib = load_library()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # K3 at 64 x 25 s: 2,499 frames, cepstra and deltas in device memory
    n_long = 400000
    L_long = padded_length(cfg, n_long)
    rng_long = np.random.default_rng(21)
    sig_long = torch.from_numpy((rng_long.standard_normal((64, L_long)) * 3000)
                                .astype(np.float32)).to(dev)
    lens_long = torch.from_numpy(np.r_[n_long, 561, rng_long.integers(30000, n_long + 1, 62)]
                                 .astype(np.int32)).to(dev)
    before = (mfcc39_fused.launches, mfcc_tail.launches)
    got, nf_long = mfcc39_fused(sig_long, lens_long, cfg)
    want, nf_p = mfcc39_fused_ref(sig_long, lens_long, cfg)
    torch.cuda.synchronize()
    f_long = got.shape[1]
    if (mfcc39_fused.launches, mfcc_tail.launches) != (before[0] + 1, before[1] + 1):
        fail(f"K3 at {f_long} frames did not run its two launches")
    if not torch.equal(nf_long, nf_p) or not torch.allclose(got, want, **K3_TOL):
        fail(f"K3 at {f_long} frames disagrees with its plain version: max |d| "
             f"{float((got - want).abs().max())}")
    k3_long_err = float((got - want).abs().max())
    phase("K3", f"64 x 25 s ({f_long} frames; the cepstra kernel and K14, no frame "
                f"limit): == plain (rtol 2e-3, atol 5e-4; max |d| {k3_long_err:.3g}), "
                f"frame counts equal")
    # K1 + K2 on a 1,500-word loop graph of the bank's digits (7,500 states)
    trans11 = [bank.trans_cost[i].cpu().numpy() for i in range(11)]
    big1 = build_loop_graph([trans11[i % 11] for i in range(1500)], word_insertion_cost=2.0)
    bgb = banded_arrays(big1, device=dev)
    bgb = bgb._replace(bank_state=bgb.bank_state % w.shape[0])  # word i is digit i % 11
    topob = vk.banded_topology(bgb)
    Bb, Tb = 64, 100
    xab, nfb = xa[:, :Tb, :Bb].contiguous(), nf[:Bb].clamp(max=Tb)
    plan_b = vk.banded_plan(Bb, n_sm, bgb.n_states, bgb.n_words, bgb.n_ends, w.shape[0],
                            "fused", lib.srt_smem_limit())
    got = vk.viterbi_banded_fused(xab, w, lw, bgb, topob, nfb)
    want = vk.viterbi_banded_fused_ref(xab, w, lw, bgb, topob, nfb)
    torch.cuda.synchronize()
    if not torch.allclose(got[0], want[0], rtol=K1_RTOL, atol=0.0):
        fail(f"K1 on the {bgb.n_states}-state loop disagrees: max |d| "
             f"{float((got[0] - want[0]).abs().max())}")
    validb = torch.arange(Tb, device=dev)[:, None] < nfb[None, :]
    endsb = bgb.end_states[torch.argmin(want[0][bgb.end_states], 0)]
    sk, fk = vk.banded_backtrace_val(got[1], got[3], endsb, nfb, topob.uniform_w)
    sp, fp = vk.banded_backtrace_val_ref(want[1], want[3], endsb, nfb, topob.uniform_w)
    torch.cuda.synchronize()
    if not bool(((sk == sp) & (fk == fp) | ~validb).all()):
        fail(f"K1 + K2 states differ on the {bgb.n_states}-state loop")
    k1_big = (got, want)
    phase("K1+K2", f"1,500-word loop ({bgb.n_states} states, frontier in "
                   f"{plan_b.frontier} memory, {plan_b.kf} frames staged) at {Bb}x{Tb}: "
                   f"final == plain (rtol 1e-5, max |d| "
                   f"{float((got[0] - want[0]).abs().max()):.3g}); states identical")
    # K10 on the same loop and inputs (K10 refused above ~6,400 states before)
    plan_10b = vk.banded_plan(Bb, n_sm, bgb.n_states, bgb.n_words, bgb.n_ends, w.shape[0],
                              "wordtrace", lib.srt_smem_limit())
    err, k10_big = check_k10(f"the 1,500-word loop ({bgb.n_states} states, frontier in "
                             f"{plan_10b.frontier} memory, {plan_10b.kf} frames staged)",
                             xab, w, lw, bgb, topob, nfb)
    report["K10"] = {"max_abs_err": max(k10_err, err)}
    # K8 + K9 on a 2,000-word loop of 2-5-state words (7,000 states)
    tr6 = [bank6.trans_cost[i].cpu().numpy() for i in range(11)]
    big8 = build_loop_graph([tr6[i % 11][:k, :k] for i, k in zip(range(2000),
                                                                (3, 4, 5, 2) * 500)],
                            word_insertion_cost=0.5)
    bg8 = banded_arrays(big8, device=dev)
    bg8 = bg8._replace(bank_state=bg8.bank_state % 66)
    topo8 = vk.banded_topology(bg8)
    B8b = 32
    nll8b = torch.from_numpy(erng.integers(0, 3, (66, Tb, B8b)).astype(np.float32)).to(dev)
    nf8b = torch.from_numpy(np.r_[Tb, 0, 1, Tb + 3, erng.integers(2, Tb + 1, B8b - 4)]
                            .astype(np.int32)).to(dev)
    plan_8 = vk.banded_plan(B8b, n_sm, bg8.n_states, bg8.n_words, bg8.n_ends, 66, "general",
                            lib.srt_smem_limit())
    got = vk.viterbi_banded_general(nll8b, bg8, topo8, nf8b, big8.eps_depth)
    want = vk.viterbi_banded_general_ref(nll8b, bg8, topo8, nf8b, big8.eps_depth)
    torch.cuda.synchronize()
    for k, plane in enumerate(("final", "bp8", "eps_u")):
        if not torch.equal(got[k], want[k]):
            fail(f"K8 {plane} differs on the {bg8.n_states}-state loop")
    ends8 = bg8.end_states[torch.argmin(want[0][bg8.end_states] + bg8.end_bonus[:, None], 0)]
    sk, fk = vk.banded_backtrace_general(got[1], got[2], bg8, ends8, nf8b, big8.eps_depth)
    sp, fp = vk.banded_backtrace_general_ref(want[1], want[2], bg8, ends8, nf8b,
                                             big8.eps_depth)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(fk, fp)):
        fail(f"K9 differs on the {bg8.n_states}-state loop")
    k8_big = (got, want)
    phase("K8+K9", f"2,000-word loop of 2-5-state words ({bg8.n_states} states, frontier "
                   f"in {plan_8.frontier} memory), integer emissions (ties), lengths 0, "
                   f"1, T, T + 3 at {B8b}x{Tb}: final, bp8, eps_u, K9 states == plain "
                   f"(bit-identical)")
    # K11 one state past its shared-memory frontier
    s11 = max_dense_states(lib) + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    tr11 = torch.rand((s11, s11), generator=gen, device=dev) * 3
    tr11[torch.rand((s11, s11), generator=gen, device=dev) < 0.5] = POS_INF
    k11_big = dict(nll=torch.rand((2, 4, s11), generator=gen, device=dev) * 5, trans=tr11,
                   init_cost=torch.rand(s11, generator=gen, device=dev),
                   n_frames=torch.tensor([4, 3], dtype=torch.int32, device=dev),
                   eps_trans=None, eps_depth=1)
    got = viterbi_dense(**k11_big)
    want = viterbi_dense_ref(**k11_big)
    torch.cuda.synchronize()
    for k, plane in enumerate(("final", "bp", "eps_bp")):
        if not torch.equal(got[k], want[k]):
            fail(f"K11 {plane} differs from the plain version at {s11} states")
    if dense_form(k11_big) != "scratch form":
        fail(f"K11 at {s11} states runs the {dense_form(k11_big)}, not the scratch form")
    phase("K11", f"{s11} states (one past the shared-memory frontier; scratch form: "
                 f"frontier in device memory) at 2x4: final, bp, eps_bp == plain "
                 f"(bit-identical)")
    # K21 on those planes: past K11's frontier the plan takes the chain form
    big_name = f"K11's planes at {s11} states"
    check_k21(big_name, (want[1], want[2], torch.argmin(want[0], 1), k11_big["n_frames"], 1))
    picked = {k: p.form for k, p in k21_picked.items()}
    if picked != {**{n_: "window" for n_ in dense_cases}, view_name: "chain",
                  big_name: "chain"}:
        fail(f"K21's plan picked {picked}: not the window form on K11's planes and the "
             f"chain form on views and past {s11 - 1} states")
    if set(k21_forms) != {"chain", "window"}:
        fail(f"the K21 sweep missed a form: {sorted(k21_forms)}")
    phase("K21", f"{big_name}: states and flags == viterbi_backtrace_ref in the plan's "
                 f"{k21_picked[big_name].form} form and the window form at 8 x 8 and "
                 f"32 x 128; every "
                 f"form ran: " + "; ".join(f"{k} on {len(v)} cases" for k, v in
                                           k21_forms.items()))
    # K13 past two feature tiles' room in shared memory (A above ~450): the
    # chunked form at A = 512 and 1,024 over the CLI bank's 55 states x 4
    # mixtures, 64 x 500 columns
    k13_wide = {}
    for a_w in (512, 1024):
        gen_w = torch.Generator(device=dev).manual_seed(a_w)
        w_w = torch.randn((55, 4, a_w), generator=gen_w, device=dev) * 0.05
        lw_w = torch.log_softmax(torch.randn((55, 4), generator=gen_w, device=dev), -1)
        xa_w = torch.randn((a_w, 500, 64), generator=gen_w, device=dev)
        if vk.emission_plan(a_w, 55, 4, lib.srt_smem_limit()) != "chunked":
            fail(f"K13 at A = {a_w} does not take the chunked form")
        before = vk.bank_emission.launches
        got = vk.bank_emission(xa_w, w_w, lw_w)
        want = vk.bank_emission_ref(xa_w, w_w, lw_w)
        torch.cuda.synchronize()
        if vk.bank_emission.launches != before + 1:
            fail(f"K13 at A = {a_w} did not launch once")
        if not torch.allclose(got, want, **K13_TOL):
            fail(f"K13 at A = {a_w} disagrees with its plain version: max |d| "
                 f"{float((got - want).abs().max())}")
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: vk.bank_emission(xa_w, w_w, lw_w))
        plain = cuda_ms(lambda: vk.bank_emission_ref(xa_w, w_w, lw_w))
        k13_wide[a_w] = (xa_w, w_w, lw_w, got, ms, plain)
        report["K13"]["max_abs_err"] = max(report["K13"]["max_abs_err"], err)
        phase("K13", f"A = {a_w} (chunked form: features in chunks of 64 dimensions) at "
                     f"64x500, 55 states x 4 mixtures: == plain (rtol 1e-5, atol 1e-4; max "
                     f"|d| {err:.3g}); {ms:.3f} ms, plain {plain:.3f} ms ({card})")

    # ---- 4g. K15 / K16 (the forward-backward) vs their plain versions --------
    # K15 on the loop graph, the 385-state sausage at 256 x 500 (emissions
    # from K13's plane, lengths T, 1, 0 and mixed), a sausage of 1-state words
    # (eps depth > 1), the 1k trie's lexgraph (cross edges, -inf end scores
    # off the word ends; eps rows 1,000 ends wide, a warp each) and the padded
    # per-item banded dict of 419 transcript graphs; K16 at 419 x 319 on the
    # same transcripts (per-item matrices, both xi modes), on a 170-state
    # loop, an ergodic 64-state HMM, a batch with an unreachable item and a
    # 3,500-state loop whose lists live in device memory; every case twice,
    # bit for bit
    from speech_recognition_tpu_torch.models.graph import (
        pad_graphs,
        pad_graphs_banded,
        transcript_graph,
    )
    from speech_recognition_tpu_torch.models.hmm import bank_nll
    from speech_recognition_tpu_torch.ops import forward_backward_kernels as fbk
    from speech_recognition_tpu_torch.ops.viterbi_banded import BandedGraph

    def fb_errors(got, want):
        """``(log Z relative, gamma absolute, xi absolute, xi relative)``
        differences, with the cross counts in the xi terms."""
        xg = [got.xi_sum] + ([got.xi_cross] if got.xi_cross is not None else [])
        xw = [want.xi_sum] + ([want.xi_cross] if want.xi_cross is not None else [])
        fin = torch.isfinite(want.log_z)
        zr = float(((got.log_z - want.log_z).abs() / want.log_z.abs().clamp(min=1e-30))[fin]
                   .max()) if bool(fin.any()) else 0.0
        if not torch.equal(torch.isfinite(got.log_z), fin):
            zr = float("inf")
        return (zr, float((got.gamma - want.gamma).abs().max()),
                max(float((a - b).abs().max()) for a, b in zip(xg, xw)),
                max(float(((a - b).abs() - FB_XI_TOL["atol"]).clamp(min=0).div(
                    b.abs().clamp(min=1e-30)).max()) for a, b in zip(xg, xw)))

    def fb_check(kernel, name, got, want):
        zr, ga, xa_, xr = fb_errors(got, want)
        finite = all(bool(torch.isfinite(x).all()) for x in (got.gamma, got.xi_sum))
        if not (finite and zr <= FB_TOL["log_z_rtol"] and ga <= FB_TOL["gamma_atol"]
                and xr <= FB_XI_TOL["rtol"]):
            fail(f"{kernel} disagrees with its plain version on {name}: log Z rel {zr:.3g}, "
                 f"gamma {ga:.3g}, xi {xa_:.3g} (rel past atol {xr:.3g})")
        phase(kernel, f"{name}: log Z rel {zr:.2g}, gamma |d| {ga:.2g}, xi |d| {xa_:.2g} "
                      f"(tolerances {FB_TOL}, xi {FB_XI_TOL})")
        return max(ga, xa_)

    fb_rng = np.random.default_rng(13)
    fb_err = {"K15": 0.0, "K16": 0.0}
    bg7 = planes["sausage7"][0]
    B15, T15 = 256, 500
    nll15 = nll13[bg7.bank_state].permute(2, 1, 0)[:B15].contiguous()
    nf15 = nf[:B15].clone()
    nf15[2] = 0
    bgl = banded_arrays(graphs["loop"], device=dev)
    nll_loop = nll13[bgl.bank_state].permute(2, 1, 0)[:128, :200].contiguous()
    nf_loop = nf[:128].clamp(max=200)
    one_g = build_word_graph([np.array([[0.7]], np.float32)] + trans[:3], [[0, 1, 2, 3]] * 5)
    bg_one = banded_arrays(one_g, device=dev)
    nll_one = torch.from_numpy(fb_rng.uniform(40, 60, (32, 100, one_g.n_states)).astype(
        np.float32)).to(dev)
    nf_one = torch.from_numpy(np.r_[100, 0, 1, fb_rng.integers(2, 101, 29)].astype(
        np.int32)).to(dev)
    from speech_recognition_tpu_torch.data.lexicon import bench_lexicon
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph

    lex_w, lex_t, lex_ids, _ = bench_lexicon()
    g_lex = build_lex_graph(lex_w, lex_t, lex_ids, word_insertion_cost=0.5).banded.to(dev)
    end_lex = torch.full((g_lex.n_states,), -float("inf"), device=dev)
    end_lex[g_lex.end_states] = 0.0
    nll_lex = torch.from_numpy(fb_rng.uniform(40, 60, (16, 200, g_lex.n_states)).astype(
        np.float32)).to(dev)
    nf_lex = torch.from_numpy(np.r_[200, 1, fb_rng.integers(2, 201, 14)].astype(np.int32)
                              ).to(dev)
    # 419 transcripts of 1-7 digits over the bank's words: the soft-EM shape
    B16, T16 = 419, 319
    tr_graphs = [transcript_graph(trans, [int(x) for x in fb_rng.integers(
        0, 11, fb_rng.integers(1, 8))]) for _ in range(B16)]
    gd16, depth16 = pad_graphs(tr_graphs)
    g16 = {k: torch.as_tensor(gd16[k], device=dev) for k in
           ("trans", "eps_trans", "init_cost", "end_scores", "bank_state")}
    feats16 = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (B16, T16, 39)).astype(np.float32)).to(dev)
    nf16 = torch.from_numpy(np.r_[T16, 1, 0, fb_rng.integers(T16 // 2, T16 + 1, B16 - 3)]
                            .astype(np.int32)).to(dev)
    s16 = g16["trans"].shape[1]
    nll16 = bank_nll(bank, feats16).gather(
        2, g16["bank_state"].long()[:, None, :].expand(B16, T16, s16)).contiguous()
    gbd, depth_b = pad_graphs_banded(tr_graphs)
    g15t = BandedGraph(*[torch.as_tensor(gbd[k], device=dev) for k in (
        "band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos", "is_start")],
        end_states=None, end_bonus=None,
        bank_state=torch.as_tensor(gbd["bank_state"], device=dev))
    end15t = torch.as_tensor(gbd["end_scores"], device=dev)
    fb15_cases = {
        "loop graph 128x200": (nll_loop, bgl, nf_loop, 1, None),
        f"385-state sausage7 {B15}x{T15} (lengths T, 1, 0, mixed)": (nll15, bg7, nf15, 1, None),
        f"sausage of 1-state words ({one_g.n_states} states, eps depth {one_g.eps_depth}) "
        f"32x100": (nll_one, bg_one, nf_one, one_g.eps_depth, None),
        f"1k trie lexgraph ({g_lex.n_states} states, cross edges) 16x200":
            (nll_lex, g_lex, nf_lex, 1, end_lex),
        f"{B16} padded transcript graphs (per-item banded dict) {B16}x{T16}":
            (nll16, g15t, nf16, depth_b, end15t),
    }
    def fb_repeat(kernel, name, fn, got):
        """A second call on the same inputs must give the same bits."""
        again = fn()
        torch.cuda.synchronize()
        for a_, b_ in zip(got, again):
            if (a_ is None) != (b_ is None) or (a_ is not None and not torch.equal(a_, b_)):
                fail(f"{kernel} is not bit-identical across two calls on {name}")

    for name, (x_, g_, n_, d_, e_) in fb15_cases.items():
        run = lambda: fbk.fb_banded(x_, g_, n_, d_, e_)  # noqa: E731
        got = run()
        want = fbk.fb_banded_ref(x_, g_, n_, d_, e_)
        torch.cuda.synchronize()
        fb_err["K15"] = max(fb_err["K15"], fb_check("K15", name, got, want))
        fb_repeat("K15", name, run, got)
    if one_g.eps_depth < 2:
        fail("the 1-state words' sausage has eps depth 1")
    wide_ = int((g_lex.eps_block < 0.5e30).sum(-1).max())
    if wide_ <= 64:  # K15's eps rows past 64 ends take a warp each
        fail(f"the 1k trie's widest eps row has {wide_} ends, not past the kernel's 64")
    loop34 = build_loop_graph([trans[i % 11] for i in range(34)])
    g34 = {k: torch.as_tensor(getattr(loop34, k), device=dev)
           for k in ("trans", "eps_trans", "init_cost")}
    nll34 = torch.from_numpy(fb_rng.uniform(40, 60, (8, 60, loop34.n_states)).astype(
        np.float32)).to(dev)
    nf34 = torch.tensor([60, 0, 1, 17, 60, 33, 59, 2], dtype=torch.int32, device=dev)
    # an ergodic 64-state HMM: every entry of both matrices finite, so the
    # lists are the whole matrices.  Emission costs of 0-3 (the CPU tests'
    # scale): with GMM-sized costs (40-60) |log Z| reaches ~4e3 and float32
    # alone moves gamma by up to 6e-4 (the plain version against itself in
    # float64, on the CPU), past the 1e-4 the hold states, whatever the order
    # of the 64-term sums
    erg_t, erg_e = (torch.from_numpy(fb_rng.uniform(lo, hi, (64, 64)).astype(np.float32)).to(dev)
                    for lo, hi in ((0.5, 4.0), (3.0, 8.0)))
    erg_i = torch.from_numpy(fb_rng.uniform(0.0, 2.0, 64).astype(np.float32)).to(dev)
    nll_erg = torch.from_numpy(fb_rng.uniform(0, 3, (16, 100, 64)).astype(np.float32)).to(dev)
    nf_erg = torch.from_numpy(np.r_[100, 0, 1, fb_rng.integers(2, 101, 13)].astype(
        np.int32)).to(dev)
    # 32 of the transcripts with item 3's init costs all POS_INF: its whole
    # alpha row is unreachable, so its LSEs take the known-maximum branch
    un_init = g16["init_cost"][:32].clone()
    un_init[3] = 1e30
    # a 3,500-state loop of 700 five-state words: the plan puts the lists
    # in device memory, and the eps rows (700 entries each) run past their
    # capacity into the dense loop
    loop700 = build_loop_graph([trans[i % 11] for i in range(700)])
    g700 = {k: torch.as_tensor(getattr(loop700, k), device=dev)
            for k in ("trans", "eps_trans", "init_cost")}
    nll700 = torch.from_numpy(fb_rng.uniform(40, 60, (2, 12, loop700.n_states)).astype(
        np.float32)).to(dev)
    nf700 = torch.tensor([12, 7], dtype=torch.int32, device=dev)
    fb16_cases = {
        f"{B16} padded transcript graphs {B16}x{T16}":
            (nll16, g16["trans"], g16["init_cost"], nf16, g16["eps_trans"], depth16,
             g16["end_scores"]),
        f"{loop34.n_states}-state loop 8x60":
            (nll34, g34["trans"], g34["init_cost"], nf34, g34["eps_trans"], 1, None),
        "ergodic 64-state HMM 16x100 (every entry finite)":
            (nll_erg, erg_t, erg_i, nf_erg, erg_e, 1, None),
        "32 transcripts, item 3 unreachable":
            (nll16[:32], g16["trans"][:32], un_init, nf16[:32], g16["eps_trans"][:32], depth16,
             g16["end_scores"][:32]),
        f"{loop700.n_states}-state loop 2x12 (lists in device memory)":
            (nll700, g700["trans"], g700["init_cost"], nf700, g700["eps_trans"], 1, None),
    }
    n_sm_fb = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, args_ in fb16_cases.items():
        plan = fbk.dense_plan(args_[0].shape[2], True, args_[0].shape[0], n_sm_fb,
                              lib.fb_dense_smem_bytes, lib.srt_smem_limit())
        if name.startswith(str(loop700.n_states)) and plan.lists != "device":
            fail(f"K16's plan keeps the {loop700.n_states}-state loop's lists in shared memory")
        for mode in ("band", "dense") if args_[0].shape[2] < 1000 else ("band",):
            run = lambda: fbk.fb_dense(*args_, xi_mode=mode)  # noqa: E731
            got = run()
            want = fbk.fb_dense_ref(*args_, xi_mode=mode)
            torch.cuda.synchronize()
            fb_err["K16"] = max(fb_err["K16"], fb_check(
                "K16", f"{name}, xi {mode} (lists in {plan.lists} memory, {plan.cap} entries "
                       f"each)", got, want))
            fb_repeat("K16", name, run, got)
    # past the rows' room in shared memory (the device-row tier): K15 on a
    # 30,000-state loop (300 words of 100 states), K16 on a 19,500-state
    # loop (195 words; its [S, S] matrices built on the card, its lists
    # prebuilt in device memory); lengths T, 0, 1 and mixed
    def long_loop(n_words, n):
        """A loop of ``n_words`` left-to-right words of ``n`` states (self
        and step costs -log 0.5, each word end to each word start at cost
        1) as a BandedGraph, and as K16's dense (trans, eps, init)."""
        s_ = n_words * n
        idx = torch.arange(s_, device=dev)
        first = idx % n == 0
        band = torch.full((3, s_), 1e30, device=dev)
        band[0] = 0.6931472
        band[1] = torch.where(first, 1e30, 0.6931472)
        starts, init = idx[first], torch.where(first, 0.0, 1e30)
        ends, blk = starts + n - 1, torch.ones((n_words, n_words), device=dev)
        g_ = BandedGraph(band, init, starts, ends, blk, torch.where(first, idx // n, 0), first,
                         ends, torch.zeros(n_words, device=dev), idx % 55)
        return g_, lambda: (torch.full((s_, s_), 1e30, device=dev).index_put_(
            (idx, idx), band[0]).index_put_((idx[1:], idx[:-1]), band[1, 1:]),
            torch.full((s_, s_), 1e30, device=dev).index_put_(
                (starts[:, None], ends[None, :]), blk), init)

    big_fb = {}
    g30k, _ = long_loop(300, 100)
    gen_fb = torch.Generator(device=dev).manual_seed(15)
    nll30k = torch.rand((4, 40, g30k.n_states), generator=gen_fb, device=dev) * 20 + 40
    nf30k = torch.tensor([40, 0, 1, 23], dtype=torch.int32, device=dev)
    if fbk.banded_plan(g30k.n_states, 300, 300, lib.fb_banded_smem_bytes,
                       lib.srt_smem_limit()).rows != "device":
        fail("K15's plan keeps the 30,000-state loop's rows in shared memory")
    run = lambda: fbk.fb_banded(nll30k, g30k, nf30k)  # noqa: E731
    got = run()
    want = fbk.fb_banded_ref(nll30k, g30k, nf30k)
    torch.cuda.synchronize()
    name = f"{g30k.n_states}-state loop 4x40 (rows in device memory)"
    fb_err["K15"] = max(fb_err["K15"], fb_check("K15", name, got, want))
    fb_repeat("K15", name, run, got)
    big_fb["K15"] = (name, fb_banded_work(nll30k, g30k, nf30k, 1, None, got), cuda_ms(run, 3),
                     cuda_ms(lambda: fbk.fb_banded_ref(nll30k, g30k, nf30k), 1))
    g19k, dense19k = long_loop(195, 100)
    tr19k, ep19k, in19k = dense19k()
    nll19k = torch.rand((2, 12, g19k.n_states), generator=gen_fb, device=dev) * 20 + 40
    nf19k = torch.tensor([12, 7], dtype=torch.int32, device=dev)
    plan19k = fbk.dense_plan(g19k.n_states, True, 2, n_sm_fb, lib.fb_dense_smem_bytes,
                             lib.srt_smem_limit())
    if (plan19k.rows, plan19k.lists) != ("device", "device"):
        fail(f"K16's plan for the 19,500-state loop is {plan19k}, not the device-row tier")
    args19k = (nll19k, tr19k, in19k, nf19k, ep19k, 1, None)
    run = lambda: fbk.fb_dense(*args19k, xi_mode="band")  # noqa: E731
    got = run()
    want = fbk.fb_dense_ref(*args19k, xi_mode="band")
    torch.cuda.synchronize()
    name = f"{g19k.n_states}-state loop 2x12, xi band (rows in device memory, lists prebuilt)"
    fb_err["K16"] = max(fb_err["K16"], fb_check("K16", name, got, want))
    fb_repeat("K16", name, run, got)
    big_fb["K16"] = (name, fb_dense_work(nll19k, tr19k, ep19k, in19k, None, nf19k, 1, got),
                     cuda_ms(run, 3),
                     cuda_ms(lambda: fbk.fb_dense_ref(*args19k, xi_mode="band"), 1))
    del want, got, args19k, tr19k, ep19k, run  # 3 GB of matrices
    for k_, (name, _, ms, plain) in big_fb.items():
        phase(k_, f"{name}: {ms:.3f} ms, plain {plain:.3f} ms ({card})")
    report["K15"] = {"max_abs_err": fb_err["K15"]}
    report["K16"] = {"max_abs_err": fb_err["K16"]}

    # ---- 5. K4 + K5 vs their plain versions -------------------------------
    from speech_recognition_tpu_torch.data.lexicon import (
        bench_lexicon,
        dict1_shaped_lexicon,
        flat_lm_lexicon,
        large_bank_lexicon,
        planted_emissions,
    )
    from speech_recognition_tpu_torch.models.lexgraph import build_lex_graph
    from speech_recognition_tpu_torch.ops import viterbi_lex_kernels as lk

    words, trans, ids, lrng = bench_lexicon()
    lex1k = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    TL = 500
    # bench_lextree's emission draw: uniform(0, 5) over the 24 bank rows
    e = lrng.uniform(0, 5, (128, TL, 24)).astype(np.float32)
    nll1k = torch.from_numpy(np.ascontiguousarray(e.transpose(2, 1, 0))).to(dev)
    nf1k = torch.from_numpy(np.r_[TL, 1, np.random.default_rng(3).integers(
        2, TL + 1, 126)].astype(np.int32)).to(dev)
    g1k = lex1k.banded.to(dev)
    k4_err, k5_err, lex_planes, lex_ends = check_lex("1k trie", lex1k, g1k, nll1k, nf1k)
    noise = np.random.default_rng(4).uniform(0, 3, tuple(g1k.eps_block.shape))
    g_rand = g1k._replace(eps_block=g1k.eps_block + torch.from_numpy(
        noise.astype(np.float32)).to(dev))
    e4, e5, _, _ = check_lex("1k trie, random eps block", lex1k, g_rand, nll1k, nf1k)
    k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
    g_gen = perturbed_band(g1k)
    e4, e5, _, _ = check_lex("1k trie, band perturbed (general mode)", lex1k, g_gen, nll1k,
                             nf1k)
    k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
    # 100 roots: K4 reduces the re-entry 64 roots per pass, so this takes two
    words, trans, ids, lm, frng = flat_lm_lexicon(100)
    lexf = build_lex_graph(words, trans, ids, lm=lm, word_insertion_cost=0.3)
    nllf = torch.from_numpy(frng.uniform(0, 5, (2 * len(words), TL, 128))
                            .astype(np.float32)).to(dev)
    e4, e5, _, _ = check_lex("flat 100-word bigram vocabulary", lexf, None, nllf, nf1k)
    k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
    words, trans, ids, drng = dict1_shaped_lexicon()
    lexd = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    n_bank_d = int(lexd.banded.bank_state.max()) + 1
    nlld = torch.from_numpy(drng.uniform(0, 5, (n_bank_d, TL, 32)).astype(np.float32)).to(dev)
    nfd = torch.from_numpy(np.r_[TL, 1, drng.integers(2, TL + 1, 30)].astype(np.int32)).to(dev)
    gd = lexd.banded.to(dev)
    e4, e5, dict_planes, dict_ends = check_lex("dict1-shaped trie", lexd, gd, nlld, nfd)
    k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
    # 8,000 bank rows: the two per-frame row tables alone pass a CTA's
    # shared memory, so the plan keeps none (the band phase reads the bank
    # rows and emissions through L1)
    words, trans, ids, brng = large_bank_lexicon()
    lexb = build_lex_graph(words, trans, ids, word_insertion_cost=0.5)
    nllbig = torch.from_numpy(brng.uniform(0, 5, (8000, TL, 16)).astype(np.float32)).to(dev)
    nfbig = torch.from_numpy(np.r_[TL, 1, brng.integers(2, TL + 1, 14)].astype(np.int32)).to(dev)
    gbig = lexb.banded.to(dev)
    e4, e5, _, _ = check_lex("8,000-bank-row trie", lexb, gbig, nllbig, nfbig)
    report["K4"] = {"max_abs_err": max(k4_err, e4)}
    report["K5"] = {"max_abs_err": max(k5_err, e5)}

    # ---- 5b. K6 + K7 vs their plain versions ---------------------------------
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram
    from speech_recognition_tpu_torch.ops import lattice_kernels as lt
    from speech_recognition_tpu_torch.ops.lattice import lattice_lm

    # bench_lextree_bigram's set-up: the 1k trie, then from the same rng
    # the add-k LM of 200 random 12-word sentences and uniform(0, 5)
    # emissions at 128 x 500
    words1k, _, ids1k, brng = bench_lexicon()
    lm1k = fit_bigram([[int(x) for x in brng.integers(0, 1000, 12)] for _ in range(200)], 1000)
    e = brng.uniform(0, 5, (TL, 24, 128)).astype(np.float32)
    nll_b = torch.from_numpy(np.ascontiguousarray(e.transpose(1, 0, 2))).to(dev)
    # lengths T, 0 and 1 among them: every frame past nf is a frozen copy
    nf_b = torch.from_numpy(np.r_[TL, 0, 1, brng.integers(2, TL + 1, 125)]
                            .astype(np.int32)).to(dev)
    lm_l1k = lattice_lm(lm1k, lex1k.leaf_word, dev)
    if lm_l1k[3] is None:
        fail("the add-k LM on the 1k trie has no backoff structure")
    errs = [check_lattice("1k trie, uniform emissions", lex1k, g1k, nll_b, nf_b, lm_l1k)]
    ep, nfp_, seqs_p = planted_emissions(np.random.default_rng(5), words1k, ids1k, 3, 24,
                                         128, TL)
    nll_p = torch.from_numpy(ep).to(dev)
    nf_p = torch.from_numpy(nfp_).to(dev)
    errs.append(check_lattice("1k trie, planted words", lex1k, g1k, nll_p, nf_p, lm_l1k))
    hit = sum(w == s_ for w, s_ in zip(errs[-1][0], seqs_p))
    phase("K6+K7", f"planted 1k-trie word strings recovered exactly: {hit} of {len(seqs_p)} "
                   f"(mean {sum(map(len, seqs_p)) / len(seqs_p):.2f} words/utt)")
    # the dense [L, L] recombination: a random LM without backoff structure
    rnd = np.random.default_rng(6)
    lm_dense = types.SimpleNamespace(cost=rnd.uniform(0.1, 3.0, (1000, 1000)),
                                     start_cost=rnd.uniform(0.1, 2.0, 1000),
                                     end_cost=rnd.uniform(0.1, 2.0, 1000))
    lm_ld = lattice_lm(lm_dense, lex1k.leaf_word, dev)
    if lm_ld[2] is None:
        fail("the random LM was taken as a backoff LM")
    errs.append(check_lattice("1k trie, uniform emissions", lex1k, g1k, nll_b, nf_b, lm_ld))
    errs.append(check_lattice("1k trie, band perturbed (general mode)", lex1k, g_gen, nll_b,
                              nf_b, lm_l1k))
    # bench_lextree_dict1_bigram's shape: the dictionary-shaped trie, the
    # LM of 400 random 20-word sentences, 16 x 500
    wordsd, _, idsd, drng2 = dict1_shaped_lexicon()
    lmd = fit_bigram([[int(x) for x in drng2.integers(0, len(wordsd), 20)]
                      for _ in range(400)], len(wordsd))
    lm_ldd = lattice_lm(lmd, lexd.leaf_word, dev)
    nll_bd = torch.from_numpy(drng2.uniform(0, 5, (n_bank_d, TL, 16)).astype(np.float32)).to(dev)
    nf_bd = torch.from_numpy(np.r_[TL, 0, 1, drng2.integers(2, TL + 1, 13)]
                             .astype(np.int32)).to(dev)
    errs.append(check_lattice("dict1-shaped trie, uniform emissions", lexd, gd, nll_bd,
                              nf_bd, lm_ldd))
    ep, nfp_, seqs_p = planted_emissions(np.random.default_rng(8), wordsd, idsd, 3, n_bank_d,
                                         16, TL)
    errs.append(check_lattice("dict1-shaped trie, planted words", lexd, gd,
                              torch.from_numpy(ep).to(dev), torch.from_numpy(nfp_).to(dev),
                              lm_ldd))
    hit = sum(w == s_ for w, s_ in zip(errs[-1][0], seqs_p))
    phase("K6+K7", f"planted dict1-shaped word strings recovered exactly: {hit} of "
                   f"{len(seqs_p)}")
    report["K6"] = {"max_abs_err": max(e[1] for e in errs)}
    report["K7"] = {"max_abs_err": max(e[2] for e in errs)}
    report["K22"] = {"max_abs_err": 0.0}

    # K7 in every plan on K6's planes: the staged mode as the plan takes it
    # and with its LM tables through L1, the direct
    # mode with its D rows in shared memory and in a device-memory scratch
    from speech_recognition_tpu_torch.ops.lattice import _ring_depth

    def k7_plans(name, nll_, g_, nf_, lm_, lexg_):
        ec, et = lt.viterbi_lattice(nll_, g_, lk.lex_topology(g_), nf_)[1:]
        l_, dense = g_.n_ends, lm_[3] is None
        k_ = 0 if dense else lm_[3][1].shape[1]
        auto = lt.rescore_plan(l_, k_, dense, lib.srt_smem_limit())
        plans = {"the plan's": auto,
                 "direct": lt.RescorePlan(0, 1024, False, False, 8 * l_),
                 "direct, D in device memory": lt.RescorePlan(0, 1024, False, True, 0)}
        if auto.leaves and auto.tables:
            plans["staged, tables through L1"] = auto._replace(
                tables=False, smem=lt.rescore_smem_bytes(l_, k_, False))
        args = (ec, et, ec.amin(2), lm_[0], lm_[1], nf_, _ring_depth(nll_.shape[1], 128))
        kw = dict(big_ll=lm_[2], backoff=lm_[3])
        want_ = lt.rescore_lattice_ref(*args, **kw)
        ok = torch.arange(nll_.shape[1], device=dev)[:, None, None] < nf_[None, :, None]
        mw_ = min(nll_.shape[1], nll_.shape[1] // (lexg_.n_states // lexg_.n_arcs) + 1)
        # the pipeline's launch at a max_dur of 11 frames (off a multiple of
        # 8, ring depth 16): a word of 4 or more 3-state units spans more
        args_w = (ec, et, lm_[0], lm_[1], nf_, _ring_depth(nll_.shape[1], 11))
        want_w = None
        for pname, plan in plans.items():
            got_ = lt.rescore_lattice(*args, **kw, plan=plan)
            torch.cuda.synchronize()
            if not (torch.equal(got_[0], want_[0]) and torch.equal(got_[1], want_[1])
                    and bool(((got_[2] == want_[2]) | ~ok).all())):
                fail(f"K7 ({pname} plan, {plan.mode}) differs from the plain version on {name}")
            want_w = check_rescore_and_walk(name, args_w, kw, 11, mw_, plan=plan,
                                            want=want_w)[1]
        n_cut = int(want_w[3].sum())
        if not n_cut:
            fail(f"no arc of {name} is longer than 11 frames: the count went unchecked")
        phase("K7", f"{name} (L={l_}, {'dense' if dense else f'backoff, K={k_}'} LM) in every "
                    f"plan (" + "; ".join(v.mode for v in plans.values())
                    + "): cost, best leaf, pred_w == plain (bit-identical); rescore_and_walk's "
                    f"q, truncation counts ({n_cut} arcs past max_dur 11), DP and walk == "
                    f"plain in each")

    k7_plans("1k trie, uniform emissions", nll_b, g1k, nf_b, lm_l1k, lex1k)
    k7_plans("1k trie, dense LM", nll_b, g1k, nf_b, lm_ld, lex1k)
    k7_plans("dict1-shaped trie, uniform emissions", nll_bd, gd, nf_bd, lm_ldd, lexd)

    # ---- 5c. K17 / K18 (the streaming chunk steps) vs their plain versions --
    # Each kernel runs chunk by chunk from its own carry and every chunk is
    # held bit for bit against the plain version on the same carry; the
    # concatenated planes must then equal the monolithic DP's.
    from speech_recognition_tpu_torch.config import DecodeConfig
    from speech_recognition_tpu_torch.decode.streaming import StreamingDecoder

    CH, BS, BL = 64, 256, 128  # chunk frames; streams on the loop and on the trie
    cli_loop = build_loop_graph([bank.trans_cost[i].cpu().numpy() for i in range(bank.n_models)],
                                word_insertion_cost=DecodeConfig().word_insertion_cost)
    bgl = banded_arrays(cli_loop, device=dev)
    topol = vk.banded_topology(bgl)
    if vk.banded_route(topol, cli_loop.eps_depth) != "fused":
        fail("the CLI's loop graph does not take K17's uniform route")
    feats_s, nf_s = planted_features(bank, BS, T, np.random.default_rng(21))
    xa_s = augment_dtb(feats_s)
    nll_s = vk.bank_emission(xa_s, w, lw)  # K13's [U, T, B] view
    init_l = bgl.init_cost[:, None].expand(-1, BS).contiguous()

    def k17_hold(name, g_, topo_, nll_, nf_, depth, base, org, chunk=CH, form=None):
        """K17 chunk by chunk against its plain version, in the form
        ``banded_plan`` picks, or with ``form`` (``warp`` / ``four``)
        forced."""
        mode = f"{base}_chunk" + ("_org" if org else "")
        b_ = nll_.shape[2]
        lib_ = load_library()
        plan_ = vk.banded_plan(b_, vk._n_sm(dev), g_.n_states, g_.n_words, g_.n_ends,
                               nll_.shape[0], mode, lib_.srt_smem_limit(), form=form)
        if plan_.form == "warp":
            if plan_.smem != lib_.banded_warp_smem_bytes(vk.MODES[mode], nll_.shape[0],
                                                         plan_.tile):
                fail(f"K17 {mode} on {name}: the warp plan's bytes differ from the kernel's")
        elif plan_.smem != lib_.banded_forward_smem_bytes(
                vk.MODES[mode], nll_.shape[0], g_.n_states, g_.n_words, g_.n_ends, plan_.tile,
                int(plan_.work_smem), int(plan_.tables), int(plan_.ring), plan_.kf):
            fail(f"K17 {mode} on {name}: the plan's bytes differ from the kernel's")

        def launch(t0, c, fr, nv, first):
            return vk._banded_forward(nll_[:, t0:t0 + c], g_, nv, depth, mode,
                                      vk.viterbi_banded_chunk, plan=plan_, frontier=fr,
                                      first=first, topo=topo_)

        def plain(t0, c, fr, nv, first):
            x_ = nll_[:, t0:t0 + c]
            if base == "fused":
                return vk._fused_dp(x_, g_, nv, fr, fr, first, org)
            return vk.viterbi_banded_chunk_ref(x_, g_, topo_, fr, nv, first, org, "general",
                                               depth)

        init_ = g_.init_cost[:, None].expand(-1, b_).contiguous()
        outs = hold_chunks(f"K17 {mode} ({plan_.form} form) on {name}", launch, plain, init_,
                           nf_, nll_.shape[1], chunk, 1)
        mono = (vk._banded_forward(nll_, g_, nf_, 1, "fused", vk.viterbi_banded_fused)
                if base == "fused" else vk.viterbi_banded_general_ref(nll_, g_, topo_, nf_,
                                                                      depth))
        torch.cuda.synchronize()
        # a stream of length 0 keeps its frontier in the chunk step (K1's DP
        # gives it POS_INF, K8's moves it at frame 0): compare the others
        live = nf_ > 0
        for k in ((1, 2, 3) if base == "fused" else (1, 2)):
            if not torch.equal(torch.cat([o[k] for o in outs])[..., live], mono[k][..., live]):
                fail(f"K17 {mode} on {name}: concatenated planes differ from the monolithic "
                     f"DP's (output {k})")
        if not torch.equal(outs[-1][0][:, live], mono[0][:, live]):
            fail(f"K17 {mode} on {name}: the last carry differs from the monolithic final")
        where = (f"{plan_.form} form, {plan_.tile} warps a CTA, {plan_.per} states a lane"
                 if plan_.form == "warp" else f"{plan_.form} form, work area in "
                 f"{plan_.frontier} memory, {plan_.kf} frames staged")
        phase("K17", f"{mode} on {name} ({g_.n_states} states) at {b_}x{nll_.shape[1]} in "
                     f"{chunk}-frame chunks ({where}): carry, planes{', org' if org else ''} "
                     f"== plain every chunk; concatenated planes == the monolithic DP's")
        return outs

    from speech_recognition_tpu_torch.utils.build import load_library

    for org in (False, True):
        for form in (None, "four"):
            k17_hold("the CLI loop graph, planted features", bgl, topol, nll_s, nf_s, 1, "fused",
                     org, form=form)
    k17_hold("the CLI loop graph, 1-frame chunks", bgl, topol, nll_s[:, :8], nf_s.clamp(max=8),
             1, "fused", True, chunk=1)
    # a stream count off the warps per CTA: padding warps in the last CTA
    k17_hold("the CLI loop graph, 203 streams", bgl, topol, nll_s[:, :70, :203],
             nf_s[:203].clamp(max=70), 1, "fused", True, form="warp")
    bg1_, topo1_, nll1_, _, _, graph1_, _ = gen_planes["1-state sausage7"]
    nll6_ = gen_planes["3-6-state sausage7"][2]
    for org in (False, True):  # 77 words: past the warp form's 32 rows
        k17_hold("the 1-state sausage7", bg1_, topo1_, nll1_, nf8, graph1_.eps_depth,
                 "general", org)
    # the warp form on general graphs: 1-state words over 3 slots (eps
    # depth 2), words of 3-6 states over 2 slots, and the loop at eps
    # depth 2 in the general chunk mode
    small = {"the 1-state sausage3": build_word_graph(
                 [bank1.trans_cost[i].cpu().numpy() for i in range(10)], [list(range(10))] * 3),
             "the 3-6-state sausage2": build_word_graph(
                 [bank6.trans_cost[i].cpu().numpy()[:k, :k] for i, k in enumerate(sizes)],
                 [list(range(11))] * 2)}
    for gname, graph_ in small.items():
        bgs = banded_arrays(graph_, device=dev)
        topos = vk.banded_topology(bgs)
        nlls = nll6_ if "3-6" in gname else nll1_
        for org in (False, True):
            for form in ("warp", "four"):
                k17_hold(gname, bgs, topos, nlls[:, :128], nf8.clamp(max=128),
                         graph_.eps_depth, "general", org, form=form)
    for org in (False, True):
        k17_hold("the CLI loop graph at eps depth 2", bgl, topol, nll_s[:, :128],
                 nf_s.clamp(max=128), 2, "general", org, form="warp")
    k17_hold("the 1,500-word loop", bgb, topob, vk.bank_emission(xab, w, lw), nfb, 1, "fused",
             True)
    nl7 = vk.bank_emission(augment_dtb(torch.from_numpy(np.random.default_rng(22).standard_normal(
        (300, 5, 39)).astype(np.float32)).to(dev)), w, lw)
    k17_hold("the 1,500-word loop, 300 streams", bgb, topob, nl7,
             torch.full((300,), 5, dtype=torch.int32, device=dev), 1, "fused", True)
    # the wrapper (K13 + the DP) against its whole plain version on one chunk
    nv0 = nf_s.clamp(max=CH)
    got17 = vk.viterbi_banded_chunk((xa_s[:, :CH].contiguous(), w, lw), bgl, topol, init_l, nv0,
                                    True, True, "fused")
    want17 = vk.viterbi_banded_chunk_ref((xa_s[:, :CH].contiguous(), w, lw), bgl, topol, init_l,
                                         nv0, True, True, "fused")
    torch.cuda.synchronize()
    if not torch.allclose(got17[0], want17[0], rtol=K1_RTOL, atol=0.0):
        fail("K17 (K13 + the DP) carry differs from its plain version beyond rtol 1e-5")
    report["K17"] = {"max_abs_err": float((got17[0] - want17[0]).abs().max())}

    topo1k_ = lk.lex_topology(g1k)

    def k18_hold(name, g_, topo_, nll_, nf_, org, chunk=CH):
        def launch(t0, c, fr, nv, first):
            return lk.viterbi_lex_chunk(nll_[:, t0:t0 + c].contiguous(), g_, topo_, fr, nv,
                                        first, org)

        def plain(t0, c, fr, nv, first):
            return lk.viterbi_lex_chunk_ref(nll_[:, t0:t0 + c], g_, topo_, fr, nv, first, org)

        b_ = nll_.shape[2]
        init_ = g_.init_cost[None].expand(b_, -1).contiguous()
        outs = hold_chunks(f"K18 on {name}", launch, plain, init_, nf_, nll_.shape[1], chunk, 0)
        mono = lk.viterbi_lex_ref(nll_, g_, topo_, nf_)
        torch.cuda.synchronize()
        live = nf_ > 0  # a stream of length 0 keeps its frontier (K4's moves at frame 0)
        for k in (1, 2, 3):
            if not torch.equal(torch.cat([o[k] for o in outs])[:, live], mono[k][:, live]):
                fail(f"K18 on {name}: concatenated planes differ from K4's plain version's "
                     f"(output {k})")
        if not torch.equal(outs[-1][0][live], mono[0][live]):
            fail(f"K18 on {name}: the last carry differs from the monolithic final")
        mode_ = lk.LEX_MODES["chunk_org" if org else "chunk"]
        plan_ = lk.lex_plan(mode_, topo_, load_library().srt_smem_limit())
        phase("K18", f"{name} ({g_.n_states} states, {topo_.pack.rows.shape[0]} bank rows) at "
                     f"{b_}x{nll_.shape[1]} in {chunk}-frame chunks ({plan_text(topo_, False)}; "
                     f"with the ancestor map: frontier {plan_.frontier}, org rows "
                     f"{'shared' if plan_.tau else 'device'}): carry, planes"
                     f"{', org' if org else ''} == plain every chunk; concatenated planes == "
                     f"K4's plain version's")
        return outs

    for org in (False, True):
        k18_hold("the 1k trie, planted words", g1k, topo1k_, nll_p, nf_p, org)
    k18_hold("the 1k trie, 1-frame chunks", g1k, topo1k_, nll_p[:, :6], nf_p.clamp(max=6), True,
             chunk=1)
    k18_hold("the dict1-shaped trie", gd, lk.lex_topology(gd), nlld, nfd, True)
    k18_hold("the 8,000-bank-row trie", gbig, lk.lex_topology(gbig), nllbig, nfbig, True)
    report["K18"] = {"max_abs_err": 0.0}

    # ---- 6. both paths, through the CLI, on the card ------------------------
    from speech_recognition_tpu_torch import cli
    from speech_recognition_tpu_torch.data.synthetic import SyntheticDigits
    from speech_recognition_tpu_torch.data.wav import write_wav

    wav_dir = os.path.join(tmp, "wavs")
    os.makedirs(wav_dir)
    for u in SyntheticDigits(seed=0).continuous_corpus(32, tag="smoke"):
        write_wav(os.path.join(wav_dir, u.name), u.samples)
    n_wavs = len(os.listdir(wav_dir))

    def run_cli(run, device):
        graph, *extra = run.split()
        bank_file = bank1_path if "@1-state-bank" in extra else bank_path
        extra = [x for x in extra if x != "@1-state-bank"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["connected_test", "-i", bank_file, "-d", wav_dir,
                      "--graph", graph, *extra, "--device", device])
        return buf.getvalue()

    def word_lines(out):
        return [l for l in out.splitlines() if l.startswith(("Correct:", "Incorrect:"))]

    counters = kernel_counters()
    # device_ms holds the profiler's kernels to these counts (K15 and K16
    # launch a scan and a combine per counted call)
    COUNTED[:] = [(c, 2 if c in (fbk.fb_banded, fbk.fb_dense) else 1) for c in counters]
    bigram = "--lm bigram"
    k3 = (mfcc39_fused, mfcc_tail)
    paths = {"connected": (("loop", "sausage"), (*k3, vk.bank_emission,
                                                 vk.viterbi_banded_fused,
                                                 vk.banded_backtrace_val)),
             "lextree": (("lextree",), (*k3, lk.viterbi_lex, lk.lex_backtrace_val)),
             "bigram composed": ((f"loop {bigram}", f"sausage {bigram}",
                                  f"lextree {bigram} --decoder compose"),
                                 (*k3, vk.bank_emission, vk.viterbi_banded_fused,
                                  vk.banded_backtrace_val, lk.viterbi_lex,
                                  lk.lex_backtrace_val)),
             "bigram lattice": ((f"lextree {bigram} --decoder lattice",),
                                (*k3, lt.viterbi_lattice, lt.rescore_and_walk)),
             "general graph": (("sausage @1-state-bank",),
                               (*k3, vk.viterbi_banded_general,
                                vk.banded_backtrace_general)),
             # a 25 s cap: 2,499 frames
             "long cap": (("loop --max-samples 400000",),
                          (*k3, vk.bank_emission, vk.viterbi_banded_fused,
                           vk.banded_backtrace_val))}
    outs, launches = {}, {}
    for path, (runs, used) in paths.items():
        for c in counters:
            c.launches = 0
        for run in runs:
            outs[run] = run_cli(run, "cuda")
        torch.cuda.synchronize()
        launches[path] = {c.__name__: c.launches for c in counters}
        if not all(launches[path][c.__name__] for c in used):
            fail(f"a kernel of the {path} path was not launched: {launches[path]}")
        phase("main path", f"{path} path launches: {launches[path]}")
    if launches["general graph"]["viterbi_banded_fused"] or \
            launches["general graph"]["banded_backtrace_val"]:
        fail(f"the 1-state bank's sausage ran the fused kernels: {launches['general graph']}")
    # the bigram lattice path's K7 launch computes q and the truncation
    # count and walks the words: no standalone K7 or K22 launch
    if launches["bigram lattice"]["rescore_lattice"] or \
            launches["bigram lattice"]["lattice_walk"]:
        fail(f"the bigram lattice path launched a standalone K7 or K22: "
             f"{launches['bigram lattice']}")
    for run in outs:
        if len(word_lines(outs[run])) != n_wavs:
            fail(f"connected_test --graph {run} decoded "
                 f"{len(word_lines(outs[run]))} of {n_wavs} wavs")
        if outs[run] != run_cli(run, "cpu"):
            fail(f"connected_test --graph {run}: CUDA output differs from the CPU run")
        wer_line = [l for l in outs[run].splitlines() if l.startswith("WER:")][0]
        phase("main path", f"cli connected_test --graph {run} --device cuda on "
                           f"{n_wavs} synthetic wavs (random-weight bank): output "
                           f"identical to --device cpu; {wer_line}")
    if word_lines(outs["lextree"]) != word_lines(outs["loop"]):
        fail("connected_test --graph lextree decoded other words than --graph loop")
    if word_lines(outs[f"lextree {bigram} --decoder compose"]) != \
            word_lines(outs[f"loop {bigram}"]):
        fail("the bigram composed onto the trie decoded other words than on the loop graph")
    phase("main path", "--graph lextree words == --graph loop words, without an LM and "
                       "with the bigram composed (flat digit vocabulary)")

    # the word-trace backend through decode_connected: the CLI corpus's
    # features (K3) on the loop graph, 512 x 500 on the 385-state sausage and
    # 64 x 100 on the 1,500-word loop (7,500 states; word i is digit i % 11)
    import dataclasses
    import glob

    from speech_recognition_tpu_torch.decode.connected import decode_connected

    wav_files = sorted(glob.glob(os.path.join(wav_dir, "*.wav")))
    for c in counters:
        c.launches = 0
    f_w, n_w = cli._featurize_files(wav_files, FrontendConfig(), 120000, dev)
    f_w = f_w[:, : int(n_w.max())]
    big1_g = dataclasses.replace(big1, bank_state=big1.bank_state % w.shape[0])
    wt_runs = {"CLI corpus, loop graph": (graphs["loop"], f_w, n_w),
               f"{B}x{T}, sausage7": (graphs["sausage7"], feats, nf),
               f"{Bb}x{Tb}, 1,500-word loop ({bgb.n_states} states)": (
                   big1_g, feats[:Bb, :Tb].contiguous(), nfb)}
    wt_out = {k: decode_connected(bank, g_, f_, n_, backend="wordtrace")
              for k, (g_, f_, n_) in wt_runs.items()}
    torch.cuda.synchronize()
    launches["wordtrace"] = {c.__name__: c.launches for c in counters}
    if not all(launches["wordtrace"][c.__name__] for c in (
            mfcc39_fused, mfcc_tail, vk.bank_emission, vk.viterbi_banded_wordtrace,
            vk.wordtrace_words_device)) or launches["wordtrace"]["viterbi_banded_fused"]:
        fail(f"the word-trace path did not run K3, K10 (K13 + the word-trace DP) and K23 "
             f"alone: {launches['wordtrace']}")
    phase("main path", f"wordtrace path launches: {launches['wordtrace']}")
    for k, (g_, f_, n_) in wt_runs.items():
        words_a, costs_a = decode_connected(bank, g_, f_, n_)
        words_w, costs_w = wt_out[k]
        if words_w != words_a:
            bad = sum(a != b_ for a, b_ in zip(words_w, words_a))
            fail(f"wordtrace words differ from the states path's on {k} ({bad} utterances)")
        if not np.allclose(costs_w, costs_a, rtol=K1_RTOL, atol=0.0):
            fail(f"wordtrace costs differ from the states path's on {k}: max |d| "
                 f"{float(np.abs(costs_w - costs_a).max())}")
        phase("main path", f"decode_connected(backend='wordtrace') on {k}: words == the "
                           f"states path's (K1 + K2), costs within rtol 1e-5 (max |d| "
                           f"{float(np.abs(costs_w - costs_a).max()):.3g}); mean words/utt "
                           f"{sum(map(len, words_w)) / len(words_w):.2f}")

    # streaming: cli stream --device cuda for --graph loop, loop --incremental
    # and lextree, and the push API on the 1-state sausage (K17's general
    # route and K9), with the counters reset just before
    def run_stream(extra, device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["stream", "-i", bank_path, "-d", wav_dir, *extra, "--device", device])
        return buf.getvalue()

    def sausage_stream(bank_, f_, n_):
        dec_ = StreamingDecoder(bank_, graph1_, chunk_frames=CH, batch=f_.shape[0])
        nb_ = n_.cpu().numpy()
        for t0 in range(0, int(nb_.max()), CH):
            dec_.push(f_[:, t0:t0 + CH], n_valid=np.clip(nb_ - t0, 0, CH).astype(np.int32))
        return dec_.finish()

    stream_runs = {"loop": [],
                   "loop --incremental": ["--chunk-frames", "32", "--incremental",
                                          "--window-chunks", "2"],
                   "lextree": ["--graph", "lextree"]}
    for c in counters:
        c.launches = 0
    s_out = {sk_: stream_lines(run_stream(sv_, "cuda")) for sk_, sv_ in stream_runs.items()}
    sau_out = sausage_stream(bank1, f_w, n_w)
    torch.cuda.synchronize()
    launches["stream"] = {c.__name__: c.launches for c in counters}
    s_used = (mfcc39_fused, mfcc_tail, vk.bank_emission, vk.viterbi_banded_chunk,
              lk.viterbi_lex_chunk, vk.banded_backtrace_val, vk.banded_backtrace_general,
              lk.lex_backtrace_val)
    if not all(launches["stream"][c.__name__] for c in s_used) or any(
            launches["stream"][c.__name__] for c in (vk.viterbi_banded_fused, lk.viterbi_lex,
                                                     vk.viterbi_banded_general)):
        fail(f"the stream path did not run K3, K13, K17, K18, K2, K9 and K5 (and no "
             f"monolithic forward): {launches['stream']}")
    phase("main path", f"stream path launches: {launches['stream']}")
    for sk_, sv_ in stream_runs.items():
        ref = stream_lines(run_stream(sv_, "cpu"))
        got = s_out[sk_]
        if sorted(got) != sorted(ref) or len(ref) != n_wavs:
            fail(f"cli stream {sk_}: {len(got)} cuda lines, {len(ref)} cpu lines, {n_wavs} wavs")
        for wav_ in ref:
            if got[wav_][:2] != ref[wav_][:2] or not np.isclose(got[wav_][2], ref[wav_][2],
                                                                rtol=K1_RTOL, atol=0.0):
                fail(f"cli stream {sk_} on {wav_}: cuda {got[wav_]} != cpu {ref[wav_]}")
        early = [int(v_[1].split("/")[0]) for v_ in got.values() if v_[1]]
        phase("main path", f"cli stream {' '.join(['--graph', *sk_.split()])} --device cuda on "
                           f"{n_wavs} wavs: words{' and mid-stream counts' if early else ''} "
                           f"identical to --device cpu, costs within rtol 1e-5"
                           + (f"; {sum(early)} words emitted mid-stream" if early else ""))
    if not ({f: v_[0] for f, v_ in s_out["loop"].items()}
            == {f: v_[0] for f, v_ in s_out["loop --incremental"].items()}
            == {f: v_[0] for f, v_ in s_out["lextree"].items()}):
        fail("cli stream: loop, loop --incremental and lextree decoded other words")
    sau_cpu = sausage_stream(bank1.to("cpu"), f_w.cpu(), n_w.cpu())
    for (wg, _, cg), (wc, _, cc) in zip(sau_out, sau_cpu):
        if wg != wc or not np.isclose(cg, cc, rtol=K1_RTOL, atol=0.0):
            fail("StreamingDecoder on the 1-state sausage: cuda differs from cpu")
    phase("main path", f"StreamingDecoder on the 1-state sausage7 (K17 general route + K9) "
                       f"over the CLI corpus's features: words == cpu, costs within rtol "
                       f"1e-5; the three cli stream graphs decode the same words")

    # isolated words, forced alignment, the dense decoder and ops.frontend.mfcc,
    # each with the counters reset just before it
    from speech_recognition_tpu_torch.ops.frontend import mfcc

    iso_dir = os.path.join(tmp, "iso")
    os.makedirs(iso_dir)
    for u in SyntheticDigits(seed=0).isolated_corpus(6, tag="smoke"):
        write_wav(os.path.join(iso_dir, u.name), u.samples)

    def run_action(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return buf.getvalue()

    def counted(path, fn, need, forbid=()):
        for c in counters:
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches[path] = {c.__name__: c.launches for c in counters}
        if not all(launches[path][c.__name__] for c in need) or \
                any(launches[path][c.__name__] for c in forbid):
            fail(f"the {path} path did not run {[c.__name__ for c in need]} alone: "
                 f"{launches[path]}")
        phase("main path", f"{path} path launches: {launches[path]}")
        return out

    iso_cmd = ["isolated_test", "-i", bank_sil_path, "-d", iso_dir, "--device"]
    iso_out = counted("isolated", lambda: run_action(iso_cmd + ["cuda"]),
                      (*k3, viterbi_dense),
                      (vk.viterbi_banded_fused, vk.viterbi_banded_general))
    if iso_out != run_action(iso_cmd + ["cpu"]):
        fail("isolated_test: CUDA output differs from the CPU run")
    phase("main path", f"cli isolated_test --device cuda on {len(os.listdir(iso_dir))} "
                       f"synthetic digit wavs (random-weight 12-model bank, silence left "
                       f"out): output identical to --device cpu; accuracy "
                       f"{iso_out.splitlines()[-1]}")
    al = {d: os.path.join(tmp, f"align_{d}.jsonl") for d in ("cuda", "cpu")}
    al_cmd = ["align", "-i", bank_sil_path, "-d", wav_dir, "--device"]
    counted("align", lambda: run_action(al_cmd + ["cuda", "-o", al["cuda"]]),
            (*k3, viterbi_dense, dense_backtrace))
    run_action(al_cmd + ["cpu", "-o", al["cpu"]])
    recs = {}
    for d, path in al.items():
        with open(path) as f:
            recs[d] = [json.loads(x) for x in f]
    if [(r["file"], r["segments"]) for r in recs["cuda"]] != \
            [(r["file"], r["segments"]) for r in recs["cpu"]] or len(recs["cuda"]) != n_wavs:
        fail("align: CUDA word segments differ from the CPU run")
    c_cu = np.array([r["cost"] for r in recs["cuda"]])
    c_cp = np.array([r["cost"] for r in recs["cpu"]])
    if not np.allclose(c_cu, c_cp, rtol=1e-5, atol=0.0):
        fail(f"align: CUDA costs differ from the CPU run: max |d| "
             f"{float(np.abs(c_cu - c_cp).max())}")
    n_seg = sum(len(r["segments"]) for r in recs["cuda"])
    n_sil = sum(s_["word"] == "sil" for r in recs["cuda"] for s_ in r["segments"])
    phase("main path", f"cli align --device cuda on {n_wavs} wavs: segments identical to "
                       f"--device cpu, costs within rtol 1e-5 (max |d| "
                       f"{float(np.abs(c_cu - c_cp).max()):.3g}); {n_seg} segments, "
                       f"{n_sil} of them silence")

    def dense_decode():
        f_, n_ = cli._featurize_files(wav_files, FrontendConfig(), 120000, dev)
        f_ = f_[:, : int(n_.max())]
        return {k: decode_connected(bank, graphs[k], f_, n_, backend="dense")
                for k in ("loop", "sausage7")}

    dense_words = counted("dense", dense_decode, (*k3, viterbi_dense, dense_backtrace),
                          (vk.viterbi_banded_fused, vk.viterbi_banded_general))
    for k, (words_d, costs_d) in dense_words.items():
        words_b, costs_b = decode_connected(bank, graphs[k], f_w, n_w)
        if words_d != words_b:
            fail(f"dense words differ from the banded path's on the {k} graph")
        if not np.allclose(costs_d, costs_b, rtol=K1_RTOL, atol=0.0):
            fail(f"dense costs differ from the banded path's on the {k} graph: max |d| "
                 f"{float(np.abs(costs_d - costs_b).max())}")
        phase("main path", f"decode_connected(backend='dense') on the CLI corpus, {k} "
                           f"graph: words == the banded path's, costs within rtol 1e-5")
    from speech_recognition_tpu_torch.data.wav import load_wav_batch

    samp8, len8, _ = load_wav_batch(wav_files[:8], 120000)
    wav_sig = [torch.from_numpy(np.ascontiguousarray(x[:n], np.float32))
               for x, n in zip(samp8, len8)]
    ceps_cuda = counted("mfcc", lambda: [mfcc(x.to(dev), len(x), cfg) for x in wav_sig],
                        (mfcc_fused,), k3)
    for x, (c_k, n_k) in zip(wav_sig, ceps_cuda):
        c_p, n_p = mfcc(x, len(x), cfg)
        if int(n_k) != int(n_p) or not torch.allclose(c_k.cpu(), c_p, **K3_TOL):
            fail("ops.frontend.mfcc on CUDA (K12) differs from the CPU pipeline")
    phase("main path", f"ops.frontend.mfcc on {len(wav_sig)} CLI wavs on CUDA (K12) == the "
                       f"CPU pipeline (rtol 2e-3, atol 5e-4)")

    # ---- 6b. the training path, through the CLI, on the card and on the CPU --
    # synth -> isolated_train --silence (11 digits + silence, 5 states x 4
    # mixtures x 39 dims) -> isolated_test -> continuous_train --algo hard
    # (3 iterations) -> connected_test, once with --device cuda (counters
    # reset just before) and once with --device cpu
    import importlib

    from speech_recognition_tpu_torch.data.aurora import (
        labels_from_transcript,
        transcript_from_filename,
    )
    from speech_recognition_tpu_torch.utils.checkpoint import load_bank

    skm = importlib.import_module("speech_recognition_tpu_torch.train.skmeans")
    cont = importlib.import_module("speech_recognition_tpu_torch.train.continuous")
    est = importlib.import_module("speech_recognition_tpu_torch.train.embedded_step")
    iso = importlib.import_module("speech_recognition_tpu_torch.train.isolated")
    corpus = os.path.join(tmp, "train_corpus")
    run_action(["synth", "-o", corpus, "--n-train", "20", "--n-test", "5",
                "--n-continuous", "200"])
    tr_dir, te_dir = os.path.join(corpus, "train"), os.path.join(corpus, "test")
    n_tr, n_te = len(os.listdir(tr_dir)), len(os.listdir(te_dir))
    train_out, train_wall = {}, {}
    k11_train_calls = {"skmeans": [], "embedded": []}
    # the mixture fits' calls (K24, K25) in the cuda run, held in 6d
    gfk = importlib.import_module("speech_recognition_tpu_torch.ops.gmm_fit_kernels")
    tkm = importlib.import_module("speech_recognition_tpu_torch.train.kmeans")
    tem = importlib.import_module("speech_recognition_tpu_torch.train.em")
    k24, k25 = tkm.kmeans_batch, tem.em_fit_batch
    gmm_calls = {"K24": [], "K25": []}
    for d in ("cuda", "cpu"):
        bank_d, cont_d = os.path.join(tmp, f"trained_{d}.npz"), os.path.join(tmp, f"cont_{d}")

        def train_run(d=d, bank_d=bank_d, cont_d=cont_d):
            out, wall = {}, {}
            for name, argv in (
                    ("isolated_train", ["isolated_train", "-i", tr_dir, "-o", bank_d,
                                        "--silence"]),
                    ("isolated_test", ["isolated_test", "-i", bank_d, "-d", te_dir]),
                    ("continuous_train", ["continuous_train", "-i", bank_d, "-d", tr_dir,
                                          "-o", cont_d, "--algo", "hard", "--iterations",
                                          "3"]),
                    ("connected_test", ["connected_test", "-i",
                                        os.path.join(cont_d, "bank_00002.npz"), "-d",
                                        te_dir])):
                t0 = time.perf_counter()
                out[name] = run_action(argv + ["--device", d])
                wall[name] = time.perf_counter() - t0
            return out, wall

        if d == "cuda":
            with recording(skm, "viterbi_dense", k11_train_calls["skmeans"]), \
                    recording(cont, "viterbi_dense", k11_train_calls["embedded"]), \
                    recording(iso, "kmeans_batch", gmm_calls["K24"]), \
                    recording(iso, "em_fit_batch", gmm_calls["K25"]):
                train_out[d], train_wall[d] = counted("training", train_run,
                                                      (*k3, viterbi_dense, dense_backtrace,
                                                       k24, k25))
        else:
            train_out[d], train_wall[d] = train_run()
    acc = {d: float(o["isolated_test"].splitlines()[-1]) for d, o in train_out.items()}
    n_iso_te = sum(1 for f in os.listdir(te_dir) if len(f.split("_")[1]) == 6)
    if abs(acc["cuda"] - acc["cpu"]) > 1.0 / n_iso_te + 1e-9:
        fail(f"isolated_test accuracy of the cuda-trained bank {acc['cuda']} is more than "
             f"one file from the cpu-trained bank's {acc['cpu']}")
    n_ok = {d: sum(l.startswith("Correct:") for l in o["connected_test"].splitlines())
            for d, o in train_out.items()}
    wers = {d: [l for l in o["connected_test"].splitlines() if l.startswith("WER:")][0]
            for d, o in train_out.items()}
    if abs(n_ok["cuda"] - n_ok["cpu"]) > 1 or len(word_lines(train_out["cuda"][
            "connected_test"])) != n_te:
        fail(f"connected_test after continuous_train: cuda decodes {n_ok['cuda']} of "
             f"{n_te} wavs right, cpu {n_ok['cpu']}")
    costs = {d: [float(l.split()[-1]) for l in o["continuous_train"].splitlines()
                 if l.startswith("iteration")] for d, o in train_out.items()}
    banks_tr = {d: load_bank(os.path.join(tmp, f"trained_{d}.npz"))[0] for d in train_out}
    if banks_tr["cuda"].means.shape != (12, 5, 4, 39) or len(costs["cuda"]) != 3 or \
            not all(np.isfinite(getattr(b_, f).numpy()).all() for b_ in banks_tr.values()
                    for f in ("means", "log_vars", "log_weights")):
        fail("the trained banks are not 12 finite models of 5 x 4 x 39, or continuous_train "
             "ran other than 3 iterations")
    if not (costs["cuda"][0] > costs["cuda"][-1] and acc["cuda"] >= 0.9):
        fail(f"training did not learn: isolated accuracy {acc['cuda']}, alignment costs "
             f"{costs['cuda']}")
    d_means = float((banks_tr["cuda"].means - banks_tr["cpu"].means).abs().max())
    phase("main path", f"training path (synth: {n_tr} training wavs, {n_te} test wavs) "
                       f"--device cuda vs cpu: isolated_test accuracy {acc['cuda']} / "
                       f"{acc['cpu']} ({n_iso_te} digit files); continuous_train costs "
                       f"{costs['cuda']} / {costs['cpu']}; connected_test {n_ok['cuda']} / "
                       f"{n_ok['cpu']} of {n_te} wavs right, {wers['cuda']} / {wers['cpu']}; "
                       f"isolated banks' largest mean difference {d_means:.3g}")
    phase("main path", "training path wall s (cuda / cpu): " + ", ".join(
        f"{k} {train_wall['cuda'][k]:.2f} / {train_wall['cpu'][k]:.2f}"
        for k in train_wall["cuda"]))
    # K11 at the two training shapes the cuda run gave it: the segmental
    # K-means batch of the first digit (its first call) and the embedded
    # step's per-utterance graphs (the first iteration's call)
    k11_train = {}
    for name, calls in k11_train_calls.items():
        if not calls:
            fail(f"the training path made no K11 call in {name}")
        args_, kw_ = calls[0]
        kw_ = {"eps_trans": None, "eps_depth": 1,
               **dict(zip(("nll", "trans", "init_cost", "n_frames"), args_)), **kw_}
        got, want = viterbi_dense(**kw_), viterbi_dense_ref(**kw_)
        torch.cuda.synchronize()
        for k, plane in enumerate(("final", "bp", "eps_bp")):
            if not torch.equal(got[k], want[k]):
                fail(f"K11 {plane} differs from the plain version at the {name} training "
                     f"shape")
        k11_train[name] = kw_
        phase("K11", f"training shape {name} {tuple(kw_['nll'].shape)} "
                     f"({dense_form(kw_)}), {len(calls)} calls on the path: final, bp, "
                     f"eps_bp == plain (bit-identical, every frame)")

    # soft EM through the CLI on the card and on the CPU, from the same
    # isolated bank (the cuda-trained one): continuous_train --algo soft (3
    # iterations, the dense dict: K16), then connected_test of its last bank;
    # then connected_test --graph loop --confidence with that bank (K3 + K1 +
    # K2 + K15); counters reset just before each cuda run
    iso_bank = os.path.join(tmp, "trained_cuda.npz")
    soft_out, soft_wall, k16_calls = {}, {}, []
    for d in ("cuda", "cpu"):
        soft_d = os.path.join(tmp, f"soft_{d}")

        def soft_run(d=d, soft_d=soft_d):
            t0 = time.perf_counter()
            out = {"continuous_train": run_action(
                ["continuous_train", "-i", iso_bank, "-d", tr_dir, "-o", soft_d, "--algo", "soft",
                 "--iterations", "3", "--device", d])}
            wall = time.perf_counter() - t0
            out["connected_test"] = run_action(["connected_test", "-i", os.path.join(
                soft_d, "bank_00002.npz"), "-d", te_dir, "--device", d])
            return out, wall

        if d == "cuda":
            with recording(est, "forward_backward", k16_calls):
                soft_out[d], soft_wall[d] = counted(
                    "soft training", soft_run, (*k3, fbk.fb_dense, vk.bank_emission,
                                                vk.viterbi_banded_fused, vk.banded_backtrace_val),
                    (fbk.fb_banded, viterbi_dense))
        else:
            soft_out[d], soft_wall[d] = soft_run()
    soft_costs = {d: [float(l.split()[-1]) for l in o["continuous_train"].splitlines()
                      if l.startswith("iteration")] for d, o in soft_out.items()}
    if len(soft_costs["cuda"]) != 3 or not np.allclose(soft_costs["cuda"], soft_costs["cpu"],
                                                       rtol=1e-4, atol=0):
        fail(f"continuous_train --algo soft costs differ between cuda and cpu: {soft_costs}")
    if not soft_costs["cuda"][-1] < soft_costs["cuda"][0]:
        fail(f"soft EM did not lower the total NLL: {soft_costs['cuda']}")
    soft_ok = {d: sum(l.startswith("Correct:") for l in o["connected_test"].splitlines())
               for d, o in soft_out.items()}
    if soft_ok["cuda"] != soft_ok["cpu"] or len(word_lines(soft_out["cuda"][
            "connected_test"])) != n_te:
        fail(f"connected_test after soft EM: cuda decodes {soft_ok['cuda']} of {n_te} wavs "
             f"right, cpu {soft_ok['cpu']}")
    phase("main path", f"continuous_train --algo soft --iterations 3 --device cuda vs cpu: "
                       f"costs {soft_costs['cuda']} / {soft_costs['cpu']} (rtol 1e-4); "
                       f"connected_test {soft_ok['cuda']} / {soft_ok['cpu']} of {n_te} wavs "
                       f"right; wall s {soft_wall['cuda']:.2f} / {soft_wall['cpu']:.2f}")
    # K16 at the shape the soft path gave it (the first iteration's call)
    args_, kw_ = k16_calls[0]
    got, want = fbk.fb_dense(*args_, **kw_), fbk.fb_dense_ref(*args_, **kw_)
    torch.cuda.synchronize()
    k16_train = (args_, kw_)
    fb_err["K16"] = max(fb_err["K16"], fb_check(
        "K16", f"soft-EM shape {tuple(args_[0].shape)} from the CLI run, xi "
               f"{kw_.get('xi_mode')}, {len(k16_calls)} calls on the path", got, want))
    report["K16"] = {"max_abs_err": fb_err["K16"]}
    conf_bank = os.path.join(tmp, "soft_cuda", "bank_00002.npz")
    conf_cmd = ["connected_test", "-i", conf_bank, "-d", te_dir, "--graph", "loop",
                "--confidence", "--device"]
    conf_mod = importlib.import_module("speech_recognition_tpu_torch.decode.confidence")
    k15_calls = []
    with recording(conf_mod, "forward_backward_banded", k15_calls):
        conf_out = {"cuda": counted("confidence", lambda: run_action(conf_cmd + ["cuda"]),
                                    (*k3, vk.bank_emission, vk.viterbi_banded_fused,
                                     vk.banded_backtrace_val, fbk.fb_banded), (fbk.fb_dense,))}
    conf_out["cpu"] = run_action(conf_cmd + ["cpu"])
    # K15 at the shape and on the inputs the confidence path gave it (the
    # loop graph, bank_nll's emissions, -inf end scores off the word ends)
    args_, kw_ = k15_calls[0]
    got, want = fbk.fb_banded(*args_, **kw_), fbk.fb_banded_ref(*args_, **kw_)
    torch.cuda.synchronize()
    fb_err["K15"] = max(fb_err["K15"], fb_check(
        "K15", f"confidence path {tuple(args_[0].shape)} on the loop graph from the CLI run, "
               f"{len(k15_calls)} call(s) on the path", got, want))
    report["K15"] = {"max_abs_err": fb_err["K15"]}

    def conf_rows(out):
        rows = {}
        for line in out.splitlines():
            if line.startswith("confidence "):
                name, rest = line[len("confidence "):].split(": ", 1)
                rows[name] = [x.rsplit(":", 1) for x in rest.split()]
        return rows

    rows_c, rows_p = conf_rows(conf_out["cuda"]), conf_rows(conf_out["cpu"])
    if word_lines(conf_out["cuda"]) != word_lines(conf_out["cpu"]) or \
            sorted(rows_c) != sorted(rows_p) or len(rows_c) != n_te:
        fail("connected_test --confidence: cuda and cpu decode other words or files")
    conf_d = 0.0
    for name in rows_c:
        if [w for w, _ in rows_c[name]] != [w for w, _ in rows_p[name]]:
            fail(f"connected_test --confidence: other words for {name} on cuda and cpu")
        conf_d = max([conf_d] + [abs(float(a) - float(b)) for (_, a), (_, b) in
                                 zip(rows_c[name], rows_p[name])])
    if conf_d > CONF_ATOL:
        fail(f"connected_test --confidence: a confidence differs by {conf_d} between cuda "
             f"and cpu (limit {CONF_ATOL})")
    confs = [float(c) for r in rows_c.values() for _, c in r]
    phase("main path", f"connected_test --graph loop --confidence on {n_te} wavs, cuda vs "
                       f"cpu: the same words ({len(confs)} with confidences), largest "
                       f"confidence difference {conf_d:.3g} (limit {CONF_ATOL}); mean "
                       f"confidence {np.mean(confs):.3f}")

    # ---- 6c. training timings: isolated_train per digit, one
    # continuous_train iteration by stage (CUDA events) ----------------------
    tcfg = FrontendConfig()
    by_digit = cli._digit_files(tr_dir)
    files_d = [f for fs in by_digit.values() for f in fs]
    f_tr, n_trf = cli._featurize_files(files_d, tcfg, 64000, dev)
    nf_np = n_trf.cpu().numpy()
    temps, i0 = {}, 0
    for dgt, fs in by_digit.items():
        temps[dgt] = [f_tr[j, : nf_np[j]] for j in range(i0, i0 + len(fs))]
        i0 += len(fs)
    from speech_recognition_tpu_torch.config import TrainConfig
    from speech_recognition_tpu_torch.train.kmeans import random_assign

    # stages split inside the port's own calls: CUDA events around the
    # calls a training function makes (no synchronization between them), so
    # the stages partition the call's time
    stage_ev = []

    @contextlib.contextmanager
    def evented(stages):
        """Record CUDA events around every call of ``module.name`` for each
        ``stage: (module, name)`` into ``stage_ev`` while the block runs."""
        origs = {k: getattr(m, n) for k, (m, n) in stages.items()}

        def wrap(stage, fn):
            def run(*a, **k):
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                out = fn(*a, **k)
                e1.record()
                stage_ev.append((stage, e0, e1, out))
                return out
            return run

        for k, (m, n) in stages.items():
            setattr(m, n, wrap(k, origs[k]))
        try:
            yield
        finally:
            for k, (m, n) in stages.items():
                setattr(m, n, origs[k])

    def stage_sums():
        """``({stage: ms}, {stage: calls})`` of ``stage_ev`` (its events
        done), which it empties."""
        ms, n = {}, {}
        for stage, a, b, _ in stage_ev:
            ms[stage] = ms.get(stage, 0.0) + a.elapsed_time(b)
            n[stage] = n.get(stage, 0) + 1
        stage_ev.clear()
        return ms, n

    sk_stages = {"K11": (skm, "viterbi_dense"), "viterbi_backtrace": (skm, "viterbi_backtrace")}
    fit_stages = {"k-means (K24)": (iso, "kmeans_batch"), "EM (K25)": (iso, "em_fit_batch")}
    digit_ms, em_iters, fit_launches = {}, [], []
    for dgt in temps:
        n0 = (k24.launches, k25.launches)
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        with evented(sk_stages):
            skm.skmeans(temps[dgt], 5, pad_to=int(nf_np.max()))
        e1.record()
        with evented(fit_stages):
            iso.fit_hmm(temps[dgt], pad_to=int(nf_np.max()), draw_assign=random_assign(
                torch.Generator().manual_seed(TrainConfig().seed + dgt)))
        e2.record()
        e2.synchronize()
        em_iters += [n for stage, _, _, out in stage_ev if stage == "EM (K25)"
                     for n in out[3].tolist()]
        fit_launches.append((k24.launches - n0[0], k25.launches - n0[1]))
        digit_ms[dgt] = (e1.elapsed_time(e2), e0.elapsed_time(e1), *stage_sums())
    sk_kw = k11_train["skmeans"]
    sk_iters = sum(v[3]["K11"] for v in digit_ms.values())
    sk_stage = {k: sum(v[2][k] for v in digit_ms.values()) for k in sk_stages}
    # one embedded-training iteration on the cuda-trained bank, split by
    # stage inside each embedded_step call; "rest" is what lies between the
    # stages
    bank_c = banks_tr["cuda"].to(dev)
    cfiles = [f for f in sorted(glob.glob(os.path.join(tr_dir, "*.wav")))
              if transcript_from_filename(os.path.basename(f))]
    clabels = [labels_from_transcript(transcript_from_filename(os.path.basename(f)))
               for f in cfiles]
    f_c, n_c = cli._featurize_files(cfiles, tcfg, 120000, dev)
    f_c = f_c[:, : int(n_c.max())].contiguous()
    bc, tc_, _ = f_c.shape
    emb_stages = {"bank_nll": (cont, "bank_nll"), "K11": (cont, "viterbi_dense"),
                  "viterbi_backtrace": (cont, "viterbi_backtrace"),
                  "statistics GEMMs": (est, "embedded_stats"),
                  "M-step": (est, "embedded_update")}

    def embedded_iteration():
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        g_, depth_ = est.compose_graphs(bank_c, clabels, 11)
        e1.record()
        est.embedded_step(bank_c, f_c, n_c, g_, eps_depth=depth_)
        e2.record()
        e2.synchronize()
        split = {"graph composition (host)": e0.elapsed_time(e1), **stage_sums()[0]}
        split["rest"] = e1.elapsed_time(e2) - sum(split[k] for k in emb_stages)
        split["whole embedded_step"] = e1.elapsed_time(e2)
        return split

    with evented(emb_stages):
        embedded_iteration()
        splits = [embedded_iteration() for _ in range(5)]
    emb_ms = {k: statistics.median(sp[k] for sp in splits) for k in splits[0]}
    # the device's busy time in the same calls (torch.profiler), against
    # their event times: the rest is the device idle behind the host
    whole = "whole embedded_step"
    g_c, depth_c = est.compose_graphs(bank_c, clabels, 11)
    emb_dev = device_ms(lambda: est.embedded_step(bank_c, f_c, n_c, g_c, eps_depth=depth_c),
                        reps=3, what="one embedded step")

    def fit0():
        return iso.fit_hmm(temps[0], pad_to=int(nf_np.max()), draw_assign=random_assign(
            torch.Generator().manual_seed(TrainConfig().seed)))

    fit0_ms = cuda_ms(fit0, reps=1)
    fit0_dev = device_ms(fit0, reps=1, what="fit_hmm of digit 0")
    for dgt, (ms, sk_ms, sk_split, sk_n) in digit_ms.items():
        phase("timing", f"isolated_train digit {dgt} ({len(temps[dgt])} templates): fit_hmm "
                        f"{ms:.1f} ms; segmental K-means {sk_ms:.1f} ms in {sk_n['K11']} "
                        f"iterations, of which K11 {sk_split['K11']:.1f} ms, viterbi_backtrace "
                        f"{sk_split['viterbi_backtrace']:.1f} ms (CUDA events; {card})")
    tot = sum(v[0] for v in digit_ms.values())
    sk_tot = sum(v[1] for v in digit_ms.values())
    phase("timing", f"isolated_train, 11 digits: fit_hmm {tot:.1f} ms in all; segmental "
                    f"K-means {sk_tot:.1f} ms in {sk_iters} iterations (digit 0's batch "
                    f"{tuple(sk_kw['nll'].shape)}), per iteration {sk_tot / sk_iters:.3f} ms, "
                    f"of which K11 {sk_stage['K11'] / sk_iters:.3f} ms, viterbi_backtrace "
                    f"{sk_stage['viterbi_backtrace'] / sk_iters:.3f} ms (CUDA events inside "
                    f"the calls; {card})")
    phase("timing", "isolated_train, 11 digits, inside fit_hmm: " + ", ".join(
        f"{k} {sum(v[2][k] for v in digit_ms.values()):.1f} ms in "
        f"{sum(v[3][k] for v in digit_ms.values())} calls" for k in fit_stages)
        + f"; launches a digit (K24, K25): {sorted(set(fit_launches))}; EM iterations a "
          f"fit: mean {np.mean(em_iters):.1f}, at the cap of 100: "
          f"{sum(n == 100 for n in em_iters)} of {len(em_iters)} fits (CUDA events inside "
          f"the calls; {card})")
    if set(fit_launches) != {(2, 2)}:
        fail(f"fit_hmm did not launch K24 and K25 once a split level: {fit_launches}")

    def fit_all():
        for dgt in temps:
            iso.fit_hmm(temps[dgt], pad_to=int(nf_np.max()), draw_assign=random_assign(
                torch.Generator().manual_seed(TrainConfig().seed + dgt)))

    fit_all_ms = cuda_ms(fit_all, reps=1)
    fit_all_dev = device_ms(fit_all, reps=1, what="fit_hmm of 11 digits")
    phase("timing", f"fit_hmm of 11 digits (segmental K-means, K24, K25): {fit_all_ms:.1f} ms "
                    f"event, device busy {fit_all_dev:.1f} ms (idle share "
                    f"{1 - fit_all_dev / fit_all_ms:.3f}) ({card})")
    phase("timing", f"one continuous_train iteration, {bc} utterances x {tc_} frames, "
                    f"{g_c['bank_state'].shape[1]} graph states, by stage inside each call: "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in emb_ms.items())
                    + f" (CUDA-event medians of 5 calls; {card})")
    phase("timing", f"device busy (torch.profiler) against event time: embedded_step "
                    f"{emb_dev:.3f} of {emb_ms[whole]:.3f} ms (idle share "
                    f"{1 - emb_dev / emb_ms[whole]:.3f}); fit_hmm of digit 0 {fit0_dev:.3f} of "
                    f"{fit0_ms:.3f} ms (idle share {1 - fit0_dev / fit0_ms:.3f}) ({card})")

    # one soft (Baum-Welch) iteration on the same bank and corpus, split by
    # stage inside each embedded_step_soft call
    soft_stages = {"bank_nll": (est, "bank_nll"), "K16": (est, "forward_backward"),
                   "statistics GEMMs": (est, "soft_stats"), "M-step": (est, "soft_update")}

    def soft_iteration():
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        g_, depth_ = est.compose_graphs(bank_c, clabels, 11, end_scores=True)
        e1.record()
        est.embedded_step_soft(bank_c, f_c, n_c, g_, eps_depth=depth_)
        e2.record()
        e2.synchronize()
        split = {"graph composition (host)": e0.elapsed_time(e1), **stage_sums()[0]}
        split["rest"] = e1.elapsed_time(e2) - sum(split[k] for k in soft_stages)
        split["whole embedded_step_soft"] = e1.elapsed_time(e2)
        return split

    with evented(soft_stages):
        soft_iteration()
        soft_splits = [soft_iteration() for _ in range(5)]
    soft_ms = {k: statistics.median(sp[k] for sp in soft_splits) for k in soft_splits[0]}
    gs_c, ds_c = est.compose_graphs(bank_c, clabels, 11, end_scores=True)
    soft_dev = device_ms(lambda: est.embedded_step_soft(bank_c, f_c, n_c, gs_c, eps_depth=ds_c),
                         reps=3, what="one soft embedded step")
    whole_s = "whole embedded_step_soft"
    phase("timing", f"one continuous_train --algo soft iteration, {bc} utterances x {tc_} "
                    f"frames, {gs_c['bank_state'].shape[1]} graph states, by stage inside each "
                    f"call: " + ", ".join(f"{k} {v:.3f} ms" for k, v in soft_ms.items())
                    + f" (CUDA-event medians of 5 calls; {card})")
    phase("timing", f"device busy (torch.profiler) against event time: embedded_step_soft "
                    f"{soft_dev:.3f} of {soft_ms[whole_s]:.3f} ms (idle share "
                    f"{1 - soft_dev / soft_ms[whole_s]:.3f}) ({card})")

    # ---- 6d. K24 / K25 (the k-means and EM fits) vs their plain versions ---
    # one iteration at every shape isolated_train gave them (the cuda run's
    # calls: 11 digits' 5 states and the silence model, each split level),
    # whole fits on planted mixtures at fit_hmm's shape and past the frames
    # a CTA stages in shared memory; then timed at digit 0's second level
    from speech_recognition_tpu_torch.ops.gmm import pairwise_gaussian_nll
    from speech_recognition_tpu_torch.train.kmeans import cluster_stats

    gmm_err = {"K24": 0.0, "K25": 0.0}
    gmm_pair = {"K24": (k24, tkm.kmeans_batch_ref), "K25": (k25, tem.em_fit_batch_ref)}
    gmm_close = {"K24": (1, 2), "K25": (0, 1, 2)}  # compared at a tolerance; the rest exactly

    def gmm_run(name, args, kw):
        kernel, plain = gmm_pair[name]
        got, again, want = kernel(*args, **kw), kernel(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name}: two launches on the same inputs differ")
        return got, want

    def gmm_hold(name, what, args, kw, tol, skip_fits=()):
        """``name``'s kernel against its plain version: the exact outputs
        equal, the rest within ``tol``, fits in ``skip_fits`` left out;
        returns the largest difference."""
        got, want = gmm_run(name, args, kw)
        keep = [i for i in range(args[1].shape[0]) if i not in skip_fits]
        err = 0.0
        for j, (a, b) in enumerate(zip(got, want)):
            a, b = a[keep], b.to(a.device)[keep]
            if j in gmm_close[name]:
                if not torch.allclose(a, b, **tol):
                    fail(f"{name} {what}: output {j} differs from the plain version by "
                         f"{float((a - b).abs().max())} (rtol {tol['rtol']}, atol "
                         f"{tol['atol']})")
                err = max(err, float((a - b).abs().max()))
            elif not torch.equal(a, b):
                fail(f"{name} {what}: output {j} differs from the plain version")
        gmm_err[name] = max(gmm_err[name], err)
        return err

    def k24_step_flips(args, kw):
        """K24's one-iteration assignment against the plain version's: the
        fits with frames assigned otherwise, each such frame at a near-tie
        of the plain distances (its two nearest clusters within 1e-4 of
        the distance), else fail."""
        x_, masks_, c0_, k_, init_ = args
        got, want = gmm_run("K24", args, dict(kw, max_iters=1))
        fits = []
        for i in range(masks_.shape[0]):
            diff = torch.nonzero(got[0][i] != want[0][i])[:, 0]
            if diff.numel():
                v0 = cluster_stats(x_, masks_[i], init_[i], k_)[2]
                top = pairwise_gaussian_nll(x_[diff], c0_[i], v0).topk(2, largest=False)[0]
                if bool(((top[:, 1] - top[:, 0]) > 1e-4 * top[:, 0].abs()).any()):
                    fail("K24 assigns a frame otherwise than its plain version away from a tie")
                fits.append(i)
        return fits

    n_levels = {n_: len(c_) for n_, c_ in gmm_calls.items()}
    if min(n_levels.values()) < 22:
        fail(f"isolated_train --silence made fewer K24 / K25 calls than 11 digits x 2 split "
             f"levels: {n_levels}")
    step_err, flips = {"K24": 0.0, "K25": 0.0}, 0
    for name in ("K24", "K25"):
        for args_, kw_ in gmm_calls[name]:
            skip = k24_step_flips(args_, kw_) if name == "K24" else []
            flips += len(skip)
            step_err[name] = max(step_err[name], gmm_hold(
                name, "one iteration at an isolated_train shape", args_,
                dict(kw_, max_iters=1), GMM_STEP_TOL, skip))
    shapes = sorted({(tuple(a_[1].shape), a_[2].shape[1]) for a_, _ in gmm_calls["K24"]})
    phase("K24/K25", f"one iteration at the {n_levels['K24']} isolated_train calls of each "
                     f"(masks, k): {shapes}: equal to the plain versions, largest difference "
                     f"K24 {step_err['K24']:.3g}, K25 {step_err['K25']:.3g} (rtol "
                     f"{GMM_STEP_TOL['rtol']}, atol {GMM_STEP_TOL['atol']}); {flips} fit(s) "
                     f"with a frame at a near-tie assigned otherwise, left out")
    # whole fits at digit 0's calls: the kernel's own trajectory (not gated:
    # a near-tie can move a fit by an iteration; the corpus-level gate is
    # the accuracy above)
    whole = []
    for name in ("K24", "K25"):
        for args_, kw_ in gmm_calls[name][:2]:
            got, want = gmm_run(name, args_, kw_)
            pairs = [(a, b.to(a.device)) for j, (a, b) in enumerate(zip(got, want))
                     if j in gmm_close[name]]
            same = (float((got[0] == want[0]).float().mean()) if name == "K24"
                    else float((got[3] == want[3].to(dev)).float().mean()))
            whole.append(f"{name} k={args_[2].shape[1]}: largest difference "
                         f"{max(float((a - b).abs().max()) for a, b in pairs):.3g}, "
                         f"{'assignments' if name == 'K24' else 'iteration counts'} equal "
                         f"{same:.3f}")
    phase("K24/K25", "whole fits at digit 0's two split levels against the plain versions "
                     "(informational): " + "; ".join(whole))
    # (sizes, D): a word's states; a fit past the frames a CTA stages; and
    # features so wide that the parameters live in device memory
    gmm_planted = {"fit_hmm shape": ((260, 240, 300, 180, 220), 39),
                   "device memory": ((8000, 300, 40), 39),
                   "parameters in device memory": ((12, 300), 3000)}
    for case, (sizes, d_) in gmm_planted.items():
        x_, masks_, c0_, init_ = planted_fits(40, sizes, dev, d=d_)
        plan_ = gfk.gmm_fit_plan(x_.shape[0], d_, 4, em=False)
        _, m0_, v0_, cnt_ = tkm.kmeans_batch_ref(x_, masks_, c0_, 4, init_)
        w0_ = cnt_ / masks_.sum(1, keepdim=True).clamp(min=1).float()
        fits_ = {"K24": [((x_, masks_, c0_, 4, init_), dict(shared_cov_quirk=q, disjoint=True))
                         for q in (False, True)],
                 "K25": [((x_, masks_, m0_, v0_, w0_), dict(disjoint=True))]}
        f64_ = []
        for name, calls_ in fits_.items():
            for args_, kw_ in calls_:
                if d_ == 39:
                    gmm_hold(name, f"planted {case}", args_, dict(kw_, max_iters=1),
                             GMM_STEP_TOL)
                else:  # one iteration against float64 (GMM_AS_ACCURATE)
                    f64_errs, f64_exact = gmm_f64_errors(*gmm_pair[name], args_,
                                                         dict(kw_, max_iters=1),
                                                         gmm_close[name])
                    if not f64_exact or any(k > GMM_AS_ACCURATE * max(p, 1e-7)
                                            for k, p in f64_errs):
                        fail(f"{name} planted {case}: one iteration off the float64 plain "
                             f"version by (kernel, float32 plain) {f64_errs}, exact outputs "
                             f"equal {f64_exact}")
                    f64_.append(f"{name} {max(k for k, _ in f64_errs):.3g} (plain "
                                f"{max(p for _, p in f64_errs):.3g})")
                gmm_hold(name, f"planted {case}", args_, dict(kw_, max_iters=100), GMM_TOL)
        it25 = k25(x_, masks_, m0_, v0_, w0_)[3].tolist()
        phase("K24/K25", f"planted mixtures, {case}: fits of {sizes} frames of D {d_} (plan: "
                         f"parameters in {plan_.params} memory, cap {plan_.cap} frames staged, "
                         f"frames tier {plan_.frames}): K24 with "
                         f"and without the quirk and K25 equal to their plain versions, one "
                         f"iteration"
                         + (f" (against float64: largest difference {', '.join(f64_)}, within "
                            f"{GMM_AS_ACCURATE}x the float32 plain version's)" if f64_ else "")
                         + f" and whole fits (EM iterations {it25}; assignments, "
                         f"counts and iteration counts exact; the rest rtol "
                         f"{GMM_TOL['rtol']}, atol {GMM_TOL['atol']}), two launches bit for "
                         f"bit")
        if case == "device memory":
            gmm_dev = {"K24": ((x_, masks_, c0_, 4, init_), {}),
                       "K25": ((x_, masks_, m0_, v0_, w0_), {})}
    for name in ("K24", "K25"):
        report[name] = {"max_abs_err": gmm_err[name]}
    # timed at digit 0's second split level (5 states, k = M = 4), and on
    # the planted device-memory case
    gmm_t, gmm_work, gmm_more = {}, {}, {}
    for name in ("K24", "K25"):
        args_, kw_ = gmm_calls[name][1]
        kernel, plain = gmm_pair[name]
        gmm_t[name] = (cuda_ms(lambda: kernel(*args_, **kw_), reps=5),
                       cuda_ms(lambda: plain(*args_, **kw_), reps=1))
        x_, masks_ = args_[:2]
        n_, d_ = x_.shape
        m_ = args_[2].shape[1]
        n_f = masks_.sum(1).tolist()
        plan_ = gfk.gmm_fit_plan(n_, d_, m_, em=name == "K25")
        if name == "K24":
            its = torch.zeros(masks_.shape[0], dtype=torch.int32, device=dev)
            k24(*args_, **kw_, iters=its)
            its = its.tolist()
        else:
            its = k25(*args_, **kw_)[3].tolist()
        staged = all(v <= plan_.cap for v in n_f)
        gmm_work[name] = gmm_fit_work(n_f, d_, m_, its, staged=staged, n=n_,
                                      kmeans=name == "K24")
        phase("timing", f"{name} at digit 0's second split level ({masks_.shape[0]} fits of "
                        f"{n_f} frames in a buffer of {n_}, D {d_}, {m_} mixtures, iterations "
                        f"{its}, staged {staged}): {gmm_t[name][0]:.3f} ms event, plain "
                        f"{gmm_t[name][1]:.1f} ms ({card})")
        args_, kw_ = gmm_dev[name]
        n_f = args_[1].sum(1).tolist()
        if name == "K24":
            its = torch.zeros(args_[1].shape[0], dtype=torch.int32, device=dev)
            k24(*args_, iters=its)
            its = its.tolist()
        else:
            its = k25(*args_)[3].tolist()
        tier_ms = cuda_ms(lambda: kernel(*args_), reps=3)
        gmm_more[f"{name} planted, {n_f[0]} frames from device memory"] = (
            *gmm_fit_work(n_f, 39, 4, its, staged=False, n=args_[0].shape[0],
                          kmeans=name == "K24"), tier_ms)
        phase("timing", f"{name} on planted fits of {n_f} frames (the first read from device "
                        f"memory), iterations {its}: {tier_ms:.3f} ms event ({card})")

    # ---- 7. timings ---------------------------------------------------------
    t = {}
    t.update(gmm_t)
    t["K3"] = (cuda_ms(lambda: mfcc39_fused(sig, lens, cfg)),
               cuda_ms(lambda: mfcc39_fused_ref(sig, lens, cfg)))
    t["K14"] = (cuda_ms(lambda: mfcc_tail(ceps_k, nf_c)),
                cuda_ms(lambda: _stack39(ceps_k, nf_c, "utterance")))
    bg, topo, want, ends = planes["sausage7"]
    t["K1"] = (cuda_ms(lambda: vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)),
               cuda_ms(lambda: vk.viterbi_banded_fused_ref(xa, w, lw, bg, topo, nf), reps=3))
    t["K13"] = (cuda_ms(lambda: vk.bank_emission(xa, w, lw)),
                cuda_ms(lambda: vk.bank_emission_ref(xa, w, lw)))
    dp_ms = cuda_ms(lambda: vk._banded_forward(nll13, bg, nf, 1, "fused",
                                               vk.viterbi_banded_fused))
    k3_long_ms = cuda_ms(lambda: mfcc39_fused(sig_long, lens_long, cfg))
    k1_big_ms = cuda_ms(lambda: vk.viterbi_banded_fused(xab, w, lw, bgb, topob, nfb))
    k8_big_ms = cuda_ms(lambda: vk.viterbi_banded_general(nll8b, bg8, topo8, nf8b,
                                                          big8.eps_depth))
    k11_big_ms = cuda_ms(lambda: viterbi_dense(**k11_big))
    t["K2"] = (cuda_ms(lambda: vk.banded_backtrace_val(want[1], want[3], ends, nf, topo.uniform_w)),
               cuda_ms(lambda: vk.banded_backtrace_val_ref(want[1], want[3], ends, nf,
                                                           topo.uniform_w), reps=3))

    def k1_k2():  # K2 reads the planes K1 has just written (part of them in L2)
        p_ = vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)
        return vk.banded_backtrace_val(p_[1], p_[3], ends, nf, topo.uniform_w)

    k1k2_ms = cuda_ms(k1_k2)
    graph7 = graphs["sausage7"]
    slot7 = torch.as_tensor(graph7.slot, device=dev)
    label7 = torch.as_tensor(graph7.slot_label, device=dev)

    def pipeline():
        f, n = mfcc39_auto(sig, lens, cfg)
        s, e, _ = _decode_banded_batch(bank, f, n, bg, topo=topo)
        return states_to_words_device(slot7, label7, s, e, n, max_words=f.shape[1],
                                      uniform_w=topo.uniform_w)

    pipe_ms = cuda_ms(pipeline)

    # K8 / K9 on the 1-state sausage (the general CLI path's graph) and the
    # 3-6-state sausage; K10 and the word-trace decode on the 385-state one
    bg1, topo1, nll1, want1, ends1, graph1, _ = gen_planes["1-state sausage7"]
    d1 = graph1.eps_depth
    t["K8"] = (cuda_ms(lambda: vk.viterbi_banded_general(nll1, bg1, topo1, nf8, d1)),
               cuda_ms(lambda: vk.viterbi_banded_general_ref(nll1, bg1, topo1, nf8, d1),
                       reps=3))
    t["K9"] = (cuda_ms(lambda: vk.banded_backtrace_general(want1[1], want1[2], bg1, ends1,
                                                           nf8, d1)),
               cuda_ms(lambda: vk.banded_backtrace_general_ref(want1[1], want1[2], bg1, ends1,
                                                               nf8, d1), reps=3))
    bg6, topo6, nll6, want6, ends6, graph6, _ = gen_planes["3-6-state sausage7"]
    k8_mixed_ms = cuda_ms(lambda: vk.viterbi_banded_general(nll6, bg6, topo6, nf8,
                                                            graph6.eps_depth))
    k9_mixed_ms = cuda_ms(lambda: vk.banded_backtrace_general(want6[1], want6[2], bg6, ends6,
                                                              nf8, graph6.eps_depth))
    t["K10"] = (cuda_ms(lambda: vk.viterbi_banded_wordtrace(xa, w, lw, bg, topo, nf)),
                cuda_ms(lambda: vk.viterbi_banded_wordtrace_ref(xa, w, lw, bg, topo, nf),
                        reps=1))
    dp10_ms = cuda_ms(lambda: vk._banded_forward(nll13, bg, nf, 1, "wordtrace",
                                                 vk.viterbi_banded_wordtrace))
    k10_big_ms = cuda_ms(lambda: vk.viterbi_banded_wordtrace(xab, w, lw, bgb, topob, nfb))
    # device times (torch.profiler) beside the event times, and torch.matmul
    # of K13's [U*M, A] x [A, T*B] product alone: a yardstick the port never
    # calls (no single PyTorch call computes the emission with its logsumexp)
    w2, x2 = w.reshape(-1, w.shape[2]), xa.reshape(xa.shape[0], -1)
    mm_ms = cuda_ms(lambda: torch.matmul(w2, x2))
    dev_ms = {k: device_ms(fn, what=k) for k, fn in (
        ("K13", lambda: vk.bank_emission(xa, w, lw)),
        ("K10", lambda: vk.viterbi_banded_wordtrace(xa, w, lw, bg, topo, nf)),
        ("K10 DP", lambda: vk._banded_forward(nll13, bg, nf, 1, "wordtrace",
                                              vk.viterbi_banded_wordtrace)),
        ("K1", lambda: vk.viterbi_banded_fused(xa, w, lw, bg, topo, nf)),
        ("matmul", lambda: torch.matmul(w2, x2)))}
    wt_ms = cuda_ms(lambda: decode_connected(bank, graph7, feats, nf, backend="wordtrace"),
                    reps=3)
    auto_ms = cuda_ms(lambda: decode_connected(bank, graph7, feats, nf), reps=3)
    fwd = vk.viterbi_banded_wordtrace(xa, w, lw, bg, topo, nf)

    def wt_ends():
        end_costs = fwd[0][bg.end_states] + bg.end_bonus[:, None]
        end_state = bg.end_states[torch.argmin(end_costs, 0)]
        return end_state, fwd[3].gather(0, end_state[None])[0]

    end_state7, entry7 = wt_ends()
    k23_args = (fwd[1], fwd[2], end_state7 // topo.uniform_w, entry7, nf)
    wt_stages = {
        "augment_dtb + weights": lambda: (augment_dtb(feats),
                                          gmm_emission_weights(*bank.flat_states())),
        "K10": lambda: vk.viterbi_banded_wordtrace(xa, w, lw, bg, topo, nf),
        "end selection": wt_ends,
        "chain walk (K23)": lambda: vk.wordtrace_words_device(*k23_args),
    }
    wt_stage_ms = {k: cuda_ms(fn) for k, fn in wt_stages.items()}
    # K23 alone beside its plain version, on the word trace's own planes
    t["K23"] = (cuda_ms(lambda: vk.wordtrace_words_device(*k23_args), reps=20),
                cuda_ms(lambda: vk.wordtrace_words_ref(*k23_args), reps=3))
    k23_words = vk.wordtrace_words_ref(*k23_args)

    topo1k = lk.lex_topology(g1k)
    t["K4"] = (cuda_ms(lambda: lk.viterbi_lex(nll1k, g1k, topo1k, nf1k)),
               cuda_ms(lambda: lk.viterbi_lex_ref(nll1k, g1k, topo1k, nf1k), reps=3))
    topod = lk.lex_topology(gd)

    def k5_1k():
        return lk.lex_backtrace_val(lex_planes[1], lex_planes[3], g1k, lex_ends, nf1k,
                                    topo=topo1k)

    def k5_dict():
        return lk.lex_backtrace_val(dict_planes[1], dict_planes[3], gd, dict_ends, nfd,
                                    topo=topod)

    t["K5"] = (cuda_ms(k5_1k, reps=10),
               cuda_ms(lambda: lk.lex_backtrace_val_ref(lex_planes[1], lex_planes[3], g1k,
                                                        lex_ends, nf1k), reps=3))
    k5_dict_ms = cuda_ms(k5_dict, reps=10)
    k5_dev = {"1k": device_ms(k5_1k, what="K5 on the 1k trie"),
              "dict1": device_ms(k5_dict, what="K5 on the dictionary-shaped trie")}
    # K5's trace: lane 0's cycles fetching new chains, waiting for windows,
    # stashing, issuing the next window, walking and writing out; windows
    # waited for and loaded during the walk; frames (mean over the streams
    # that ran)
    k5_trace = {}
    for name, (planes_, g_, ends_, nf_, topo_) in (
            ("1k", (lex_planes, g1k, lex_ends, nf1k, topo1k)),
            ("dict1-shaped", (dict_planes, gd, dict_ends, nfd, topod))):
        tr5 = torch.zeros((nf_.numel(), 9), dtype=torch.int64, device=dev)
        lk.lex_backtrace_val(planes_[1], planes_[3], g_, ends_, nf_, topo=topo_, trace=tr5)
        torch.cuda.synchronize()
        k5_trace[name] = tr5[tr5[:, 8] > 0].double().mean(0).tolist()
    topo_big = lk.lex_topology(gbig)
    k4_big_ms = cuda_ms(lambda: lk.viterbi_lex(nllbig, gbig, topo_big, nfbig))
    k4_dict_ms = cuda_ms(lambda: lk.viterbi_lex(nlld, gd, topod, nfd))
    k4_dict_plain = cuda_ms(lambda: lk.viterbi_lex_ref(nlld, gd, topod, nfd), reps=1)
    # the general mode, and the cycles per frame step by phase (the
    # kernel's clock64 trace of thread 0: band, barrier, eps scan, warp
    # reduction, apply, barrier; mean over streams of cycles / frames run)
    topo_gen = lk.lex_topology(g_gen)
    k4_gen_ms = cuda_ms(lambda: lk.viterbi_lex(nll1k, g_gen, topo_gen, nf1k))

    def frame_cycles(lattice, nll_, nf_, topo_, g_):
        trace = torch.zeros((nll_.shape[2], 6), dtype=torch.int64, device=dev)
        lk.lex_forward(nll_, g_, topo_, nf_, lattice,
                       lt.viterbi_lattice if lattice else lk.viterbi_lex, trace=trace)
        frames = nf_.clamp(min=1 if lattice else 0, max=nll_.shape[1]).double()
        return (trace.double()[frames > 0] / frames[frames > 0, None]).mean(0).tolist()

    k4_cycles = frame_cycles(False, nll1k, nf1k, topo1k, g1k)

    from speech_recognition_tpu_torch.decode.lextree import _decode_lex_batch
    from speech_recognition_tpu_torch.models.lexgraph import lex_words_from_path_batch

    lbank, lexp, lcfg, lsig, llens = make_lex_pipeline(dev)
    gp, topop = lexp.banded.to(dev), lk.lex_topology(lexp.banded)

    def lex_pipeline():
        f, n = mfcc39_auto(lsig, llens, lcfg)
        return _decode_lex_batch(lbank, f, n, gp, topop) + (n,)

    lex_ms = cuda_ms(lex_pipeline)
    states, flags, _, nfp = lex_pipeline()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lex_words = lex_words_from_path_batch(lexp, states.T.cpu().numpy(), nfp.cpu().numpy(),
                                          flags.T.cpu().numpy())
    words_ms = (time.perf_counter() - t0) * 1e3

    # K6 / K7 at bench_lextree_bigram's shape (every stream 500 frames)
    from speech_recognition_tpu_torch.ops.lattice import (
        _decode_lattice_batch,
        _ring_depth,
        lattice_words_ref,
    )

    nf_full = torch.full((128,), TL, dtype=torch.int32, device=dev)
    dmax = _ring_depth(TL, 128)
    k6_out = lt.viterbi_lattice(nll_b, g1k, topo1k, nf_full)
    k7_args = (k6_out[1], k6_out[2], k6_out[1].amin(2), lm_l1k[0], lm_l1k[1], nf_full, dmax)
    k7_kw = dict(big_ll=None, backoff=lm_l1k[3])
    # the pipeline's K7 launch: q, the truncation count and the walk too
    mw_1k = min(TL, TL // (lex1k.n_states // lex1k.n_arcs) + 1)
    k7w_args = (*k7_args[:2], *k7_args[3:], 128, mw_1k)
    t["K6"] = (cuda_ms(lambda: lt.viterbi_lattice(nll_b, g1k, topo1k, nf_full)),
               cuda_ms(lambda: lt.viterbi_lattice_ref(nll_b, g1k, topo1k, nf_full), reps=3))

    def k7_extras():
        return lt.rescore_and_walk(*k7w_args, **k7_kw)

    def k7_no_walk():  # max_words 0: the walk takes no step, q and the count stay
        return lt.rescore_and_walk(*k7w_args[:-1], 0, **k7_kw)

    t["K7"] = (cuda_ms(k7_extras),
               cuda_ms(lambda: lt.rescore_and_walk_ref(*k7w_args, **k7_kw), reps=3))
    k7w_out = k7_extras()
    # cycles a frame by phase (clock64, thread 0 of each CTA)
    tr = torch.zeros((128, 4), dtype=torch.int64, device=dev)
    lt.rescore_and_walk(*k7w_args, **k7_kw, trace=tr)
    torch.cuda.synchronize()
    k7_cycles = (tr.double().mean(0) / TL).tolist()
    # K22 as it runs on the path, K7's last step: the launch's device time
    # less the same launch's at max_words 0 (the walk takes no step), in
    # turns; beside its plain version on the same planes
    k7_walk_turns = [device_ms(fn, reps=20, what=w_) for fn, w_ in (
        (k7_extras, "K7"), (k7_no_walk, "K7 without the walk"),
        (k7_no_walk, "K7 without the walk, again"), (k7_extras, "K7, again"))]
    k22_w_args = (k7w_out[2].transpose(1, 2), k7w_args[1].transpose(1, 2), k7w_out[1],
                  nf_full)
    t["K22"] = (statistics.median(k7_walk_turns[::3]) - statistics.median(k7_walk_turns[1:3]),
                cuda_ms(lambda: lattice_words_ref(*k22_w_args, max_words=mw_1k), reps=3))
    k7_dense_ms = cuda_ms(lambda: lt.rescore_lattice(*k7_args[:-1], dmax, big_ll=lm_ld[2]))
    nf_d16 = torch.full((16,), TL, dtype=torch.int32, device=dev)
    k6_dict_ms = cuda_ms(lambda: lt.viterbi_lattice(nll_bd, gd, topod, nf_d16))
    k6_cycles = frame_cycles(True, nll_b, nf_full, topo1k, g1k)
    k6_gen_ms = cuda_ms(lambda: lt.viterbi_lattice(nll_b, g_gen, topo_gen, nf_full))
    # K6 on the 1k trie with its tau frontier in device memory (the plan
    # keeps it on chip)
    k6_alt = lk.lex_plan(True, topo1k, lib.srt_smem_limit())._replace(tau=False)
    k6_alt_ms = cuda_ms(lambda: lk.lex_forward(nll_b, g1k, topo1k, nf_full, True,
                                               lt.viterbi_lattice, plan=k6_alt))
    kd_out = lt.viterbi_lattice(nll_bd, gd, topod, nf_d16)
    k7d_args = (kd_out[1], kd_out[2], kd_out[1].amin(2), lm_ldd[0], lm_ldd[1], nf_d16, dmax)
    k7_plan = lt.rescore_plan(g1k.n_ends, lm_l1k[3][1].shape[1], False, lib.srt_smem_limit())
    k7d_plan = lt.rescore_plan(gd.n_ends, lm_ldd[3][1].shape[1], False, lib.srt_smem_limit())
    k7_dict_ms = cuda_ms(lambda: lt.rescore_lattice(*k7d_args, backoff=lm_ldd[3]))
    dev_ms["K7"] = statistics.median(k7_walk_turns[::3])
    dev_ms["K7 without the walk"] = statistics.median(k7_walk_turns[1:3])
    dev_ms.update({k: device_ms(fn, what=k) for k, fn in (
        ("K2", lambda: vk.banded_backtrace_val(want[1], want[3], ends, nf, topo.uniform_w)),
        ("K1+K2", k1_k2),
        ("K7 dict1-shaped", lambda: lt.rescore_lattice(*k7d_args, backoff=lm_ldd[3])))})

    # K9 on both sausages, K8 alone and K8 then K9 as one number (K9 reads
    # the planes K8 has just written), device times
    def k8_k9():
        p_ = vk.viterbi_banded_general(nll1, bg1, topo1, nf8, d1)
        return vk.banded_backtrace_general(p_[1], p_[2], bg1, ends1, nf8, d1)

    k8k9_ms = cuda_ms(k8_k9)
    # K9's clock64 trace per stream: lane 0's cycles in windows and walks,
    # windows waited for and loaded during the walk
    k9_trace = {}
    for name, (w_, e_, g_, d_) in (("1-state", (want1, ends1, bg1, d1)),
                                   ("3-6-state", (want6, ends6, bg6, graph6.eps_depth))):
        tr = torch.zeros((B, 5), dtype=torch.int64, device=dev)
        vk.banded_backtrace_general(w_[1], w_[2], g_, e_, nf8, d_, trace=tr)
        torch.cuda.synchronize()
        k9_trace[name] = tr.double().mean(0).tolist()
    dev_ms.update({k: device_ms(fn, what=k) for k, fn in (
        ("K9", lambda: vk.banded_backtrace_general(want1[1], want1[2], bg1, ends1, nf8, d1)),
        ("K9 3-6-state", lambda: vk.banded_backtrace_general(want6[1], want6[2], bg6, ends6,
                                                             nf8, graph6.eps_depth)),
        ("K8", lambda: vk.viterbi_banded_general(nll1, bg1, topo1, nf8, d1)),
        ("K8+K9", k8_k9))})

    # the bigram pipeline: 128 x 5 s wav -> words over lexp's trie with an
    # add-k LM of 200 random 12-word sentences
    from speech_recognition_tpu_torch.langmodel.bigram import fit_bigram as _fit

    prng = np.random.default_rng(9)
    lm_p = _fit([[int(x) for x in prng.integers(0, len(lexp.words), 12)] for _ in range(200)],
                len(lexp.words))
    lm_lp = lattice_lm(lm_p, lexp.leaf_word, dev)
    su_p = lexp.n_states // lexp.n_arcs

    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt
    from speech_recognition_tpu_torch.ops.lattice import (
        _lattice_truncation_count,
        lattice_words_device,
    )

    def bigram_pipeline():
        f, n = mfcc39_auto(lsig, llens, lcfg)
        return _decode_lattice_batch(lbank, f, n, gp, topop, lm_lp, su_p)

    def bigram_pipeline_unfused():
        # the stages the one launch replaced, each on its own: the
        # tensor-op truncation count, the amin, K7 and the standalone K22
        f, n = mfcc39_auto(lsig, llens, lcfg)
        _, ec, et = lt.viterbi_lattice(bank_nll_ubt(lbank, f, n), gp, topop, n)
        nt = _lattice_truncation_count(ec.transpose(1, 2), et.transpose(1, 2), n, 128)
        c, bl, pr = lt.rescore_lattice(ec, et, ec.amin(2), lm_lp[0], lm_lp[1], n,
                                       _ring_depth(f.shape[1], 128), big_ll=lm_lp[2],
                                       backoff=lm_lp[3])
        lr, nw = lattice_words_device(pr.transpose(1, 2), et.transpose(1, 2), bl, n,
                                      max_words=min(f.shape[1], f.shape[1] // su_p + 1))
        return lr, nw, c, nt

    big_ms = cuda_ms(bigram_pipeline)
    got_p, was_p = bigram_pipeline(), bigram_pipeline_unfused()
    torch.cuda.synchronize()
    if not (torch.equal(got_p[0], was_p[0]) and torch.equal(got_p[1], was_p[1])
            and torch.equal(got_p[2], was_p[2]) and int(got_p[3].sum()) == int(was_p[3])):
        fail("the bigram pipeline's words, costs or truncation count differ from its "
             "stages run one by one")
    # its stages, each timed alone on the previous stage's outputs
    f_p, n_p = mfcc39_auto(lsig, llens, lcfg)
    t_p = f_p.shape[1]
    nll_pp = bank_nll_ubt(lbank, f_p, n_p)
    p6 = lt.viterbi_lattice(nll_pp, gp, topop, n_p)
    p7_args = (p6[1], p6[2], p6[1].amin(2), lm_lp[0], lm_lp[1], n_p, _ring_depth(t_p, 128))
    p7 = lt.rescore_lattice(*p7_args, big_ll=lm_lp[2], backoff=lm_lp[3])
    k22_args = (p7[2].transpose(1, 2), p6[2].transpose(1, 2), p7[1], n_p)
    mw_p = min(t_p, t_p // su_p + 1)
    stages = {
        "K3": lambda: mfcc39_auto(lsig, llens, lcfg),
        "bank_nll_ubt": lambda: bank_nll_ubt(lbank, f_p, n_p),
        "K6": lambda: lt.viterbi_lattice(nll_pp, gp, topop, n_p),
        "K7 (+q, count, walk)": lambda: lt.rescore_and_walk(
            *p7_args[:2], *p7_args[3:], 128, mw_p, big_ll=lm_lp[2], backoff=lm_lp[3]),
    }
    stage_ms = {k: cuda_ms(fn) for k, fn in stages.items()}
    # the launches the last stage replaced that run on in other code, on
    # the same planes
    replaced_ms = {
        "tensor-op truncation count": cuda_ms(lambda: _lattice_truncation_count(
            p6[1].transpose(1, 2), p6[2].transpose(1, 2), n_p, 128)),
        "amin": cuda_ms(lambda: p6[1].amin(2)),
        "standalone K22": cuda_ms(lambda: lattice_words_device(*k22_args, max_words=mw_p),
                                  reps=20)}
    k7p_dev = device_ms(stages["K7 (+q, count, walk)"], what="bigram pipeline, K7")
    k22_p_plain = cuda_ms(lambda: lattice_words_ref(*k22_args, max_words=mw_p), reps=3)
    leaves_rev, n_words, _, _ = bigram_pipeline()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr_h, nw_h = leaves_rev.cpu().numpy(), n_words.cpu().numpy()
    big_words = [lexp.leaf_word[lr_h[: nw_h[i], i][::-1]].tolist() for i in range(len(nw_h))]
    big_words_ms = (time.perf_counter() - t0) * 1e3

    # K11 at each checked shape (the isolated one without planes, as the
    # isolated path runs it), the dense backtrace, K12, the isolated pipeline
    from speech_recognition_tpu_torch.decode.isolated import classify_batch, model_costs

    iso_case = dense_cases["isolated 512x500, 11 models x 5 states"]
    t["K11"] = (cuda_ms(lambda: viterbi_dense(**iso_case, planes=False)),
                cuda_ms(lambda: viterbi_dense_ref(**iso_case, planes=False), reps=3))
    k11_ms = {name: (cuda_ms(lambda kw=kw: viterbi_dense(**kw)),
                     cuda_ms(lambda kw=kw: viterbi_dense_ref(**kw), reps=1))
              for name, kw in dense_cases.items()}
    # K11 in each form, device times: packed (the isolated path, no planes),
    # cluster (the sausage; the tie batch), item (the transcript graphs), wide
    # (a 500-state graph, past the largest cluster, 8 x 100) and scratch
    wrng = np.random.default_rng(19)
    tr_w = wrng.uniform(0, 3, (2, 500, 500)).astype(np.float32)
    tr_w[wrng.uniform(size=tr_w.shape) < 0.7] = POS_INF
    wide_case = dict(nll=on_dev(wrng.uniform(0, 5, (8, 100, 500)).astype(np.float32)),
                     trans=on_dev(tr_w[0]), init_cost=on_dev(wrng.uniform(0, 2, 500)
                                                             .astype(np.float32)),
                     n_frames=on_dev(np.full(8, 100, np.int32)), eps_trans=on_dev(tr_w[1]),
                     eps_depth=1)
    k11_forms = {
        f"isolated, no planes ({dense_form(iso_case)})":
            lambda: viterbi_dense(**iso_case, planes=False),
        **{f"{name} ({dense_form(kw)})": (lambda kw=kw: viterbi_dense(**kw))
           for name, kw in dense_cases.items() if not name.startswith("isolated")},
        f"500 states 8x100 ({dense_form(wide_case)})": lambda: viterbi_dense(**wide_case),
        f"{s11} states 2x4 ({dense_form(k11_big)})": lambda: viterbi_dense(**k11_big)}
    k11_dev = {k: device_ms(fn, what=f"K11 {k}") for k, fn in k11_forms.items()}
    # K11's clock64 traces: the packed form's cycles per frame step (mean
    # over warps) at the isolated shape, the cluster form's cycles per
    # frame by phase (thread 0 of each CTA, mean) on the sausage
    iso_plan = dk.dense_plan(iso_case["nll"].shape[0], n_s, True, False,
                             lib.srt_smem_limit(), n_sm, slots)
    tr = torch.zeros((iso_plan.grid * iso_plan.warps, 2), dtype=torch.int64, device=dev)
    dk._launch(**iso_case, planes=False, trace=tr)
    sau_plan = dk.dense_plan(64, g7.n_states, False, True, lib.srt_smem_limit(), n_sm, slots)
    tr_s = torch.zeros((sau_plan.grid, 5), dtype=torch.int64, device=dev)
    dk._launch(**dense_cases["385-state sausage7 64x500"], trace=tr_s)
    torch.cuda.synchronize()
    tr = tr[tr[:, 1] > 0].double()
    k11_cycles = (float((tr[:, 0] / tr[:, 1]).mean()),
                  (tr_s[:, :4].double() / tr_s[:, 4:].double()).mean(0).tolist())
    saus = dense_cases["385-state sausage7 64x500"]
    fin_s, bp_s, ebp_s = dense_out["385-state sausage7 64x500"]
    ends7 = on_dev(g7.end_states).long()
    end_s = ends7[torch.argmin(fin_s[:, ends7] + on_dev(g7.end_bonus), 1)]
    # K21 through viterbi_backtrace (the dense decode's call) beside its
    # plain version, and alone at the other checked shapes
    bt_args = (bp_s, ebp_s, end_s, saus["n_frames"], saus["eps_depth"])
    t["K21"] = (cuda_ms(lambda: viterbi_backtrace(*bt_args), reps=20),
                cuda_ms(lambda: viterbi_backtrace_ref(*bt_args), reps=3))
    k21_states = viterbi_backtrace_ref(*bt_args)[0]
    k21_ms = {name: cuda_ms(lambda a=a: dense_backtrace(*a), reps=10)
              for name, a in k21_args.items() if not name.startswith("385")}
    # K21's two forms on each dense case in this call: the chain form (the
    # parent's kernel) as "parent" and the plan's window form as "change",
    # timed parent, change, change, parent; device times of both; and the
    # window form's counters (windows a stream, loads ahead taken and
    # dropped, words staged) for the bytes it staged and their rate
    k21_forms_ms = {}
    for name, a in k21_args.items():
        pl = k21_plans(a[0], a[4])
        fns = {"parent": lambda a=a, p=pl["chain"]: dk._backtrace(*a, plan=p),
               "change": lambda a=a, p=pl["plan"]: dk._backtrace(*a, plan=p)}
        ev = {k: [] for k in fns}
        for k in ("parent", "change", "change", "parent"):
            ev[k].append(cuda_ms(fns[k], reps=10))
        stats = torch.zeros((a[0].shape[0], 7), dtype=torch.int64, device=dev)
        dk._backtrace(*a, plan=pl["plan"], stats=stats)
        torch.cuda.synchronize()
        st = stats.double()
        k21_forms_ms[name] = dict(
            event=ev, plan=pl["plan"],
            device={k: device_ms(fn, what=f"K21 {k} on {name}") for k, fn in fns.items()},
            windows=(float(st[:, 0].mean()), int(st[:, 0].max())),
            ahead=int(st[:, 1].sum()), dropped=int(st[:, 2].sum()),
            staged=4 * int(st[:, 3].sum()),
            wait=float((st[:, 4] / st[:, 6].clamp(min=1)).mean()),
            reload=float((st[:, 5] / st[:, 6].clamp(min=1)).mean()))
    # K22 and K23 where chains are long: the planted 1k-trie words (the
    # random-signal pipeline's chains hold a word or two) and the skip-arc
    # loop graph
    k22_planted = errs[1][3]
    k22_pl_words = lattice_words_ref(*k22_planted[:4], max_words=k22_planted[4])[1]
    k22_pl_ms = cuda_ms(lambda: lattice_words_device(*k22_planted[:4],
                                                     max_words=k22_planted[4]), reps=10)
    k23_skip_ms = cuda_ms(lambda: vk.wordtrace_words_device(*k23_skip_args), reps=10)
    walk_dev = {k: device_ms(fn, what=k) for k, fn in (
        ("K21", lambda: viterbi_backtrace(*bt_args)),
        ("standalone K22 on the bigram pipeline's planes",
         lambda: lattice_words_device(*k22_args, max_words=mw_p)),
        ("K23", lambda: vk.wordtrace_words_device(*k23_args)))}
    t["K12"] = (cuda_ms(lambda: mfcc_fused(sig, lens, cfg)),
                cuda_ms(lambda: mfcc_fused_ref(sig, lens, cfg)))
    n2 = 32000  # 2 s at 16 kHz
    L2 = ((padded_length(cfg, n2) + 159) // 160 + 8) * 160
    sig2 = torch.from_numpy((np.random.default_rng(15).standard_normal((512, L2)) * 3000)
                            .astype(np.float32)).to(dev)
    lens2 = torch.full((512,), n2, dtype=torch.int32, device=dev)

    def iso_pipeline():
        f, n = mfcc39_auto(sig2, lens2, cfg)
        return classify_batch(bank, f, n)[0]

    iso_ms = cuda_ms(iso_pipeline)
    f2, n2_t = mfcc39_auto(sig2, lens2, cfg)
    mask2 = torch.arange(f2.shape[1], device=dev)[None, :] < n2_t[:, None]
    nll2 = bank_nll(bank, f2, mask2)
    iso_stage_ms = {
        "K3": lambda: mfcc39_auto(sig2, lens2, cfg),
        "bank_nll": lambda: bank_nll(bank, f2, mask2),
        "regroup + K11 + argmin": lambda: torch.argmin(
            model_costs(nll2, bank.trans_cost, n2_t), 1),
    }
    iso_stage_ms = {k: cuda_ms(fn) for k, fn in iso_stage_ms.items()}

    for k, (ms, plain) in t.items():
        phase("timing", f"{k}: kernel {ms:.3f} ms, plain {plain:.3f} ms "
                        f"(CUDA-event median; {card})")
    for name, (ms, plain) in k11_ms.items():
        phase("timing", f"K11 with planes on {name}: kernel {ms:.3f} ms, plain {plain:.3f} "
                        f"ms (CUDA-event median; {card})")
    for name, ms in k11_dev.items():
        phase("timing", f"K11 {name}: {ms:.4f} ms device (torch.profiler; {card})")
    phase("timing", f"K11 cycles per frame (clock64 trace): packed form at the isolated "
                    f"shape {k11_cycles[0]:.0f} a warp; cluster form on the sausage, thread "
                    f"0 of each CTA: " + ", ".join(
                        f"{k} {v:.0f}" for k, v in zip(("scans", "owners + publish",
                                                         "barriers", "total"), k11_cycles[1]))
                    + f" ({card})")
    phase("timing", f"dense backtrace on the 385-state sausage at 64x{T}: K21 "
                    f"{t['K21'][0]:.4f} ms, viterbi_backtrace_ref (tensor ops) "
                    f"{t['K21'][1]:.3f} ms (CUDA-event median; {card}); K21 elsewhere: "
                    + ", ".join(f"{k} {v:.4f} ms" for k, v in k21_ms.items()))
    phase("timing", f"the walks on long chains: standalone K22 on the planted 1k trie 128x500 "
                    f"(longest chain {int(k22_pl_words.max())} words) {k22_pl_ms:.4f} ms, "
                    f"K23 on the skip-arc loop graph 64x300 (longest chain "
                    f"{int(want_s[1].max())} words) {k23_skip_ms:.4f} ms (CUDA-event median; "
                    f"{card})")
    phase("timing", "the walks' device time (torch.profiler): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in walk_dev.items()) + f" ({card})")
    for name, r in k21_forms_ms.items():
        p, ev, dv = r["plan"], r["event"], r["device"]
        phase("timing", f"K21 forms on {name}: parent (chain form) "
                        f"{ev['parent'][0]:.4f} / {ev['parent'][1]:.4f} ms, change (window "
                        f"form, {p.rows} frames x {p.states} states, "
                        f"{'block' if p.block else 'row'} layout, {32 // p.lanes} streams "
                        f"a warp, {p.grid} CTAs of {p.warps} warps) {ev['change'][0]:.4f} / "
                        f"{ev['change'][1]:.4f} ms (CUDA-event medians, in the order parent, "
                        f"change, change, parent); device {dv['parent']:.4f} / "
                        f"{dv['change']:.4f} ms (torch.profiler); window form: "
                        f"{r['windows'][0]:.1f} windows a stream (at most {r['windows'][1]}), "
                        f"{r['ahead']} taken from the load ahead, {r['dropped']} loads ahead "
                        f"dropped, {r['staged'] / 1e6:.2f} MB staged = "
                        f"{r['staged'] / 1e6 / dv['change']:.1f} GB/s at its device time; of "
                        f"a stream's cycles {r['reload']:.2f} in window changes, "
                        f"{r['wait']:.2f} of them waiting for copies ({card})")
    phase("timing", f"isolated pipeline 512 x 2 s wav -> predictions (K3 + bank_nll + "
                    f"K11 + argmin): {iso_ms:.3f} ms = {512 * 2 / (iso_ms / 1e3):.0f} "
                    f"audio-s/s (CUDA-event median; {card}); stages alone: " + ", ".join(
                        f"{k} {ms:.3f} ms" for k, ms in iso_stage_ms.items()))
    phase("timing", f"K8 / K9 on the 3-6-state sausage7 ({bg6.n_states} states) at {B}x{T}: "
                    f"{k8_mixed_ms:.3f} / {k9_mixed_ms:.3f} ms (CUDA-event median; {card})")
    for name, (win, walk, wait, ahead, frames) in k9_trace.items():
        phase("timing", f"K9 trace on the {name} sausage, mean over {B} streams: lane 0's "
                        f"cycles in windows {win:.0f}, walking {walk:.0f} ({frames:.0f} "
                        f"frames); windows waited for {wait:.2f}, loaded during the walk "
                        f"{ahead:.2f} ({card})")
    phase("timing", f"K9 {B}x{T}: 1-state sausage {t['K9'][0]:.3f} ms event, "
                    f"{dev_ms['K9']:.4f} ms device; 3-6-state sausage {k9_mixed_ms:.3f} ms "
                    f"event, {dev_ms['K9 3-6-state']:.4f} ms device; K8 then K9 as one number "
                    f"on the 1-state sausage: {k8k9_ms:.3f} ms event, {dev_ms['K8+K9']:.3f} "
                    f"ms device, against K8 alone {t['K8'][0]:.3f} / {dev_ms['K8']:.3f} ms "
                    f"({card})")
    phase("timing", f"K1 = K13 {t['K13'][0]:.3f} ms + DP alone {dp_ms:.3f} ms on sausage7 "
                    f"at {B}x{T}; past the old limits: K3 64 x 25 s ({f_long} frames) "
                    f"{k3_long_ms:.3f} ms, K1 on the {bgb.n_states}-state loop at "
                    f"{Bb}x{Tb} {k1_big_ms:.3f} ms, K8 on the {bg8.n_states}-state loop at "
                    f"{B8b}x{Tb} {k8_big_ms:.3f} ms, K11 at {s11} states 2x4 "
                    f"{k11_big_ms:.3f} ms (CUDA-event median; {card})")
    phase("timing", f"word-trace decode {B}x{T} on sausage7 (decode_connected "
                    f"backend='wordtrace', features -> word lists): {wt_ms:.3f} ms; the "
                    f"states path (K1 + K2 + states_to_words_device) {auto_ms:.3f} ms; "
                    f"word-trace stages alone: " + ", ".join(
                        f"{k} {ms:.3f} ms" for k, ms in wt_stage_ms.items())
                    + f" (CUDA-event median; {card})")
    phase("timing", f"K4 dict1-shaped trie ({gd.n_states} states) at 32x{TL}: "
                    f"{k4_dict_ms:.3f} ms, plain {k4_dict_plain:.3f} ms; K4 on the "
                    f"8,000-bank-row trie (no row tables) at 16x{TL}: {k4_big_ms:.3f} ms "
                    f"(CUDA-event median; {card})")
    phase("timing", f"K5 1k trie at 128x{TL}: {t['K5'][0]:.4f} ms event, "
                    f"{k5_dev['1k']:.4f} ms device; dict1-shaped trie at 32x{TL}: "
                    f"{k5_dict_ms:.4f} ms event, {k5_dev['dict1']:.4f} ms device ({card})")
    for name, (rows, wait, stash, issue, walk, write, waited, ahead,
               frames) in k5_trace.items():
        phase("timing", f"K5 trace on the {name} trie, mean over streams: lane 0's cycles "
                        f"fetching chains {rows:.0f}, waiting for windows {wait:.0f}, "
                        f"stashing {stash:.0f}, issuing the next window {issue:.0f}, "
                        f"walking {walk:.0f} ({frames:.0f} frames, "
                        f"{walk / frames:.1f} a frame), writing out {write:.0f}; windows "
                        f"waited for {waited:.2f}, loaded during the walk {ahead:.2f} ({card})")
    phases = ("band", "barrier A", "eps scan", "eps reduce", "eps apply", "barrier B")
    for name, cyc in (("K4", k4_cycles), ("K6", k6_cycles)):
        phase("timing", f"{name} on the 1k trie at 128x{TL}, cycles per frame step by phase "
                        f"(trace, mean over streams): " + ", ".join(
                            f"{k} {v:.0f}" for k, v in zip(phases, cyc))
                        + f"; total {sum(cyc):.0f} ({card})")
    phase("timing", f"general mode (1k trie, one band entry perturbed) at 128x{TL}: K4 "
                    f"{k4_gen_ms:.3f} ms, K6 {k6_gen_ms:.3f} ms; K6 with its tau frontier in "
                    f"device memory {k6_alt_ms:.3f} ms against the plan's "
                    f"{t['K6'][0]:.3f} (CUDA-event median; {card})")
    phase("timing", f"K13 {B}x{T}: {t['K13'][0]:.3f} ms event, {dev_ms['K13']:.3f} ms "
                    f"device; torch.matmul of its [U*M, A] x [A, T*B] product alone (a "
                    f"yardstick the port does not call) {mm_ms:.3f} ms event, "
                    f"{dev_ms['matmul']:.3f} ms device; K10 = K13 + the word-trace DP: "
                    f"{t['K10'][0]:.3f} ms event, {dev_ms['K10']:.3f} ms device, the DP alone "
                    f"{dp10_ms:.3f} ms event, {dev_ms['K10 DP']:.3f} ms device; K1 "
                    f"{t['K1'][0]:.3f} ms event, {dev_ms['K1']:.3f} ms device ({card})")
    phase("timing", f"K2 {B}x{T} on sausage7: {t['K2'][0]:.3f} ms event, {dev_ms['K2']:.4f} ms "
                    f"device; K1 then K2 as one number (K2 on the planes K1 has just "
                    f"written): {k1k2_ms:.3f} ms event, {dev_ms['K1+K2']:.3f} ms device, "
                    f"against K1 alone {t['K1'][0]:.3f} / {dev_ms['K1']:.3f} ms ({card})")
    phase("timing", f"K7 1k trie 128x{TL} (backoff, plan {k7_plan.mode}) with q, the "
                    f"truncation count and the walk (rescore_and_walk, max_words {mw_1k}): "
                    f"{t['K7'][0]:.4f} ms event, "
                    f"{dev_ms['K7']:.4f} ms device, at max_words 0 (no walk) "
                    f"{dev_ms['K7 without the walk']:.4f} ms device: the walk (K22, its last "
                    f"step) {t['K22'][0]:.4f} ms; in turns (with, without, without, with) "
                    + " / ".join(f"{v:.4f}" for v in k7_walk_turns)
                    + f" ms device; dict1-shaped 16x{TL} (plan "
                    f"{k7d_plan.mode}): {k7_dict_ms:.3f} ms event, "
                    f"{dev_ms['K7 dict1-shaped']:.3f} ms device ({card})")
    phase("timing", "K7 cycles a frame (clock64, thread 0 of each CTA; row wait, D + ring "
                    "reads, barrier, recombination + stores): "
                    + " / ".join(f"{v:.0f}" for v in k7_cycles)
                    + f" = {sum(k7_cycles):.0f} ({card})")
    phase("timing", f"on the {bgb.n_states}-state loop at {Bb}x{Tb}: K10 {k10_big_ms:.3f} ms "
                    f"(frontier in {plan_10b.frontier} memory), K1 {k1_big_ms:.3f} ms "
                    f"(CUDA-event median; {card})")
    # each kernel's time before its last redesign (PERF.md §6), on the same
    # card model and limit
    for name, ms, before in (("K3 256 x 5 s", t["K3"][0], 1.259),
                             ("K12 256 x 5 s", t["K12"][0], 1.175),
                             ("K4 1k trie 128 x 500", t["K4"][0], 5.970),
                             ("K6 1k trie 128 x 500", t["K6"][0], 7.288),
                             ("K4 dict1-shaped 32 x 500", k4_dict_ms, 51.236),
                             ("K6 dict1-shaped 16 x 500", k6_dict_ms, 62.262),
                             ("K13 512 x 500", t["K13"][0], 0.425),
                             ("K10 512 x 500", t["K10"][0], 5.133),
                             ("K1 512 x 500", t["K1"][0], 1.648),
                             ("word-trace decode 512 x 500", wt_ms, 10.014),
                             ("K2 512 x 500", t["K2"][0], 0.183),
                             ("K5 1k trie 128 x 500", t["K5"][0], 0.325),
                             ("K7 (+q, count, walk) 1k trie 128 x 500", t["K7"][0], 1.867),
                             ("K7 dict1-shaped 16 x 500", k7_dict_ms, 11.467),
                             ("K1 7,500-state loop 64 x 100", k1_big_ms, 116.473),
                             ("K9 512 x 500, 1-state sausage", t["K9"][0], 0.256),
                             ("K11 isolated 512 x 500 x 11, no planes", t["K11"][0], 0.360),
                             ("K11 385-state sausage 64 x 500",
                              k11_ms["385-state sausage7 64x500"][0], 28.525)):
        phase("timing", f"{name}: {ms:.3f} ms against {before:.3f} ms before its last "
                        f"redesign on the same card model = {ms / before:.3f} of it ({card})")
    phase("timing", f"K7 dense [L, L] LM on the 1k trie at 128x{TL}: {k7_dense_ms:.3f} ms; "
                    f"dict1-shaped trie at 16x{TL}: K6 {k6_dict_ms:.3f} ms, K7 (backoff, "
                    f"K={lm_ldd[3][1].shape[1]}) {k7_dict_ms:.3f} ms (CUDA-event median; {card})")
    phase("timing", f"pipeline 256 x 5 s wav -> word ids (K3 + K1 + K2 + "
                    f"states_to_words_device): {pipe_ms:.3f} ms "
                    f"= {256 * 5 / (pipe_ms / 1e3):.0f} audio-s/s (CUDA-event median; {card})")
    phase("timing", f"lex pipeline 128 x 5 s wav -> paths over the 1k trie (K3 + "
                    f"bank_nll_ubt + K4 + argmin + K5): {lex_ms:.3f} ms "
                    f"= {128 * 5 / (lex_ms / 1e3):.0f} audio-s/s (CUDA-event median; {card}); "
                    f"+ host words {words_ms:.1f} ms wall for "
                    f"{sum(map(len, lex_words))} words")
    phase("timing", f"bigram pipeline 128 x 5 s wav -> words over the 1k trie (K3 + "
                    f"bank_nll_ubt + K6 + K7 with q, the truncation count and the walk): "
                    f"{big_ms:.3f} ms = {128 * 5 / (big_ms / 1e3):.0f} audio-s/s "
                    f"(CUDA-event median; {card}); + host words {big_words_ms:.1f} ms "
                    f"wall for {sum(map(len, big_words))} words")
    phase("timing", "bigram pipeline stages alone: " + ", ".join(
        f"{k} {ms:.3f} ms" for k, ms in stage_ms.items()) + "; the launches the last "
        "replaced, each alone: " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in replaced_ms.items())
        + f"; K7 device {k7p_dev:.4f} ms; the plain walk {k22_p_plain:.3f} ms "
        f"(CUDA-event medians, torch.profiler; {card})")

    # K15 at the confidence decode's shape (256 x 500 on the 385-state
    # sausage), K16 at the soft-EM path's own call (419 x 319 transcripts),
    # each beside its plain version; device times; then the K15 / K16
    # crossover on padded transcript graphs of 30-400 states at 256 x 300
    k15_args = (nll15, bg7, nf15)
    t["K15"] = (cuda_ms(lambda: fbk.fb_banded(*k15_args)),
                cuda_ms(lambda: fbk.fb_banded_ref(*k15_args), reps=1))
    t["K16"] = (cuda_ms(lambda: fbk.fb_dense(*k16_train[0], **k16_train[1])),
                cuda_ms(lambda: fbk.fb_dense_ref(*k16_train[0], **k16_train[1]), reps=1))
    fb_dev = {"K15": device_ms(lambda: fbk.fb_banded(*k15_args), what="K15"),
              "K16": device_ms(lambda: fbk.fb_dense(*k16_train[0], **k16_train[1]),
                               what="K16")}
    k16_synth = fb16_cases[f"{B16} padded transcript graphs {B16}x{T16}"]
    k16_synth_ms = cuda_ms(lambda: fbk.fb_dense(*k16_synth, xi_mode="band"))
    k15_tr_ms = cuda_ms(lambda: fbk.fb_banded(nll16, g15t, nf16, depth_b, end15t))
    # the sweep: 256 padded transcript graphs of n words each, all 300
    # frames, with optional silence arcs (model 10 standing in for the
    # silence model, as continuous_train composes them for a bank that has
    # one) and without; the constant is set from the first
    from speech_recognition_tpu_torch.models.graph import BANDED_FB_MIN_STATES

    sweeps = {}
    for kind, sil_, n_ws in (("with silence", 10, (2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 40)),
                             ("without silence", None, (6, 8, 10, 12, 16, 24, 32, 48, 64, 80))):
        sweeps[kind] = []
        for n_w in n_ws:
            gs_ = [transcript_graph(trans, [int(x) for x in fb_rng.integers(0, 10, n_w)],
                                    sil=sil_) for _ in range(256)]
            gd_, dd_ = pad_graphs(gs_)
            gdt = [torch.as_tensor(gd_[k], device=dev) for k in ("trans", "init_cost")]
            eps_, end_ = (torch.as_tensor(gd_[k], device=dev) for k in ("eps_trans",
                                                                        "end_scores"))
            gb_, db_ = pad_graphs_banded(gs_)
            gbt = BandedGraph(*[torch.as_tensor(gb_[k], device=dev) for k in (
                "band", "init_cost", "word_starts", "word_ends", "eps_block", "start_pos",
                "is_start")], end_states=None, end_bonus=None, bank_state=None)
            s_ = gdt[0].shape[1]
            x_ = torch.from_numpy(fb_rng.uniform(40, 60, (256, 300, s_)).astype(
                np.float32)).to(dev)
            n_ = torch.full((256,), 300, dtype=torch.int32, device=dev)
            sweeps[kind].append((s_, cuda_ms(lambda: fbk.fb_dense(x_, *gdt, n_, eps_, dd_, end_,
                                                                  "band"), reps=3),
                                 cuda_ms(lambda: fbk.fb_banded(x_, gbt, n_, db_, end_), reps=3)))
        sweep = sweeps[kind]
        cross_s = next((s_ for i, (s_, _, _) in enumerate(sweep)
                        if all(k15 < k16 for _, k16, k15 in sweep[i:])), None)
        fb_line = "; ".join(f"S={s_}: K16 {k16:.3f}, K15 {k15:.3f}" for s_, k16, k15 in sweep)
        phase("timing", f"K15 / K16 crossover on padded transcript graphs {kind} at 256x300 "
                        f"(ms): {fb_line}; K15 is faster from S={cross_s} on; "
                        f"BANDED_FB_MIN_STATES = {BANDED_FB_MIN_STATES} (CUDA-event medians of "
                        f"3; {card})")
    phase("timing", f"K15 385-state sausage7 {B15}x{T15}: {t['K15'][0]:.3f} ms event, "
                    f"{fb_dev['K15']:.3f} ms device, plain {t['K15'][1]:.3f} ms; K15 on the "
                    f"{B16} transcripts' banded dict {k15_tr_ms:.3f} ms; K16 at the soft-EM "
                    f"path's call {tuple(k16_train[0][0].shape)}: {t['K16'][0]:.3f} ms event, "
                    f"{fb_dev['K16']:.3f} ms device, plain {t['K16'][1]:.3f} ms; K16 on the "
                    f"synthetic {B16}x{T16} transcripts {k16_synth_ms:.3f} ms (CUDA-event "
                    f"median; {card})")

    # ---- 7b. streaming: the chunk kernels per push, the push API ------------
    # K17 on the second 64-frame chunk of the 256 x 500 planted stream over
    # the CLI's loop graph (carried frontier, no first-frame seed), K18 on
    # the second chunk of the 128 x 500 planted-word emissions over the 1k
    # trie; then whole streams through StreamingDecoder.push / finish
    nv_c = (nf_s - CH).clamp(0, CH).to(torch.int32)
    fr_c = vk.viterbi_banded_chunk((xa_s[:, :CH].contiguous(), w, lw), bgl, topol, init_l,
                                   nf_s.clamp(max=CH), True, False, "fused")[0]
    xa_c = xa_s[:, CH:2 * CH].contiguous()
    nll_c = vk.bank_emission(xa_c, w, lw)
    k17_args = ((xa_c, w, lw), bgl, topol, fr_c, nv_c, False, False, "fused")
    k17_org_args = k17_args[:6] + (True, "fused")
    t["K17"] = (cuda_ms(lambda: vk.viterbi_banded_chunk(*k17_args)),
                cuda_ms(lambda: vk.viterbi_banded_chunk_ref(*k17_args), reps=3))
    k17_org_ms = cuda_ms(lambda: vk.viterbi_banded_chunk(*k17_org_args))

    def k17_dp():
        return vk._banded_forward(nll_c, bgl, nv_c, 1, "fused_chunk", vk.viterbi_banded_chunk,
                                  frontier=fr_c, topo=topol)

    k17_dp_ms = cuda_ms(k17_dp)
    # K13 + the DP behind a sleep kernel: the pair's device time from
    # events (the profiler's window of the pair has lost a launch in every
    # run so far), and the DP's alone
    k17_q = queued_ms(lambda: vk.viterbi_banded_chunk(*k17_args))
    k17_dp_q = queued_ms(k17_dp)
    init_t = g1k.init_cost[None].expand(BL, -1).contiguous()
    fr_t = lk.viterbi_lex_chunk(nll_p[:, :CH].contiguous(), g1k, topo1k_, init_t,
                                nf_p.clamp(max=CH).to(torch.int32), True, False)[0]
    nll_pc = nll_p[:, CH:2 * CH].contiguous()
    nv_t = (nf_p - CH).clamp(0, CH).to(torch.int32)
    k18_args = (nll_pc, g1k, topo1k_, fr_t, nv_t, False, False)
    t["K18"] = (cuda_ms(lambda: lk.viterbi_lex_chunk(*k18_args)),
                cuda_ms(lambda: lk.viterbi_lex_chunk_ref(*k18_args), reps=3))
    k18_org_ms = cuda_ms(lambda: lk.viterbi_lex_chunk(*k18_args[:6], True))
    dev_ms.update({k: device_ms(fn, what=k) for k, fn in (
        ("K17", lambda: vk.viterbi_banded_chunk(*k17_args)),
        ("K13 on a chunk", lambda: vk.bank_emission(xa_c, w, lw)),
        ("K17 DP", k17_dp),
        ("K18", lambda: lk.viterbi_lex_chunk(*k18_args)))})
    k18_q = queued_ms(lambda: lk.viterbi_lex_chunk(*k18_args))
    sp = STREAM_PARENT
    phase("timing", f"K17 per push (K13 + the DP's uniform chunk mode) on the CLI loop graph "
                    f"({bgl.n_states} states) at {BS} streams x {CH} frames: "
                    f"{t['K17'][0]:.3f} ms event (parent {sp['K17']:.3f}), {k17_q:.4f} ms device "
                    f"from queued events ({dev_ms['K17']:.3f} from the profiler); with the "
                    f"ancestor map {k17_org_ms:.3f}; the DP alone {k17_dp_ms:.3f} ms event "
                    f"(parent {sp['K17 DP']:.3f}), {dev_ms['K17 DP']:.4f} ms device (parent "
                    f"{sp['K17 DP device']:.3f}), {k17_dp_q:.4f} queued; K13 on the chunk "
                    f"alone device {dev_ms['K13 on a chunk']:.4f}; plain {t['K17'][1]:.3f} ms "
                    f"({card}; parent: PERF.md's earlier figures)")
    phase("timing", f"K18 per push on the 1k trie ({g1k.n_states} states) at {BL} x {CH} "
                    f"planted-word emissions: {t['K18'][0]:.3f} ms event (parent "
                    f"{sp['K18']:.3f}), {dev_ms['K18']:.4f} ms device (parent "
                    f"{sp['K18 device']:.3f}), {k18_q:.4f} queued; with the ancestor map "
                    f"{k18_org_ms:.3f}; plain {t['K18'][1]:.3f} ms ({card})")

    def stream_rates(name, bank_, graph_, feats_, nf_, mono):
        """Event ms of a whole stream's pushes, of its finish and of the
        monolithic decode at the same shape, device ms and idle share of
        the pushes, and flush attempts in incremental mode."""
        b_, t_len = feats_.shape[0], feats_.shape[1]
        nf_np = nf_.cpu().numpy()

        def pushes(dec_, incremental):
            for t0 in range(0, t_len, CH):
                nv = (np.full(b_, min(CH, t_len - t0), np.int32) if incremental
                      else np.clip(nf_np - t0, 0, CH).astype(np.int32))
                dec_.push(feats_[:, t0:t0 + CH], n_valid=nv)
            return dec_

        def new(incremental):
            return StreamingDecoder(bank_, graph_, chunk_frames=CH, batch=b_,
                                    emit_incremental=incremental, window_chunks=4)

        n_push = -(-t_len // CH)
        dec_n = new(False)  # built once: the graph's tables are set-up, not a push

        def run_pushes():
            dec_n.reset()
            return pushes(dec_n, False)

        push_ms = cuda_ms(run_pushes, reps=3)
        push_dev = device_ms(run_pushes, reps=2, what=f"the pushes of a {name} stream")
        # one stream of pushes per reading: the decoder's pinned n_valid
        # slots then never wait on a copy queued behind the sleep
        push_q = queued_ms(run_pushes, reps=1)
        run_pushes()
        fin_ms = cuda_ms(dec_n.finish, reps=3)
        whole_ms = cuda_ms(lambda: run_pushes().finish(), reps=3)
        mono_ms = cuda_ms(mono, reps=3)
        flushes = []
        dec_i = new(True)
        orig = dec_i._try_flush

        def timed_flush():
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            out = orig()
            torch.cuda.synchronize()
            flushes.append(((time.perf_counter() - t0_) * 1e3, dec_i._flushed))
            return out

        dec_i._try_flush = timed_flush
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        pushes(dec_i, True)
        res_i = dec_i.finish()
        inc_ms = (time.perf_counter() - t0_) * 1e3
        audio_s = float(nf_.sum()) / 100.0
        flush_ms = [f_[0] for f_ in flushes]
        phase("timing", f"stream {name} ({b_} x {t_len} frames, {n_push} pushes of {CH}): "
                        f"pushes {push_ms:.3f} ms event ({push_ms / n_push:.3f} a push), "
                        f"device {push_dev:.3f} ms (kernels, profiler), idle share "
                        f"{1 - push_dev / push_ms:.3f}; device with launch gaps {push_q:.3f} "
                        f"ms (queued events, {push_q / n_push:.3f} a push), idle share "
                        f"{1 - push_q / push_ms:.3f}; "
                        f"finish {fin_ms:.3f} ms; pushes + finish {whole_ms:.3f} ms = "
                        f"{audio_s / whole_ms * 1e3:,.0f} audio-s/s ({audio_s:.1f} s of audio); "
                        f"the monolithic decode {mono_ms:.3f} ms "
                        f"({whole_ms / mono_ms:.2f}x) ({card})")
        phase("timing", f"stream {name}, incremental (window 4, a flush try every 2 pushes): "
                        f"{inc_ms:.1f} ms host clock for the pushes and finish; {len(flushes)} "
                        f"flush attempts, {statistics.median(flush_ms) if flush_ms else 0:.3f} "
                        f"ms median (max {max(flush_ms) if flush_ms else 0:.3f}), "
                        f"{dec_i._flushed} of {t_len} frames flushed mid-stream; "
                        f"{sum(map(len, dec_i._emitted))} words in all ({card})")
        return {"push_ms": push_ms, "push_dev": push_dev, "push_q": push_q, "finish_ms": fin_ms,
                "whole_ms": whole_ms, "mono_ms": mono_ms, "flush_ms": flush_ms,
                "audio_s": audio_s, "res_i": res_i}

    sr = stream_rates("loop", bank, cli_loop, feats_s, nf_s,
                      lambda: _decode_banded_batch(bank, feats_s, nf_s, bgl, topo=topol))
    n_push = -(-T // CH)
    phase("timing", f"stream loop against the parent (PERF.md's earlier figures): a push "
                    f"{sr['push_ms'] / n_push:.3f} ms event (parent {sp['push']:.3f}), idle "
                    f"share {1 - sr['push_dev'] / sr['push_ms']:.3f} (parent {sp['idle']:.3f}); "
                    f"pushes + finish {sr['audio_s'] / sr['whole_ms'] * 1e3:,.0f} audio-s/s "
                    f"(parent {sp['rate']:,}) ({card})")
    units_l = [[ord(ch) - ord("a") for ch in wd] for wd in lexp.words]
    feats_l, nf_l = planted_features(lbank, BL, T, np.random.default_rng(23), units=units_l,
                                     dwell=(2, 4))
    stream_rates("lextree", lbank, lexp, feats_l, nf_l,
                 lambda: _decode_lex_batch(lbank, feats_l, nf_l, gp, topop))

    # ---- 7c. the beams, the spell checker and the native IO -------------------
    # The rank-threshold forward (viterbi_banded_tb(beam_width=)) is plain
    # tensor ops on the card, as in the JAX package, and K9 backtraces its
    # planes, on the trie in its cross mode; the token beam (ops.beam) is K19
    # (its frame loop) and K26 (its walk).  Each path runs with the counters
    # reset just before it.
    from speech_recognition_tpu_torch.data.wav import load_wav_batch as scipy_load
    from speech_recognition_tpu_torch.decode.connected import _decode_banded_batch
    from speech_recognition_tpu_torch.decode.lextree import beam_decode_lextree, decode_lextree
    from speech_recognition_tpu_torch.langmodel.lextree import lextree_from_words
    from speech_recognition_tpu_torch.langmodel.spellcheck import SpellChecker, text_viterbi_batch
    from speech_recognition_tpu_torch.models.hmm import bank_nll_ubt
    from speech_recognition_tpu_torch.decode import lextree as lexdec
    from speech_recognition_tpu_torch.ops import beam_kernels as bk
    from speech_recognition_tpu_torch.ops.beam import (
        beam_backtrace,
        beam_backtrace_ref,
        beam_search,
        beam_search_ref,
        beam_tables,
    )
    from speech_recognition_tpu_torch.ops.viterbi_banded import (
        _CROSS,
        banded_backtrace_tb,
        viterbi_banded_tb,
    )
    from speech_recognition_tpu_torch.runtime.loader import load_wav_batch as native_load

    cpu = torch.device("cpu")
    beam_ms = {}  # the stage times printed at the section's end

    def on(bank_, where):
        """A copy of a bank on ``where`` (a module's ``to`` moves it in place)."""
        return copy.deepcopy(bank_).to(where)

    no_exact = (vk.viterbi_banded_fused, vk.banded_backtrace_val, vk.viterbi_banded_general,
                lk.viterbi_lex, lk.lex_backtrace_val)

    def same(a, b_):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b_))

    def ends_of(g_, final_):
        return g_.end_states[torch.argmin(final_[g_.end_states] + g_.end_bonus[:, None], 0)]

    def beam_planes(name, bank_, g_, f_, n_, depth, ks):
        """The pruned forward at each k on cuda == cpu (final, bp8, eps_u);
        K9 on its planes == the plain backtrace.  Returns the graph
        emissions [T, S, B], the bank emissions [U, T, B] and the planes of
        the first k."""
        nll_ = bank_nll_ubt(bank_, f_, n_)
        tb_ = nll_.permute(1, 0, 2)[:, g_.bank_state, :]
        first = None
        for k in ks:
            got = viterbi_banded_tb(tb_, g_, n_, depth, beam_width=k)
            want = viterbi_banded_tb(tb_.cpu(), g_.to(cpu), n_.cpu(), depth, beam_width=k)
            if not same(got, want):
                fail(f"the beam forward on {name} at k={k}: cuda differs from cpu")
            ends = ends_of(g_, got[0])
            sk, fk = vk.banded_backtrace_general(got[1], got[2], g_, ends, n_, depth)
            sp, fp = banded_backtrace_tb(got[1], got[2], g_, ends, n_, depth)
            torch.cuda.synchronize()
            if not (torch.equal(sk, sp) and torch.equal(fk, fp)):
                fail(f"K9 on the beam planes of {name} at k={k} differs from its plain version")
            first = first or (got, ends, sp, fp)
        return tb_, nll_, first

    # (a) word graphs: the CLI's loop graph (exact route K1 + K2) and the
    # 1-state sausage (K8 + K9), 64 x 500 planted features, k = 8 and S
    BB = 64
    word_runs = {}
    for name, bank_, graph_ in (("CLI loop", on(bank, dev), cli_loop),
                                ("1-state sausage7", on(bank1, dev), g1s)):
        f_, n_ = planted_features(bank_, BB, T, np.random.default_rng(31))
        g_ = banded_arrays(graph_, device=dev)
        topo_ = vk.banded_topology(g_)
        s_ = g_.n_states
        tb_, nll_, _ = beam_planes(name, bank_, g_, f_, n_, graph_.eps_depth, (8, s_))
        w_x, c_x = decode_connected(bank_, graph_, f_, n_)
        w_f, c_f = decode_connected(bank_, graph_, f_, n_, beam_width=s_)
        if w_f != w_x or not np.allclose(c_f, c_x, rtol=K1_RTOL, atol=0.0):
            fail(f"decode_connected(beam_width=S) on {name}: other words or costs than the "
                 f"exact route")
        if graph_ is cli_loop:
            exact_fwd = (lambda b_=bank_, f=f_, n=n_, g=g_, tp=topo_:
                         vk.fused_forward(b_, f, n, g, tp))
        else:
            exact_fwd = (lambda x=nll_, g=g_, tp=topo_, n=n_, d=graph_.eps_depth:
                         vk.viterbi_banded_general(x, g, tp, n, d))
        word_runs[name] = (bank_, graph_, f_, n_)
        beam_ms[name] = {
            "beam forward k=8": cuda_ms(lambda x=tb_, g=g_, n=n_, d=graph_.eps_depth:
                                        viterbi_banded_tb(x, g, n, d, beam_width=8), reps=3),
            "exact forward": cuda_ms(exact_fwd, reps=3),
            "beam route k=8": cuda_ms(lambda b_=bank_, f=f_, n=n_, g=g_, d=graph_.eps_depth:
                                      _decode_banded_batch(b_, f, n, g, d, beam_width=8),
                                      reps=3),
            "exact route": cuda_ms(lambda b_=bank_, f=f_, n=n_, g=g_, d=graph_.eps_depth,
                                   tp=topo_: _decode_banded_batch(b_, f, n, g, d, topo=tp),
                                   reps=3)}
        phase("beam", f"{name} ({s_} states) at {BB}x{T}, planted: the beam forward at k = 8 "
                      f"and k = S on cuda == cpu (final, bp8, eps_u); K9 on the beam planes "
                      f"== plain; at k = S the words == the exact route's, costs within rtol "
                      f"1e-5 (max |d| {float(np.abs(c_f - c_x).max()):.3g})")
    counted("beam connected", lambda: [decode_connected(b_, g_, f_, n_, beam_width=16)
                                       for b_, g_, f_, n_ in word_runs.values()],
            (vk.banded_backtrace_general,), no_exact)

    # the pipeline: wav -> K3 -> decode_connected(beam_width=16), 64 x 5 s
    pipe_dir = os.path.join(tmp, "beam_wavs")
    os.makedirs(pipe_dir)
    for u in SyntheticDigits(seed=3).continuous_corpus(BB, tag="beam"):
        write_wav(os.path.join(pipe_dir, u.name), u.samples)
    pipe_files = sorted(glob.glob(os.path.join(pipe_dir, "*.wav")))

    def beam_pipeline(device, bank_):
        f_, n_ = cli._featurize_files(pipe_files, FrontendConfig(), 80000, device)
        return decode_connected(bank_, cli_loop, f_[:, : int(n_.max())].contiguous(), n_,
                                beam_width=16)

    w_pg, c_pg = counted("beam pipeline", lambda: beam_pipeline(dev, bank),
                         (*k3, vk.banded_backtrace_general), no_exact)
    w_pc, c_pc = beam_pipeline(cpu, on(bank, cpu))
    if w_pg != w_pc:
        fail("wav -> K3 -> decode_connected(beam_width=16): cuda words differ from cpu")
    beam_ms["pipeline"] = cuda_ms(lambda: beam_pipeline(dev, bank), reps=3)
    phase("beam", f"wav -> K3 -> decode_connected(beam_width=16) on {BB} wavs (5 s cap): "
                  f"words == --device cpu; costs max rel |d| "
                  f"{float(np.abs(c_pg - c_pc).max() / np.abs(c_pc).max()):.3g} (K3 vs the "
                  f"plain frontend)")

    # (b) the 1k trie (bench_lex_pipeline's bank and trie), 32 x 500 planted
    f_t, n_t = feats_l[:32].contiguous(), nf_l[:32].contiguous()
    s_t = gp.n_states
    tb_t, nll_t, (bt_planes, bt_ends, sp64, fp64) = beam_planes(
        "1k trie", lbank, gp, f_t, n_t, lexp.eps_depth, (64, s_t))
    fin0, bp0, eu0 = viterbi_banded_tb(tb_t, gp, n_t, lexp.eps_depth)
    ends0 = ends_of(gp, fin0)
    sk, fk = vk.banded_backtrace_general(bp0, eu0, gp, ends0, n_t, lexp.eps_depth)
    sp, fp = banded_backtrace_tb(bp0, eu0, gp, ends0, n_t, lexp.eps_depth)
    torch.cuda.synchronize()
    if not (torch.equal(sk, sp) and torch.equal(fk, fp)):
        fail("K9 (cross mode) on the 1k trie's exact planes differs from its plain version")
    tt_ = torch.arange(1, T, device=dev)[:, None]
    n_cross = int(((bp0[tt_, sp[1:].long(), torch.arange(32, device=dev)[None]] == _CROSS)
                   & (tt_ < n_t[None])).sum())
    w_lex, c_lex = decode_lextree(lbank, lexp, f_t, n_t)
    w_lb, c_lb = decode_lextree(lbank, lexp, f_t, n_t, beam_width=s_t)
    if w_lb != w_lex or not np.array_equal(c_lb, c_lex):
        fail("decode_lextree(beam_width=S) on the 1k trie: other words or costs than K4 + K5")
    counted("lextree beam", lambda: decode_lextree(lbank, lexp, f_t, n_t, beam_width=64),
            (vk.banded_backtrace_general,), no_exact)
    # K9's work on the k = 64 planes: a code per frame below nf, an eps_u,
    # start_pos and word_ends entry and a code per unwind, a cross_src entry
    # per cross step
    cross64 = int(((bt_planes[1][tt_, sp64[1:].long(), torch.arange(32, device=dev)[None]]
                    == _CROSS) & (tt_ < n_t[None])).sum())
    k9x_work = (int(n_t.clamp(max=T).sum()) + int(fp64.sum()) * (bt_planes[2].element_size() + 9)
                + cross64 * 8 + T * 32 * 5 + nbytes(bt_ends, n_t),
                4.0 * (int(n_t.clamp(max=T).sum()) + int(fp64.sum())))
    k9x = (bt_planes[1], bt_planes[2], gp, bt_ends, n_t, 1)
    k9x_ms = cuda_ms(lambda: vk.banded_backtrace_general(*k9x))
    k9x_plain = cuda_ms(lambda: banded_backtrace_tb(*k9x), reps=3)
    beam_ms["1k trie"] = {
        "beam forward k=64": cuda_ms(lambda: viterbi_banded_tb(tb_t, gp, n_t, 1, beam_width=64),
                                     reps=3),
        "exact forward (K4)": cuda_ms(lambda: lk.viterbi_lex(nll_t, gp, topop, n_t), reps=3),
        "beam route k=64": cuda_ms(lambda: decode_lextree(lbank, lexp, f_t, n_t,
                                                          beam_width=64), reps=3),
        "exact route (K4 + K5)": cuda_ms(lambda: decode_lextree(lbank, lexp, f_t, n_t),
                                         reps=3)}
    phase("beam", f"1k trie ({s_t} states) at 32x{T}, planted: the beam forward at k = 64 and "
                  f"k = S on cuda == cpu; K9 (cross mode) == plain on the beam planes and on "
                  f"the exact planes ({n_cross} cross steps on the best paths); at k = S "
                  f"words and costs == decode_lextree's (K4 + K5)")

    # (c) the token beam on the same batch: K19 (the frame loop) and K26 (the
    # walk) against their plain versions on the card's own tensors at k = 64,
    # with and without the bigram; at k = S (the device tier) the route's
    # words and costs == K4 + K5; a dict1-shaped case on the device tier
    tb_k = beam_tables(lexp.banded, leaf_word=lexp.leaf_word, device=dev)
    r_k, l_k = tb_k.eps_block.shape
    u_k = nll_t.shape[0]
    pack_k = bk.beam_pack(tb_k)
    plans_k = [bk.beam_plan(s_t, k_, bk.beam_widest(pack_k, k_, tb_k.init_states.shape[0]),
                            r_k, l_k, u_k) for k_ in (64, s_t)]
    if [p_.tier for p_ in plans_k] != ["shared", "device"]:
        fail(f"beam_plan on the 1k trie: k = 64 and k = S should take the shared and the "
             f"device tier, got {plans_k}")
    w_tk, c_tk = counted("token beam k=S", lambda: beam_decode_lextree(lbank, lexp, f_t, n_t,
                                                                         s_t),
                         (beam_search, beam_backtrace), no_exact)
    if w_tk != w_lex or not np.array_equal(c_tk, c_lex):
        fail("the token beam at k = S on the 1k trie: other words or costs than K4 + K5")
    lm_t = fit_bigram([[int(x) for x in np.random.default_rng(41).integers(0, len(lexp.words),
                                                                           12)]
                       for _ in range(200)], len(lexp.words))
    big = torch.from_numpy(np.concatenate([np.asarray(lm_t.cost, np.float32),
                                           np.asarray(lm_t.start_cost, np.float32)[None]]))
    big_end = torch.from_numpy(np.asarray(lm_t.end_cost, np.float32))
    nll_bt = nll_t.permute(2, 1, 0).contiguous()  # [B, T, U]
    k19_runs, k19_err, k19_found = {}, 0.0, {}
    for lm_on in (False, True):
        bc, be = (big.to(dev), big_end.to(dev)) if lm_on else (None, None)
        got = beam_search(nll_bt, tb_k, n_t, 64, bigram_cost=bc)
        walk = beam_backtrace(got[0], got[1], got[4], got[5], tb_k, n_t, final_pred=got[2],
                              bigram_cost=bc, bigram_end=be)
        want = beam_search_ref(nll_bt, tb_k, n_t, 64, bigram_cost=bc)
        want_walk = beam_backtrace_ref(want[0], want[1], want[4], want[5], tb_k, n_t,
                                       final_pred=want[2], bigram_cost=bc, bigram_end=be)
        torch.cuda.synchronize()
        tag = f"K19 / K26 on the 1k trie at k = 64 ({'with' if lm_on else 'without'} the bigram)"
        k19_found[lm_on] = token_beam_agrees(tag, got, want, walk, want_walk)
        k19_err = max(k19_err, float((walk[0] - want_walk[0]).abs().max()))
        k19_runs[lm_on] = (got, bc)
    # the dictionary-shaped trie (86,520 states): the device tier at k = 64
    tb_d = beam_tables(lexd.banded, leaf_word=lexd.leaf_word, device=dev)
    plan_d = bk.beam_plan(tb_d.n_states, 64, bk.beam_widest(bk.beam_pack(tb_d), 64,
                                                             tb_d.init_states.shape[0]),
                          *tb_d.eps_block.shape, nlld.shape[0])
    if plan_d.tier != "device":
        fail(f"beam_plan on the dict1-shaped trie at k = 64: {plan_d}")
    nll_dt = nlld.permute(2, 1, 0).contiguous()  # [32, TL, U]
    got_d = beam_search(nll_dt, tb_d, nfd, 64)
    walk_d = beam_backtrace(got_d[0], got_d[1], got_d[4], got_d[5], tb_d, nfd)
    want_d = beam_search_ref(nll_dt, tb_d, nfd, 64)
    want_walk_d = beam_backtrace_ref(want_d[0], want_d[1], want_d[4], want_d[5], tb_d, nfd)
    torch.cuda.synchronize()
    found_d = token_beam_agrees("K19 / K26 on the dict1-shaped trie at k = 64", got_d, want_d,
                                walk_d, want_walk_d)
    report["K19"] = {"max_abs_err": k19_err}
    report["K26"] = {"max_abs_err": k19_err}
    w_t64, _ = counted("token beam", lambda: beam_decode_lextree(lbank, lexp, f_t, n_t, 64),
                       (beam_search, beam_backtrace), no_exact + (vk.banded_backtrace_general,))
    counted("token beam bigram", lambda: beam_decode_lextree(lbank, lexp, f_t, n_t, 64,
                                                             lm=lm_t),
            (beam_search, beam_backtrace), no_exact + (vk.banded_backtrace_general,))
    for path in ("token beam", "token beam bigram", "token beam k=S"):
        if (launches[path]["beam_search"], launches[path]["beam_backtrace"]) != (1, 1):
            fail(f"the {path} path is not one K19 and one K26 launch: {launches[path]}")

    @contextlib.contextmanager
    def plain_token_beam():
        """The route with the plain versions in place of the gates."""
        saved = (lexdec.beam_search, lexdec.beam_backtrace)
        lexdec.beam_search, lexdec.beam_backtrace = beam_search_ref, beam_backtrace_ref
        try:
            yield
        finally:
            lexdec.beam_search, lexdec.beam_backtrace = saved

    with plain_token_beam():
        plain_route = {lm_on: cuda_ms(lambda lm_=(lm_t if lm_on else None):
                                      beam_decode_lextree(lbank, lexp, f_t, n_t, 64, lm=lm_),
                                      reps=1)
                       for lm_on in (False, True)}
    got64 = k19_runs[False][0]
    t["K19"] = (cuda_ms(lambda: beam_search(nll_bt, tb_k, n_t, 64), reps=10),
                cuda_ms(lambda: beam_search_ref(nll_bt, tb_k, n_t, 64), reps=1))
    t["K26"] = (cuda_ms(lambda: beam_backtrace(got64[0], got64[1], got64[4], got64[5], tb_k,
                                               n_t), reps=20),
                cuda_ms(lambda: beam_backtrace_ref(got64[0], got64[1], got64[4], got64[5],
                                                   tb_k, n_t), reps=3))
    k19_big_ms = cuda_ms(lambda: beam_search(nll_bt, tb_k, n_t, 64,
                                             bigram_cost=k19_runs[True][1]), reps=10)
    k19_s_ms = cuda_ms(lambda: beam_search(nll_bt, tb_k, n_t, s_t), reps=1)
    k19_d_ms = cuda_ms(lambda: beam_search(nll_dt, tb_d, nfd, 64), reps=3)
    k19_dev = device_ms(lambda: beam_search(nll_bt, tb_k, n_t, 64), what="K19")
    k26_dev = device_ms(lambda: beam_backtrace(got64[0], got64[1], got64[4], got64[5], tb_k,
                                               n_t), what="K26")
    # the survivors a frame, from the kernel's counter on the k = 64 run
    k19_stats = torch.zeros((32, bk.STATS), dtype=torch.int64, device=dev)
    bk.launch_search(nll_bt, tb_k, n_t, 64, True, None, stats=k19_stats)
    k19_stats = k19_stats.cpu()
    n_fr = float(k19_stats[:, 0].sum())
    m_mean = float(k19_stats[:, 1].sum()) / n_fr
    m_max = int(k19_stats[:, 2].max())
    k19_phases = {ph: float(k19_stats[:, 3 + i].sum()) / n_fr for i, ph in enumerate(bk.PHASES)}
    frames_k = int(n_t.clamp(min=1, max=T).max())
    k19_work = token_beam_work(got64[3], tb_k, n_t, u_k)
    k19_big_work = token_beam_work(k19_runs[True][0][3], tb_k, n_t, u_k,
                                   bigram_cost=k19_runs[True][1])
    k19_d_work = token_beam_work(got_d[3], tb_d, nfd, nll_dt.shape[2])
    k26_work = token_walk_work(n_t, T, 64)
    beam_ms["token beam"] = {
        "k=64 route (K19 + K26)": cuda_ms(lambda: beam_decode_lextree(lbank, lexp, f_t, n_t,
                                                                      64), reps=5),
        "k=64 route, plain": plain_route[False],
        "k=64 with the bigram (K19 + K26)": cuda_ms(lambda: beam_decode_lextree(
            lbank, lexp, f_t, n_t, 64, lm=lm_t), reps=5),
        "k=64 with the bigram, plain": plain_route[True],
        "k=S (device tier)": cuda_ms(lambda: beam_decode_lextree(lbank, lexp, f_t, n_t, s_t),
                                     reps=1),
        "exact K4 + K5": beam_ms["1k trie"]["exact route (K4 + K5)"]}
    agree = sum(a == b_ for a, b_ in zip(w_t64, w_lex))
    phase("beam", f"token beam on the 1k trie at 32x{T}: at k = S ({s_t}, the device tier) "
                  f"words and costs == K4 + K5; at k = 64, without and with a bigram, K19 and "
                  f"K26 == beam_search_ref / beam_backtrace_ref on every live slot, the final "
                  f"frontier, costs and words ({k19_found[False]} and {k19_found[True]} of 32 "
                  f"streams end in a word); the dict1-shaped trie ({tb_d.n_states} states, "
                  f"device tier) at k = 64 likewise ({found_d} of 32); k = 64 decodes {agree} "
                  f"of 32 streams as the exact decode")
    phase("timing", f"K19 on the 1k trie 32x{T} (shared tier, {plans_k[0].threads} threads): "
                    f"k = 64 {t['K19'][0]:.3f} ms event, {k19_dev:.4f} ms device "
                    f"({k19_dev / frames_k * 1e3:.3f} us a frame over {frames_k} frames; plain "
                    f"{t['K19'][1]:.1f} ms), with the bigram {k19_big_ms:.3f} ms, k = S (device "
                    f"tier, {plans_k[1].threads} threads) {k19_s_ms:.1f} ms; the dict1-shaped "
                    f"trie 32x{TL} k = 64 (device tier) {k19_d_ms:.3f} ms; survivors a frame "
                    f"(the kernel's counter, k = 64): mean {m_mean:.1f}, most {m_max}; cycles a "
                    f"frame by phase (its clock64 trace): "
                    f"{', '.join(f'{k_} {v_:.0f}' for k_, v_ in k19_phases.items())}; K26 "
                    f"({bk.walk_plan(64, T).form} form) {t['K26'][0]:.4f} ms event, "
                    f"{k26_dev:.4f} ms device (plain {t['K26'][1]:.2f} ms) ({card})")
    # the route by stage: the tables (cached a graph and device), the bank
    # emissions, K19, K26 and the host's word lists
    nll_rt = bank_nll_ubt(lbank, f_t, n_t).permute(2, 1, 0)
    res_rt = beam_search(nll_rt, tb_k, n_t, 64)
    walk_rt = beam_backtrace(res_rt[0], res_rt[1], res_rt[4], res_rt[5], tb_k, n_t,
                             final_pred=res_rt[2])
    stages = {
        "beam_tables": cuda_ms(lambda: beam_tables(lexp.banded, leaf_word=lexp.leaf_word,
                                                   device=dev)),
        "bank_nll_ubt": cuda_ms(lambda: bank_nll_ubt(lbank, f_t, n_t)),
        "K19": t["K19"][0],
        "K26": t["K26"][0],
        "word lists": cuda_ms(lambda: (walk_rt[0].cpu(),
                                       lexdec._word_lists(walk_rt[1].cpu().numpy())), reps=10),
        "route event": beam_ms["token beam"]["k=64 route (K19 + K26)"],
        "route device": device_ms(lambda: beam_decode_lextree(lbank, lexp, f_t, n_t, 64),
                                  what="token beam route")}
    phase("timing", f"token beam route, 1k trie 32x{T} k = 64, by stage (ms): "
                    + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in stages.items())
                    + f"; idle share {1 - stages['route device'] / stages['route event']:.3f} "
                      f"({card})")

    # (d) the spell checker: 256 misspellings against the 1,000-word list
    words_sc = list(lexp.words)
    srng = np.random.default_rng(51)
    texts = []
    for _ in range(256):
        s_ = list(" ".join(words_sc[int(i)] for i in srng.integers(0, 1000,
                                                                   int(srng.integers(1, 4)))))
        i_ = int(srng.integers(0, len(s_)))
        op = int(srng.integers(0, 3))
        if op == 0:
            s_[i_] = "abcdefghij"[int(srng.integers(0, 10))]
        elif op == 1:
            del s_[i_]
        else:
            s_.insert(i_, "abcdefghij"[int(srng.integers(0, 10))])
        texts.append("".join(s_).strip() or words_sc[0])
    tree_sc = lextree_from_words(words_sc)
    sc_g = text_viterbi_batch(texts, tree_sc, device=dev)
    t0_ = time.perf_counter()
    sc_c = text_viterbi_batch(texts, tree_sc, device=cpu)
    sc_cpu_ms = (time.perf_counter() - t0_) * 1e3
    if sc_g != sc_c:
        fail("text_viterbi_batch: cuda strings or costs differ from cpu")
    checker_g, checker_c = SpellChecker(device=dev).fit(words_sc), SpellChecker(device=cpu).fit(
        words_sc)
    if [checker_g.spell_check(x) for x in texts[:64]] != [checker_c.spell_check(x)
                                                           for x in texts[:64]]:
        fail("SpellChecker.spell_check: cuda differs from cpu")
    dict_file, text_file = os.path.join(tmp, "dict.txt"), os.path.join(tmp, "text.txt")
    with open(dict_file, "w") as f_:
        f_.write("words\n" + "\n".join(words_sc) + "\n")
    with open(text_file, "w") as f_:
        f_.write("\n".join(texts[:64]) + "\n")
    sc_cmd = ["spellcheck", "-d", dict_file, "-f", text_file, "--device"]
    sc_out = counted("spellcheck", lambda: run_action(sc_cmd + ["cuda"]), (), counters)
    if sc_out != run_action(sc_cmd + ["cpu"]) or len(sc_out.splitlines()) != 64:
        fail("cli spellcheck --device cuda: output differs from --device cpu")
    beam_ms["spellcheck"] = {
        "text_viterbi_batch, 256 strings": cuda_ms(
            lambda: text_viterbi_batch(texts, tree_sc, device=dev), reps=3),
        "the same on the CPU (host clock)": sc_cpu_ms,
        "cli spellcheck, 64 lines": cuda_ms(lambda: run_action(sc_cmd + ["cuda"]), reps=1)}
    phase("spellcheck", f"256 misspellings against the 1,000-word list: text_viterbi_batch "
                        f"strings and costs on cuda == cpu; SpellChecker on 64 == cpu; cli "
                        f"spellcheck --device cuda prints cpu's 64 lines "
                        f"({sum(c == 0 for c, _ in sc_g)} strings at cost 0)")

    # (e) the native loader: 600 wavs, and connected_test through 512-file chunks
    io_dir = os.path.join(tmp, "io_wavs")
    os.makedirs(io_dir)
    for u in SyntheticDigits(seed=4).continuous_corpus(600, tag="io"):
        write_wav(os.path.join(io_dir, u.name), u.samples)
    io_files = sorted(glob.glob(os.path.join(io_dir, "*.wav")))
    t0_ = time.perf_counter()
    nat = native_load(io_files, 120000)
    nat_ms = (time.perf_counter() - t0_) * 1e3
    t0_ = time.perf_counter()
    ref = scipy_load(io_files, 120000)
    scipy_ms = (time.perf_counter() - t0_) * 1e3
    if not all(np.array_equal(a, b_) for a, b_ in zip(nat, ref)):
        fail("the native loader's samples, lengths or rates differ from scipy's")
    io_cmd = ["connected_test", "-i", bank_path, "-d", io_dir, "--device", "cuda"]
    io_chunked = counted("native IO", lambda: run_action(io_cmd),
                         (*k3, vk.bank_emission, vk.viterbi_banded_fused,
                          vk.banded_backtrace_val))
    orig_featurize = cli._featurize_files
    cli._featurize_files = lambda *a, **k: orig_featurize(*a, **{**k, "chunk": 10 ** 9})
    try:
        io_one = run_action(io_cmd)
    finally:
        cli._featurize_files = orig_featurize
    if io_chunked != io_one or len(word_lines(io_chunked)) != 600:
        fail("connected_test over 600 wavs: the 512-file chunks print other lines than one "
             "batch")
    beam_ms["native IO"] = {"native load, 600 wavs": nat_ms, "scipy load, 600 wavs": scipy_ms}
    phase("native IO", f"600 synthetic wavs: the native loader == scipy (samples, lengths, "
                       f"rates); connected_test --device cuda through 512-file chunks prints "
                       f"what one batch prints")
    for stage, v_ in beam_ms.items():
        items = v_.items() if isinstance(v_, dict) else [("ms", v_)]
        phase("timing", f"7c {stage}: " + "; ".join(f"{k_} {ms_:.3f} ms" for k_, ms_ in items)
              + f" ({card})")
    phase("timing", f"7c K9 cross mode on the 1k trie's k = 64 beam planes (32x{T}): "
                    f"{k9x_ms:.4f} ms event, plain {k9x_plain:.3f} ms ({card})")

    # ---- 8. parallel: the sharded paths, one NCCL rank per card ---------------
    launches["parallel"] = parallel_section(dev, tmp, card)

    # ---- 9. bounds ----------------------------------------------------------
    sum_nf = int(nf.clamp(max=T).sum())  # K1 / K2 / K10 streams stop at nf
    sum_nf8 = int(nf8.clamp(max=T).sum())
    unwinds1 = gen_planes["1-state sausage7"][-1]  # eps flags on the best paths
    unwinds6 = gen_planes["3-6-state sausage7"][-1]
    nfr3 = int(lens.numel()) * int(mfcc39_fused(sig, lens, cfg)[0].shape[1])
    w_units = w.numel() // w.shape[-1]  # emission components per frame
    sum_nf1k = int(nf1k.clamp(max=TL).sum())
    l1k, k1k = g1k.n_ends, lm_l1k[3][1].shape[1]
    work = {
        "K3": (nbytes(sig, lens) + nfr3 * 39 * 4, mfcc_ops(cfg, nfr3)),
        "K14": (nbytes(ceps_k, nf_c) + nfr3 * 39 * 4, tail_ops(cfg, int(nf_c.sum()))),
        "K1": (nbytes(xa, w, lw, nf) + graph_bytes(bg) + nbytes(*want[:1])
               + sum_nf * (bg.n_states + bg.n_words * (want[2].element_size() + 4)),
               sum_nf * (2 * w.numel() + 4 * w_units) + dp_ops(bg, sum_nf, span_pairs(topo))),
        "K2": (sum_nf * 1 + T * B * 5 + nbytes(ends, nf), 4.0 * sum_nf),
        "K4": (nbytes(nll1k, nf1k) + graph_bytes(g1k) + nbytes(lex_planes[0])
               + sum_nf1k * (g1k.n_states + g1k.n_words * (lex_planes[2].element_size() + 4)),
               dp_ops(g1k, sum_nf1k)),
        "K5": (sum_nf1k * 1 + TL * 128 * 5 + nbytes(lex_ends, nf1k), 4.0 * sum_nf1k),
        "K6": (nbytes(nll_b, nf_full, *k6_out) + graph_bytes(g1k), dp_ops(g1k, 128 * TL)),
        # the pipeline's launch: no q plane read; the truncation counts
        # and the walk's rows written
        "K7": rescore_walk_work(nbytes(*k7_args[:2], *k7_args[3:6], *lm_l1k[3]), TL, 128, l1k,
                                k1k, False, k7w_out[5], mw_1k),
        # K8 computes and writes every frame of every stream (the plain
        # scan's planes, frozen frames included)
        "K8": (nbytes(nll1, nf8, *want1) + graph_bytes(bg1),
               dp_ops(bg1, T * B, span_pairs(topo1), d1)),
        # K9 reads a code per frame below nf, and an eps_u entry, a
        # start_pos and a word_ends entry and a code per unwind step
        "K9": (sum_nf8 + unwinds1 * (want1[2].element_size() + 9) + T * B * 5
               + nbytes(ends1, nf8), 4.0 * (sum_nf8 + unwinds1)),
        # K13 computes every frame of every stream
        "K13": (nbytes(xa, w, lw, nll13), T * B * (2 * w.numel() + 4 * w_units)),
        "K10": (nbytes(xa, w, lw, nf) + graph_bytes(bg) + 2 * nbytes(fwd[0])
                + sum_nf * bg.n_words * (fwd[1].element_size() + 4),
                sum_nf * (2 * w.numel() + 4 * w_units) + dp_ops(bg, sum_nf, span_pairs(topo))),
        # the walks read only the entries their chains visit
        "K21": dense_walk_work(k21_states, ebp_s, saus["n_frames"], saus["eps_depth"]),
        "K22": chain_walk_work(k7w_out[5], mw_1k, 4, 4, 8),
        "K23": chain_walk_work(k23_words[1], k23_words[0].shape[0], 0,
                               k23_args[0].element_size() + 4, 12),
        "K19": k19_work,
        "K26": k26_work,
    }
    # K15 / K16 (their plain versions' outputs give the output sizes)
    out15 = fbk.fb_banded_ref(*k15_args)
    out16 = fbk.fb_dense_ref(*k16_train[0], **k16_train[1])
    x16, tr16, in16, n16, ep16, d16_, en16 = k16_train[0]
    work["K15"] = fb_banded_work(nll15, bg7, nf15, 1, None, out15)
    work["K16"] = fb_dense_work(x16, tr16, ep16, in16, en16, n16, d16_, out16)
    # K11: the isolated path stops each item at its length and writes no
    # planes; with planes every frame is computed and both planes written
    def k11_work(kw, planes=True):
        x, s_ = kw["nll"], kw["nll"].shape[2]
        steps = x.shape[0] * x.shape[1] if planes else \
            int(kw["n_frames"].clamp(max=x.shape[1]).sum())
        depth = kw["eps_depth"] if kw["eps_trans"] is not None else 0
        n_b = (steps * s_ * 4 + nbytes(kw["trans"], kw["eps_trans"], kw["init_cost"],
                                        kw["n_frames"]) + x.shape[0] * s_ * 4
               + (2 * x.numel() * 4 if planes else 0))
        return n_b, dense_ops(steps, s_, depth)

    work["K11"] = k11_work(iso_case, planes=False)
    nf12 = mfcc_fused(sig, lens, cfg)[1]
    work["K12"] = (nbytes(sig, lens) + lens.numel() * (1 + (L - cfg.frame_len)
                                                       // cfg.frame_step) * cfg.n_ceps * 4,
                   ceps_ops(cfg, int(nf12.sum())))
    # the other timed shapes: the dense LM and the dictionary-shaped trie
    sum_nfd = int(nfd.clamp(max=TL).sum())
    sum_nfb = int(nfbig.clamp(max=TL).sum())
    ld, kd = gd.n_ends, lm_ldd[3][1].shape[1]
    eu_d = torch.empty((), dtype=topod.eps_u_dtype).element_size()
    eu_b = torch.empty((), dtype=topo_big.eps_u_dtype).element_size()
    more = {
        "K7 dense LM": (nbytes(*k7_args[:6], lm_ld[2]) + TL * 128 * l1k * 4 + 128 * 8,
                        rescore_ops(TL, 128, l1k, 0, dense=True), k7_dense_ms),
        "K4 dict1-shaped": (nbytes(nlld, nfd) + graph_bytes(gd) + 32 * gd.n_states * 4
                            + sum_nfd * (gd.n_states + gd.n_words * (eu_d + 4)),
                            dp_ops(gd, sum_nfd), k4_dict_ms),
        "K4 8,000-bank-row trie": (nbytes(nllbig, nfbig) + graph_bytes(gbig)
                                   + 16 * gbig.n_states * 4 + sum_nfb * (
                                       gbig.n_states + gbig.n_words * (eu_b + 4)),
                                   dp_ops(gbig, sum_nfb), k4_big_ms),
        "K5 dict1-shaped": (sum_nfd * 1 + TL * 32 * 5 + nbytes(dict_ends, nfd), 4.0 * sum_nfd,
                            k5_dict_ms),
        "K6 dict1-shaped": (nbytes(nll_bd, nf_d16, *kd_out) + graph_bytes(gd),
                            dp_ops(gd, 16 * TL), k6_dict_ms),
        "K4 general mode": (*work["K4"], k4_gen_ms),
        "K6 general mode": (*work["K6"], k6_gen_ms),
        "K6 tau in device memory": (*work["K6"], k6_alt_ms),
        "K7 dict1-shaped": (nbytes(kd_out[1], kd_out[2], *lm_ldd[:2], *lm_ldd[3], nf_d16)
                            + TL * 16 * 4 + TL * 16 * ld * 4 + 16 * 8,
                            rescore_ops(TL, 16, ld, kd, dense=False), k7_dict_ms),
        "K8 3-6-state sausage7": (nbytes(nll6, nf8, *want6) + graph_bytes(bg6),
                                  dp_ops(bg6, T * B, span_pairs(topo6)), k8_mixed_ms),
        "K9 3-6-state sausage7": (sum_nf8 + unwinds6 * (want6[2].element_size() + 9)
                                  + T * B * 5 + nbytes(ends6, nf8), 4.0 * (sum_nf8 + unwinds6),
                                  k9_mixed_ms),
        "K8 + K9": (work["K8"][0] + work["K9"][0], work["K8"][1] + work["K9"][1], k8k9_ms),
        "K9 cross mode, 1k trie k=64 beam planes 32x500": (*k9x_work, k9x_ms),
        "K11 wide form, 500 states 8x100": (*k11_work(wide_case), cuda_ms(
            lambda: viterbi_dense(**wide_case))),
        "K1 + K2": (work["K1"][0] + work["K2"][0], work["K1"][1] + work["K2"][1], k1k2_ms),
        "K1 DP alone": (nbytes(nll13, nf) + graph_bytes(bg) + nbytes(*want[:1])
                        + sum_nf * (bg.n_states + bg.n_words * (want[2].element_size() + 4)),
                        dp_ops(bg, sum_nf, span_pairs(topo)), dp_ms),
        "K10 DP alone": (nbytes(nll13, nf) + graph_bytes(bg) + 2 * nbytes(fwd[0])
                         + sum_nf * bg.n_words * (fwd[1].element_size() + 4),
                         dp_ops(bg, sum_nf, span_pairs(topo)), dp10_ms),
        "K10 1,500-word loop": (nbytes(xab, w, lw, nfb) + graph_bytes(bgb)
                                + 2 * nbytes(k10_big[0]) + int(nfb.sum()) * bgb.n_words
                                * (k10_big[1].element_size() + 4),
                                int(nfb.sum()) * (2 * w.numel() + 4 * w_units)
                                + dp_ops(bgb, int(nfb.sum()), span_pairs(topob)), k10_big_ms),
        "K3 64 x 25 s": (nbytes(sig_long, lens_long) + 64 * f_long * 39 * 4,
                         mfcc_ops(cfg, int(nf_long.sum())), k3_long_ms),
        "K1 1,500-word loop": (nbytes(xab, w, lw, nfb) + graph_bytes(bgb)
                               + nbytes(*k1_big[1][:1]) + int(nfb.sum()) * (
                                   bgb.n_states + bgb.n_words * (k1_big[1][2].element_size() + 4)),
                               int(nfb.sum()) * (2 * w.numel() + 4 * w_units)
                               + dp_ops(bgb, int(nfb.sum()), span_pairs(topob)), k1_big_ms),
        "K8 2,000-word loop": (nbytes(nll8b, nf8b, *k8_big[1]) + graph_bytes(bg8),
                               dp_ops(bg8, Tb * B8b, span_pairs(topo8), big8.eps_depth),
                               k8_big_ms),
        f"K11 at {s11} states": (*k11_work(k11_big), k11_big_ms),
        **{f"K11 with planes, {name}": (*k11_work(dense_cases[name]), ms)
           for name, (ms, _) in k11_ms.items()},
        **{f"K21 {name}": (*dense_walk_work(viterbi_backtrace_ref(*k21_args[name])[0],
                                            k21_args[name][1], k21_args[name][3],
                                            k21_args[name][4]), ms)
           for name, ms in k21_ms.items()},
        "K22 1k trie, planted words 128x500": (
            *chain_walk_work(k22_pl_words, k22_planted[4], 4, 4, 8), k22_pl_ms),
        "K23 skip-arc loop graph 64x300": (
            *chain_walk_work(want_s[1], want_s[0].shape[0], 0, 5, 12), k23_skip_ms),
        f"K19 1k trie 32x{T} k=64 with the bigram": (*k19_big_work, k19_big_ms),
        f"K19 dict1-shaped 32x{TL} k=64 (device tier)": (*k19_d_work, k19_d_ms),
    }
    more["K16 synthetic transcripts, band xi"] = (*fb_dense_work(
        *k16_synth[:1], k16_synth[1], k16_synth[4], k16_synth[2], k16_synth[6], k16_synth[3],
        k16_synth[5], fbk.fb_dense_ref(*k16_synth, xi_mode="band")), k16_synth_ms)
    for a_w, (xa_w, w_w, lw_w, out_w, ms, _) in k13_wide.items():
        more[f"K13 chunked form, A = {a_w}, 64x500"] = (
            nbytes(xa_w, w_w, lw_w, out_w), 500 * 64 * (2 * w_w.numel() + 4 * 55 * 4), ms)
    for k_, (name, work_, ms, _) in big_fb.items():
        more[f"{k_} {name}"] = (*work_, ms)
    more["K15 transcripts' banded dict"] = (*fb_banded_work(
        nll16, g15t, nf16, depth_b, end15t, fbk.fb_banded_ref(nll16, g15t, nf16, depth_b,
                                                              end15t)), k15_tr_ms)
    # K17 / K18 per chunk (the timed calls: every frame of the chunk is
    # computed, frozen ones too); with the ancestor map add its [S, B]
    # output and an org select and store per state and frame
    eu17 = torch.empty((), dtype=_eps_u_dtype(bgl.n_ends)).element_size()
    frames17, frames18 = CH * BS, CH * BL
    work["K17"] = (nbytes(xa_c, w, lw, nv_c, fr_c) + graph_bytes(bgl) + nbytes(fr_c)
                   + frames17 * (bgl.n_states + bgl.n_words * (eu17 + 4)),
                   frames17 * (2 * w.numel() + 4 * w_units) + dp_ops(bgl, frames17,
                                                                     span_pairs(topol)))
    work["K18"] = (nbytes(nll_pc, nv_t, fr_t) + graph_bytes(g1k) + nbytes(fr_t)
                   + frames18 * (g1k.n_states + g1k.n_words * (topo1k_.eps_u_dtype.itemsize
                                                               + 4)),
                   dp_ops(g1k, frames18))
    more["K17 with the ancestor map"] = (work["K17"][0] + 4 * bgl.n_states * BS,
                                         work["K17"][1] + 2.0 * bgl.n_states * frames17,
                                         k17_org_ms)
    more["K17 DP alone"] = (work["K17"][0] - nbytes(xa_c, w, lw) + nbytes(nll_c),
                            dp_ops(bgl, frames17, span_pairs(topol)), k17_dp_ms)
    more["K18 with the ancestor map"] = (work["K18"][0] + 4 * g1k.n_states * BL,
                                         work["K18"][1] + 2.0 * g1k.n_states * frames18,
                                         k18_org_ms)
    work.update(gmm_work)
    more.update(gmm_more)
    bounds = {k: bound(*v) for k, v in work.items()}
    # a serial walk's floor beside its byte bound: its longest stream's
    # frames as dependent shared-memory loads (~30 cycles each on Hopper)
    # at the H100 SXM's 1,980 MHz boost clock
    for name, nf_, ms in (("K5 1k trie 128x500", nf1k, t["K5"][0]),
                          ("K5 dict1-shaped 32x500", nfd, k5_dict_ms)):
        floor_ms = int(nf_.clamp(max=TL).max()) * SMEM_STEP_CYCLES / SM_CLOCK_HZ * 1e3
        phase("bound", f"{name}: serial floor {floor_ms:.4f} ms ({int(nf_.max())} dependent "
                       f"shared-memory steps); the kernel took {ms / floor_ms:.1f}x it")
    # the walks K21-K23 and K26: their longest chain's steps (frames, words)
    for name, steps, ms in (
            (f"K21 385-state sausage 64x{T}", int(saus["n_frames"].clamp(max=T).max()),
             t["K21"][0]),
            (f"K22 as K7's last step, 1k trie 128x{TL}", int(k7w_out[5].max()), t["K22"][0]),
            ("standalone K22 1k trie, planted words 128x500", int(k22_pl_words.max()),
             k22_pl_ms),
            (f"K23 sausage7 word trace {B}x{T}", int(k23_words[1].max()), t["K23"][0]),
            ("K23 skip-arc loop graph 64x300", int(want_s[1].max()), k23_skip_ms),
            (f"K26 token walk, 1k trie 32x{T} k=64", int(n_t.clamp(max=T).max()),
             t["K26"][0])):
        floor_ms = steps * SMEM_STEP_CYCLES / SM_CLOCK_HZ * 1e3
        phase("bound", f"{name}: serial floor {floor_ms:.3g} ms ({steps} dependent steps at "
                       f"one shared-memory load each); the kernel took {ms / floor_ms:.1f}x it")
    k19_floor = token_beam_floor(n_t) * 1e3
    phase("bound", f"K19 1k trie 32x{T} k=64: serial floor {k19_floor:.4f} ms (the longest "
                   f"stream's frames x a frame's dependent steps {TOKEN_BEAM_STEPS} at "
                   f"{STEP_CYCLES} cycles, one merge round); the kernel took "
                   f"{t['K19'][0] / k19_floor:.1f}x it event, {k19_dev / k19_floor:.1f}x "
                   f"device")
    for k, (*w_, ms) in [(k, (*v, t[k][0])) for k, v in work.items()] + list(more.items()):
        b_ms, by = bound(*w_)
        sfu = f", {w_[2] / 1e9:.2f} G exps and logs" if len(w_) > 2 else ""
        phase("bound", f"{k}: {w_[0] / 1e6:.1f} MB, {w_[1] / 1e9:.2f} G operations{sfu} -> "
                       f"{b_ms:.4f} ms, bound by {by}; the kernel took {ms / b_ms:.0f}x it")

    bad = sorted(m for m in sys.modules if m in ("jax", "speech_recognition_tpu")
                 or m.startswith(("jax.", "speech_recognition_tpu.")))
    if bad:
        fail(f"modules of jax or of the JAX package were imported: {bad[:5]}")
    src = {"K3": ("mfcc39_fused", "speech_recognition_tpu_torch/csrc/mfcc39.cu",
                  "speech_recognition_tpu/ops/frontend_pallas.py:190"),
           "K14": ("mfcc_tail", "speech_recognition_tpu_torch/csrc/mfcc39.cu",
                   "speech_recognition_tpu/ops/frontend_pallas.py:190"),
           "K1": ("viterbi_banded_fused", "speech_recognition_tpu_torch/csrc/banded_forward.cu",
                  "speech_recognition_tpu/ops/viterbi_banded_pallas.py:133"),
           "K13": ("bank_emission", "speech_recognition_tpu_torch/csrc/bank_emission.cu",
                   "speech_recognition_tpu/ops/viterbi_banded_pallas.py:133"),
           "K2": ("banded_backtrace_val",
                  "speech_recognition_tpu_torch/csrc/banded_backtrace.cu",
                  "speech_recognition_tpu/ops/viterbi_banded_pallas.py:1027"),
           "K4": ("viterbi_lex", "speech_recognition_tpu_torch/csrc/viterbi_lex.cu",
                  "speech_recognition_tpu/ops/viterbi_lex_pallas.py:550"),
           "K5": ("lex_backtrace_val", "speech_recognition_tpu_torch/csrc/lex_backtrace.cu",
                  "speech_recognition_tpu/ops/viterbi_lex_pallas.py:1581"),
           "K6": ("viterbi_lattice", "speech_recognition_tpu_torch/csrc/viterbi_lex.cu",
                  "speech_recognition_tpu/ops/viterbi_lex_pallas.py:1017"),
           # rescore_lattice launches K7 too (a walk of no rows)
           "K7": (("rescore_and_walk", "rescore_lattice"),
                  "speech_recognition_tpu_torch/csrc/lattice_rescore.cu",
                  "speech_recognition_tpu/ops/lattice.py:165"),
           "K8": ("viterbi_banded_general",
                  "speech_recognition_tpu_torch/csrc/banded_forward.cu",
                  "speech_recognition_tpu/ops/viterbi_banded_pallas.py:133"),
           "K9": ("banded_backtrace_general",
                  "speech_recognition_tpu_torch/csrc/banded_backtrace.cu",
                  "speech_recognition_tpu/ops/viterbi_banded_pallas.py:945"),
           "K10": ("viterbi_banded_wordtrace",
                   "speech_recognition_tpu_torch/csrc/banded_forward.cu",
                   "speech_recognition_tpu/ops/viterbi_banded_pallas.py:133"),
           "K11": ("viterbi_dense", "speech_recognition_tpu_torch/csrc/viterbi_dense.cu",
                   "speech_recognition_tpu/ops/pallas_kernels.py:59"),
           "K12": ("mfcc_fused", "speech_recognition_tpu_torch/csrc/mfcc39.cu",
                   "speech_recognition_tpu/ops/pallas_kernels.py:294"),
           # no TPU kernel: these replace the JAX package's lax.scan passes
           "K15": ("fb_banded", "speech_recognition_tpu_torch/csrc/forward_backward.cu",
                   "speech_recognition_tpu/ops/forward_backward.py:259"),
           "K16": ("fb_dense", "speech_recognition_tpu_torch/csrc/forward_backward.cu",
                   "speech_recognition_tpu/ops/forward_backward.py:62"),
           # no TPU kernel: these replace the streaming chunk step's lax.scan
           "K17": ("viterbi_banded_chunk",
                   "speech_recognition_tpu_torch/csrc/banded_warp.cu",
                   "speech_recognition_tpu/decode/streaming.py:86"),
           "K18": ("viterbi_lex_chunk", "speech_recognition_tpu_torch/csrc/viterbi_lex.cu",
                   "speech_recognition_tpu/decode/streaming.py:86"),
           # no TPU kernel: these replace the backtrace scans (lax.scan)
           "K21": ("dense_backtrace", "speech_recognition_tpu_torch/csrc/dense_backtrace.cu",
                   "speech_recognition_tpu/ops/viterbi.py:141"),
           # K22 runs on the path as K7's last step: its launches are K7's
           # (rescore_and_walk's), its ms that launch's device time less the
           # same launch's at max_words 0 (the standalone lattice_walk, off
           # every path, is timed apart)
           "K22": ("rescore_and_walk",
                   "speech_recognition_tpu_torch/csrc/lattice_walk.cuh",
                   "speech_recognition_tpu/ops/lattice.py:479"),
           "K23": ("wordtrace_words_device", "speech_recognition_tpu_torch/csrc/word_walk.cu",
                   "speech_recognition_tpu/ops/viterbi_banded_pallas.py:912"),
           # no TPU kernel: these replace mixture training's lax.while_loops
           "K24": ("kmeans_batch", "speech_recognition_tpu_torch/csrc/gmm_fit.cu",
                   "speech_recognition_tpu/train/kmeans.py:91"),
           "K25": ("em_fit_batch", "speech_recognition_tpu_torch/csrc/gmm_fit.cu",
                   "speech_recognition_tpu/train/em.py:95"),
           # no TPU kernel: these replace the token beam's two lax.scans
           "K19": ("beam_search", "speech_recognition_tpu_torch/csrc/token_beam.cu",
                   "speech_recognition_tpu/ops/beam.py:155"),
           "K26": ("beam_backtrace", "speech_recognition_tpu_torch/csrc/word_walk.cu",
                   "speech_recognition_tpu/ops/beam.py:327")}
    # each kernel's launches over the path runs above (no single PyTorch
    # call computes any of these functions: library_ms is null)
    n_launch = {fn: sum(p[fn] for p in launches.values()) for fn in launches["connected"]}
    src = {k: ((fn,) if isinstance(fn, str) else fn, *v) for k, (fn, *v) in src.items()}
    kernels = [{"name": f"{k} {' + '.join(fn)}", "route": "cuda", "source": path,
                "replaces": rep, "launches": sum(n_launch[f_] for f_ in fn),
                "max_abs_err": report[k]["max_abs_err"],
                "ms": t[k][0], "plain_ms": t[k][1], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "library_ms": None}
               for k, (fn, path, rep) in src.items()]
    phase("timing", f"device_ms: {DEVICE_READINGS['readings']} readings; "
                    f"{DEVICE_READINGS['rerun']} profiler window(s) re-run for missing "
                    f"kernels; not measured (three short windows, printed as nan): "
                    f"{', '.join(DEVICE_READINGS['failed']) or 'none'}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(device_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

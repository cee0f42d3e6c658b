"""PyTorch + CUDA port of ``speech_recognition_tpu``.

The JAX package beside this one is the reference; this package keeps
its module paths and function names so each counterpart is found at
once.  The slices ported so far are the connected-digit main path (every
banded word graph, and the word-trace backend), the large-vocabulary
lexical-tree decode, the bigram LM over word lattices, isolated-word
recognition, the dense decoder, forced alignment and hard-EM training:

  ops.frontend.mfcc39_auto        wav -> 39-dim MFCCs   (kernel: csrc/mfcc39.cu)
  decode.connected.decode_connected
    -> _decode_banded_batch        uniform graphs: K1 = the GMM emission kernel
                                   (K13: csrc/bank_emission.cu) + the banded
                                   Viterbi DP (csrc/banded_forward.cu),
                                   value backtrace (K2: csrc/banded_backtrace.cu);
                                   other graphs: bank_nll_ubt, banded Viterbi on
                                   bank emissions (K8: csrc/banded_forward.cu),
                                   general backtrace (K9: csrc/banded_backtrace.cu)
    -> states_to_words_device      plain tensor ops
    backend="wordtrace"            forward with entry-time planes (K10 = K13 +
                                   the word-trace mode of csrc/banded_forward.cu)
                                   -> wordtrace_words_device
  decode.lextree.decode_lextree
    -> models.hmm.bank_nll_ubt     unit-bank emissions (torch.matmul)
    -> viterbi_lex                 lexical-tree Viterbi (kernel: csrc/viterbi_lex.cu)
    -> lex_backtrace_val           value backtrace (kernel: csrc/lex_backtrace.cu)
    -> lex_words_from_path_batch   host numpy
  decode.isolated.classify_batch   one emission GEMM -> dense Viterbi per
  decode.dtw.dtw_classify_batch      (utterance, model), no planes (K11:
                                   csrc/viterbi_dense.cu) -> argmin
  decode_connected(backend="dense") and train.continuous.align_batch
                                   K11 with eps passes and planes (per
                                   utterance graphs for alignment) ->
                                   ops.viterbi.viterbi_backtrace
  ops.frontend.mfcc                psf cepstra (K12: csrc/mfcc39.cu, cepstra mode)
  train.isolated.fit_hmm           segmental K-means (K11 aligns a word's templates,
                                   then ops.viterbi.viterbi_backtrace) -> mixture
                                   splitting (train.kmeans, train.em: tensor ops)
  train.embedded_step              align_batch (K11) -> statistics GEMMs -> M-step

Every kernel wrapper runs its plain PyTorch version for CPU tensors and
launches the hand-written CUDA kernel for CUDA tensors (or raises); a
CUDA tensor never falls back to the plain version.  The device is
always taken from the input tensors.

This package imports no ``jax`` and no module of the reference package
``speech_recognition_tpu``, not even its jax-free ones: what it needs
of ``config``, ``data`` and the wav loader has its own copy here
(``config.py``, ``data/``).  Only the tests import both packages.
"""

from speech_recognition_tpu_torch.utils import numerics as _numerics  # noqa: F401  (sets the f32 policy)

__version__ = "0.1.0"

"""Tensor ops and kernel wrappers of the port.  The dense Viterbi's
single-utterance form is ``ops.viterbi.viterbi`` (not re-exported here,
so the name keeps naming its module)."""

from speech_recognition_tpu_torch.ops.gmm import (
    mahalanobis,
    pairwise_gaussian_nll,
    pairwise_sq_euclidean,
)
from speech_recognition_tpu_torch.ops.viterbi import (
    ViterbiResult,
    viterbi_backtrace,
    viterbi_batch,
    viterbi_path_cost,
)
from speech_recognition_tpu_torch.ops.viterbi_kernels import viterbi_dense

__all__ = ["ViterbiResult", "viterbi_batch", "viterbi_backtrace", "viterbi_path_cost",
           "viterbi_dense", "mahalanobis", "pairwise_gaussian_nll", "pairwise_sq_euclidean"]

"""Tensor ops and kernel wrappers of the port.  The dense Viterbi's
single-utterance form is ``ops.viterbi.viterbi`` (not re-exported here,
so the name keeps naming its module).  ``forward_backward`` is
re-exported as the JAX package does, so ``ops.forward_backward`` names
the function: import the module by its full name (``from
speech_recognition_tpu_torch.ops.forward_backward import ...``)."""

from speech_recognition_tpu_torch.ops.forward_backward import forward_backward
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
           "viterbi_dense", "forward_backward", "mahalanobis", "pairwise_gaussian_nll", "pairwise_sq_euclidean"]

"""Models of the port: the GMM-HMM bank and the composed word graphs."""

from speech_recognition_tpu_torch.models.graph import (
    WordGraph,
    build_loop_graph,
    build_word_graph,
    pad_graphs,
    transcript_graph,
)
from speech_recognition_tpu_torch.models.hmm import (
    GMMHMM,
    HMMBank,
    bank_nll,
    bank_nll_ubt,
    linear_init_cost,
    uniform_left_to_right_trans,
)

__all__ = ["GMMHMM", "HMMBank", "bank_nll", "bank_nll_ubt", "linear_init_cost",
           "uniform_left_to_right_trans", "WordGraph", "build_word_graph", "build_loop_graph",
           "transcript_graph", "pad_graphs"]

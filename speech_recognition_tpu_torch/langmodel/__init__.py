"""Language-model side of the port: the lexical tree, the bigram LM and
the spell checker."""

from speech_recognition_tpu_torch.langmodel.bigram import (
    BigramBackoff,
    BigramLM,
    bigram_backoff,
    fit_bigram,
    scale,
    sequence_cost,
    uniform_bigram,
)
from speech_recognition_tpu_torch.langmodel.lextree import LexTree, lextree_from_words
from speech_recognition_tpu_torch.langmodel.spellcheck import (
    SpellChecker,
    text_viterbi,
    text_viterbi_batch,
)

__all__ = ["LexTree", "lextree_from_words", "BigramLM", "uniform_bigram", "fit_bigram",
           "scale", "sequence_cost", "BigramBackoff", "bigram_backoff", "SpellChecker",
           "text_viterbi", "text_viterbi_batch"]

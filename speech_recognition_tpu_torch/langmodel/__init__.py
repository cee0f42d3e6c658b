"""Language-model side of the port: so far the lexical tree only (the
bigram LM and the spell checker are later slices)."""

from speech_recognition_tpu_torch.langmodel.lextree import LexTree, lextree_from_words

__all__ = ["LexTree", "lextree_from_words"]

"""Decoders of the port: isolated words (GMM-HMM bank and DTW templates),
connected words over composed graphs, the lexical tree (exact, and with
the rank-threshold or the token-passing beam), streaming
(chunked) decoding of long audio, and word confidence from
forward-backward posteriors."""

from speech_recognition_tpu_torch.decode.confidence import path_posteriors, word_confidence
from speech_recognition_tpu_torch.decode.connected import (
    connected_graph_arrays,
    decode_connected,
)
from speech_recognition_tpu_torch.decode.dtw import (
    TemplateBank,
    dtw_classify_batch,
    dtw_score_models,
    stack_templates,
)
from speech_recognition_tpu_torch.decode.isolated import classify_batch, score_models
from speech_recognition_tpu_torch.decode.lextree import beam_decode_lextree, decode_lextree
from speech_recognition_tpu_torch.decode.streaming import StreamingDecoder

__all__ = ["score_models", "classify_batch", "decode_connected", "connected_graph_arrays",
           "TemplateBank", "dtw_classify_batch", "dtw_score_models", "stack_templates",
           "decode_lextree", "beam_decode_lextree", "path_posteriors", "word_confidence",
           "StreamingDecoder"]

"""Aurora digit-corpus filename conventions (counterpart of
``speech_recognition_tpu/data/aurora.py``).

File names encode speaker and transcript, ``[A-Z]+_<digits>[AB].wav``,
with digit characters in ``[OZ1-9]``."""

from __future__ import annotations

import re
from typing import List, Optional

from speech_recognition_tpu_torch.config import FILENAME_INDEX_MAP

__all__ = ["transcript_from_filename", "labels_from_transcript"]

_SEQ_RE = re.compile(r"(?<=_)[OZ0-9]+(?=[AB])")


def transcript_from_filename(filename: str) -> Optional[str]:
    m = _SEQ_RE.search(filename)
    return m.group(0) if m else None


def labels_from_transcript(transcript: str) -> List[int]:
    return [FILENAME_INDEX_MAP[c] for c in transcript]

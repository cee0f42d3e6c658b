"""Training side of the port; so far only what forced alignment needs."""

from speech_recognition_tpu_torch.train.continuous import align_batch, harvest_state_ids

__all__ = ["align_batch", "harvest_state_ids"]

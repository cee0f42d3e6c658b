"""Host-side input pipeline of the port: the native batched wav loader
(``wav_loader.cc``, built with g++ at first use) and its prefetching
iterator."""

from speech_recognition_tpu_torch.runtime.loader import PrefetchWavBatches, load_wav_batch

__all__ = ["load_wav_batch", "PrefetchWavBatches"]

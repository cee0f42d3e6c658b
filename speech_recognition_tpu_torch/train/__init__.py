"""Training side of the port: hard-EM (Viterbi) and soft-EM (Baum-Welch)
training.

Segmental K-means (``skmeans``), mixture splitting with k-means and EM
(``isolated.fit_gmm_state`` / ``fit_hmm``), the silence model, forced
alignment (``continuous.align_batch``), the embedded Viterbi-EM step
(``embedded_step``, on the transcript graphs of ``compose_graphs``), the
Baum-Welch step (``embedded_step_soft``) and the from-scratch embedded
re-estimation (``continuous.continuous_train``).
"""

from speech_recognition_tpu_torch.train.continuous import (
    align_batch,
    continuous_train,
    harvest_state_ids,
)
from speech_recognition_tpu_torch.train.em import em_fit
from speech_recognition_tpu_torch.train.embedded_step import (
    EmbeddedStats,
    compose_graphs,
    embedded_step,
    embedded_step_soft,
)
from speech_recognition_tpu_torch.train.isolated import align_states, fit_gmm_state, fit_hmm
from speech_recognition_tpu_torch.train.kmeans import kmeans, random_assign
from speech_recognition_tpu_torch.train.silence import fit_silence_hmm, harvest_silence_samples
from speech_recognition_tpu_torch.train.skmeans import calc_transition_costs, skmeans

__all__ = ["align_batch", "harvest_state_ids", "continuous_train", "em_fit", "embedded_step",
           "embedded_step_soft", "EmbeddedStats", "compose_graphs", "align_states",
           "fit_gmm_state", "fit_hmm", "kmeans", "random_assign", "fit_silence_hmm",
           "harvest_silence_samples", "calc_transition_costs", "skmeans"]

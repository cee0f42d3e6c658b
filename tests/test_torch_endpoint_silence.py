"""Port vs reference: the energy endpointer and the silence model.

``frame_energies_db``, ``endpoint_signal``, ``trim_to_speech`` and
``harvest_silence_samples`` are numpy on both sides and compared
exactly.  ``fit_silence_hmm`` trains from JAX's own k-means draws
(``tests.test_torch_train.JaxDraws``, JAX with x64 off) and is compared
at rtol 1e-4 / atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import EndpointConfig as JEndpointConfig
from speech_recognition_tpu.data import endpoint as jend
from speech_recognition_tpu.data.synthetic import SyntheticDigits
from speech_recognition_tpu.train import silence as jsil
from speech_recognition_tpu_torch.config import EndpointConfig
from speech_recognition_tpu_torch.data import endpoint as tend
from speech_recognition_tpu_torch.models.hmm import GMMHMM, HMMBank, bank_nll
from speech_recognition_tpu_torch.train import silence as tsil
from tests.test_torch_train import JaxDraws, close


def wavs():
    """Synthetic digit wavs with silence around the speech, a quiet wav
    with no speech, a short one and an all-zero one."""
    utts = SyntheticDigits(seed=4).isolated_corpus(1, tag="ep")[:6]
    rng = np.random.default_rng(5)
    quiet = (rng.standard_normal(16000) * 3).astype(np.int16)
    return [u.samples for u in utts] + [quiet, quiet[:200], np.zeros(8000, np.int16)]


def test_endpoint_signal_equal():
    cfgs = [(JEndpointConfig(), EndpointConfig()),
            (JEndpointConfig(onset_threshold_db=6.0, speech_threshold_ms=100.0),
             EndpointConfig(onset_threshold_db=6.0, speech_threshold_ms=100.0))]
    found = 0
    for jc, tc in cfgs:
        for w in wavs():
            np.testing.assert_array_equal(tend.frame_energies_db(w, tc),
                                          jend.frame_energies_db(w, jc))
            got, want = tend.endpoint_signal(w, tc), jend.endpoint_signal(w, jc)
            assert got == want
            found += got[0] is not None
            np.testing.assert_array_equal(tend.trim_to_speech(w, tc), jend.trim_to_speech(w, jc))
    assert found >= 6
    assert tend.endpoint_signal(wavs()[-3]) == (None, None)


def test_harvest_silence_samples_equal():
    got = tsil.harvest_silence_samples(wavs())
    want = jsil.harvest_silence_samples(wavs())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_mix", [1, 2])
def test_fit_silence_hmm_matches_reference(n_mix):
    rng = np.random.default_rng(6)
    frames = np.concatenate([rng.normal(0.0, 1.0, (150, 12)),
                             rng.normal(3.0, 0.5, (90, 12))]).astype(np.float32)
    key = jax.random.PRNGKey(4242)
    with jax.enable_x64(False):
        want = jsil.fit_silence_hmm(key, frames, n_states=4, n_mix=n_mix)
        got = tsil.fit_silence_hmm(torch.from_numpy(frames), n_states=4, n_mix=n_mix,
                                   draw_assign=JaxDraws(key, per_state=False))
    for f in ("means", "log_vars", "log_weights", "trans_cost"):
        assert getattr(got, f).shape == getattr(want, f).shape
        close(getattr(got, f), getattr(want, f))


def test_pad_mixtures_keeps_the_emissions():
    rng = np.random.default_rng(7)
    sil = GMMHMM(torch.from_numpy(rng.standard_normal((3, 2, 6)).astype(np.float32)),
                 torch.from_numpy(rng.uniform(-1, 0, (3, 2, 6)).astype(np.float32)),
                 torch.log(torch.tensor([[0.3, 0.7]] * 3)), torch.zeros((3, 3)))
    padded = tsil.pad_mixtures(sil, 4)
    assert padded.means.shape == (3, 4, 6) and tsil.pad_mixtures(sil, 2) is sil
    x = torch.from_numpy(rng.standard_normal((40, 6)).astype(np.float32))
    bank = lambda m: HMMBank.stack([m])
    torch.testing.assert_close(bank_nll(bank(padded), x), bank_nll(bank(sil), x),
                               rtol=1e-6, atol=1e-6)

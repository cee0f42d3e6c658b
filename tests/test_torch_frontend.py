"""Port vs reference: the MFCC frontend, which is also the plain version
of the fused-frontend kernel K3.

The port's ``mfcc39_batch`` (NDFT GEMM), reached directly and through
K3's wrapper ``mfcc39_fused`` (a CPU tensor runs the plain version), is
held against the reference XLA ``mfcc39_batch`` at rtol 2e-3 /
atol 5e-4 (f32 spectral chains with different summation orders; the
log stage amplifies quiet mel channels) and against the float64 psf
oracle at rtol 2e-3 / atol 1e-3.  Frame counts must match exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from speech_recognition_tpu.config import FrontendConfig
from speech_recognition_tpu.ops import frontend as jfe
from speech_recognition_tpu_torch.ops import frontend as tfe
from speech_recognition_tpu_torch.ops.frontend_kernel import (
    mfcc39_fused,
    mfcc39_fused_ref,
    mfcc_fused_ref,
    mfcc_tail,
)
from tests.oracles.frontend_ref import load_wav_as_mfcc_oracle
from tests.test_frontend import synth_signal

PSF = FrontendConfig()
# "fused_ref": K3's wrapper, which serves a CPU tensor with its plain version
PORT_PATHS = {"ndft": tfe.mfcc39_batch, "fused_ref": mfcc39_fused}


def _batch(seed, lens, cap):
    rng = np.random.default_rng(seed)
    sigs = np.zeros((len(lens), tfe.padded_length(PSF, cap)), np.float32)
    raw = []
    for i, n in enumerate(lens):
        s = synth_signal(rng, n)
        raw.append(s)
        sigs[i, :n] = s
    return sigs, np.asarray(lens, np.int32), raw


def test_constants_match_reference():
    for cfg in (PSF, FrontendConfig(variant="scratch"), FrontendConfig(sample_rate=8000)):
        jc, tc = jfe._frontend_constants(cfg), tfe._frontend_constants(cfg)
        for k in ("window", "mel_w", "dct_m", "lifter"):
            np.testing.assert_array_equal(tc[k], jc[k])
        np.testing.assert_array_equal(tc["dft_cs"], jc["dft_cs"])
        for n in (1, 400, 401, 16000):
            assert tfe.max_frames(cfg, n) == jfe.max_frames(cfg, n)
            assert tfe.padded_length(cfg, n) == jfe.padded_length(cfg, n)


@pytest.mark.parametrize("path", sorted(PORT_PATHS))
@pytest.mark.parametrize("case", ["varlen", "single_frame", "norm_none"])
def test_mfcc39_matches_reference(path, case):
    lens = {"varlen": [16000, 7321, 2000, 9000],
            "single_frame": [400, 123, 16000],
            "norm_none": [16000, 5000]}[case]
    norm = "none" if case == "norm_none" else "utterance"
    sigs, lengths, _ = _batch(7, lens, 16000)
    f_j, nf_j = jfe.mfcc39_batch(sigs, lengths, PSF, norm=norm)
    f_t, nf_t = PORT_PATHS[path](torch.from_numpy(sigs), torch.from_numpy(lengths),
                                 PSF, norm=norm)
    np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))
    f_j = np.asarray(f_j)
    scale = 1.0 if norm == "utterance" else np.abs(f_j).max(axis=(0, 1))
    np.testing.assert_allclose(f_t.numpy() / scale, f_j / scale, rtol=2e-3, atol=5e-4)
    for i, n in enumerate(nf_t.numpy()):
        assert np.all(f_t.numpy()[i, n:] == 0.0)


@pytest.mark.parametrize("path", sorted(PORT_PATHS))
def test_mfcc39_matches_reference_past_k3_shared_memory(path):
    """25 s at 16 kHz (2,499 frames, past the 1,967 frames whose cepstra
    and deltas once fit in K3's shared memory; K3 has no frame limit
    now): K3's plain version against the reference ``mfcc39`` at rtol
    2e-3 / atol 5e-4, frame counts equal."""
    lens = [400000, 31000]
    sigs, lengths, _ = _batch(13, lens, 400000)
    f_j, nf_j = jfe.mfcc39_batch(sigs, lengths, PSF)
    f_t, nf_t = PORT_PATHS[path](torch.from_numpy(sigs), torch.from_numpy(lengths), PSF)
    assert f_t.shape[1] == 2499 > 1967
    np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-3, atol=5e-4)


@pytest.mark.parametrize("path", sorted(PORT_PATHS))
def test_mfcc39_matches_float64_oracle(path):
    lens = [16000, 7321, 7000, 12345]
    sigs, lengths, raw = _batch(11, lens, 16000)
    feats, nf = PORT_PATHS[path](torch.from_numpy(sigs), torch.from_numpy(lengths), PSF)
    for i, s in enumerate(raw):
        ref = load_wav_as_mfcc_oracle(s)
        assert int(nf[i]) == ref.shape[0]
        np.testing.assert_allclose(feats[i, : ref.shape[0]].numpy(), ref,
                                   rtol=2e-3, atol=1e-3)


def test_eight_khz_and_frame_cap():
    cfg = FrontendConfig(sample_rate=8000)
    rng = np.random.default_rng(3)
    sigs = np.zeros((2, tfe.padded_length(cfg, 8000)), np.float32)
    sigs[0] = synth_signal(rng, sigs.shape[1], 8000)
    sigs[1, :3000] = synth_signal(rng, 3000, 8000)
    lengths = np.array([sigs.shape[1], 3000], np.int32)
    f_j, nf_j = jfe.mfcc39_batch(sigs, lengths, cfg, n_frames_cap=50)
    for fn in PORT_PATHS.values():
        f_t, nf_t = fn(torch.from_numpy(sigs), torch.from_numpy(lengths), cfg,
                       n_frames_cap=50)
        np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-3, atol=5e-4)


def test_frames_longer_than_the_fft_match_reference():
    """At 48 kHz a 25 ms frame (1200 samples) is longer than the 512-point
    FFT; the reference's DFT bases fold it modulo 512, and so do the
    port's plain version and K3.  The signal is white noise, as in the
    benchmark's pipeline: ``synth_signal``'s fade-out leaves near-silent
    last frames whose log-mel rounding, in either package's f32 chain,
    can exceed the tolerance at these rates.  (44.1 kHz is held on the
    card, K3 against this plain version: the reference's framing compiles
    1102 one-sample slices there, which takes half a minute.)"""
    rate = 48000
    cfg = FrontendConfig(sample_rate=rate)
    assert cfg.frame_len > cfg.n_fft and tfe.fused_supported(cfg, "utterance")
    rng = np.random.default_rng(0)
    lens = np.array([rate // 2, rate // 5 + 37, 900], np.int32)
    sigs = (rng.standard_normal((3, tfe.padded_length(cfg, rate // 2))) * 3000).astype(np.float32)
    sigs[np.arange(sigs.shape[1])[None, :] >= lens[:, None]] = 0.0
    for norm in ("utterance", "none"):
        f_j, nf_j = jfe.mfcc39_batch(sigs, lens, cfg, norm=norm)
        f_t, nf_t = mfcc39_fused(torch.from_numpy(sigs), torch.from_numpy(lens), cfg, norm=norm)
        np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))
        f_j = np.asarray(f_j)
        scale = 1.0 if norm == "utterance" else np.abs(f_j).max(axis=(0, 1))
        np.testing.assert_allclose(f_t.numpy() / scale, f_j / scale, rtol=2e-3, atol=5e-4)


def test_delta_standardize_cmvn_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 11, 4)).astype(np.float32)
    nf = np.array([11, 5, 1], np.int32)
    xt, nft = torch.from_numpy(x), torch.from_numpy(nf)
    for i in range(3):
        np.testing.assert_allclose(tfe.delta_feature(xt[i], nft[i]).numpy(),
                                   np.asarray(jfe.delta_feature(x[i], nf[i])), rtol=1e-6)
        np.testing.assert_allclose(tfe.standardize(xt[i], nft[i]).numpy(),
                                   np.asarray(jfe.standardize(x[i], nf[i])),
                                   rtol=1e-5, atol=1e-6)
    mean_t, std_t = tfe.cmvn_stats(xt, nft)
    mean_j, std_j = jfe.cmvn_stats(x, nf)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(std_t.numpy(), np.asarray(std_j), rtol=1e-5)
    np.testing.assert_allclose(tfe.apply_cmvn(xt, nft, mean_t, std_t).numpy(),
                               np.asarray(jfe.apply_cmvn(x, nf, mean_j, std_j)),
                               rtol=1e-5, atol=1e-5)


def test_mfcc_single_utterance_and_scratch_variant():
    cfg = FrontendConfig(variant="scratch")
    sigs, lengths, _ = _batch(9, [9000], 16000)
    for c in (PSF, cfg):
        f_j, n_j = jfe.mfcc39(sigs[0], lengths[0], c)
        f_t, n_t = tfe.mfcc39(torch.from_numpy(sigs[0]), int(lengths[0]), c)
        assert int(n_t) == int(n_j)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=2e-3, atol=5e-4)


def test_auto_gate_is_a_config_predicate():
    assert tfe.fused_supported(PSF, "utterance")
    assert tfe.fused_supported(PSF, "none")
    assert tfe.fused_supported(FrontendConfig(sample_rate=8000), "utterance")
    assert tfe.fused_supported(FrontendConfig(sample_rate=48000), "none")
    assert not tfe.fused_supported(PSF, "cmvn")
    assert not tfe.fused_supported(FrontendConfig(variant="scratch"), "utterance")
    assert not tfe.fused_supported(FrontendConfig(n_fft=1024), "utterance")
    # mel weight on the Nyquist bin (high_freq past the last bin edge)
    assert not tfe.fused_supported(dataclasses.replace(PSF, high_freq=8020.0), "utterance")
    # CPU tensors take the plain pipeline, and the kernel wrapper its plain version
    sigs, lengths, _ = _batch(1, [4000, 16000], 16000)
    st, lt = torch.from_numpy(sigs), torch.from_numpy(lengths)
    before = mfcc39_fused.launches
    a, na = tfe.mfcc39_auto(st, lt, PSF)
    b, nb = tfe.mfcc39_batch(st, lt, PSF)
    assert torch.equal(a, b) and torch.equal(na, nb)
    c, nc = mfcc39_fused(st, lt, PSF)
    d, nd = mfcc39_fused_ref(st, lt, PSF)
    assert torch.equal(c, d) and torch.equal(nc, nd)
    assert mfcc39_fused.launches == before


@pytest.mark.parametrize("norm", ["utterance", "none"])
def test_tail_of_cepstra_is_k3s_plain_version(norm):
    """K3 is K12's cepstra kernel followed by the tail kernel K14, whose
    plain version is ``_stack39``: the two plain versions composed equal
    K3's plain version exactly, and the reference ``mfcc39`` within rtol
    2e-3 / atol 5e-4 (raw features: one-sided delta rows at nf 1, 2 and
    3 included; standardized: nf 1 and >= 4, since at nf 2 and 3 a delta
    column is constant or nearly so and standardizing it only amplifies
    the two pipelines' rounding).  ``mfcc_tail`` takes ``_stack39`` for a
    CPU tensor and counts no launch."""
    sigs, lengths, _ = _batch(17, [16000, 300, 500, 700, 9000], 16000)
    st, lt = torch.from_numpy(sigs), torch.from_numpy(lengths)
    ceps, nf = mfcc_fused_ref(st, lt, PSF)
    assert nf.tolist()[1:4] == [1, 2, 3]
    want, nf_w = mfcc39_fused_ref(st, lt, PSF, norm=norm)
    before = mfcc_tail.launches
    for got in (tfe._stack39(ceps, nf, norm), mfcc_tail(ceps, nf, norm)):
        assert torch.equal(got, want) and torch.equal(nf, nf_w)
    assert mfcc_tail.launches == before
    f_j, nf_j = jfe.mfcc39_batch(sigs, lengths, PSF, norm=norm)
    np.testing.assert_array_equal(nf.numpy(), np.asarray(nf_j))
    rows = [0, 1, 4] if norm == "utterance" else list(range(5))
    f_j = np.asarray(f_j)[rows]
    scale = 1.0 if norm == "utterance" else np.abs(f_j).max(axis=(0, 1))
    np.testing.assert_allclose(want.numpy()[rows] / scale, f_j / scale, rtol=2e-3, atol=5e-4)

"""Port vs reference: isolated-word recognition.

* ``classify_batch`` / ``score_models`` (GMM-HMM bank) and
  ``dtw_classify_batch`` / ``dtw_score_models`` (single-Gaussian
  templates) against the reference: predictions equal, costs at rtol
  1e-5 (emission GEMMs sum in different orders);
* the pairwise distance helpers of ``ops.gmm`` and the bank helpers of
  ``models.hmm``;
* ``SyntheticDigits.isolated_corpus``: the same names and samples;
* K12's plain version (``ops.frontend._mfcc_batch``, reached through
  ``mfcc_fused`` on CPU tensors) against the reference's Pallas
  ``pallas_mfcc`` in interpret mode, at that test's own tolerance (rtol
  1e-4, atol 1e-3), frame counts equal;
* end to end: the reference CLI's and the port CLI's ``isolated_test``
  on the same wavs and bank print the same lines.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.data.synthetic import SyntheticDigits as JSynth
from speech_recognition_tpu.decode import dtw as jdtw
from speech_recognition_tpu.decode import isolated as jiso
from speech_recognition_tpu.models import hmm as jhmm
from speech_recognition_tpu.ops import gmm as jgmm
from speech_recognition_tpu_torch.data.synthetic import SyntheticDigits
from speech_recognition_tpu_torch.data.wav import write_wav
from speech_recognition_tpu_torch.decode import dtw as tdtw
from speech_recognition_tpu_torch.decode import isolated as tiso
from speech_recognition_tpu_torch.models import hmm as thmm
from speech_recognition_tpu_torch.ops import gmm as tgmm
from speech_recognition_tpu_torch.utils.checkpoint import save_bank
from tests.test_torch_gmm_hmm import bank_params, both_banks, close


def _feats(seed, b, t, d, nf):
    f = np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)
    return f, np.asarray(nf, np.int32)


@pytest.mark.parametrize("n_states,n_mix", [(5, 2), (3, 1)])
def test_classify_batch_matches_reference(n_states, n_mix):
    jb, tb = both_banks(31, n_models=6, n_states=n_states, n_mix=n_mix, dim=8)
    feats, nf = _feats(32, 7, 25, 8, [25, 1, 0, 9, 24, 2, 13])
    p_j, c_j = jiso.classify_batch(jb, jnp.asarray(feats), jnp.asarray(nf))
    p_t, c_t = tiso.classify_batch(tb, torch.from_numpy(feats), torch.from_numpy(nf))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    close(c_t, c_j)
    for b in (0, 3):
        close(tiso.score_models(tb, torch.from_numpy(feats[b]), int(nf[b])),
              jiso.score_models(jb, jnp.asarray(feats[b]), jnp.int32(nf[b])))


def test_dtw_classify_batch_matches_reference():
    rng = np.random.default_rng(33)
    n, s, d = 5, 4, 8
    means, _, _, trans = bank_params(34, n_models=n, n_states=s, n_mix=1, dim=d)
    means = means[:, :, 0]
    variances = rng.uniform(0.3, 1.2, (n, s, d)).astype(np.float32)
    jt = jdtw.stack_templates(list(zip(means, variances, trans)))
    tt = tdtw.stack_templates(list(zip(means, variances, trans)))
    assert torch.equal(tt.means, tdtw.TemplateBank.from_numpy(means, variances, trans).means)
    feats, nf = _feats(35, 6, 20, d, [20, 4, 0, 1, 17, 11])
    p_j, c_j = jdtw.dtw_classify_batch(jt, jnp.asarray(feats), jnp.asarray(nf))
    p_t, c_t = tdtw.dtw_classify_batch(tt, torch.from_numpy(feats), torch.from_numpy(nf))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    close(c_t, c_j)
    close(tdtw.dtw_score_models(tt, torch.from_numpy(feats[0]), 20),
          jdtw.dtw_score_models(jt, jnp.asarray(feats[0]), jnp.int32(20)))


def test_pairwise_helpers_and_bank_helpers_match():
    rng = np.random.default_rng(36)
    x = rng.standard_normal((9, 7)).astype(np.float32)
    mu = rng.standard_normal((5, 7)).astype(np.float32)
    var = rng.uniform(0.3, 1.5, (5, 7)).astype(np.float32)
    tx, tmu, tvar = map(torch.from_numpy, (x, mu, var))
    close(tgmm.mahalanobis(tx[:, None], tmu[None], tvar[None]),
          jgmm.mahalanobis(x[:, None], mu[None], var[None]))
    close(tgmm.pairwise_gaussian_nll(tx, tmu, tvar), jgmm.pairwise_gaussian_nll(x, mu, var))
    close(tgmm.pairwise_gaussian_nll(tx, tmu, tvar[0]),
          jgmm.pairwise_gaussian_nll(x, mu, var[0]))
    close(tgmm.pairwise_sq_euclidean(tx, tmu), jgmm.pairwise_sq_euclidean(x, mu), atol=1e-4)
    for n in (1, 5):
        np.testing.assert_array_equal(thmm.linear_init_cost(n), jhmm.linear_init_cost(n))
        np.testing.assert_array_equal(thmm.uniform_left_to_right_trans(n),
                                      jhmm.uniform_left_to_right_trans(n))


def test_isolated_corpus_matches_reference():
    got = SyntheticDigits(seed=4).isolated_corpus(2, tag="test")
    want = JSynth(seed=4).isolated_corpus(2, tag="test")
    assert [u.name for u in got] == [u.name for u in want] and len(got) == 22
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.samples, w.samples)


@pytest.mark.parametrize("rate", [16000, 8000])
def test_k12_plain_matches_pallas_mfcc(rate):
    """As ``tests/test_banded.py`` runs ``pallas_mfcc``: interpret mode."""
    import jax.experimental.pallas as pl

    import speech_recognition_tpu.ops.pallas_kernels as pk
    from speech_recognition_tpu.config import FrontendConfig as JConfig
    from speech_recognition_tpu_torch.config import FrontendConfig
    from speech_recognition_tpu_torch.ops.frontend import mfcc, padded_length
    from speech_recognition_tpu_torch.ops.frontend_kernel import mfcc_fused

    orig = pl.pallas_call

    def interp(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    cfg = FrontendConfig(sample_rate=rate)
    n = [rate // 2, 5321 * rate // 16000, 300]
    sig = np.zeros((3, padded_length(cfg, max(n))), np.float32)
    rng = np.random.default_rng(37)
    for i in range(3):
        sig[i, : n[i]] = rng.standard_normal(n[i]) * 2000
    pk.pl.pallas_call = interp
    try:
        ceps_j, nf_j = pk.pallas_mfcc(jnp.asarray(sig), jnp.asarray(np.asarray(n, np.int32)),
                                      JConfig(sample_rate=rate))
    finally:
        pk.pl.pallas_call = orig
    ceps_t, nf_t = mfcc_fused(torch.from_numpy(sig), torch.tensor(n, dtype=torch.int32), cfg)
    np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf_j))
    np.testing.assert_allclose(ceps_t.numpy(), np.asarray(ceps_j), rtol=1e-4, atol=1e-3)
    one, n1 = mfcc(torch.from_numpy(sig[1]), n[1], cfg)
    assert int(n1) == int(nf_t[1]) and torch.equal(one, ceps_t[1])


@pytest.mark.parametrize("n_mix,sil", [(2, True), (1, False)])
def test_cli_isolated_test_matches_reference(tmp_path, capsys, n_mix, sil):
    """A GMM bank with a silence model (left out of the classification)
    and a one-mixture template-kind bank, on 22 synthetic digit wavs."""
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    data = tmp_path / "data"
    data.mkdir()
    for u in SyntheticDigits(seed=5).isolated_corpus(2, tag="test"):
        write_wav(os.path.join(data, u.name), u.samples)
    n_models = 12 if sil else 11
    bank = thmm.HMMBank.from_numpy(*bank_params(38, n_models=n_models, n_states=5,
                                                n_mix=n_mix, dim=39, sep=1.0))
    meta = {"norm": "utterance", "kind": "isolated" if n_mix > 1 else "template"}
    if sil:
        meta["silence_index"] = 11
    path = str(tmp_path / "bank.npz")
    save_bank(path, bank, meta)
    capsys.readouterr()
    jmain(["isolated_test", "-i", path, "-d", str(data)])
    ref = capsys.readouterr().out
    tmain(["isolated_test", "-i", path, "-d", str(data), "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref
    assert got.splitlines()[-1].replace(".", "").isdigit()

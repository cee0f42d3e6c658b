"""Port vs reference: the native wav loader, the prefetching pipeline,
the CLI's chunked featurization and microphone capture.

* ``runtime.loader.load_wav_batch`` (the port's own ``wav_loader.cc``,
  built with g++ into ``_build/``) against the scipy reading
  ``data.wav.load_wav_batch`` and the reference's native loader: samples,
  lengths and rates equal, truncation, zero tails, one thread or eight, a
  bad file raising, a failed build raising;
* ``PrefetchWavBatches`` chunk for chunk against one batch, and stopping
  its worker when the consumer leaves early;
* the CLI's ``_featurize_files`` through 4-file chunks (the tail padded
  and dropped) against one batch, and ``connected_test --device cpu`` over
  more files than one chunk against the reference CLI;
* ``data.capture.record`` and ``cli record`` raising without pyaudio, as
  the reference's do.
"""

import os

import numpy as np
import pytest
import torch

from speech_recognition_tpu.runtime.loader import load_wav_batch as j_load
from speech_recognition_tpu_torch.data.synthetic import SyntheticDigits
from speech_recognition_tpu_torch.data.wav import load_wav_batch as scipy_load
from speech_recognition_tpu_torch.data.wav import write_wav
from speech_recognition_tpu_torch.runtime import loader


@pytest.fixture(scope="module")
def wav_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    gen = SyntheticDigits(seed=1)
    paths = []
    for u in gen.isolated_corpus(2, tag="rt") + gen.continuous_corpus(4, tag="rt"):
        p = os.path.join(d, u.name)
        write_wav(p, u.samples)
        paths.append(p)
    return paths


def test_native_loader_builds_into_the_build_dir():
    lib = loader._library()
    path = loader.library_path()
    assert os.path.exists(path) and os.path.dirname(path).endswith("_build")
    assert lib.load_wav_batch is not None


@pytest.mark.parametrize("cap", [60000, 1000])
def test_batch_matches_scipy_and_reference(wav_paths, cap):
    """Every sample, length and rate equal to the scipy path and to the
    reference's native loader; a short cap truncates; tails are zeros."""
    out, lengths, rates = loader.load_wav_batch(wav_paths, cap)
    assert out.shape == (len(wav_paths), cap) and out.dtype == np.float32
    for want in (scipy_load(wav_paths, cap), j_load(wav_paths, cap)):
        for g_, w_ in zip((out, lengths, rates), want):
            np.testing.assert_array_equal(g_, w_)
    for i in range(len(wav_paths)):
        assert np.all(out[i, lengths[i]:] == 0)
    if cap == 1000:
        assert (lengths == 1000).all()


def test_multichannel_and_8k_files(tmp_path):
    """A stereo file keeps its first channel; rates come through."""
    from scipy.io import wavfile

    rng = np.random.default_rng(3)
    stereo = (rng.standard_normal((700, 2)) * 3000).astype(np.int16)
    wavfile.write(str(tmp_path / "s.wav"), 8000, stereo)
    write_wav(str(tmp_path / "m.wav"), stereo[:, 1], 8000)
    paths = [str(tmp_path / "s.wav"), str(tmp_path / "m.wav")]
    got = loader.load_wav_batch(paths, 900)
    for g_, w_ in zip(got, scipy_load(paths, 900)):
        np.testing.assert_array_equal(g_, w_)
    assert (got[2] == 8000).all()


def test_bad_file_raises(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(IOError, match="bad.wav"):
        loader.load_wav_batch([str(bad)], 1000)
    with pytest.raises(IOError, match="missing.wav"):
        loader.load_wav_batch([str(tmp_path / "missing.wav")], 1000)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with its output; nothing falls back."""
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_SRC", str(src))
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "_build"))
    loader._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            loader.load_wav_batch([str(src)], 10)
    finally:
        loader._library.cache_clear()


def test_multithreaded_same_result(wav_paths):
    a = loader.load_wav_batch(wav_paths, 30000, n_threads=1)
    b = loader.load_wav_batch(wav_paths, 30000, n_threads=8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _random_wavs(tmp_path, n, seed=4):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        sig = (rng.standard_normal(int(rng.integers(100, 900))) * 3000).astype(np.int16)
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, sig, 8000)
        paths.append(p)
    return paths


def test_prefetch_batches_match_single_batch(tmp_path):
    paths = _random_wavs(tmp_path, 11)
    whole = loader.load_wav_batch(paths, 1024)
    got_paths, i = [], 0
    for chunk, samples, lengths, rates in loader.PrefetchWavBatches(paths, 4, 1024):
        got_paths.extend(chunk)
        n = len(chunk)
        for g_, w_ in zip((samples, lengths, rates), whole):
            np.testing.assert_array_equal(g_, w_[i:i + n])
        i += n
    assert got_paths == paths


def test_prefetch_surfaces_errors_and_stops_early(tmp_path):
    paths = _random_wavs(tmp_path, 9)
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF....WAVEjunk")
    with pytest.raises(IOError, match="bad.wav"):
        for _ in loader.PrefetchWavBatches(paths[:4] + [str(bad)] + paths[4:], 4, 1024):
            pass
    it = iter(loader.PrefetchWavBatches(paths, 2, 1024, depth=1))
    next(it)
    it.close()  # the worker thread is joined, not left blocked on the queue


def test_cli_featurize_chunks_match_one_batch(tmp_path):
    """``_featurize_files`` in 4-file chunks (9 files: the tail chunk
    padded with the first file, its rows dropped) equals one batch: frame
    counts equal, features within 1e-6 (the plain frontend's CPU GEMMs
    block their sums by batch size: measured 2.4e-7, two ulps at 1)."""
    from speech_recognition_tpu_torch.cli import _featurize_files
    from speech_recognition_tpu_torch.config import FrontendConfig

    gen = SyntheticDigits(seed=6)
    paths = []
    for i, u in enumerate(gen.isolated_corpus(1)[:9]):
        p = str(tmp_path / f"{i}_{u.name}")
        write_wav(p, u.samples, 16000)
        paths.append(p)
    cpu = torch.device("cpu")
    f1, n1 = _featurize_files(paths, FrontendConfig(), 40000, cpu, chunk=10 ** 9)
    f2, n2 = _featurize_files(paths, FrontendConfig(), 40000, cpu, chunk=4)
    assert torch.equal(n1, n2) and f1.shape == f2.shape == (9,) + f1.shape[1:]
    torch.testing.assert_close(f2, f1, rtol=0, atol=1e-6)


def test_cli_connected_test_over_chunks_matches_reference(tmp_path, capsys, monkeypatch):
    """More wavs than one chunk (the chunk lowered to 5 in both CLIs):
    the port's ``connected_test --device cpu`` prints the reference's
    lines."""
    from speech_recognition_tpu import cli as jcli
    from speech_recognition_tpu_torch import cli as tcli
    from speech_recognition_tpu_torch.models.hmm import HMMBank
    from speech_recognition_tpu_torch.utils.checkpoint import save_bank
    from tests.test_torch_gmm_hmm import bank_params

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for u in SyntheticDigits(seed=2).continuous_corpus(12, tag="ck"):
        write_wav(str(wav_dir / u.name), u.samples)
    bank = str(tmp_path / "bank.npz")
    save_bank(bank, HMMBank.from_numpy(*bank_params(5, n_models=11, n_states=3, n_mix=2,
                                                    dim=39)), {"norm": "utterance"})
    for mod in (jcli, tcli):
        orig = mod._featurize_files
        monkeypatch.setattr(mod, "_featurize_files",
                            lambda *a, _o=orig, **k: _o(*a, **{**k, "chunk": 5}))
    jcli.main(["connected_test", "-i", bank, "-d", str(wav_dir)])
    ref = capsys.readouterr().out
    tcli.main(["connected_test", "-i", bank, "-d", str(wav_dir), "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == ref and got.count("orrect:") == 12


def test_record_raises_without_pyaudio(tmp_path):
    from speech_recognition_tpu_torch.cli import main
    from speech_recognition_tpu_torch.data import capture

    if capture.HAVE_PYAUDIO:
        pytest.skip("pyaudio is installed: recording needs a microphone")
    with pytest.raises(RuntimeError, match="pyaudio"):
        capture.record(str(tmp_path / "x.wav"))
    with pytest.raises(RuntimeError, match="pyaudio"):
        main(["record", "-o", str(tmp_path / "x.wav"), "--device", "cpu"])

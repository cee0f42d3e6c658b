"""Port vs reference: forced alignment.

* ``transcript_graph`` (with and without optional silence) and
  ``pad_graphs``: identical arrays;
* ``align_batch`` (K11's plain version with per-utterance graphs, then
  the backtrace): state ids equal, costs at rtol 1e-5 (emission GEMMs
  sum in different orders); ``harvest_state_ids`` equal;
* end to end: the reference CLI's and the port CLI's ``align`` on the
  same wavs and bank write the same word segments, with costs at rtol
  1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_recognition_tpu.models import graph as jgraph
from speech_recognition_tpu.train import continuous as jcont
from speech_recognition_tpu_torch.data.synthetic import SyntheticDigits
from speech_recognition_tpu_torch.data.wav import write_wav
from speech_recognition_tpu_torch.models import graph as tgraph
from speech_recognition_tpu_torch.models.hmm import HMMBank
from speech_recognition_tpu_torch.train import continuous as tcont
from speech_recognition_tpu_torch.utils.checkpoint import save_bank
from tests.test_torch_gmm_hmm import bank_params, both_banks, close

TRANSCRIPTS = [[0, 3, 3, 1], [2], [1, 0], [3, 2, 1]]
KEYS = ("trans", "eps_trans", "init_cost", "end_states", "bank_state")


def _graphs(trans, sil, edge_sil=True):
    kw = dict(sil=sil, edge_sil=edge_sil)
    return ([jgraph.transcript_graph(trans, ls, **kw) for ls in TRANSCRIPTS],
            [tgraph.transcript_graph(trans, ls, **kw) for ls in TRANSCRIPTS])


@pytest.mark.parametrize("sil,edge_sil", [(None, True), (4, True), (4, False)])
def test_transcript_graph_and_pad_graphs_match(sil, edge_sil):
    jb, _ = both_banks(41, n_models=5, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(5)]
    gj, gt = _graphs(trans, sil, edge_sil)
    for a, b in zip(gj, gt):
        for f in ("trans", "eps_trans", "init_cost", "end_states", "end_bonus", "bank_state",
                  "slot", "slot_label", "slot_layer", "state_in_word"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
        assert b.eps_depth == a.eps_depth
    (pj, dj), (pt, dt) = jgraph.pad_graphs(gj), tgraph.pad_graphs(gt)
    assert dt == dj and sorted(pt) == sorted(pj)
    for k in pj:
        assert pt[k].dtype == pj[k].dtype, k
        np.testing.assert_array_equal(pt[k], pj[k])


@pytest.mark.parametrize("sil", [None, 4])
def test_align_batch_matches_reference(sil):
    jb, tb = both_banks(42, n_models=5, n_states=3, n_mix=2, dim=6)
    trans = [np.asarray(jb.trans_cost[i]) for i in range(5)]
    gj, _ = _graphs(trans, sil)
    batch, depth = jgraph.pad_graphs(gj)
    rng = np.random.default_rng(43)
    feats = rng.standard_normal((4, 40, 6)).astype(np.float32)
    nf = np.asarray([40, 12, 27, 33], np.int32)
    ids_j, c_j = jcont.align_batch(jb, jnp.asarray(feats), jnp.asarray(nf),
                                   *(jnp.asarray(batch[k]) for k in KEYS), eps_depth=depth)
    ids_t, c_t = tcont.align_batch(tb, torch.from_numpy(feats), torch.from_numpy(nf),
                                   *(torch.from_numpy(batch[k]) for k in KEYS),
                                   eps_depth=depth)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    close(c_t, c_j)
    for got, want in zip(tcont.harvest_state_ids(ids_t.numpy()),
                         jcont.harvest_state_ids(np.asarray(ids_j))):
        np.testing.assert_array_equal(got, want)


def test_cli_align_matches_reference(tmp_path, capsys):
    """Connected-digit wavs, a 12-model bank whose model 11 is silence
    (optional between and around the words)."""
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    data = tmp_path / "data"
    data.mkdir()
    for u in SyntheticDigits(seed=6).continuous_corpus(6, max_len=4, tag="align"):
        write_wav(os.path.join(data, u.name), u.samples)
    bank = HMMBank.from_numpy(*bank_params(44, n_models=12, n_states=5, n_mix=2, dim=39,
                                           sep=1.0))
    path = str(tmp_path / "bank.npz")
    save_bank(path, bank, {"norm": "utterance", "silence_index": 11})
    out_j, out_t = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    jmain(["align", "-i", path, "-d", str(data), "-o", out_j])
    tmain(["align", "-i", path, "-d", str(data), "-o", out_t, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1].replace(out_t, out_j)
    with open(out_j) as fj, open(out_t) as ft:
        rj, rt = [json.loads(x) for x in fj], [json.loads(x) for x in ft]
    assert len(rt) == len(rj) == 6
    for a, b in zip(rj, rt):
        assert (b["file"], b["segments"]) == (a["file"], a["segments"])
        np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-5)
    assert any(s["word"] == "sil" for r in rt for s in r["segments"])

"""Port vs reference: the spell checker (``langmodel/spellcheck.py``).

* ``text_viterbi`` (the per-string column loop) against the reference's
  on its own oracle cases and on misspellings of repo-built word lists:
  cost and matched string equal, and the cost equal to the float oracle
  ``tests/oracles/text_ref.py``;
* ``text_viterbi_batch`` (the depth-sorted level sweep over ``[N, B]``)
  against the reference's batched form: costs and strings equal, and the
  costs equal to the per-string DP's;
* ``SpellChecker`` (whole words from the leaves on the path) against the
  reference's, and its stored, unused ``beam``;
* ``cli spellcheck --device cpu`` against the reference CLI: the same
  lines, with ``-t``, ``-f`` and stdin, and the CSV header rule.

Word lists come from ``data/lexicon.py`` and the reference's test words;
misspellings from numpy seeds.
"""

import io
import sys

import numpy as np
import pytest

from speech_recognition_tpu.langmodel import spellcheck as jsc
from speech_recognition_tpu.langmodel.lextree import lextree_from_words as j_lextree
from speech_recognition_tpu_torch.data.lexicon import random_words
from speech_recognition_tpu_torch.langmodel import spellcheck as tsc
from speech_recognition_tpu_torch.langmodel.lextree import lextree_from_words as t_lextree
from tests.oracles.text_ref import text_viterbi_oracle

WORDS = ["cat", "car", "card", "care", "dog", "do", "door", "a", "an", "and"]
TEXTS = ["cat", "cta", "carrd", "dog and cat", "doog", "xyz", "cardcare"]


def misspell(words, n, seed):
    """``n`` strings of 1-3 dictionary words with one edit each (a
    substitution, deletion or insertion of a letter), from a numpy seed."""
    rng = np.random.default_rng(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    out = []
    for _ in range(n):
        ws = [words[int(i)] for i in rng.integers(0, len(words), int(rng.integers(1, 4)))]
        s = list(" ".join(ws))
        i = int(rng.integers(0, len(s)))
        op = int(rng.integers(0, 3))
        if op == 0:
            s[i] = letters[int(rng.integers(0, 26))]
        elif op == 1 and len(s) > 1:
            del s[i]
        else:
            s.insert(i, letters[int(rng.integers(0, 26))])
        out.append("".join(s).strip() or ws[0])
    return out


def word_list(kind):
    if kind == "reference words":
        return WORDS
    return random_words(np.random.default_rng(12), list("abcdefgh"), 200, 2, 7)


@pytest.mark.parametrize("text", TEXTS)
def test_text_viterbi_matches_reference_and_oracle(text):
    jt, tt = j_lextree(list(WORDS)), t_lextree(list(WORDS))
    cost, matched = tsc.text_viterbi(text, tt, device="cpu")
    r_cost, r_matched = jsc.text_viterbi(text, jt)
    _, o_cost = text_viterbi_oracle(text, tt.val, tt.parent, tt.prop)
    assert (cost, matched) == (float(r_cost), r_matched)
    assert cost == o_cost


@pytest.mark.parametrize("kind", ["reference words", "random 200"])
def test_text_viterbi_on_misspellings_matches_reference(kind):
    words = word_list(kind)
    jt, tt = j_lextree(list(words)), t_lextree(list(words))
    texts = misspell(words, 12, seed=len(words))
    for text in texts:
        r_cost, r_matched = jsc.text_viterbi(text, jt)
        assert tsc.text_viterbi(text, tt, device="cpu") == (float(r_cost), r_matched), text


@pytest.mark.parametrize("kind", ["reference words", "random 200"])
def test_text_viterbi_batch_matches_reference(kind):
    """The level sweep against the reference's batched form (strings and
    costs) and against the per-string DP (costs; the paths may differ only
    between exact-cost ties)."""
    words = word_list(kind)
    jt, tt = j_lextree(list(words)), t_lextree(list(words))
    texts = TEXTS + misspell(words, 20, seed=3)
    got = tsc.text_viterbi_batch(texts, tt, device="cpu")
    ref = jsc.text_viterbi_batch(texts, jt)
    assert [(float(c), m) for c, m in got] == [(float(c), m) for c, m in ref]
    for text, (c, _) in zip(texts, got):
        assert c == tsc.text_viterbi(text, tt, device="cpu")[0]


def test_level_plan_matches_reference():
    words = word_list("random 200")
    jp, tp = jsc._LevelPlan(j_lextree(words)), tsc._LevelPlan(t_lextree(words))
    for f in ("perm", "inv", "val", "parent", "is_word_end", "is_root_child"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    assert (tp.off, tp.max_depth, tp.n, tp.space) == (jp.off, jp.max_depth, jp.n, jp.space)


@pytest.mark.parametrize("kind", ["reference words", "random 200"])
def test_spell_checker_matches_reference(kind):
    words = word_list(kind)
    jsp = jsc.SpellChecker().fit(words)
    tsp = tsc.SpellChecker(beam=5, device="cpu").fit(words)
    assert tsp.beam == 5
    texts = TEXTS + ["czrd", "cat cat", "at"] + misspell(words, 10, seed=9)
    for text in texts:
        assert tsp.spell_check(text) == jsp.spell_check(text), text
    if kind == "reference words":
        assert tsp.spell_check("dog and cat") == "dog and cat"
        assert tsp.spell_check("czrd") == "card"
    with pytest.raises(ValueError, match="fit"):
        tsc.SpellChecker(device="cpu").spell_check("cat")


def _run(main, argv, stdin=None, capsys=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main(argv)
    return capsys.readouterr().out


def test_cli_spellcheck_matches_reference(tmp_path, capsys, monkeypatch):
    """``-t``, ``-f`` and stdin, a plain word list and the CSV form whose
    first line is ``words``: the port prints the reference's lines."""
    from speech_recognition_tpu.cli import main as jmain
    from speech_recognition_tpu_torch.cli import main as tmain

    words = word_list("random 200")
    plain = tmp_path / "dict.txt"
    plain.write_text("\n".join(words) + "\n")
    csv = tmp_path / "dict.csv"
    csv.write_text("words\n" + "\n".join(w.upper() for w in WORDS) + "\n\n")
    lines = misspell(words, 6, seed=21)
    text_file = tmp_path / "text.txt"
    text_file.write_text("\n".join(lines + ["", "  " + lines[0].upper() + "  "]) + "\n")
    cases = [(["-d", str(plain), "-f", str(text_file)], None),
             (["-d", str(plain), "-t", lines[1]], None),
             (["-d", str(csv), "-t", "dog and cta"], None),
             (["-d", str(csv)], "carrd\ndoog\n")]
    for argv, stdin in cases:
        ref = _run(jmain, ["spellcheck", *argv], stdin, capsys, monkeypatch)
        got = _run(tmain, ["spellcheck", *argv, "--device", "cpu"], stdin, capsys,
                   monkeypatch)
        assert got == ref and got.strip(), argv
    empty = tmp_path / "empty.txt"
    empty.write_text("words\n")
    with pytest.raises(SystemExit, match="no words"):
        tmain(["spellcheck", "-d", str(empty), "-t", "x", "--device", "cpu"])

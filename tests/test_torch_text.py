"""The port's copies of the text layer held bitwise to their JAX sources:
``text/converters/`` (each converter's ``convert``), ``text/normalize.py``,
``text/arabic_numbers.py``, ``text/word_tokenizer.py`` and the clean
stage's ``standardize_text`` / ``standardize_text_english``.

Inputs: the JAX tests' own cases (the parametrised tokens of
tests/test_converters.py, tests/test_converters_edge.py and
tests/test_normalize.py, and the ``CASES`` and seeded ``GENERATORS`` of
tests/test_converters_reference_parity.py), and strings from a seeded
numpy generator that mixes Arabic letters and tashkeel, digits, Latin
letters, punctuation and whitespace. Every function must return what its
source returns, or raise the same exception with the same message.
"""

import importlib.util
import json
import os
import random

import numpy as np
import pytest

from pl_bert_tpu.preprocess import pipeline as jpipe
from pl_bert_tpu.text import arabic_numbers as jnum
from pl_bert_tpu.text import normalize as jnorm
from pl_bert_tpu.text import word_tokenizer as jtok
from pl_bert_tpu.text.converters import labels as jlabels
from pl_bert_tpu_torch.preprocess import pipeline as pipe
from pl_bert_tpu_torch.text import arabic_numbers as num
from pl_bert_tpu_torch.text import normalize as norm
from pl_bert_tpu_torch.text import word_tokenizer as tok
from pl_bert_tpu_torch.text.converters import labels

TESTS = os.path.dirname(os.path.abspath(__file__))
ARABIC = "".join(chr(c) for c in range(0x0621, 0x064B))
TASHKEEL = "".join(chr(c) for c in range(0x064B, 0x0653))
PUNCT = ".,!?;:،؟؛«»()-\"'…"
POOLS = [ARABIC, TASHKEEL, "0123456789٠١٢٣٤٥٦٧٨٩", "abcdefghijklmnopqrstuvwxyzABCXYZ",
         PUNCT, "  \t\n", "\x00​ $%/&#@½"]
WEIGHTS = np.array([40, 6, 10, 10, 10, 14, 2], float) / 92


def _module(name: str):
    """A JAX test module, imported from its file for its cases."""
    spec = importlib.util.spec_from_file_location(f"_cases_{name}",
                                                  os.path.join(TESTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parametrized_strings(mod) -> list[str]:
    """Every string among the parametrize values of ``mod``'s tests."""
    out = []
    for obj in vars(mod).values():
        for mark in getattr(obj, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            for value in mark.args[1]:
                values = value if isinstance(value, tuple) else (value,)
                out += [v for v in values if isinstance(v, str)]
    return out


def _random_strings(seed: int, n: int, longest: int = 60) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pools = rng.choice(len(POOLS), size=rng.integers(0, longest), p=WEIGHTS)
        out.append("".join(POOLS[p][rng.integers(len(POOLS[p]))] for p in pools))
    return out


def _tokens() -> list[str]:
    parity = _module("test_converters_reference_parity")
    toks = [t for cases in parity.CASES.values() for t in cases]
    for name, gen in sorted(parity.GENERATORS.items()):
        rng = random.Random(f"port-{name}")
        toks += [gen(rng) for _ in range(60)]
    for name in ("test_converters", "test_converters_edge", "test_normalize"):
        toks += _parametrized_strings(_module(name))
    words = [w for s in _random_strings(1, 200, 12) for w in s.split()]
    return sorted(set(toks + words))


TOKENS = _tokens()
TEXTS = _random_strings(0, 400) + [
    "عام 1986 كان", "19 و 1986", "مرحبا hello بالعالم", "مَرْحَبًا", "الشَّدَّة", "a.b",
    "مرحبا، بالعالم!", "café naïve", "a\x00b�c", "a\tb\nc",
    "hello (23 Jan 2020, 12:10 AM)", "It costs $3.50 on 5th May, 1999 at 10:05 pm.",
]


def _outcome(fn, *args):
    """A call's value, or its exception's type and message."""
    try:
        return ("value", fn(*args))
    except Exception as e:  # noqa: BLE001 — the exception is the outcome compared
        return ("raises", type(e).__name__, str(e))


def test_every_token_case_is_harvested():
    assert len(TOKENS) > 1000 and "1,234,567" in TOKENS and "12:10 AM" in TOKENS


@pytest.mark.parametrize("label", sorted(jlabels))
def test_converter_matches_jax(label):
    """``convert`` of converter ``label`` on every case token."""
    assert sorted(labels) == sorted(jlabels)
    mine, ref = labels[label], jlabels[label]
    bad = [(t, got, want) for t in TOKENS
           if (got := _outcome(mine.convert, t)) != (want := _outcome(ref.convert, t))]
    assert not bad, bad[:5]


@pytest.mark.parametrize("name", [
    "clean_text", "convert_numbers_to_arabic_words", "filter_non_arabic_words",
    "remove_diacritics", "separate_words_and_punctuation", "remove_accents",
    "normalize_single", "normalize_text",
])
def test_normalize_function_matches_jax(name):
    mine, ref = getattr(norm, name), getattr(jnorm, name)
    bad = [(t, got, want) for t in TEXTS
           if (got := _outcome(mine, t)) != (want := _outcome(ref, t))]
    assert not bad, bad[:5]


@pytest.mark.parametrize("name", ["standardize_text", "standardize_text_english"])
def test_clean_stage_function_matches_jax(name):
    mine, ref = getattr(pipe, name), getattr(jpipe, name)
    bad = [(t, got, want) for t in TEXTS
           if (got := _outcome(mine, t)) != (want := _outcome(ref, t))]
    assert not bad, bad[:5]


def test_arabic_number_words_match_jax():
    rng = np.random.default_rng(2)
    ns = [0, 1, 2, 3, 10, 11, 12, 19, 20, 99, 100, 101, 200, 999, 1000, 2000, 3000, 10**6,
          2 * 10**6, 10**9, 10**12, -5, -1986, 1986]
    ns += rng.integers(-10**4, 10**4, 300).tolist() + (10 ** rng.uniform(0, 15, 300)).astype(
        np.int64).tolist()
    bad = [(n, got, want) for n in ns
           if (got := _outcome(num.arabic_number_words, n))
           != (want := _outcome(jnum.arabic_number_words, n))]
    assert not bad, bad[:5]


@pytest.mark.parametrize("mode", ["whitespace", "words_and_punctuation"])
def test_word_tokenizer_matches_jax(tmp_path, mode):
    """The vocabulary (capped below the corpus's distinct words), the ids,
    the decoded text and the saved files byte for byte, and a load of
    each package's files by the other."""
    corpus = TEXTS + ["[UNK] [MASK] كلمة كلمة كلمة"]
    mine = tok.create_word_tokenizer(corpus, vocab_size=300, output_dir=str(tmp_path / "port"),
                                     split_mode=mode)
    ref = jtok.create_word_tokenizer(corpus, vocab_size=300, output_dir=str(tmp_path / "jax"),
                                     split_mode=mode)
    assert mine.vocab == ref.vocab and mine.vocab_size == ref.vocab_size == 300
    for name in ("tokenizer.json", "vocab.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    for t in TEXTS:
        assert mine.encode(t) == ref.encode(t)
        assert mine.decode(mine.encode(t)) == ref.decode(ref.encode(t))
    crossed = tok.WordTokenizer.load(str(tmp_path / "jax"))
    assert crossed.vocab == ref.vocab and crossed.split_mode == mode
    assert jtok.WordTokenizer.load(str(tmp_path / "port")).vocab == mine.vocab
    assert json.loads((tmp_path / "port" / "tokenizer.json").read_text())["split_mode"] == mode


def test_text_package_exports_match_jax():
    """``pl_bert_tpu_torch.text`` exports what ``pl_bert_tpu.text`` does."""
    import pl_bert_tpu.text as jtext
    import pl_bert_tpu_torch.text as text

    for name in ("LATIN_LETTERS", "LETTERS_IPA", "PAD", "PHONEME_MASK", "PHONEME_SEPARATOR",
                 "PUNCTUATION", "UNKNOWN", "symbols"):
        assert getattr(text, name) == getattr(jtext, name), name
    assert text.CharacterIndexer()("abc") == jtext.CharacterIndexer()("abc")

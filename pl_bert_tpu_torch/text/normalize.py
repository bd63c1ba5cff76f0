"""Text normalization / cleaning layer (L1).

Behavioral parity with the reference normalization layer
(reference: text_normalize.py:77-293):

- Unicode cleanup (control-char removal, whitespace canonicalization)
- Arabic pipeline: digits → Arabic number words, Arabic-only word filter,
  tashkeel (diacritic) stripping
- punctuation/word splitting against the shared PUNCTUATION set
- the English token-class router (``normalize_text``) — which in the
  reference is dead code because it calls an undefined ``remove_accents``
  (reference: text_normalize.py:282); implemented working here.

A copy of ``pl_bert_tpu/text/normalize.py`` (1-233).
"""

from __future__ import annotations

import functools
import re
import unicodedata

from pl_bert_tpu_torch.text.converters import labels
from pl_bert_tpu_torch.text.arabic_numbers import arabic_number_words
from pl_bert_tpu_torch.text.symbols import PUNCTUATION


def is_whitespace(char: str) -> bool:
    if char in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(char) == "Zs"


def is_control(char: str) -> bool:
    if char in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(char) in ("Cc", "Cf")


class _CleanTable(dict):
    """Lazily-populated codepoint→replacement map for ``str.translate``.

    ``clean_text`` is a pure per-character map, so the Cc/Cf/Zs category
    decision is computed once per distinct codepoint (``__missing__``)
    and the hot loop runs inside ``str.translate``'s C implementation —
    ~15x faster than the per-char Python loop on corpus-scale input,
    bit-identical output (pinned by the randomized differential parity
    test vs the reference in tests/test_normalize_reference_parity.py).
    """

    def __missing__(self, cp: int):
        char = chr(cp)
        if cp == 0 or cp == 0xFFFD or is_control(char):
            out = None  # drop
        elif is_whitespace(char):
            out = " "
        else:
            out = cp  # identity
        self[cp] = out
        return out


_CLEAN_TABLE = _CleanTable()


def clean_text(text: str) -> str:
    """Drop NUL/replacement/control chars; canonicalize whitespace to ' '
    (reference: text_normalize.py:77-110)."""
    return text.translate(_CLEAN_TABLE)


_DIGITS = re.compile(r"\d+")


def _verbalize_digit_run(m: "re.Match[str]") -> str:
    num = m.group()
    try:
        return arabic_number_words(int(num))
    except (ValueError, NotImplementedError):
        return num  # e.g. a huge ID beyond the engine's scales keeps digits


def convert_numbers_to_arabic_words(text: str) -> str:
    """Replace every maximal digit run with its Arabic verbalization
    (reference: text_normalize.py:112-134).

    Single ``\\d+`` pass with a callback. Equivalent to the reference's
    longest-first per-number ``re.sub`` with ``(?<!\\d)…(?!\\d)`` anchors:
    ``\\d+`` matches are exactly the maximal runs those anchors select,
    and verbalizations contain no digit characters, so no pass can create
    or split a run another pass would see differently (equivalence fuzz:
    tests/test_normalize.py::test_convert_numbers_single_pass_equivalence).
    The reference's per-number dynamic patterns also thrash ``re``'s
    512-entry compile cache at corpus scale — the hot-loop motivation.
    """
    return _DIGITS.sub(_verbalize_digit_run, text)


_ARABIC_WORD = re.compile(
    r"^[؀-ۿݐ-ݿࢠ-ࣿ٠-٩]+$"
)


@functools.lru_cache(maxsize=65536)
def _is_arabic_word(word: str) -> bool:
    return _ARABIC_WORD.fullmatch(word) is not None


def filter_non_arabic_words(text: str) -> str:
    """Keep only words made entirely of Arabic-block characters
    (reference: text_normalize.py:136-152). The per-word check is
    memoized — natural-language word frequency is Zipfian, so the
    corpus-scale loop mostly cache-hits."""
    return " ".join(w for w in text.split() if _is_arabic_word(w))


# The nine tashkeel marks: tanween (fath/damm/kasr), fatha, damma, kasra,
# shadda, sukoon, superscript alef.
_TASHKEEL = re.compile("[ً-ْٰ]")


def remove_diacritics(text: str) -> str:
    return _TASHKEEL.sub("", text)


_PUNCT_CLASS = re.escape("".join(PUNCTUATION))
_TOKEN_SPLIT = re.compile(f"([{_PUNCT_CLASS}])|([^\\s{_PUNCT_CLASS}]+)")


def separate_words_and_punctuation(text: str) -> list[str]:
    """Tokenize into words and standalone punctuation marks."""
    return [a if a else b for a, b in _TOKEN_SPLIT.findall(text)]


def remove_accents(text: str) -> str:
    """Strip combining marks ("café" → "cafe")."""
    decomposed = unicodedata.normalize("NFD", text)
    return "".join(c for c in decomposed if unicodedata.category(c) != "Mn")


# ---------------------------------------------------------------------------
# English token-class router (vestigial in the reference fork, kept for
# capability parity; reference: text_normalize.py:217-293)
# ---------------------------------------------------------------------------

MONTHS = frozenset(
    [
        "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "oct",
        "nov", "dec", "january", "february", "march", "april", "june",
        "july", "august", "september", "october", "november", "december",
    ]
)


def _has_numbers(s: str) -> bool:
    return any(c.isdigit() for c in s)


def _has_month(s: str) -> bool:
    return s.lower() in MONTHS or s == "May"


def normalize_single(text: str, prev_text: str = "", next_text: str = "") -> str:
    """Route one token to a converter by shape + neighbor context."""
    if "//" in text or ".com" in text or ".html" in text:
        text = labels["ELECTRONIC"].convert(text).upper()
    elif _has_numbers(text):
        if _has_month(prev_text):
            # month stays its own token; emit only the converted day part
            month = labels["DATE"].get_month(prev_text.lower())
            text = labels["DATE"].convert(f"{month} {text}").replace(month, "").strip()
        elif _has_month(next_text):
            month = labels["DATE"].get_month(next_text.lower())
            text = labels["DATE"].convert(f"{text} {month}").replace(month, "").strip()
        elif text.endswith(("th", "nd", "st", "rd")):
            text = labels["ORDINAL"].convert(text)
        elif ":" in text:
            text = labels["TIME"].convert(text)
        elif text.startswith(("$", "€", "£", "¥")):
            text = labels["MONEY"].convert(text)
        elif "/" in text:
            text = labels["FRACTION"].convert(text)
        elif "." in text:
            text = labels["DECIMAL"].convert(text)
        elif "," in text or len(text) <= 3:
            text = labels["CARDINAL"].convert(text)
        elif "-" in text:
            text = labels["RANGE"].convert(text)
        else:
            text = labels["DATE"].convert(text)
        if _has_numbers(text):
            text = labels["CARDINAL"].convert(text)
    elif text == "#" and _has_numbers(next_text):
        text = "number"
    return text.replace("$", "")



@functools.lru_cache(maxsize=1)
def _nltk_tokenizers():
    """Construct once (the reference caches at module scope,
    text_normalize.py:176): TweetTokenizer compiles its regexes at
    construction, a per-record cost in corpus-scale loops otherwise."""
    from nltk.tokenize import TweetTokenizer
    from nltk.tokenize.treebank import TreebankWordDetokenizer

    return TweetTokenizer(), TreebankWordDetokenizer()


def normalize_text(text: str) -> str:
    """Normalize an English sentence by routing each token through the
    converter registry with one-token lookahead/lookbehind context."""
    tokenizer, detokenizer = _nltk_tokenizers()

    text = (
        remove_accents(text)
        .replace("–", " to ")
        .replace("-", " - ")
        .replace(":p", ": p")
        .replace(":P", ": P")
        .replace(":d", ": d")
        .replace(":D", ": D")
    )
    words = tokenizer.tokenize(text)
    out = []
    for i, word in enumerate(words):
        prev_w = words[i - 1] if i > 0 else ""
        next_w = words[i + 1] if i + 1 < len(words) else ""
        out.append(normalize_single(word, prev_w, next_w))
    return (
        detokenizer
        .detokenize(out)
        .replace("’ s", "'s")
        .replace(" 's", "'s")
    )

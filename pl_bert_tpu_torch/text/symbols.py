"""Phoneme symbol table — the 188-id vocabulary contract.

A copy of ``pl_bert_tpu/text/symbols.py``: the port keeps its own so it
imports nothing of the JAX package.

The id assignment must match the reference exactly (reference:
char_indexer.py:5-17): ``[PAD]`` at 0, then the sorted punctuation set,
the IPA letter string, the 26 Latin letters, then ``M`` (phoneme mask,
id 185), ``' '`` (word separator, id 186) and ``U`` (unknown, id 187).
Every downstream artifact (training data, checkpoints, HF exports) keys
off these ids, so the table is data we must reproduce verbatim; the
encoding machinery around it is our own (vectorized numpy bulk encoder
instead of a per-char Python loop).
"""

from __future__ import annotations

import string

import numpy as np

PAD = "P"
# Arabic + Western punctuation, deduplicated and sorted so ids are stable.
PUNCTUATION = "".join(
    sorted(set(';:,.!?¡¿—…"«»“”‘’،؛؟٫٬٪﴾﴿ـ' + string.punctuation))
)
LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋ"
    "ⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘̩ᵻ"
)
LATIN_LETTERS = string.ascii_lowercase
PHONEME_MASK = "M"
PHONEME_SEPARATOR = " "
UNKNOWN = "U"

symbols: list[str] = (
    [PAD]
    + list(PUNCTUATION)
    + list(LETTERS_IPA)
    + list(LATIN_LETTERS)
    + [PHONEME_MASK]
    + [PHONEME_SEPARATOR]
    + [UNKNOWN]
)

if len(symbols) != len(set(symbols)):  # pragma: no cover - import-time invariant
    raise RuntimeError("phoneme symbol table contains duplicates")

NUM_SYMBOLS = len(symbols)
PAD_ID = 0
MASK_ID = symbols.index(PHONEME_MASK)
SEPARATOR_ID = symbols.index(PHONEME_SEPARATOR)
UNKNOWN_ID = symbols.index(UNKNOWN)

SYMBOL_TO_ID: dict[str, int] = {s: i for i, s in enumerate(symbols)}

# Dense codepoint → id lookup table for vectorized bulk encoding. The max
# codepoint in the table is U+FD3F (﴿); one uint8 slot per codepoint below
# that is ~65 KB, negligible, and turns encoding into a single numpy gather.
_MAX_CODEPOINT = max(ord(s) for s in symbols)
_LOOKUP = np.full(_MAX_CODEPOINT + 2, UNKNOWN_ID, dtype=np.int32)
for _s, _i in SYMBOL_TO_ID.items():
    _LOOKUP[ord(_s)] = _i


def encode(text: str) -> np.ndarray:
    """Vectorized char → id encoding with OOV → UNKNOWN fallback.

    Decodes the string to UTF-32 codepoints and gathers through the dense
    lookup table — no Python-level per-character loop.
    """
    if not text:
        return np.zeros((0,), dtype=np.int32)
    cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32).astype(np.int64)
    cps = np.where(cps > _MAX_CODEPOINT, _MAX_CODEPOINT + 1, cps)
    return _LOOKUP[cps]


def decode(ids) -> str:
    """Inverse of :func:`encode` (ids must be valid symbol ids)."""
    return "".join(symbols[int(i)] for i in ids)


class CharacterIndexer:
    """Callable char→id mapper, API-compatible with the reference
    (reference: char_indexer.py:19-25) but returning a numpy array."""

    def __init__(self) -> None:
        self.word_index_dictionary = SYMBOL_TO_ID

    def __call__(self, text: str) -> list[int]:
        return encode(text).tolist()

"""PL-BERT's 188-id phoneme table, frozen for the benchmark.

The reference's ``char_indexer.py`` ids: ``[PAD]`` at 0, the sorted
punctuation set, the IPA letters, the 26 Latin letters, then the mask
``M`` (185), the word separator ``' '`` (186) and ``U`` (187). The
benchmark writes its corpus with this table and its reference encodes
with it, so a later change to the program's own table cannot move what
the program is held to.
"""

from __future__ import annotations

import string

import numpy as np

_PUNCTUATION = "".join(
    sorted(set(';:,.!?¡¿—…"«»“”‘’،؛؟٫٬٪﴾﴿ـ' + string.punctuation))
)
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋ"
    "ⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘̩ᵻ"
)
SYMBOLS = ["P", *_PUNCTUATION, *_LETTERS_IPA, *string.ascii_lowercase, "M", " ", "U"]
NUM_SYMBOLS = len(SYMBOLS)
MASK_ID = SYMBOLS.index("M")
SEPARATOR_ID = SYMBOLS.index(" ")
UNKNOWN_ID = SYMBOLS.index("U")
_ID = {s: i for i, s in enumerate(SYMBOLS)}


def encode(text: str) -> np.ndarray:
    """Characters → int32 ids (an unknown character → ``U``)."""
    return np.array([_ID.get(c, UNKNOWN_ID) for c in text], dtype=np.int32)

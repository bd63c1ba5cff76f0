"""PLAIN converter (behavioral parity: reference converters/Plain.py:7-78).

A copy of ``pl_bert_tpu/text/converters/Plain.py`` (1-29).
"""

import re

from pl_bert_tpu_torch.text.converters.plain_data import PLAIN_WORDS

_UPPER_WORDS = {"DR": "drive", "ST": "street"}
_CHAR_FILTER = re.compile(r"[^a-zA-ZÀ-ÖØ-öø-ÿ0-9']")
_SPLIT_SUFFIXES = ("strasse", "weg")
_SPLIT_RE = re.compile(rf"(.*)({'|'.join(_SPLIT_SUFFIXES)})$", flags=re.I)


class Plain:
    """Mostly passthrough; applies the abbreviation/UK→US table and splits
    German street-name suffixes ("Ringstrasse"→"ring strasse")."""

    def convert(self, token) -> str:
        if isinstance(token, float):  # NaN
            return "NaN"
        if token in _UPPER_WORDS:
            return _UPPER_WORDS[token]
        if token.lower() in PLAIN_WORDS:
            return PLAIN_WORDS[token.lower()]
        token = _CHAR_FILTER.sub("", token)
        if token.lower().endswith(_SPLIT_SUFFIXES):
            head, tail = _SPLIT_RE.match(token).groups()
            if head:
                token = f"{head} {tail}".lower()
        return token

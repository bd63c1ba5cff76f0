"""LETTERS converter (behavioral parity: reference converters/Letters.py:9-89).

A copy of ``pl_bert_tpu/text/converters/Letters.py`` (1-47).
"""

import re

from pl_bert_tpu_torch.text.converters.Verbatim import Verbatim

_LETTER_FILTER = re.compile(r"[^A-Za-zÀ-ÖØ-öø-ÿ&']")
_ACCENTED = {"é": "e acute"}


class Letters:
    """Spell out a letter sequence ("ABCs"→"a b c's")."""

    def __init__(self) -> None:
        self._verbatim = Verbatim()

    def convert(self, token) -> str:
        if isinstance(token, float):  # NaN leaks in as float in the dataset
            return "n a"
        if " " in token and ". " not in token:
            token = token.split(" ")[0]
        if len(token) == 1:
            return _ACCENTED.get(token, token)

        possessive = token[-1] != "-"
        token = _LETTER_FILTER.sub("", str(token))
        if possessive and len(token) >= 3 and token[-2:] in ("'s", "s'"):
            token = token[:-2]
        elif (
            possessive
            and token
            and token[-1] == "s"
            and any(c.isupper() for c in token[:-1])
        ):
            token = token[:-1]
        else:
            possessive = False

        spelled = " ".join(
            self._convert_char(c) for c in token if c != "'"
        )
        return spelled + ("'s" if possessive else "")

    def _convert_char(self, char: str) -> str:
        if char in _ACCENTED:
            return _ACCENTED[char]
        return self._verbatim.convert_char(char)

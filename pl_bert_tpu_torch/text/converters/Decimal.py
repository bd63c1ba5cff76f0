"""DECIMAL converter (behavioral parity: reference converters/Decimal.py:10-124).

A copy of ``pl_bert_tpu/text/converters/Decimal.py`` (1-49).
"""

import re

from pl_bert_tpu_torch.text.converters.numbers import SCALES, cardinal_words, digit_words

_DECIMAL = re.compile(r"(-?\d*)\.(\d+)(.*)")
_NUMBER = re.compile(r"(-?\d+)(.*)")
_SCALE_SUFFIX = re.compile(f" *({'|'.join(SCALES)})")
_E_SUFFIX = re.compile(r" *E(-?\d+)")


class Decimal:
    """"3.5 million"→"three point five million",
    "3.66E-49"→"three point six six times ten to the minus forty nine"."""

    def convert(self, token: str) -> str:
        token = token.replace(",", "")
        number = decimal = ""
        m = _DECIMAL.match(token)
        if m:
            number, decimal, token = m.group(1), m.group(2), m.group(3)
        else:
            m = _NUMBER.match(token)
            if m:
                number, token = m.group(1), m.group(2)

        suffix = ""
        m = _SCALE_SUFFIX.match(token)
        if m:
            suffix = m.group(1)
        else:
            m = _E_SUFFIX.match(token)
            if m:
                suffix = f"times ten to the {cardinal_words(m.group(1))}"

        parts: list[str] = []
        if decimal:
            parts.append("point")
            # trailing ".0" reads "zero" only with an integer part and no scale
            if decimal == "0" and number and not suffix:
                parts.append("zero")
            else:
                parts.append(digit_words(decimal))
        if number:
            parts.insert(0, cardinal_words(number))
        if suffix:
            parts.append(suffix)
        return " ".join(parts)

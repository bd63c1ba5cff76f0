"""MEASURE converter (behavioral parity: reference converters/Measure.py:10-560).

A copy of ``pl_bert_tpu/text/converters/Measure.py`` (1-93).
"""

import re

from pl_bert_tpu_torch.text.converters.Decimal import Decimal
from pl_bert_tpu_torch.text.converters.Fraction import Fraction, VULGAR_FRACTIONS
from pl_bert_tpu_torch.text.converters.measure_data import build_unit_table
from pl_bert_tpu_torch.text.converters.numbers import SCALES

_VULGAR_CLASS = "|".join(VULGAR_FRACTIONS)
_FRACTION = re.compile(
    rf"(((?:-?\d* )?-?\d+ */ *-? *\d+)|(-?\d* *(?:{_VULGAR_CLASS})))"
)
# mixed numbers ("8 1/2", "8½") keep the unit plural without "of a"
_MIXED = re.compile(rf"(-?\d+ -?\d+ */ *-? *\d+)|(-?\d+ *(?:{_VULGAR_CLASS}))")
_VALUE = re.compile(
    rf"(-?(?: |\d)*\.?\d+ *(?:{'|'.join(SCALES)})?)"
)
_NON_NUMERIC = re.compile(r"[^0-9\-\.]")
_UNIT_SPLIT = re.compile(r"(\/|per(?!cent)|sq|2|²|3|³)")


def _split_unit(token: str):
    """Split a compound unit string at /, per, sq, ², ³ markers.

    Exponent markers are emitted before the unit they modify
    ("km2" → "2", "km" so it reads "square kilometers")."""
    while True:
        m = _UNIT_SPLIT.search(token)
        if not m:
            if token:
                yield token
            return
        s, e = m.span()
        if m.group(1) in ("sq", "2", "²", "3", "³"):
            yield token[s:e]
            if token[:s]:
                yield token[:s]
        else:
            if token[:s]:
                yield token[:s]
            yield token[s:e]
        token = token[e:]


class Measure:
    """"100km/h"→"one hundred kilometers per hour",
    "5 cm3"→"five c c", "1/2 kg"→"one half of a kilogram"."""

    def __init__(self) -> None:
        self._decimal = Decimal()
        self._fraction = Fraction()
        self._units, self._units_lower = build_unit_table()

    def convert(self, token: str) -> str:
        token = token.replace(",", "")
        out: list[str] = []
        plural = False

        m = _FRACTION.match(token)
        if m:
            out.append(self._fraction.convert(m.group(0)))
            token = (token[: m.span()[0]] + token[m.span()[1]:]).replace(" ", "")
            if _MIXED.match(m.group(0)):
                plural = True
            else:
                out.append("of an" if token[:1] in tuple("aeiou") else "of a")
        else:
            m = _VALUE.match(token)
            if m:
                out.append(self._decimal.convert(m.group(1).replace(" ", "")))
                token = token[: m.span()[0]] + token[m.span()[1]:]
                numeric = _NON_NUMERIC.sub("", m.group(1))
                if abs(float(numeric)) != 1 or "." in m.group(1):
                    plural = True

        after_per = False  # units after "per" read singular
        for word in token.split(" "):
            for i, piece in enumerate(_split_unit(word)):
                form = 1 if (plural and not after_per) else 0
                if piece in self._units:
                    out.append(self._units[piece][form])
                elif piece.lower() in self._units_lower:
                    out.append(self._units_lower[piece.lower()][form])
                else:
                    out.append(piece)
                if out[-1] == "per" and i != 0:
                    after_per = True
                elif out[-1] not in ("square", "cubic"):
                    after_per = False

        result = " ".join(out)
        return re.sub(r"cubic centimeters?", "c c", result)

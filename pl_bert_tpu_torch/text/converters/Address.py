"""ADDRESS converter (behavioral parity: reference converters/Address.py:10-82).

A copy of ``pl_bert_tpu/text/converters/Address.py`` (1-48).
"""

import re

from pl_bert_tpu_torch.text.converters.numbers import cardinal_words, digit_words

_ADDRESS = re.compile(
    r"((?P<upper>[A-Z\.]*)|(?P<lower>[a-zA-Z]*))"
    r"(?P<link>( |-)*)(?P<number>\d+)(?P<direction>[NESWnesw])?"
)
_DIRECTIONS = {"n": "north", "e": "east", "s": "south", "w": "west"}


class Address:
    """"I02W" → "i o two west", "A380" → "a three eighty"."""

    def convert(self, token: str) -> str:
        token = token.strip()
        m = _ADDRESS.match(token)
        if not m:
            return token
        out: list[str] = []
        upper, lower = m.group("upper"), m.group("lower")
        link, number = m.group("link"), m.group("number")
        if lower:
            out.append(lower.lower())
        elif upper:
            out += [c for c in upper.lower() if c != "."]

        # two-digit (or linked/zero-flanked three-digit) numbers read as
        # digit + cardinal pair; otherwise fully digit-wise
        mixed = len(number) == 2 or (
            len(number) == 3 and (link or number[-1] == "0" or number[0] == "0")
        )
        if mixed:
            if number[-3:-2]:
                out.append(digit_words(number[-3:-2]))
            if number[-2:-1] == "0":
                out.append("o")
                out.append(digit_words(number[-1]))
            else:
                out.append(cardinal_words(number[-2:]))
        else:
            out.append(digit_words(number))

        if m.group("direction"):
            out.append(_DIRECTIONS[m.group("direction").lower()])
        return " ".join(out)

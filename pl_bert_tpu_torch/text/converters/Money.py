"""MONEY converter (behavioral parity: reference converters/Money.py:10-298).

A copy of ``pl_bert_tpu/text/converters/Money.py`` (1-94).
"""

import re

from pl_bert_tpu_torch.text.converters.currency_data import CURRENCIES
from pl_bert_tpu_torch.text.converters.numbers import SCALES, cardinal_words, digit_words

# reversed-input anchor: matching the reversed string pins the LAST dot as
# the decimal point (handles "Rs.12.83")
_DECIMAL_REV = re.compile(r"(.*?)(-?\d*)\.(\d+)(.*)")
_NUMBER = re.compile(r"(.*?)(-?\d+)(.*)")

_SCALE_ABBR = {
    "k": "thousand", "m": "million", "bn": "billion", "b": "billion",
    "t": "trillion", "cr": "crore", "crores": "crore", "lakhs": "lakh",
    "lacs": "lakh",
}
_ALL_SCALES = ["lakh", "crore"] + SCALES + list(_SCALE_ABBR)
_SCALE_RE = re.compile(
    f"({'|'.join(sorted(_ALL_SCALES, key=len, reverse=True))})(.*)", flags=re.I
)


class Money:
    """"$1.56"→"one dollar and fifty six cents",
    "€3.5 million"→"three point five million euros"."""

    def convert(self, token: str) -> str:
        token = re.sub(r"[, ]", "", token)

        before = after = number = decimal = scale = ""
        currency = None

        m = _DECIMAL_REV.search(token[::-1])
        if m:
            before, number = m.group(4)[::-1], m.group(3)[::-1]
            decimal, after = m.group(2)[::-1], m.group(1)[::-1]
        else:
            m = _NUMBER.search(token)
            if m:
                before, number, after = m.group(1), m.group(2), m.group(3)

        if before:
            before = before.lower()
            if before in CURRENCIES:
                currency = CURRENCIES[before]
            elif before[-1] in CURRENCIES:  # "US$", "A$", "NT$"
                currency = CURRENCIES[before[-1]]

        if after:
            m = _SCALE_RE.match(after)
            if m:
                scale = m.group(1).lower()
                scale = _SCALE_ABBR.get(scale, scale)
                after = m.group(2)
            if after.lower() in CURRENCIES:
                currency = CURRENCIES[after.lower()]
                after = ""

        subunit_style = currency is not None and "number" in currency

        out: list[str] = []
        if subunit_style and not scale:
            # "x dollars and y cents"
            if number and (number != "0" or not decimal):
                out.append(cardinal_words(number))
                out.append(
                    currency["number"]["singular" if number == "1" else "plural"]
                )
                if decimal and decimal != "0" * len(decimal):
                    out.append("and")
            if decimal and decimal != "0" * len(decimal):
                decimal = f"{decimal:0<2}"  # ".5" reads as fifty cents
                out.append(cardinal_words(decimal))
                out.append(
                    currency["decimal"]["singular" if decimal == "01" else "plural"]
                )
        else:
            # "x point y <scale> <currency>"
            if number:
                out.append(cardinal_words(number))
            if decimal and decimal != "0" * len(decimal):
                out += ["point", digit_words(decimal)]
            if scale:
                out.append(scale)
            if currency:
                unit = currency["number"] if subunit_style else currency
                if number == "1" and not decimal and not scale:
                    out.append(unit["singular"])
                else:
                    out.append(unit["plural"])
        if after:
            out.append(after.lower())
        return " ".join(out)

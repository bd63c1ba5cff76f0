"""FRACTION converter (behavioral parity: reference converters/Fraction.py:9-284).

A copy of ``pl_bert_tpu/text/converters/Fraction.py`` (1-78).
"""

import re

from pl_bert_tpu_torch.text.converters.numbers import cardinal_words, ordinalize_word

# Unicode vulgar fractions: (prepended-form numerator, standalone numerator,
# denominator text).
VULGAR_FRACTIONS = {
    "½": ("a", "one", "half"),
    "⅓": ("a", "one", "third"),
    "⅔": ("two", "two", "thirds"),
    "¼": ("a", "one", "quarter"),
    "¾": ("three", "three", "quarters"),
    "⅕": ("a", "one", "fifth"),
    "⅖": ("two", "two", "fifths"),
    "⅗": ("three", "three", "fifths"),
    "⅘": ("four", "four", "fifths"),
    "⅙": ("a", "one", "sixth"),
    "⅚": ("five", "five", "sixths"),
    "⅐": ("a", "one", "seventh"),
    "⅛": ("an", "one", "eighth"),
    "⅜": ("three", "three", "eighths"),
    "⅝": ("five", "five", "eighths"),
    "⅞": ("seven", "seven", "eighths"),
    "⅑": ("a", "one", "ninth"),
    "⅒": ("a", "one", "tenth"),
}

_VULGAR = re.compile("|".join(VULGAR_FRACTIONS))
# numerator/denominator, allowing thousand-grouping spaces ("100 000/24")
_NUM = r"-?\d{1,3}(?: \d{3})+|-?\d+"
_SLASH = re.compile(rf"({_NUM}) */ *({_NUM})")

# denominators verbalized irregularly
_EDGE_DENOMS = {"1": ("over one", "over one"), "2": ("half", "halves"), "4": ("quarter", "quarters")}


class Fraction:
    """"1/4"→"one quarter", "8 ½"→"eight and a half",
    "100 000/24"→"one hundred thousand twenty fourths"."""

    def convert(self, token: str) -> str:
        token = token.replace(",", "")

        m = _VULGAR.search(token)
        if m:
            prepended, single, denom_text = VULGAR_FRACTIONS[m.group(0)]
            remainder = _VULGAR.sub("", token)
            if remainder:
                return f"{cardinal_words(remainder)} and {prepended} {denom_text}"
            return f"{single} {denom_text}"

        m = _SLASH.search(token)
        if not m:
            return token
        numerator = m.group(1).replace(" ", "")
        denominator = m.group(2).replace(" ", "")
        numerator_text = cardinal_words(numerator)
        singular = abs(int(numerator)) == 1

        if denominator in _EDGE_DENOMS:
            denom_text = _EDGE_DENOMS[denominator][0 if singular else 1]
        else:
            words = cardinal_words(denominator).split(" ")
            words[-1] = ordinalize_word(words[-1])
            if not singular:
                words[-1] += "s"
            denom_text = " ".join(words)
        result = f"{numerator_text} {denom_text}"

        remainder = _SLASH.sub("", token).strip()
        if remainder:
            words = result.split()
            if words[0] == "one":
                words[0] = "a"
            result = f"{cardinal_words(remainder)} and {' '.join(words)}"
        return result

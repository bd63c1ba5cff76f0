"""Shared English number-verbalization engine.

One engine backs every numeric converter (Cardinal/Ordinal/Digit/Date/...).
The reference spreads duplicate word tables across Cardinal.py, Ordinal.py
and Fraction.py (reference: converters/Cardinal.py:76-115,
converters/Ordinal.py:49-100); here they live once.

Output conventions follow the reference's verbalization style:
no "and" ("one hundred one"), no hyphens ("twenty one"), "minus" prefix,
digit-wise zero is "o", year style "nineteen o six".

A copy of ``pl_bert_tpu/text/converters/numbers.py`` (1-216).
"""

from __future__ import annotations

import re

ONES = {
    "1": "one", "2": "two", "3": "three", "4": "four", "5": "five",
    "6": "six", "7": "seven", "8": "eight", "9": "nine",
}
TENS = {
    "1": "ten", "2": "twenty", "3": "thirty", "4": "forty", "5": "fifty",
    "6": "sixty", "7": "seventy", "8": "eighty", "9": "ninety",
}
TEENS = {
    11: "eleven", 12: "twelve", 13: "thirteen", 14: "fourteen",
    15: "fifteen", 16: "sixteen", 17: "seventeen", 18: "eighteen",
    19: "nineteen",
}
# Scale words for successive 10^3 groups (index 0 = thousand).
SCALES = [
    "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion", "undecillion", "duodecillion", "tredecillion",
    "quattuordecillion", "quindecillion", "sexdecillion",
    "septendecillion", "octodecillion", "novemdecillion", "vigintillion",
]

# cardinal word → ordinal word, for the last-word rewrite trick used by
# Ordinal and Fraction.
_IRREGULAR_ORDINAL = {
    "zero": "zeroth", "one": "first", "two": "second", "three": "third",
    "five": "fifth", "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def ordinalize_word(word: str) -> str:
    """Cardinal word → ordinal word ("twenty"→"twentieth", "four"→"fourth")."""
    if word in _IRREGULAR_ORDINAL:
        return _IRREGULAR_ORDINAL[word]
    if word.endswith("y"):
        return word[:-1] + "ieth"
    return word + "th"


_NON_DIGIT_DASH = re.compile(r"[^0-9\-]")
_NON_DIGIT = re.compile(r"[^0-9]")

_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
_ROMAN_DETECT = re.compile(r"[.IVXLCDM]+(th|nd|st|rd|'s|s)?")
_ROMAN_STRIP = re.compile(r"[^IVXLCDM]")


def _largest_section(token: str) -> str:
    return max(token.split(" "), key=len)


def is_roman(token: str) -> bool:
    """True if the longest space-separated section looks like a Roman
    numeral (optionally with th/st/nd/rd/'s/s suffix)."""
    return _ROMAN_DETECT.fullmatch(_largest_section(token)) is not None


def roman_value(token: str) -> tuple[str, str]:
    """Roman numeral → (decimal string, possessive suffix).

    Right-to-left scan: each glyph adds its value if ≥ the previous
    glyph's value, else subtracts (handles IV, IX, XL, ...).
    """
    section = _largest_section(token)
    suffix = "'s" if section.endswith("s") else ""
    section = _ROMAN_STRIP.sub("", section)
    total = prev = 0
    for glyph in reversed(section):
        value = _ROMAN_VALUES[glyph]
        total += value if value >= prev else -value
        prev = value
    return str(total), suffix


def _three_digit_words(chunk: str) -> list[str]:
    """Verbalize a ≤3-digit chunk, omitting zero ("zero" is a caller-level
    special case for all-zero inputs)."""
    words: list[str] = []
    hundreds, rest = chunk[-3:-2], chunk[-2:]
    if hundreds and hundreds != "0":
        words += [ONES[hundreds], "hundred"]
    rest_val = int(rest)
    if rest_val in TEENS:
        words.append(TEENS[rest_val])
    else:
        if len(rest) == 2 and rest[0] != "0":
            words.append(TENS[rest[0]])
        if rest[-1] != "0":
            words.append(ONES[rest[-1]])
    return words


def cardinal_words(token: str) -> str:
    """Free-form numeric token → cardinal words.

    Accepts Roman numerals, commas/spaces/dots as grouping, and leading
    dashes (an odd count verbalizes as "minus"). Style: no "and", no
    hyphens (reference: converters/Cardinal.py:33-36).
    """
    token = token.replace(".", "")
    suffix = ""
    if is_roman(token):
        token, suffix = roman_value(token)
    token = _NON_DIGIT_DASH.sub("", token)
    minus = False
    while token.startswith("-"):
        token = token[1:]
        minus = not minus
    token = _NON_DIGIT.sub("", token)

    if not token:
        # nothing numeric survived (bare dashes, malformed fragments):
        # emit NOTHING rather than a spurious "zero"/"minus zero"
        return suffix
    if token == "0" * len(token):
        words = ["zero"]
    elif len(token) > 3 * (len(SCALES) + 1):
        # beyond the largest scale word (vigintillion): digit-by-digit,
        # the only sane verbalization for ID/hash-like digit runs —
        # silently dropping scale words would emit nonsense like
        # "one" for 10^66
        words = [("zero" if d == "0" else ONES[d]) for d in token]
    else:
        words = []
        chunks = []
        while token:
            chunks.append(token[-3:])
            token = token[:-3]
        for depth, chunk in enumerate(chunks):
            chunk_words = _three_digit_words(chunk)
            if depth > 0 and chunk_words:
                chunk_words.append(SCALES[depth - 1])
            words = chunk_words + words

    text = " ".join(words)
    if minus:
        text = f"minus {text}"
    return text + suffix


_ORDINAL_SUFFIX = re.compile(r"(?i)(\d+)(th|nd|st|rd)(s?)")


def ordinal_words(token: str) -> str:
    """Numeric/Roman token → ordinal words ("5th"→"fifth", "II"→"the second")."""
    token = re.sub(r"[, ºª]", "", token)
    prefix = suffix = ""
    if is_roman(token):
        if not token.endswith(("th", "nd", "st", "rd")):
            prefix = "the"
        token, suffix = roman_value(token)
    else:
        m = _ORDINAL_SUFFIX.fullmatch(token)
        if m:
            token, suffix = m.group(1), m.group(3)
    words = cardinal_words(token).split(" ")
    words[-1] = ordinalize_word(words[-1])
    text = " ".join(words)
    if prefix:
        text = f"{prefix} {text}"
    return text + suffix


DIGIT_WORDS = {"0": "o", **ONES}


def digit_words(token: str) -> str:
    """Digit-by-digit verbalization; zero is "o", "007" is Bond."""
    token = _NON_DIGIT.sub("", token)
    if token == "007":
        return "double o seven"
    return " ".join(DIGIT_WORDS[d] for d in token)


def year_words(token: str, plural: bool = False) -> str:
    """Year-style verbalization ("1906"→"nineteen o six", "1990"+plural→
    "nineteen nineties", "2001"→"two thousand one")."""
    if token == "00":
        return "o o"
    if token[-3:-1] == "00":  # x00x → plain cardinal ("two thousand one")
        text = cardinal_words(token)
        if plural:
            text += "es" if text.endswith("x") else "s"
        return text
    parts = []
    if token[-4:-2]:
        parts.append(cardinal_words(token[-4:-2]))
    if token[-2:] == "00":
        parts.append("hundreds" if plural else "hundred")
        return " ".join(parts)
    if token[-2:-1] == "0":
        parts.append("hundred" if len(token) == 3 else "o")
    tail = cardinal_words(token[-2:])
    if plural:
        if tail.endswith("y"):
            tail = tail[:-1] + "ies"
        else:
            tail += "es" if tail.endswith("x") else "s"
    parts.append(tail)
    return " ".join(parts)

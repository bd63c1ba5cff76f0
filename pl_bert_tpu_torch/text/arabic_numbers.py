"""Arabic cardinal number verbalization (Modern Standard Arabic).

Standalone replacement for the ``num2words(lang='ar')`` dependency the
reference pulls in (reference: text_normalize.py:112-134) — that package
is not available here, so the rules are implemented directly: units,
compound 11-19, tens with و-conjunction (units precede tens), the
irregular hundreds series, and dual/plural scale nouns (ألف/ألفان/آلاف…).

A copy of ``pl_bert_tpu/text/arabic_numbers.py`` (1-113).
"""

from __future__ import annotations

import functools

_ONES = [
    "صفر", "واحد", "اثنان", "ثلاثة", "أربعة", "خمسة",
    "ستة", "سبعة", "ثمانية", "تسعة",
]
_TEN = "عشرة"
_TENS = {
    2: "عشرون", 3: "ثلاثون", 4: "أربعون", 5: "خمسون",
    6: "ستون", 7: "سبعون", 8: "ثمانون", 9: "تسعون",
}
_HUNDREDS = {
    1: "مائة", 2: "مائتان", 3: "ثلاثمائة", 4: "أربعمائة", 5: "خمسمائة",
    6: "ستمائة", 7: "سبعمائة", 8: "ثمانمائة", 9: "تسعمائة",
}
# scale: (singular, dual, 3-10 plural)
_SCALES = [
    ("ألف", "ألفان", "آلاف"),
    ("مليون", "مليونان", "ملايين"),
    ("مليار", "ملياران", "مليارات"),
    ("تريليون", "تريليونان", "تريليونات"),
    ("كوادريليون", "كوادريليونان", "كوادريليونات"),
]
_MINUS = "سالب"
_AND = "و"


def _under_hundred(n: int) -> str:
    if n < 10:
        return _ONES[n]
    if n == 10:
        return _TEN
    if n == 11:
        return "أحد عشر"
    if n == 12:
        return "اثنا عشر"
    if n < 20:
        return f"{_ONES[n - 10]} عشر"
    tens, units = divmod(n, 10)
    if units == 0:
        return _TENS[tens]
    return f"{_ONES[units]} {_AND}{_TENS[tens]}"


def _under_thousand(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_HUNDREDS[hundreds])
    if rest:
        parts.append(_under_hundred(rest))
    return f" {_AND}".join(parts)


def _scaled(count: int, scale_idx: int) -> str:
    singular, dual, plural = _SCALES[scale_idx]
    if count == 1:
        return singular
    if count == 2:
        return dual
    if 3 <= count <= 10:
        return f"{_under_thousand(count)} {plural}"
    # the scale noun's form follows the count's FINAL units: a trailing
    # 1/2 takes the bare noun itself (101,000 = "مائة ألف وألف", not the
    # ungrammatical "مائة وواحد ألف"; 102,000 = "… وألفان"), a trailing
    # 3-10 takes the plural ("مائة وثلاثة آلاف"), everything else the
    # singular
    rem = count % 100
    if rem in (1, 2):
        head = _scaled(count - rem, scale_idx)
        return f"{head} {_AND}{singular if rem == 1 else dual}"
    noun = plural if 3 <= rem <= 10 else singular
    return f"{_under_thousand(count)} {noun}"


@functools.lru_cache(maxsize=16384)
def arabic_number_words(n: int) -> str:
    """Integer → MSA cardinal words ("125" → "مائة وخمسة وعشرون").

    Pure int→str, memoized: corpus number distributions are heavy-tailed
    (years, small counts repeat), so the clean stage mostly cache-hits.
    """
    if n == 0:
        return _ONES[0]
    negative = n < 0
    n = abs(n)

    groups: list[int] = []
    while n:
        groups.append(n % 1000)
        n //= 1000
    if len(groups) - 2 >= len(_SCALES):
        raise NotImplementedError("number too large to verbalize")

    parts: list[str] = []
    for idx in range(len(groups) - 1, -1, -1):
        count = groups[idx]
        if count == 0:
            continue
        parts.append(_scaled(count, idx - 1) if idx > 0 else _under_thousand(count))
    text = f" {_AND}".join(parts)
    return f"{_MINUS} {text}" if negative else text

"""DATE converter (behavioral parity: reference converters/Date.py:10-294).

A copy of ``pl_bert_tpu/text/converters/Date.py`` (1-157).
"""

import re

from pl_bert_tpu_torch.text.converters.numbers import ordinal_words, year_words

_MONTHS = (
    "january|february|march|april|may|june|july|august|september|october"
    "|november|december|sept|jan|feb|mar|apr|jun|jul|aug|sep|oct|nov|dec"
)
_MONTH_FULL = {
    "jan": "january", "feb": "february", "mar": "march", "apr": "april",
    "jun": "june", "jul": "july", "aug": "august", "sep": "september",
    "sept": "september", "oct": "october", "nov": "november", "dec": "december",
    **{f"{i:02d}": m for i, m in enumerate(
        ["january", "february", "march", "april", "may", "june", "july",
         "august", "september", "october", "november", "december"], start=1)},
    **{str(i): m for i, m in enumerate(
        ["january", "february", "march", "april", "may", "june", "july",
         "august", "september"], start=1)},
}
_DAY_FULL = {
    "mon": "monday", "tue": "tuesday", "wed": "wednesday", "thu": "thursday",
    "fri": "friday", "sat": "saturday", "sun": "sunday",
}

_DAY_PREFIX = re.compile(
    r"^(?P<prefix>monday|tuesday|wednesday|thursday|friday|saturday|sunday"
    r"|mon|tue|wed|thu|fri|sat|sun)\.?",
    flags=re.I,
)
_TH = re.compile(r"(?:(?<=\d)|(?<=\d ))(?:th|nd|rd|st)", flags=re.I)

_SEP = r" *(?:-|\.|/) *"
_YMD = re.compile(rf"^(?P<year>\d{{2,5}}){_SEP}(?P<month>\d{{1,2}}){_SEP}(?P<day>\d{{1,2}})$")
_MDY = re.compile(rf"^(?P<month>\d{{1,2}}){_SEP}(?P<day>\d{{1,2}}){_SEP}(?P<year>\d{{2,5}})$")
_TEXT_YMD = re.compile(rf"^(?P<year>\d{{2,5}}){_SEP}(?P<month>{_MONTHS}){_SEP}(?P<day>\d{{1,2}})$", flags=re.I)
_TEXT_DMY = re.compile(rf"^(?P<day>\d{{1,2}}){_SEP}(?P<month>{_MONTHS}){_SEP}(?P<year>\d{{2,5}})$", flags=re.I)
_TEXT_MDY = re.compile(rf"^(?P<month>{_MONTHS}){_SEP}(?P<day>\d{{1,2}}){_SEP}(?P<year>\d{{2,5}})$", flags=re.I)

_BC = r"(?: *(?P<bcsuffix>[A-Z\.]+)?)"
_DMY_LONG = re.compile(
    rf"^(?:(?:(?P<day>\d{{1,2}}) +(of +)?)?(?P<month>{_MONTHS})\.? +)?"
    rf"(?P<year>\d{{1,5}})(?P<plural>s?)\/?{_BC}$",
    flags=re.I,
)
_MDY_LONG = re.compile(
    rf"^(?P<month>{_MONTHS})?\.? *(?P<day>\d{{1,2}})? +"
    rf"(?P<year>\d{{1,5}})(?P<plural>s?)\/?{_BC}$",
    flags=re.I,
)
_DM = re.compile(rf"^(?P<day>\d{{1,2}}) +(of +)?(?P<month>{_MONTHS})\.?{_BC}$", flags=re.I)
_MD = re.compile(rf"^(?P<month>{_MONTHS})\.? +(?P<day>\d{{1,2}}){_BC}$", flags=re.I)


def _month_name(token):
    if not token:
        return token
    return _MONTH_FULL.get(token.lower(), token.lower())


def _bc_suffix(match) -> str | None:
    try:
        raw = match.group("bcsuffix")
    except (IndexError, AttributeError):
        return None
    if not raw:
        return None
    return " ".join(c for c in raw.lower() if c not in (" ", "."))


class Date:
    """"23 Jan 2020"→"the twenty third of january twenty twenty",
    "90s"→"nineties", "13 AD"→"thirteen a d"."""

    def get_month(self, token: str) -> str:
        return _month_name(token)

    def convert(self, token: str) -> str:
        token = re.sub(r"[,']", "", token).strip()

        m = _TH.search(token)
        if m:  # drop the ordinal marker in "5th July" (keeping "thursday")
            token = token[: m.span()[0]] + token[m.span()[1]:]

        weekday = None
        m = _DAY_PREFIX.match(token)
        if m:
            p = m.group("prefix").lower()
            weekday = _DAY_FULL.get(p, p)
            token = token[m.span()[1]:].strip()
        if token.lower().startswith("the "):
            token = token[4:]

        day = month = year = suffix = None
        day_first = True

        def emit() -> str:
            parts = [weekday]
            if day_first:
                if day:
                    parts += ["the", day, "of"]
                parts.append(month)
            else:
                parts += [month, day]
            parts += [year, suffix]
            return " ".join(p for p in parts if p)

        m = _DM.match(token)
        if not m:
            m = _MD.match(token)
            if m:
                day_first = False
        if m:
            day = ordinal_words(m.group("day"))
            month = _month_name(m.group("month"))
            suffix = _bc_suffix(m)
            return emit()

        m = (
            _MDY.match(token)
            or _YMD.match(token)
            or _TEXT_DMY.match(token)
            or _TEXT_YMD.match(token)
            or _TEXT_MDY.match(token)
        )
        if m:
            day, month, year = m.group("day"), m.group("month"), m.group("year")
            try:
                if (
                    m.group(0).startswith(month) and int(day) > 12
                    or weekday and m.group(0).endswith(year) and int(month) <= 12
                ):
                    day_first = False
                if int(month) > 12:  # disambiguate swapped numeric fields
                    month, day = day, month
            except ValueError:
                pass  # textual month
            month, year = _month_name(month), year_words(year)
            if day:
                day = ordinal_words(day)
            return emit()

        m = _DMY_LONG.match(token)
        if not m:
            m = _MDY_LONG.match(token)
            if m:
                day_first = False
        if m:
            if m.group("day"):
                day = ordinal_words(m.group("day"))
            month = _month_name(m.group("month"))
            year = year_words(m.group("year"), plural=bool(m.group("plural")))
            suffix = _bc_suffix(m)
            return emit()

        return token

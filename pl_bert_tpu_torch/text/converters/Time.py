"""TIME converter (behavioral parity: reference converters/Time.py:9-141).

A copy of ``pl_bert_tpu/text/converters/Time.py`` (1-83).
"""

import re

from pl_bert_tpu_torch.text.converters.numbers import cardinal_words

_HM = re.compile(
    r"^(?P<hour>\d{1,2}) *((?::|.) *(?P<minute>\d{1,2}))? *(?P<suffix>[a-zA-Z\. ]*)$",
    flags=re.I,
)
_HMS = re.compile(
    r"^(?:(?P<hour>\d{1,2}) *:)? *(?P<minute>\d{1,2})"
    r"(?: *: *(?P<seconds>\d{1,2})(?: *. *(?P<millis>\d{1,2}))?)?"
    r" *(?P<suffix>[a-zA-Z\. ]*)$",
    flags=re.I,
)
_AMPM_FIRST = re.compile(r"^(?P<suffix>[a-zA-Z\. ]*)(?P<hour>\d{1,2})", flags=re.I)


def _spell_suffix(suffix: str) -> list[str]:
    return [c for c in suffix.lower() if c not in (" ", ".")]


def _is_ampm(suffix: str) -> bool:
    return suffix.replace(".", "").replace(" ", "").lower().startswith(("am", "pm"))


def _mod12(hour: str) -> str:
    return hour if hour == "12" else str(int(hour) % 12)


def _plural(unit: str, value: str) -> str:
    return unit if int(value) == 1 else unit + "s"


class Time:
    """"12:10 AM"→"twelve ten a m", "3:00"→"three o'clock",
    "1:20:05"→"one hour twenty minutes and five seconds"."""

    def convert(self, token: str) -> str:
        token = token.strip()
        out: list[str] = []

        m = _HM.match(token)
        if m:
            hour, minute, suffix = m.group("hour"), m.group("minute"), m.group("suffix")
            ampm = _is_ampm(suffix)
            out.append(cardinal_words(_mod12(hour) if ampm else hour))
            if minute and minute != "00":
                if minute[0] == "0":
                    out.append("o")
                out.append(cardinal_words(minute))
            elif not ampm:
                # on-the-hour: military "hundred" past twelve, else "o'clock"
                out.append("hundred" if int(hour) > 12 or int(hour) == 0 else "o'clock")
            out += _spell_suffix(suffix)
            return " ".join(out)

        m = _HMS.match(token)
        if m:
            hour, minute = m.group("hour"), m.group("minute")
            seconds, millis, suffix = m.group("seconds"), m.group("millis"), m.group("suffix")
            if hour:
                out += [cardinal_words(hour), _plural("hour", hour)]
            if minute:
                out += [cardinal_words(minute), _plural("minute", minute)]
            if seconds:
                if not millis:
                    out.append("and")
                out += [cardinal_words(seconds), _plural("second", seconds)]
            if millis:
                out += ["and", cardinal_words(millis), _plural("millisecond", millis)]
            out += _spell_suffix(suffix)
            return " ".join(out)

        m = _AMPM_FIRST.match(token)
        if m:  # "PM3" → "three p m"
            hour, suffix = m.group("hour"), m.group("suffix")
            out.append(cardinal_words(_mod12(hour) if _is_ampm(suffix) else hour))
            out += _spell_suffix(suffix)
            return " ".join(out)

        return token

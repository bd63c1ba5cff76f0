"""RANGE converter (behavioral parity: reference converters/Range.py:7-35).

A copy of ``pl_bert_tpu/text/converters/Range.py`` (1-15).
"""

from pl_bert_tpu_torch.text.converters.numbers import cardinal_words


class Range:
    """"3-5" → "three to five"."""

    def convert(self, token: str) -> str:
        parts = token.split("-")
        if len(parts) == 2:
            return f"{cardinal_words(parts[0])} to {cardinal_words(parts[1])}"
        if len(parts) == 1:
            return cardinal_words(parts[0])
        return "".join(cardinal_words(p) + " " for p in parts)

"""TELEPHONE converter (behavioral parity: reference converters/Telephone.py:7-73).

A copy of ``pl_bert_tpu/text/converters/Telephone.py`` (1-32).
"""

from pl_bert_tpu_torch.text.converters.numbers import ONES

_CHAR_MAP = {" ": "sil", "-": "sil", "x": "extension", "0": "o", **ONES}


class Telephone:
    """Digit-wise reading with "sil" at separators; runs of exactly two or
    three trailing "o"s collapse to hundred/thousand."""

    def convert(self, token: str) -> str:
        token = token.lower().replace("(", "-").replace(")", "-")
        words = [_CHAR_MAP.get(c, c) for c in token]
        # drop leading and repeated "sil"
        words = [
            w for i, w in enumerate(words)
            if w != "sil" or (i > 0 and words[i - 1] != "sil")
        ]
        # collapse o-runs of length 2/3 into hundred/thousand when they end a
        # group (followed by sil or end) and don't continue a longer run
        i = 0
        while i < len(words):
            run = 0
            while i + run < len(words) and words[i + run] == "o":
                run += 1
            ends_group = i + run >= len(words) or words[i + run] == "sil"
            fresh_start = i == 0 or words[i - 1] not in ("o", "sil")
            if ends_group and fresh_start and run in (2, 3):
                words[i : i + run] = ["hundred" if run == 2 else "thousand"]
            i += 1
        return " ".join(words)

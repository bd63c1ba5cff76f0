"""DIGIT converter (behavioral parity: reference converters/Digit.py:7-45).

A copy of ``pl_bert_tpu/text/converters/Digit.py`` (1-10).
"""

from pl_bert_tpu_torch.text.converters.numbers import digit_words


class Digit:
    """Digit-by-digit verbalization; "0"→"o", "007"→"double o seven"."""

    def convert(self, token: str) -> str:
        return digit_words(token)

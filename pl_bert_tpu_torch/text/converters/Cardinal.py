"""CARDINAL converter (behavioral parity: reference converters/Cardinal.py:9-198).

A copy of ``pl_bert_tpu/text/converters/Cardinal.py`` (1-11).
"""

from pl_bert_tpu_torch.text.converters.numbers import cardinal_words


class Cardinal:
    """Integers/Roman numerals → words ("123"→"one hundred twenty three",
    "-2"→"minus two", "IV's"→"four's")."""

    def convert(self, token: str) -> str:
        return cardinal_words(token)

"""ORDINAL converter (behavioral parity: reference converters/Ordinal.py:10-139).

A copy of ``pl_bert_tpu/text/converters/Ordinal.py`` (1-10).
"""

from pl_bert_tpu_torch.text.converters.numbers import ordinal_words


class Ordinal:
    """"5th"→"fifth", "22nd"→"twenty second", "II"→"the second"."""

    def convert(self, token: str) -> str:
        return ordinal_words(token)

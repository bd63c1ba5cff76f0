"""PUNCT converter — identity (behavioral parity: reference converters/Punct.py:5-18).

A copy of ``pl_bert_tpu/text/converters/Punct.py`` (1-6).
"""


class Punct:
    def convert(self, token: str) -> str:
        return token

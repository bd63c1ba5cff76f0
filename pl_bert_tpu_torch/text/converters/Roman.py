"""ROMAN numeral detector/valuator (behavioral parity: reference converters/Roman.py:7-65).

A copy of ``pl_bert_tpu/text/converters/Roman.py`` (1-13).
"""

from pl_bert_tpu_torch.text.converters.numbers import is_roman, roman_value


class Roman:
    """Roman numeral → (decimal string, possessive suffix)."""

    def check_if_roman(self, token: str) -> bool:
        return is_roman(token)

    def convert(self, token: str) -> tuple[str, str]:
        return roman_value(token)

"""Token-class converters for English text normalization.

18 rule-based converters (registry parity: reference
text_normalize.py:56-75). Each exposes ``convert(token) -> str``; numeric
ones share the engine in :mod:`pl_bert_tpu_torch.text.converters.numbers`.
Instances are created once here (the reference used a @singleton
decorator; module-level instantiation achieves the same).

A copy of ``pl_bert_tpu/text/converters/__init__.py`` (1-54).
"""

from pl_bert_tpu_torch.text.converters.Address import Address
from pl_bert_tpu_torch.text.converters.Cardinal import Cardinal
from pl_bert_tpu_torch.text.converters.Date import Date
from pl_bert_tpu_torch.text.converters.Decimal import Decimal
from pl_bert_tpu_torch.text.converters.Digit import Digit
from pl_bert_tpu_torch.text.converters.Electronic import Electronic
from pl_bert_tpu_torch.text.converters.Fraction import Fraction
from pl_bert_tpu_torch.text.converters.Letters import Letters
from pl_bert_tpu_torch.text.converters.Measure import Measure
from pl_bert_tpu_torch.text.converters.Money import Money
from pl_bert_tpu_torch.text.converters.Ordinal import Ordinal
from pl_bert_tpu_torch.text.converters.Plain import Plain
from pl_bert_tpu_torch.text.converters.Punct import Punct
from pl_bert_tpu_torch.text.converters.Range import Range
from pl_bert_tpu_torch.text.converters.Roman import Roman
from pl_bert_tpu_torch.text.converters.Telephone import Telephone
from pl_bert_tpu_torch.text.converters.Time import Time
from pl_bert_tpu_torch.text.converters.Verbatim import Verbatim

labels = {
    "PLAIN": Plain(),
    "PUNCT": Punct(),
    "DATE": Date(),
    "LETTERS": Letters(),
    "CARDINAL": Cardinal(),
    "VERBATIM": Verbatim(),
    "DECIMAL": Decimal(),
    "MEASURE": Measure(),
    "MONEY": Money(),
    "ORDINAL": Ordinal(),
    "TIME": Time(),
    "ELECTRONIC": Electronic(),
    "DIGIT": Digit(),
    "FRACTION": Fraction(),
    "TELEPHONE": Telephone(),
    "ADDRESS": Address(),
    "ROMAN": Roman(),
    "RANGE": Range(),
}

__all__ = [
    "Address", "Cardinal", "Date", "Decimal", "Digit", "Electronic",
    "Fraction", "Letters", "Measure", "Money", "Ordinal", "Plain",
    "Punct", "Range", "Roman", "Telephone", "Time", "Verbatim", "labels",
]

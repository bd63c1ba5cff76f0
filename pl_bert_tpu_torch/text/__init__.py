"""Text: the phoneme symbol table (``symbols.py``), the normalization
layer (``normalize.py``, ``converters/``, ``arabic_numbers.py``) and the
grapheme head's word tokenizer (``word_tokenizer.py``), each a copy of
the JAX package's module of the same name. The exports are
``pl_bert_tpu/text/__init__.py``'s."""
from pl_bert_tpu_torch.text.symbols import (  # noqa: F401
    CharacterIndexer,
    LATIN_LETTERS,
    LETTERS_IPA,
    PAD,
    PHONEME_MASK,
    PHONEME_SEPARATOR,
    PUNCTUATION,
    UNKNOWN,
    symbols,
)

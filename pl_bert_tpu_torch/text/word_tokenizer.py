"""Word-level tokenizer for the grapheme (token) prediction head.

Frequency-based whitespace tokenizer with ``[UNK]/[PAD]/[CLS]/[SEP]/
[MASK]`` specials, JSON save/load — the vocabulary source for the
multi-task variant's token head (reference: tokenizer.py:13-150).

A copy of ``pl_bert_tpu/text/word_tokenizer.py`` (1-110).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Iterable

SPECIAL_TOKENS = ["[UNK]", "[PAD]", "[CLS]", "[SEP]", "[MASK]"]


def _split_for_mode(mode: str):
    if mode == "whitespace":
        return str.split
    if mode == "words_and_punctuation":
        from pl_bert_tpu_torch.text.normalize import separate_words_and_punctuation

        return separate_words_and_punctuation
    raise ValueError(f"unknown split_mode: {mode!r}")


def create_word_tokenizer(
    texts: Iterable[str], vocab_size: int = 60_000,
    output_dir: str | None = None, split_mode: str = "whitespace",
) -> "WordTokenizer":
    """Count word frequencies over a corpus and keep the most common
    ``vocab_size`` (including specials).

    ``split_mode`` selects the tokenization the vocabulary is built over
    AND that ``tokenize()/encode()`` later use — it is persisted with the
    tokenizer so save/load round-trips keep vocabulary and lookup
    consistent. "whitespace" is the reference's split (tokenizer.py:24);
    the tokenize preprocessing stage uses "words_and_punctuation" so the
    vocabulary holds exactly the tokens the phonemize stage emitted (a
    split() vocab would store 'word،' while lookup asks for 'word' and
    '،', mapping both to [UNK])."""
    split = _split_for_mode(split_mode)
    counter: Counter[str] = Counter()
    for text in texts:
        counter.update(split(text))
    # a corpus containing a LITERAL special token must not duplicate it
    # in the vocab (the id map would rebind e.g. unk_token_id to the
    # later index, orphaning the real special slots)
    for special in SPECIAL_TOKENS:
        counter.pop(special, None)
    vocab = SPECIAL_TOKENS + [
        w for w, _ in counter.most_common(vocab_size - len(SPECIAL_TOKENS))
    ]
    tok = WordTokenizer(vocab, split_mode=split_mode)
    if output_dir:
        tok.save(output_dir)
    return tok


class WordTokenizer:
    def __init__(self, vocab: list[str], split_mode: str = "whitespace") -> None:
        self.vocab = vocab
        self.split_mode = split_mode
        self._split = _split_for_mode(split_mode)
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        self.id_to_token = {i: t for i, t in enumerate(vocab)}
        self.vocab_size = len(vocab)
        self.unk_token_id = self.token_to_id["[UNK]"]

    # --- persistence -----------------------------------------------------
    def save(self, output_dir: str) -> None:
        os.makedirs(output_dir, exist_ok=True)
        payload = {
            "vocab": self.vocab,
            "token_to_id": self.token_to_id,
            "id_to_token": self.id_to_token,
            "vocab_size": self.vocab_size,
            "split_mode": self.split_mode,
        }
        with open(os.path.join(output_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
            json.dump(payload, f, ensure_ascii=False, indent=2)
        with open(os.path.join(output_dir, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False, indent=2)

    @classmethod
    def load(cls, tokenizer_path: str) -> "WordTokenizer":
        with open(os.path.join(tokenizer_path, "tokenizer.json"), encoding="utf-8") as f:
            payload = json.load(f)
        return cls(payload["vocab"], payload.get("split_mode", "whitespace"))

    # --- coding ------------------------------------------------------------
    def tokenize(self, text: str) -> list[str]:
        return self._split(text)

    def convert_tokens_to_ids(self, tokens: list[str]) -> list[int]:
        return [self.token_to_id.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: list[int]) -> list[str]:
        return [self.id_to_token.get(i, "[UNK]") for i in ids]

    def encode(self, text: str) -> list[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def decode(self, ids: list[int]) -> str:
        return " ".join(self.convert_ids_to_tokens(ids))


# Backwards-compatible alias matching the reference class name
ArabicWordTokenizer = WordTokenizer

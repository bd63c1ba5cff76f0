"""Dataset adapters: ``MaskedPhonemeDataset`` and
``TruncatedTextDataset``, a copy of ``pl_bert_tpu/data/dataset.py``
(:20-64 and :67-99).

``MaskedPhonemeDataset`` mirrors the reference dataset's contract
(reference: dataloader.py:19-142) over any sequence of records with a
``phonemes: list[str]`` column (HF datasets, lists of dicts, …),
delegating the masking to :class:`WholeWordMasker`.

``TruncatedTextDataset`` mirrors the sentence-boundary-aware random
cropping used to bound diacritizer input (reference: dataloader.py:144-197).
"""

from __future__ import annotations

import numpy as np

from pl_bert_tpu_torch.data.masking import MaskedSample, MaskingParams, WholeWordMasker
from pl_bert_tpu_torch.text.symbols import PUNCTUATION


class MaskedPhonemeDataset:
    def __init__(
        self,
        dataset,
        word_pred_prob: float = 0.15,
        phoneme_mask_prob: float = 0.8,
        replace_prob: float = 0.1,
        word_separator: int = 87,
        max_seq_length: int = 512,
        use_token_ids: bool = False,
        seed: int = 1,
    ) -> None:
        self.data = dataset
        self.use_token_ids = use_token_ids
        self.masker = WholeWordMasker(
            MaskingParams(
                word_pred_prob=word_pred_prob,
                phoneme_mask_prob=phoneme_mask_prob,
                replace_prob=replace_prob,
                max_seq_length=max_seq_length,
                word_separator=word_separator,
            ),
            seed=seed,
        )

    def __len__(self) -> int:
        return len(self.data)

    def get(self, index: int, epoch: int = 0) -> MaskedSample:
        record = self.data[index]
        token_ids = record.get("token_ids") if self.use_token_ids else None
        if self.use_token_ids and not token_ids:
            # fail like the reference's record['token_ids'] KeyError
            # (dataloader.py:40) — a silent separator-fill would train
            # the grapheme head on constant garbage labels
            raise ValueError(
                f"use_token_ids=True but dataset row {index} has no "
                "token_ids — run the tokenize preprocessing stage"
            )
        return self.masker(
            record["phonemes"], epoch=epoch, index=index, token_ids=token_ids
        )

    def __getitem__(self, index: int) -> MaskedSample:
        return self.get(index)


class TruncatedTextDataset:
    def __init__(self, dataset, max_seq_length: int = 512, seed: int = 1) -> None:
        self.data = dataset
        self.max_seq_length = max_seq_length
        self._rng = np.random.Generator(np.random.Philox(seed))

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        record = dict(self.data[index])
        record["text"] = self._truncate(record["text"])
        return record

    def _truncate(self, text: str) -> str:
        n = len(text)
        if n <= self.max_seq_length:
            return text
        start = int(self._rng.integers(0, max(1, n - self.max_seq_length)))
        # snap back to just after the previous sentence boundary
        if start > 0:
            for i in range(start - 1, -1, -1):
                if text[i] in PUNCTUATION:
                    start = i + 1
                    break
        end = min(start + self.max_seq_length, n)
        # extend forward (≤20% slack) to finish the last sentence
        if end < n:
            for i in range(end, min(n, end + int(0.2 * self.max_seq_length))):
                if text[i] in PUNCTUATION:
                    end = i + 1
                    break
        return text[start:end]

"""Dataset adapter: ``MaskedPhonemeDataset``, a copy of
``pl_bert_tpu/data/dataset.py:20-64``.

``MaskedPhonemeDataset`` mirrors the reference dataset's contract
(reference: dataloader.py:19-142) over any sequence of records with a
``phonemes: list[str]`` column (HF datasets, lists of dicts, …),
delegating the masking to :class:`WholeWordMasker`.
"""

from __future__ import annotations

from pl_bert_tpu_torch.data.masking import MaskedSample, MaskingParams, WholeWordMasker


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

"""Fixed-shape batch collation.

A copy of ``pl_bert_tpu/data/collate.py`` (``collate_fixed``).

The reference sorts each batch by length and zero-pads to the batch max
(reference: dataloader.py:200-223, 276-297), which gives every batch a
different shape — a recompilation per shape under XLA. Here every batch
is padded to the static ``max_seq_length`` and masked indices are a
dense boolean plane instead of a ragged Python list (SURVEY §7 hard
parts 2-3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pl_bert_tpu_torch.data.masking import MaskedSample


@dataclass
class Batch:
    """Dense fixed-shape training batch (all arrays [B, L])."""

    masked_ids: np.ndarray  # int32
    label_ids: np.ndarray  # int32
    token_ids: np.ndarray  # int32
    mask_positions: np.ndarray  # bool
    lengths: np.ndarray  # int32 [B]

    @property
    def attention_mask(self) -> np.ndarray:
        """bool [B, L]: True at valid (non-pad) positions."""
        return (
            np.arange(self.masked_ids.shape[1])[None, :] < self.lengths[:, None]
        )


def collate_fixed(samples: list[MaskedSample], max_seq_length: int) -> Batch:
    """Zero-pad samples to the static [B, max_seq_length] shape."""
    b = len(samples)
    masked = np.zeros((b, max_seq_length), dtype=np.int32)
    labels = np.zeros((b, max_seq_length), dtype=np.int32)
    tokens = np.zeros((b, max_seq_length), dtype=np.int32)
    mask_pos = np.zeros((b, max_seq_length), dtype=bool)
    lengths = np.zeros(b, dtype=np.int32)
    for i, s in enumerate(samples):
        n = min(len(s.masked_ids), max_seq_length)
        masked[i, :n] = s.masked_ids[:n]
        labels[i, :n] = s.label_ids[:n]
        tokens[i, :n] = s.token_ids[:n]
        mask_pos[i, :n] = s.mask_positions[:n]
        lengths[i] = n
    return Batch(masked, labels, tokens, mask_pos, lengths)

"""bench.py's training workload as batches for the port: samples longer
than the sequence (so no row carries padding and every position is a
real phoneme token), masked on the host by the port's whole-word
masker. Used by ``chip_smoke.py`` and ``training/profile.py``."""

from __future__ import annotations

import numpy as np

from pl_bert_tpu_torch.data.collate import collate_fixed
from pl_bert_tpu_torch.data.masking import MaskingParams, WholeWordMasker

# bench.py's phoneme alphabet
ALPHABET = list("ɑɐɒæbdfɡhijklmnopqrstuvwzʃʒθðŋɹɾʔˈˌː")


def full_length_batches(n_batches: int, batch: int, seq: int, seed: int = 0) -> list[dict]:
    """``n_batches`` dicts of ``masked_ids``, ``label_ids``,
    ``mask_positions`` and ``lengths`` arrays ([batch, seq]; masker seed
    1, as bench.py's pool)."""
    rng = np.random.default_rng(seed)
    masker = WholeWordMasker(MaskingParams(max_seq_length=seq), seed=1)
    pool = []
    for _ in range(n_batches):
        samples = []
        for i in range(batch):
            words, total = [], 0
            while total < seq + 64:  # one separator per word
                k = int(rng.integers(2, 10))
                words.append("".join(rng.choice(ALPHABET, size=k)))
                total += k + 1
            samples.append(masker(words, epoch=0, index=i))
        b = collate_fixed(samples, seq)
        pool.append({"masked_ids": b.masked_ids, "label_ids": b.label_ids,
                     "mask_positions": b.mask_positions, "lengths": b.lengths})
    return pool

"""Packed datasets for the on-device masking path.

A copy of ``pl_bert_tpu/data/packed.py`` (``pack_token_batch``,
``PackedPhonemeDataset``, ``PackedSequenceDataset``): the same arrays for
the same records and seed. Samples are packed by
``runtime.pack_batch_native``: the C++ packer, or its numpy route where
the packer cannot be built.

Each sample is encoded ONCE on the host into static arrays
(label ids + word ids + length); per-step masking randomness then runs
on device (ops/ondevice_masking.py). Batches here are pure stacking —
the host hot loop shrinks from per-item RNG + string encoding to a
memcpy.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from pl_bert_tpu_torch.runtime import pack_batch_native


def full_lengths(samples: list[list[str]]) -> np.ndarray:
    """Uncropped phoneme length per sample (one separator per word) —
    the ONE definition of "full length", shared by the in-RAM datasets
    and the store writer (a drift between the two would silently change
    which samples get per-epoch re-crop windows)."""
    return np.array(
        [sum(len(w) + 1 for w in s) for s in samples], dtype=np.int64
    )


def pack_token_batch(
    samples: list[list[str]],
    token_lists: list[list[int]],
    max_len: int,
    separator: int,
    offsets: np.ndarray | None = None,
) -> np.ndarray:
    """Per-phoneme grapheme token ids for the packed layout.

    Mirrors the reference's token expansion (reference:
    dataloader.py:66-68: each word's token id repeated once per phoneme,
    ``word_separator`` at every separator position), laid out over the
    same char stream the packer builds, with the same per-sample crop
    ``offsets``. Padding positions are 0 (the loss only reads token ids
    at mask positions, which are never separators or padding).
    """
    b = len(samples)
    out = np.zeros((b, max_len), np.int32)
    if offsets is None:
        offsets = np.zeros(b, np.int64)
    for i, (words, tids) in enumerate(zip(samples, token_lists)):
        if not words:
            continue
        lens = np.fromiter((len(w) for w in words), np.int64, len(words))
        total = int(lens.sum()) + len(lens)
        stream = np.full(total, separator, np.int32)
        ends = np.cumsum(lens + 1)
        char = np.ones(total, bool)
        char[ends - 1] = False
        stream[char] = np.repeat(np.asarray(tids, np.int32), lens)
        win = stream[int(offsets[i]) : int(offsets[i]) + max_len]
        out[i, : len(win)] = win
    return out


class _PackedBase:
    """Shared deterministic batching over precomputed row arrays.

    Subclasses provide ``label_ids``/``lengths`` (+ extras) and
    ``batch(indices) -> dict``.
    """

    lengths: np.ndarray

    def __len__(self) -> int:
        return len(self.lengths)

    def batch(self, indices: np.ndarray) -> dict:
        raise NotImplementedError

    def batches(
        self,
        batch_size: int,
        epoch: int,
        seed: int = 1,
        shuffle: bool = True,
        drop_last: bool = True,
        indices: np.ndarray | None = None,
        start_batch: int = 0,
    ) -> Iterator[dict]:
        order = np.arange(len(self)) if indices is None else np.asarray(indices)
        if shuffle:
            rng = np.random.Generator(
                np.random.Philox(key=seed, counter=[0, 0, 0, epoch])
            )
            order = order[rng.permutation(len(order))]
        n = len(order)
        stop = n - (n % batch_size) if drop_last else n
        for lo in range(start_batch * batch_size, stop, batch_size):
            yield self.batch(order[lo : lo + batch_size])


class PackedPhonemeDataset(_PackedBase):
    """One sample per row, cropped/padded to the static length.

    Samples longer than ``max_seq_length`` get a FRESH random crop window
    every epoch (reference semantics: a random 512-window per
    __getitem__, dataloader.py:110-126), via a re-pack of
    just the long samples keyed by (seed, epoch)."""

    def __init__(
        self, dataset, max_seq_length: int = 512, seed: int = 1,
        token_separator: int = 87,
    ) -> None:
        self.max_seq_length = max_seq_length
        self.seed = seed
        self.token_separator = token_separator
        samples = [dataset[i]["phonemes"] for i in range(len(dataset))]
        self.label_ids, self.word_ids, self.lengths = pack_batch_native(
            samples, max_seq_length
        )
        # keep only the samples that need per-epoch re-cropping
        full_lens = full_lengths(samples)
        long_mask = full_lens > max_seq_length
        self._long_idx = np.flatnonzero(long_mask)
        self._long_samples = [samples[i] for i in self._long_idx]
        self._long_full_lens = full_lens[self._long_idx]
        self._crop_epoch = 0  # epoch the current windows belong to

        # multi-task: per-phoneme grapheme token ids alongside the labels
        self.has_tokens = len(dataset) > 0 and "token_ids" in dataset[0]
        if self.has_tokens:
            token_lists = [dataset[i]["token_ids"] for i in range(len(dataset))]
            self.token_ids = pack_token_batch(
                samples, token_lists, max_seq_length, token_separator
            )
            self._long_tokens = [token_lists[i] for i in self._long_idx]

    def _recrop(self, epoch: int) -> None:
        # epoch 0 = the deterministic head-crop state from __init__ (used
        # for stable validation snapshots); training epochs start at 1
        if epoch == self._crop_epoch or epoch == 0 or len(self._long_idx) == 0:
            return
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, 1, epoch])
        )
        # reference crop start: randint(0, full - max) — high-exclusive
        offsets = rng.integers(
            0, self._long_full_lens - self.max_seq_length
        ).astype(np.int32)
        labels, words, lengths = pack_batch_native(
            self._long_samples, self.max_seq_length, offsets
        )
        self.label_ids[self._long_idx] = labels
        self.word_ids[self._long_idx] = words
        self.lengths[self._long_idx] = lengths
        if self.has_tokens:
            self.token_ids[self._long_idx] = pack_token_batch(
                self._long_samples, self._long_tokens, self.max_seq_length,
                self.token_separator, offsets,
            )
        self._crop_epoch = epoch

    def batches(self, batch_size, epoch, seed=1, shuffle=True, drop_last=True,
                indices=None, start_batch=0):
        self._recrop(epoch)
        yield from super().batches(
            batch_size, epoch, seed, shuffle, drop_last, indices, start_batch
        )

    def batch(self, indices: np.ndarray) -> dict:
        out = {
            "label_ids": self.label_ids[indices],
            "word_ids": self.word_ids[indices],
            "lengths": self.lengths[indices],
        }
        if self.has_tokens:
            out["token_ids"] = self.token_ids[indices]
        return out


class PackedSequenceDataset(_PackedBase):
    """Sequence-packed variant: multiple short samples share one row.

    First-fit-decreasing binning over the per-sample packed arrays; each
    row carries ``segment_ids`` (per-sample index within the row, -1 at
    padding) for block-diagonal attention and ``position_ids`` that
    restart at every segment. Word ids are offset per segment so the
    on-device whole-word masking treats segments independently.

    This goes beyond the reference (which pads every sample to the batch
    max): packing converts padding waste on short-sample corpora directly
    into throughput. Note the loss averages per packed ROW rather than
    per original sample — a documented divergence.
    """

    def __init__(
        self, dataset, max_seq_length: int = 512, token_separator: int = 87,
    ) -> None:
        self.max_seq_length = L = max_seq_length
        samples = [dataset[i]["phonemes"] for i in range(len(dataset))]
        ids, wids, lens = pack_batch_native(samples, L)
        self.has_tokens = len(dataset) > 0 and "token_ids" in dataset[0]
        toks = None
        if self.has_tokens:
            token_lists = [dataset[i]["token_ids"] for i in range(len(dataset))]
            toks = pack_token_batch(samples, token_lists, L, token_separator)

        order = np.argsort(lens)[::-1]  # first-fit decreasing
        # Placement-identical to the naive first-fit scan, but bins that
        # can never fit anything again leave the scan: a bin with space
        # below the GLOBAL min length is dead (lengths only decrease in
        # FFD order), and ``ub_max`` (a never-decreasing upper bound on
        # the best active space) short-circuits scans that cannot
        # succeed. Without this, a corpus of window-filling samples
        # (every bin at space 0) degenerates to O(n^2) Python-loop
        # iterations per 65536-row store chunk.
        nonzero = lens[lens > 0]
        min_len = int(nonzero.min()) if nonzero.size else 0
        bins: list[list[int]] = []
        bin_space: list[int] = []
        active: list[int] = []  # creation-ordered bins with space >= min_len
        ub_max = -1
        for idx in order:
            n = int(lens[idx])
            if n == 0:
                continue
            placed = False
            if n <= ub_max:
                for pos, b in enumerate(active):
                    if n <= bin_space[b]:
                        bins[b].append(int(idx))
                        bin_space[b] -= n
                        if bin_space[b] < min_len:
                            active.pop(pos)
                        placed = True
                        break
            if not placed:
                bins.append([int(idx)])
                bin_space.append(L - n)
                if L - n >= min_len:
                    active.append(len(bins) - 1)
                    ub_max = max(ub_max, L - n)

        rows = len(bins)
        self.label_ids = np.zeros((rows, L), np.int32)
        self.word_ids = np.full((rows, L), -1, np.int32)
        self.segment_ids = np.full((rows, L), -1, np.int32)
        self.position_ids = np.zeros((rows, L), np.int32)
        self.lengths = np.zeros(rows, np.int32)
        if self.has_tokens:
            self.token_ids = np.zeros((rows, L), np.int32)
        for r, members in enumerate(bins):
            pos = 0
            word_offset = 0
            for seg, idx in enumerate(members):
                n = int(lens[idx])
                sl = slice(pos, pos + n)
                self.label_ids[r, sl] = ids[idx, :n]
                if self.has_tokens:
                    self.token_ids[r, sl] = toks[idx, :n]
                w = wids[idx, :n]
                self.word_ids[r, sl] = np.where(w >= 0, w + word_offset, -1)
                self.segment_ids[r, sl] = seg
                self.position_ids[r, sl] = np.arange(n)
                word_offset += int(w.max()) + 1 if n else 0
                pos += n
            self.lengths[r] = pos

    @property
    def packing_efficiency(self) -> float:
        return float(self.lengths.sum()) / (len(self) * self.max_seq_length)

    def batch(self, indices: np.ndarray) -> dict:
        out = {
            "label_ids": self.label_ids[indices],
            "word_ids": self.word_ids[indices],
            "segment_ids": self.segment_ids[indices],
            "position_ids": self.position_ids[indices],
            "lengths": self.lengths[indices],
        }
        if self.has_tokens:
            out["token_ids"] = self.token_ids[indices]
        return out

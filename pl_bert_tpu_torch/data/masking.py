"""Whole-word phoneme-span masking.

A copy of ``pl_bert_tpu/data/masking.py``: the same arrays for the same
records and seed, with the port's own symbol table.

Reproduces the reference masking distribution
(reference: dataloader.py:19-142): each word is selected for prediction
w.p. ``word_pred_prob``; a selected word's phonemes are all masked
w.p. ``phoneme_mask_prob``, replaced with random phonemes drawn from the
same sample w.p. ``replace_prob``, or kept; a ``' '`` separator id
follows every word; sequences longer than ``max_seq_length`` get a
random crop with mask-index rebasing.

Two implementations:

- :func:`mask_sample_reference_parity` — byte-for-byte reproduction of
  the reference's global-RNG call sequence (np.random.rand /
  np.random.choice / random.choices / np.random.randint), used as the
  parity oracle in tests.
- :class:`WholeWordMasker` — the production path: vectorized numpy over
  words, driven by a counter-based ``np.random.Generator`` seeded per
  (seed, epoch, index) so any sample's masking is reproducible in
  isolation (preemption-safe resume; no global RNG state to checkpoint).

Outputs are dense arrays (ids + boolean mask positions) instead of the
reference's ragged Python index lists — the shape XLA wants.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np

from pl_bert_tpu_torch.text.symbols import MASK_ID, SEPARATOR_ID, encode


@dataclass(frozen=True)
class MaskingParams:
    word_pred_prob: float = 0.15
    phoneme_mask_prob: float = 0.8
    replace_prob: float = 0.1
    max_seq_length: int = 512
    word_separator: int = 87  # placeholder token id emitted per phoneme

    def __post_init__(self) -> None:
        # the reference's np.random.choice(p=[pmp, rp, 1-pmp-rp]) raises
        # on an invalid simplex (dataloader.py:85-98); the vectorized
        # inverse-CDF here would instead silently clip replace_prob and
        # make no_change impossible — refuse the same configs it does
        if not 0.0 <= self.phoneme_mask_prob + self.replace_prob <= 1.0:
            raise ValueError(
                "phoneme_mask_prob + replace_prob must be in [0, 1], got "
                f"{self.phoneme_mask_prob} + {self.replace_prob}"
            )


@dataclass
class MaskedSample:
    """One masked training sample (lengths all equal)."""

    masked_ids: np.ndarray  # int32 [L] — input with masking applied
    label_ids: np.ndarray  # int32 [L] — unmasked phoneme ids
    token_ids: np.ndarray  # int32 [L] — per-phoneme grapheme/token ids
    mask_positions: np.ndarray  # bool  [L] — True at masked/replaced chars


def _crop(arrs: list[np.ndarray], mask_pos: np.ndarray, start: int, max_len: int):
    end = start + max_len
    return [a[start:end] for a in arrs], mask_pos[start:end]


def mask_sample_reference_parity(
    word_phonemes: list[str],
    params: MaskingParams,
    token_ids: list[int] | None = None,
) -> MaskedSample:
    """Oracle implementation driving np.random/random global state with the
    reference's exact call sequence (reference: dataloader.py:59-126)."""
    phoneme_str = "".join(word_phonemes)
    if token_ids is None:
        token_ids = [params.word_separator] * len(word_phonemes)

    out_tokens: list[int] = []
    labels = ""
    masked = ""
    masked_index: list[int] = []
    for word, tid in zip(word_phonemes, token_ids):
        out_tokens.extend([tid] * len(word))
        out_tokens.append(params.word_separator)
        labels += word + " "
        if np.random.rand() < params.word_pred_prob:
            action = np.random.choice(
                ["mask", "replace", "no_change"],
                p=[
                    params.phoneme_mask_prob,
                    params.replace_prob,
                    1 - (params.phoneme_mask_prob + params.replace_prob),
                ],
            )
            if action == "replace":
                word_masked = "".join(random.choices(phoneme_str, k=len(word)))
            elif action == "mask":
                word_masked = "M" * len(word)
            else:
                word_masked = word
            if action != "no_change":
                start = len(masked)
                masked_index.extend(range(start, start + len(word_masked)))
        else:
            word_masked = word
        masked += word_masked + " "

    if len(masked) > params.max_seq_length:
        start = int(np.random.randint(0, len(masked) - params.max_seq_length))
        end = start + params.max_seq_length
        masked = masked[start:end]
        labels = labels[start:end]
        out_tokens = out_tokens[start:end]
        masked_index = [i - start for i in masked_index if start <= i < end]

    mask_pos = np.zeros(len(masked), dtype=bool)
    if masked_index:
        mask_pos[np.asarray(masked_index)] = True
    return MaskedSample(
        masked_ids=encode(masked),
        label_ids=encode(labels),
        token_ids=np.asarray(out_tokens, dtype=np.int32),
        mask_positions=mask_pos,
    )


class WholeWordMasker:
    """Vectorized whole-word masking with per-sample counter-based RNG.

    The masking distribution matches the reference exactly; only the RNG
    stream differs (documented design change — reproducibility keyed by
    (seed, epoch, index) instead of global mutable state, see SURVEY §7
    hard part 1).
    """

    def __init__(self, params: MaskingParams, seed: int = 1) -> None:
        self.params = params
        self.seed = seed

    def rng_for(self, epoch: int, index: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, epoch, index])
        )

    def __call__(
        self,
        word_phonemes: list[str],
        epoch: int,
        index: int,
        token_ids: list[int] | None = None,
    ) -> MaskedSample:
        p = self.params
        rng = self.rng_for(epoch, index)

        word_ids = [encode(w) for w in word_phonemes]
        lens = np.array([len(w) for w in word_ids], dtype=np.int64)
        n_words = len(word_ids)

        # layout with separators: word i occupies [starts[i], starts[i]+lens[i])
        starts = np.zeros(n_words, dtype=np.int64)
        if n_words > 1:
            starts[1:] = np.cumsum(lens[:-1] + 1)
        total = int(lens.sum()) + n_words  # + one separator per word

        label_ids = np.full(total, SEPARATOR_ID, dtype=np.int32)
        flat = np.concatenate(word_ids) if n_words else np.zeros(0, np.int32)
        # positions of non-separator chars
        char_pos = np.concatenate(
            [np.arange(s, s + l) for s, l in zip(starts, lens)]
        ) if n_words else np.zeros(0, np.int64)
        label_ids[char_pos] = flat

        # word-level decisions, vectorized
        selected = rng.random(n_words) < p.word_pred_prob
        u = rng.random(n_words)
        do_mask = selected & (u < p.phoneme_mask_prob)
        do_replace = selected & ~do_mask & (
            u < p.phoneme_mask_prob + p.replace_prob
        )

        masked_ids = label_ids.copy()
        mask_pos = np.zeros(total, dtype=bool)
        per_char_mask = np.repeat(do_mask, lens)
        per_char_replace = np.repeat(do_replace, lens)
        masked_ids[char_pos[per_char_mask]] = MASK_ID
        n_repl = int(per_char_replace.sum())
        if n_repl:
            # replacements drawn from this sample's own phonemes (reference
            # WARNING at dataloader.py:95 — kept for distribution parity)
            masked_ids[char_pos[per_char_replace]] = flat[
                rng.integers(0, len(flat), size=n_repl)
            ]
        mask_pos[char_pos[per_char_mask | per_char_replace]] = True

        token_out = np.full(total, p.word_separator, dtype=np.int32)
        if token_ids is not None and n_words:
            token_out[char_pos] = np.repeat(
                np.asarray(token_ids, dtype=np.int32), lens
            )

        if total > p.max_seq_length:
            start = int(rng.integers(0, total - p.max_seq_length))
            (masked_ids, label_ids, token_out), mask_pos = _crop(
                [masked_ids, label_ids, token_out], mask_pos, start, p.max_seq_length
            )
        return MaskedSample(masked_ids, label_ids, token_out, mask_pos)

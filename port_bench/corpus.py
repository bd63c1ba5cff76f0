"""The one generator of the benchmark's training corpora.

A traffic mix's ``corpus`` block says how its samples are shaped:

- ``samples``: how many;
- ``words_per_sample`` [lo, hi): words a sample, uniform; or
  ``min_sample_phonemes``: words are added until the sample's phonemes
  and separators reach it (full-length rows: every sample outruns the
  512 window and is cropped);
- ``phonemes_per_word`` [lo, hi): phonemes a word, uniform;
- ``alphabet``: the phonemes drawn from, uniformly;
- ``token_vocab`` [lo, hi) or null: a grapheme id a word, uniform;
- ``shape_seed``: the seed of the shapes.

The shapes (how many words each sample has and how long each word is)
come from ``shape_seed`` alone, so every run seed trains on the same set
of lengths and the same packed rows' occupancy; the run's seed orders
the samples and draws their phonemes and grapheme ids.
"""

from __future__ import annotations

import numpy as np


def _shapes(spec: dict) -> list[np.ndarray]:
    """Each sample's word lengths, from ``shape_seed``."""
    rng = np.random.default_rng(int(spec["shape_seed"]))
    lo, hi = spec["phonemes_per_word"]
    n = int(spec["samples"])
    if spec.get("words_per_sample"):
        wlo, whi = spec["words_per_sample"]
        counts = rng.integers(wlo, whi, size=n)
        lengths = rng.integers(lo, hi, size=int(counts.sum()))
        return np.split(lengths, np.cumsum(counts)[:-1])
    need = int(spec["min_sample_phonemes"])
    out = []
    for _ in range(n):
        lengths = rng.integers(lo, hi, size=need // (lo + 1) + 1)
        stop = int(np.searchsorted(np.cumsum(lengths + 1), need)) + 1
        out.append(lengths[:stop])
    return out


def make_corpus(spec: dict, seed: int) -> list[dict]:
    """The corpus of one run: records ``{"phonemes": [word, ...]}``, with
    ``"token_ids"`` (one a word) where the mix has a grapheme vocabulary."""
    shapes = _shapes(spec)
    rng = np.random.default_rng(int(seed))
    shapes = [shapes[i] for i in rng.permutation(len(shapes))]
    counts = np.array([len(s) for s in shapes])
    lengths = np.concatenate(shapes)
    alphabet = np.array(list(spec["alphabet"]))
    text = "".join(alphabet[rng.integers(0, len(alphabet), size=int(lengths.sum()))].tolist())
    ends = np.cumsum(lengths)
    words = [text[e - n:e] for e, n in zip(ends.tolist(), lengths.tolist())]
    vocab = spec.get("token_vocab")
    tokens = rng.integers(vocab[0], vocab[1], size=len(words)).tolist() if vocab else None
    corpus, at = [], 0
    for c in counts.tolist():
        record = {"phonemes": words[at:at + c]}
        if tokens is not None:
            record["token_ids"] = tokens[at:at + c]
        corpus.append(record)
        at += c
    return corpus

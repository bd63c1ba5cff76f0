"""PL-BERT's model family: the shared-layer ALBERT encoder with its
masked-phoneme head and, where the configuration has a word vocabulary,
the grapheme head. Every call goes to the modules that hold it:
``corpus.py`` (the phoneme-word corpus), ``weights.py`` (HF
``AlbertModel``'s names), ``feed.py`` (packed or host-masked batches),
``reference.py`` (the fp32 encoder and AdamW) and ``cost.py`` (the
work counts with attention inside each packed segment).

A configuration names this file by its ``"family": "plbert"``; the
interface is ``spec.py``'s.
"""

from __future__ import annotations

import itertools

from port_bench import feed
from port_bench.corpus import make_corpus
# ``step_flops`` and ``kernel_bound_s`` are the family's work counts as they are
from port_bench.cost import batch_stats, kernel_bound_s, step_flops
from port_bench.reference import Reference
from port_bench.symbols import SEPARATOR_ID
from port_bench.weights import make_weights


def model(cell: dict) -> dict:
    """The configuration's ``model_params`` with the token-type table's size."""
    cfg = cell["config"]
    return {**cfg["model_params"], "type_vocab_size": cfg["type_vocab_size"]}


def corpus(cell: dict, seed: int) -> list:
    """The mix's phoneme-word samples, made from ``seed``."""
    return make_corpus(cell["traffic"]["corpus"], seed)


def weights(cell: dict, seed: int, device) -> dict:
    return make_weights(model(cell), seed, device)


def batches(cell: dict, corpus: list, seed: int, n: int) -> list:
    """The first ``n`` micro-batches as ``feed.py`` works them out: packed
    rows, or full rows masked on the host."""
    dp = cell["traffic"]["dataset_params"]
    L, B = dp["max_seq_length"], cell["traffic"]["training_params"]["batch_size"]
    if dp["sequence_packing"]:
        it = feed.packed_batches(corpus, L, B, seed, dp["word_separator"])
    else:
        it = feed.host_masked_batches(corpus, L, B, seed, dp)
    return list(itertools.islice(it, n))


def kept(cell: dict, arrays: dict) -> list:
    """A fed batch's arrays but its grapheme ids where the configuration
    has no word vocabulary, so no grapheme head reads them."""
    heads = cell["config"]["model_params"]["num_token_vocab"] > 0
    return [k for k in arrays if k != "token_ids" or heads]


def stats(cell: dict, arrays: dict) -> dict:
    """``cost.batch_stats`` with the phoneme table's separator, and the
    share of word characters the loss reads where the batch does not
    carry its mask (whole words at ``word_pred_prob``, of them masked or
    replaced)."""
    dp = cell["traffic"]["dataset_params"]
    masked_share = dp["word_pred_prob"] * (dp["phoneme_mask_prob"] + dp["replace_prob"])
    return batch_stats(arrays, SEPARATOR_ID, masked_share)


def reference(cell: dict, weights: dict, rounding: str) -> Reference:
    return Reference(model(cell), cell["config"]["training_params"],
                     cell["traffic"]["dataset_params"], weights, rounding)

"""Operations and bytes that a training step's inputs need, and the
card's peaks: the yardstick of every share the benchmark reports.

Everything counts the work of the step's real tokens (padding left
out), attention only within each packed segment (Σ segment² a row, not
L²), and no recomputation. A kernel's bound is the larger of its
operations at the bf16 tensor-core peak and its bytes at the memory's
(each input read once, each output written once); the LayerNorm
kernels' also takes their fp32 arithmetic and their Philox draws' integer
instructions, as ``chip_smoke.py::ln_bound`` counts them.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# integer instructions a clock on the busier of the IMAD and LOP3 pipes:
# 64 an SM, 132 SMs at the 1,980 MHz boost clock
PEAK_INT = 64 * 132 * 1.98e9
# those instructions a dropout draw in the LayerNorm kernels, counted in
# their SASS (PERF.md §6: the integer terms of 0.0422 and 0.0450 ms at
# [49152, 768] on an H100 SXM)
INT_PER_DRAW = {"K5": 18.7, "K6": 19.9}
BF16 = 2


def batch_stats(batch: dict, separator: int, masked_share: float) -> dict:
    """Host-side counts of one micro-batch (numpy arrays as the feed
    delivered them): real tokens, row slots, Σ segment² over its rows,
    and the positions its losses read (counted where the batch carries
    them, else ``masked_share`` of its word characters)."""
    lengths = np.asarray(batch["lengths"], dtype=np.int64)
    labels = np.asarray(batch["label_ids"])
    L = labels.shape[1]
    real = np.arange(L)[None, :] < lengths[:, None]
    seg = batch.get("segment_ids")
    if seg is None:
        seg_sq = float((lengths ** 2).sum())
    else:
        seg = np.asarray(seg)
        seg_sq = 0.0
        for row in seg:
            counts = np.bincount(row[row >= 0])
            seg_sq += float((counts.astype(np.int64) ** 2).sum())
    if "mask_positions" in batch:
        masked = float((np.asarray(batch["mask_positions"]) & real).sum())
    else:
        masked = masked_share * float(((labels != separator) & real).sum())
    return {"tokens": int(lengths.sum()), "slots": int(labels.size), "seg_sq": seg_sq,
            "masked": masked, "rows": int(labels.shape[0])}


def dense_flops(model: dict, tokens: float) -> float:
    """Forward and backward (3× the forward) of the embedding mapping and
    the layers' projections and FFN."""
    H, E, F = model["hidden_size"], model["embedding_size"], model["intermediate_size"]
    per_layer = 2 * (H * 3 * H + H * H + 2 * H * F)
    return 3 * tokens * (2 * E * H + model["num_hidden_layers"] * per_layer)


def attention_flops(model: dict, seg_sq: float, backward: bool = False) -> float:
    """One layer's q·kᵀ and p·v over every head (4·Σs²·H), or its
    backward's dv, dp, dq and dk (8·Σs²·H)."""
    return (8 if backward else 4) * seg_sq * model["hidden_size"]


def head_flops(model: dict, positions: float, vocab: int) -> float:
    return 3 * 2 * positions * model["hidden_size"] * vocab


def step_flops(model: dict, stats: list[dict]) -> float:
    """A step's operations (its micro-batches' ``batch_stats``)."""
    total = 0.0
    for s in stats:
        total += dense_flops(model, s["tokens"])
        total += model["num_hidden_layers"] * (attention_flops(model, s["seg_sq"])
                                               + attention_flops(model, s["seg_sq"], True))
        total += head_flops(model, s["masked"], model["vocab_size"])
        if model.get("num_token_vocab", 0) > 0:
            total += head_flops(model, s["masked"], model["num_token_vocab"])
    return total


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def kernel_bound_s(kernel: str, model: dict, s: dict) -> float:
    """Least seconds a micro-batch's calls of ``kernel`` (K3-K8) could
    take on the card, summed over its layer applications."""
    H, n = model["hidden_size"], model["num_hidden_layers"]
    M = s["tokens"]
    heads = model["num_attention_heads"]
    rows = s["rows"]
    L = s["slots"] // max(rows, 1)
    stats = 2 * rows * heads * L * 4
    weights = 4 * H * H * BF16
    if kernel == "K7":
        one = _bound(attention_flops(model, s["seg_sq"]), 4 * M * H * BF16)
    elif kernel == "K8":
        one = _bound(attention_flops(model, s["seg_sq"], True), 7 * M * H * BF16)
    elif kernel == "K3":
        one = _bound(8 * M * H * H + attention_flops(model, s["seg_sq"]),
                     2 * M * H * BF16 + weights + 4 * M * H * BF16 + stats)
    elif kernel == "K4":
        one = _bound(8 * M * H * H + attention_flops(model, s["seg_sq"], True),
                     2 * M * (H + 3 * H) * BF16 + weights + stats)
    elif kernel in ("K5", "K6"):
        passes, fp32 = (3, 10) if kernel == "K5" else (5, 20)
        elems = M * H
        draws = elems if model["dropout"] > 0 else 0
        one = max(passes * elems * BF16 / PEAK_BYTES, fp32 * elems / PEAK_FP32,
                  INT_PER_DRAW[kernel] * draws / PEAK_INT)
        return 2 * n * one
    else:
        raise ValueError(f"no bound for {kernel}")
    return n * one

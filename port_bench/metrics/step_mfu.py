"""The whole step's share of the card's bf16 peak, %: the operations the
window's steps need for their real tokens (the model family's
``step_flops``; for PL-BERT, ``cost.step_flops``: the dense layers 3×
their forward, attention within segments, both heads over the positions
their losses read; no padding, no recomputation) over the steps' device
time (CUDA events) and the card's 989 TFLOP/s (``card.PEAK_BF16``)."""

from port_bench.card import PEAK_BF16


def read(w: dict):
    if not w["step_ms"]:
        return None
    flops = sum(w["family"].step_flops(w["model"], step) for step in w["stats"])
    return 100.0 * flops / (sum(w["step_ms"]) / 1e3) / PEAK_BF16

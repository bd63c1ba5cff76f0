"""The whole step's share of the card's bf16 peak, %: the operations the
window's steps need for their real tokens (``cost.step_flops``: the
dense layers 3× their forward, attention within segments, both heads
over the positions their losses read; no padding, no recomputation) over
the steps' device time (CUDA events) and 989 TFLOP/s."""

from port_bench import cost


def read(w: dict):
    if not w["step_ms"]:
        return None
    flops = sum(cost.step_flops(w["model"], step) for step in w["stats"])
    return 100.0 * flops / (sum(w["step_ms"]) / 1e3) / cost.PEAK_BF16

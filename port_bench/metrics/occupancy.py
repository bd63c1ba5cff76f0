"""Real tokens over row slots of the window's batches, in %, counted
from the batches' lengths."""


def read(w: dict):
    slots = sum(m["slots"] for step in w["stats"] for m in step)
    return 100.0 * sum(m["tokens"] for step in w["stats"] for m in step) / slots if slots else None

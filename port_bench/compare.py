"""The numbers that decide ``correct`` for a training cell.

Set-up drives the program's training object through its first steps;
the reference follows the first ``steps`` of them from the same weights
on the same batches. Compared, each with its limit:

- ``feed_arrays_differ``: arrays of those steps' batches in which the
  program's feed and the reference's derivation (``feed.py``) differ;
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over 1 − β₁), worst leaf: the gap
  between the two sides' norms of the leaf over the larger of the
  reference leaf's norm and the median leaf's;
- ``change_gap``: the same, of each leaf's change over the steps,
  leaving out leaves whose first reference gradient is under a
  thousandth of the median leaf's (their moves are the round-off's, as
  a key's bias under the softmax).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# a leaf below this share of the median leaf's gradient norm moves by
# round-off alone
NOUGHT = 1e-3


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def _gap(prog: dict, ref: dict, names) -> tuple[float, str]:
    names = list(names)
    floor = float(np.median([ref[n] for n in names]))
    worst, leaf = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30)
        if not math.isfinite(prog[n]):
            gap = math.inf
        if gap > worst or not leaf:
            worst, leaf = gap, n
    return worst, leaf


def gaps(prog: dict, ref: dict, start: dict) -> dict:
    """``prog``/``ref``: {"losses": [...], "grads": first step's gradient
    by leaf, "params": the parameters after the compared steps};
    ``start``: the parameters both began from. → {number: value} and,
    under ``leaves``, the worst leaf of each."""
    losses = [abs(p - r) / max(abs(r), 1e-30) if math.isfinite(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    g_prog, g_ref = _norms(prog["grads"]), _norms(ref["grads"])
    grad_gap, grad_leaf = _gap(g_prog, g_ref, g_ref)
    median = float(np.median(list(g_ref.values())))
    moving = [n for n in g_ref if g_ref[n] >= NOUGHT * median]
    d_prog = _norms({n: prog["params"][n] - start[n] for n in moving})
    d_ref = _norms({n: ref["params"][n] - start[n] for n in moving})
    change_gap, change_leaf = _gap(d_prog, d_ref, moving)
    return {"loss_gap": max(losses), "grad_gap": grad_gap, "change_gap": change_gap,
            "leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                       "left_out": sorted(set(g_ref) - set(moving))}}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of every limited number."""
    checks = {name: {"value": numbers[name], "limit": limit} for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks

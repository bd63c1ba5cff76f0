"""Everything a cell is made of, found by the names in ``BENCHMARK.json``:
``port_bench/configs/<config>.json`` (the model and its training
settings), ``port_bench/traffic/<traffic>.json`` (batch, packing,
masking, path and corpus), ``port_bench/limits/<workload>.json`` (the
limits of the numbers that decide ``correct``),
``port_bench/metrics/<metric>.py`` (a reader a per-layer metric) and
``port_bench/families/<family>.py`` (the model family that the
configuration names under ``"family"``). A later cell, mix,
configuration, metric or model family is new files and new entries.

A family file holds what belongs to one architecture, as module-level
functions; ``cell`` is what :func:`cell` returns:

- ``model(cell) -> dict``: the model dict the readers get as
  ``w["model"]``;
- ``corpus(cell, seed)``: the dataset handed to the program's Trainer;
- ``weights(cell, seed, device) -> dict``: the state dict the model
  loads with ``strict=True``;
- ``batches(cell, corpus, seed, n) -> list[dict]``: the reference's own
  derivation of the first ``n`` micro-batches the feed delivers;
- ``kept(cell, arrays) -> list[str]``: the keys of a fed batch
  that are compared with that derivation;
- ``stats(cell, arrays) -> dict``: a micro-batch's host counts, at least
  ``tokens``, ``slots`` and ``rows``;
- ``reference(cell, weights, rounding)``: an object with
  ``step(batches, k, seed) -> loss``, ``grads()`` and ``params``;
- ``step_flops(model, stats)`` and ``kernel_bound_s(kernel, model,
  stats)``: the work counts behind every share."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def cell(root: Path, workload: str) -> dict:
    """The cell's workload entry, configuration, traffic, limits, metrics
    (the end-to-end ones it reports, the per-layer ones it reads) and
    model family (its module)."""
    bench = load(root)
    entry = _named(bench["workloads"], workload, "workload")
    config = _named(bench["configs"], entry["config"], "configuration")
    bench_dir = root / "port_bench"
    cfg = _read(root / config["file"])
    if "family" not in cfg:
        raise ValueError(f"{config['file']} names no model family: it needs a \"family\" key, "
                         "the name of a file under port_bench/families/")

    def mine(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "workload": entry,
        "config": cfg,
        "traffic": _read(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        "limits": _read(bench_dir / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
        "metrics_dir": bench_dir / "metrics",
        "family": family(bench_dir / "families", cfg["family"]),
    }


def family(families_dir: Path, name: str):
    """The module of model family ``name``, loaded from its file."""
    return _load(families_dir / f"{name}.py", f"port_bench_family_{name}")


def reader(metrics_dir: Path, name: str):
    """The ``read(window) → number or None`` of per-layer metric ``name``."""
    return _load(metrics_dir / f"{name}.py", f"port_bench_metric_{name}").read


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

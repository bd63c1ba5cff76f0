"""Everything a cell is made of, found by the names in ``BENCHMARK.json``:
``port_bench/configs/<config>.json`` (the model and its training
settings), ``port_bench/traffic/<traffic>.json`` (batch, packing,
masking, path and corpus), ``port_bench/limits/<workload>.json`` (the
limits of the numbers that decide ``correct``) and
``port_bench/metrics/<metric>.py`` (a reader a per-layer metric). A
later cell, mix, configuration or metric is new files and new entries."""

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
    """The cell's workload entry, configuration, traffic, limits and
    metrics (the end-to-end ones it reports, the per-layer ones it reads)."""
    bench = load(root)
    entry = _named(bench["workloads"], workload, "workload")
    config = _named(bench["configs"], entry["config"], "configuration")
    bench_dir = root / "port_bench"

    def mine(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    return {
        "workload": entry,
        "config": _read(root / config["file"]),
        "traffic": _read(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        "limits": _read(bench_dir / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
        "metrics_dir": bench_dir / "metrics",
    }


def reader(metrics_dir: Path, name: str):
    """The ``read(window) → number or None`` of per-layer metric ``name``."""
    path = metrics_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

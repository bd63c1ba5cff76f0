"""BENCHMARK.json against the benchmark's contract, and every cell found
by name; a cell, a mix, a configuration and a per-layer metric added as
files and entries only."""

import json
import re
from pathlib import Path

import pytest

from port_bench import spec
from port_bench.tests.tiny import REPO, tiny_root

BENCH = json.loads((REPO / "BENCHMARK.json").read_text(encoding="utf-8"))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and not path.startswith("/")
        assert ".." not in Path(path).parts and (REPO / path).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(1 <= len(word) <= 200 and "\n" not in word for word in BENCH["command"])
    # every run fits the check's time: 2 + 14 runs a cell, 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
        assert set(e) <= allowed[section]
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "per_layer":
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert e["moves"] in {m["name"] for m in BENCH["end_to_end"]}
            assert set(e["workloads"]) <= set(CELLS)
            if e["name"].endswith("_roofline"):
                assert e["unit"] == "%"
        if section == "workloads":
            assert NAME.fullmatch(e["config"]) and NAME.fullmatch(e["traffic"])
            assert e["chips"] in (1, 4)
        if section == "configs":
            assert len(e["reduced"]) <= 16 and e["source"].startswith("https://")


def test_every_config_used_and_every_pair_once():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.cell(REPO, cell)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    assert set(c["limits"]["limits"]) == {"feed_arrays_differ", "loss_gap", "grad_gap",
                                          "change_gap"}
    assert {m["name"] for m in c["end_to_end"]} == {"real_tokens_per_s", "setup_s"}
    assert c["per_layer"]
    for metric in c["per_layer"]:
        assert callable(spec.reader(c["metrics_dir"], metric["name"]))


def test_cell_added_as_files_and_entries(tmp_path):
    """A later cell: a configuration, a mix, its limits and a per-layer
    metric, each a new file beside an unchanged copy of the benchmark."""
    root = tiny_root(tmp_path, "train_packed")
    (root / "port_bench" / "metrics" / "rows_a_step.py").write_text(
        "def read(w):\n    return sum(m['rows'] for s in w['stats'] for m in s) / w['steps']\n",
        encoding="utf-8")
    bench = json.loads((root / "BENCHMARK.json").read_text(encoding="utf-8"))
    bench["per_layer"].append({"name": "rows_a_step", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "data packing",
                               "moves": "real_tokens_per_s", "workloads": ["tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench), encoding="utf-8")
    for name in ("port_bench/run.py", "port_bench/spec.py", "port_bench/configs/plbert_ar.json"):
        assert (root / name).read_bytes() == (REPO / name).read_bytes()
    c = spec.cell(root, "tiny")
    assert c["config"]["model_params"]["hidden_size"] == 128
    assert c["traffic"]["training_params"]["batch_size"] == 8
    read = spec.reader(c["metrics_dir"], "rows_a_step")
    assert read({"stats": [[{"rows": 8}], [{"rows": 8}]], "steps": 2}) == 8
    assert "rows_a_step" in {m["name"] for m in c["per_layer"]}

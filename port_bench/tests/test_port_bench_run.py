"""Whole runs of a cell at test widths on the CPU (the harness's look
for a card skipped): the result's keys, ``correct`` on the program as it
is, and ``correct`` false with the timed path broken underneath."""

import json
import subprocess
import sys

import pytest

from port_bench import faults, run
from port_bench.tests.tiny import REPO, kernel_ln_stream, tiny_root

SEED = 2**31 + 977


@pytest.fixture
def fp32_cpu(monkeypatch):
    """The program's CPU path in fp32, dropping what its kernels drop, so
    that it agrees with the fp32 reference to round-off."""
    kernel_ln_stream(monkeypatch)


@pytest.mark.parametrize("base", ["mt_train_packed", "train_full", "train_packed"])
def test_program_as_it_is_is_correct(tmp_path, fp32_cpu, base):
    result = run.run(tiny_root(tmp_path, base), "tiny", SEED, 0.2, trace=False, device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"real_tokens_per_s", "setup_s"}
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"]["feed_arrays_differ"]["value"] == 0


def test_traced_run_reports_per_layer_metrics(tmp_path, fp32_cpu):
    result = run.run(tiny_root(tmp_path, "train_packed"), "tiny", SEED, 0.2, trace=True,
                     device="cpu")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert {"feed_wait_ms", "occupancy"} <= set(result["metrics"])
    # no card, no device time: a reader that finds nothing reports nothing
    assert "K7_roofline" not in result["metrics"] and "device_idle" not in result["metrics"]
    assert set(result["device"]) >= {"busy_s", "window_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("base", ["mt_train_packed", "train_full"])
def test_a_broken_step_is_not_correct(tmp_path, fp32_cpu, fault, base):
    result = run.run(tiny_root(tmp_path, base), "tiny", SEED, 0.2, trace=False, device="cpu",
                     hook=faults.FAULTS[fault])
    assert not result["correct"], result["checks"]


def test_no_card_no_result():
    """Without a CUDA card the command exits with another code than 0
    and prints no result."""
    proc = subprocess.run([sys.executable, "-m", "port_bench", "--workload", "train_packed",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    with pytest.raises(json.JSONDecodeError):
        json.loads(proc.stdout or "")

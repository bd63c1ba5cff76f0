"""The port's elastic launcher (``training/orchestrate.py``): the restart
tracker, the in-process supervised loop, and one whole-process relaunch
of the port's Trainer on the CPU that crashes (rc 17) and resumes to the
end (reference: modal_main.py:5-51)."""

import json
import os

import pytest
import yaml

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.training.orchestrate import RestartTracker, launch, launch_subprocess


@pytest.mark.parametrize("existing", [None, "{not json", '{"last_start": 1}'])
def test_restart_tracker_counts_and_restarts_from_a_bad_file(tmp_path, existing):
    path = tmp_path / "state" / "tracker.json"
    if existing is not None:
        path.parent.mkdir()
        path.write_text(existing)
    tracker = RestartTracker(str(path))
    assert [tracker.track() for _ in range(3)] == [0, 1, 2]
    assert json.loads(path.read_text())["count"] == 2
    assert not os.path.exists(str(path) + ".tmp")


def _config(tmp_path):
    path = str(tmp_path / "cfg.yml")
    Config.from_dict({"training_params": {"output_dir": str(tmp_path / "out")}}).save(path)
    return path


@pytest.mark.parametrize("failures,max_restarts", [(2, 5), (3, 2)])
def test_launch_restarts_then_gives_up(tmp_path, failures, max_restarts):
    calls = []

    def flaky_train(args):
        calls.append(args)
        if len(calls) <= failures:
            raise RuntimeError("simulated preemption")
        return 42

    args = {"config_path": _config(tmp_path), "run_name": "r", "device": "cpu"}
    if failures > max_restarts:
        with pytest.raises(RuntimeError, match="simulated"):
            launch(args, max_restarts=max_restarts, restart_delay=0.0, train_fn=flaky_train)
        assert len(calls) == max_restarts + 1
    else:
        assert launch(args, max_restarts=max_restarts, restart_delay=0.0,
                      train_fn=flaky_train) == 42
        assert len(calls) == failures + 1
    assert all(a is args for a in calls)
    state = json.loads((tmp_path / "out" / "r" / "restart_tracker.json").read_text())
    assert state["count"] == len(calls) - 1


def test_subprocess_relaunch_resumes_after_a_crash(tmp_path):
    """Each attempt is a fresh ``python -m pl_bert_tpu_torch.training.train
    --device cpu``; the first dies at step 2 (rc 17) after its step-2
    checkpoint, the second resumes from it and finishes the budget."""
    raw = {
        "training_params": dict(output_dir=str(tmp_path / "ckpt"), mixed_precision="fp32",
                                batch_size=4, save_interval=2, log_interval=1, num_steps=4,
                                training_dataset="synthetic:40:0:3-12"),
        "dataset_params": dict(max_seq_length=64, ondevice_masking=True,
                               sequence_packing=True),
        "model_params": dict(hidden_size=64, num_attention_heads=2, intermediate_size=128,
                             max_position_embeddings=64, num_hidden_layers=1,
                             embedding_size=32, attention_impl="pallas"),
    }
    cfg_path = tmp_path / "config.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PLBERT_CRASH_AT_STEP": "2",
           "PYTHONPATH": os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")])}
    rc = launch_subprocess({"config_path": str(cfg_path), "run_name": "elastic",
                            "device": "cpu"}, max_restarts=2, restart_delay=0.0, env=env)
    assert rc == 0
    run = tmp_path / "ckpt" / "elastic"
    assert (run / ".crash_injected").exists()
    assert json.loads((run / "restart_tracker.json").read_text())["count"] == 1
    assert sorted(p.name for p in run.glob("step_*.pth")) == ["step_2.pth", "step_4.pth"]
    assert int((run / "launcher_child.pid").read_text()) > 0
    steps = [json.loads(line)["step"] for line in open(run / "metrics.jsonl")
             if "loss" in json.loads(line)]
    # the crashed child logged steps 1-2, the relaunched one 3-4
    assert steps == [1, 2, 3, 4], steps

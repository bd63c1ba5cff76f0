"""The port's Trainer entry point on the CPU, at a tiny size (2 layers,
hidden 128, L 64, batch 4): resume, the JAX Trainer's loss trajectory,
the packed on-device run on the flash path, checkpoint retention and
tails, fault injection, and checkpoints across the two packages."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from pl_bert_tpu.config import Config as JaxConfig
from pl_bert_tpu.training import train as jax_train
from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.training import checkpoint as ckpt
from pl_bert_tpu_torch.training import train as port_train
from pl_bert_tpu_torch.training import train_step as ts

REPO = Path(__file__).resolve().parent.parent
MODEL = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=64, num_hidden_layers=2, embedding_size=32)


def _write_config(tmp_path, name="cfg.yml", model=None, dataset=None, **training):
    raw = {
        "training_params": {
            **dict(output_dir=str(tmp_path / "runs"), mixed_precision="fp32", batch_size=4,
                   save_interval=3, log_interval=1, num_steps=6, learning_rate=1e-3,
                   training_dataset="synthetic:160:0:3-12"), **training},
        "dataset_params": dict(max_seq_length=64, **(dataset or {})),
        "model_params": dict(MODEL, **(model or {})),
    }
    path = tmp_path / name
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _run(config_path, run_name):
    return port_train.train({"config_path": config_path, "run_name": run_name,
                             "device": "cpu"})


def _records(tmp_path, run_name):
    with open(tmp_path / "runs" / run_name / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _set_steps(path, steps):
    raw = yaml.safe_load(Path(path).read_text())
    raw["training_params"]["num_steps"] = steps
    Path(path).write_text(yaml.safe_dump(raw))


PACKED = dict(model={"attention_impl": "pallas", "dropout": 0.1},
              dataset={"ondevice_masking": True, "sequence_packing": True})


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_narrow_heads_train_on_the_eager_path(tmp_path, caplog, impl):
    """12 heads of 32 (a shape the JAX Trainer trains through its XLA
    fallback): the kernels do not take head_dim 32, so the model resolves
    the eager path, logs why, and the Trainer takes a step with it."""
    import logging

    cfg = _write_config(tmp_path, num_steps=1, save_interval=1, model={
        "hidden_size": 384, "num_attention_heads": 12, "attention_impl": impl})
    with caplog.at_level(logging.WARNING, logger="pl_bert_tpu_torch.models.albert"):
        assert _run(cfg, "narrow") == 1
    assert any("falls back to the eager path" in r.message and "head_dim 32" in r.message
               for r in caplog.records)
    losses = [r["loss"] for r in _records(tmp_path, "narrow") if "loss" in r]
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_six_steps_equal_three_plus_resume_plus_three(tmp_path, capsys):
    """On the packed, on-device-masked run on the flash path with
    dropout: parameters and AdamW moments of step 6 are bitwise those of
    an uninterrupted run, and metrics.jsonl continues without a gap. The
    run trains (loss falls) and validates."""
    cfg = _write_config(tmp_path, **PACKED)
    assert _run(cfg, "whole") == 6
    assert "sequence packing: 160 samples" in capsys.readouterr().out
    _set_steps(cfg, 3)
    assert _run(cfg, "split") == 3
    assert ckpt.list_checkpoints(tmp_path / "runs" / "split") == [3]
    # a resumed run reads the run directory's config copy
    _set_steps(tmp_path / "runs" / "split" / "cfg.yml", 6)
    assert _run(cfg, "split") == 6
    assert "step_3.pth loaded" in capsys.readouterr().out
    a = torch.load(ckpt.checkpoint_path(tmp_path / "runs" / "whole", 6), weights_only=True)
    b = torch.load(ckpt.checkpoint_path(tmp_path / "runs" / "split", 6), weights_only=True)
    assert a["step"] == b["step"] == 6 and a["batch_in_epoch"] == b["batch_in_epoch"] == 6
    for k in a["net"]:
        assert torch.equal(a["net"][k], b["net"][k]), k
    for i in a["optimizer"]["state"]:
        for part in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["optimizer"]["state"][i][part],
                               b["optimizer"]["state"][i][part]), (i, part)
    whole = [r for r in _records(tmp_path, "whole") if "loss" in r]
    split = [r for r in _records(tmp_path, "split") if "loss" in r]
    assert [r["step"] for r in split] == [1, 2, 3, 4, 5, 6]
    assert [r["loss"] for r in split] == [r["loss"] for r in whole]
    vals = [r for r in _records(tmp_path, "whole") if "val_phoneme_loss" in r]
    assert [r["step"] for r in vals] == [0, 3, 6]
    assert all(np.isfinite(r["val_phoneme_loss"]) for r in vals)
    assert whole[-1]["loss"] < whole[0]["loss"]


def test_host_masking_run_follows_the_jax_trainer(tmp_path, capsys):
    """Host masking, dropout 0, fp32: from the JAX Trainer's initial
    weights (carried across as a ``.pth``) the port's Trainer logs the
    same validation loss and the same loss at every step within the rtol
    1e-4 of the step test (same corpus, same seed, so the same batches)."""
    # batch 8: the JAX tests run on a mesh of eight host devices
    jcfg = _write_config(tmp_path, "jax.yml", model={"dropout": 0.0}, num_steps=5,
                         save_interval=100, batch_size=8)
    config = JaxConfig.load(jcfg)
    log_dir = str(tmp_path / "runs" / "jax")
    os.makedirs(log_dir)
    trainer = jax_train.Trainer(config, log_dir, resuming=False)
    init = str(tmp_path / "init.pth")
    torch.save({"net": bridge.model_state_dict_from_jax(
        jax.tree.map(np.asarray, trainer.state.params))}, init)
    try:
        assert trainer.train() == 5
    finally:
        trainer.metrics.close()
    pcfg = _write_config(tmp_path, "port.yml", model={"dropout": 0.0, "pretrained_model": init},
                         num_steps=5, save_interval=100, batch_size=8)
    assert _run(pcfg, "port") == 5
    want = [r for r in _records(tmp_path, "jax")]
    got = [r for r in _records(tmp_path, "port")]
    assert [sorted(r) for r in got if "loss" in r] and len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == w["step"] and g["epoch"] == w["epoch"]
        for k in ("loss", "phoneme_loss", "grad_norm", "val_phoneme_loss",
                  "val_masked_accuracy"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"step {g['step']} {k}")
    # the tail checkpoint: num_steps is off the save_interval grid
    assert ckpt.list_checkpoints(tmp_path / "runs" / "port") == [5]


def test_keep_checkpoints_and_the_tail(tmp_path):
    cfg = _write_config(tmp_path, num_steps=5, save_interval=2, keep_checkpoints=2)
    assert _run(cfg, "keep") == 5
    run_dir = tmp_path / "runs" / "keep"
    assert ckpt.list_checkpoints(run_dir) == [4, 5]
    assert ckpt.find_latest_checkpoint(run_dir) == (True, 5)
    assert ckpt.find_latest_checkpoint(tmp_path / "nowhere") == (False, 0)
    assert ckpt.load_checkpoint_meta(ckpt.checkpoint_path(run_dir, 5)) == {
        "step": 5, "epoch": 1, "batch_in_epoch": 5}
    assert not [n for n in os.listdir(run_dir) if ".tmp" in n]
    # complete: a relaunch trains no further
    assert _run(cfg, "keep") == 5


def test_epoch_cap_saves_the_tail_as_complete(tmp_path):
    """max_epochs ends the run before num_steps: the tail is saved with
    epoch max_epochs + 1, so a relaunch sees the run as complete."""
    cfg = _write_config(tmp_path, num_steps=100, save_interval=4, max_epochs=1,
                        training_dataset="synthetic:40:0:3-12")
    assert _run(cfg, "cap") == 9  # 38 training samples, 9 batches of 4
    run_dir = tmp_path / "runs" / "cap"
    assert ckpt.list_checkpoints(run_dir) == [4, 8, 9]
    assert ckpt.load_checkpoint_meta(ckpt.checkpoint_path(run_dir, 9))["epoch"] == 2
    assert _run(cfg, "cap") == 9


def test_crash_at_step_exits_17_then_resumes(tmp_path):
    cfg = _write_config(tmp_path, num_steps=4, save_interval=2)
    env = dict(os.environ, PLBERT_CRASH_AT_STEP="2", PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "pl_bert_tpu_torch.training.train", "--config_path", cfg,
           "--run_name", "crash", "--device", "cpu"]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    assert first.returncode == 17, first.stdout + first.stderr
    assert "fault injection: dying at step 2" in first.stdout
    run_dir = tmp_path / "runs" / "crash"
    assert ckpt.list_checkpoints(run_dir) == [2] and (run_dir / ".crash_injected").exists()
    os.environ["PLBERT_CRASH_AT_STEP"] = "2"
    try:  # the marker disarms the injection: the relaunch runs to the end
        assert _run(cfg, "crash") == 4
    finally:
        del os.environ["PLBERT_CRASH_AT_STEP"]
    assert ckpt.list_checkpoints(run_dir) == [2, 4]
    assert [r["step"] for r in _records(tmp_path, "crash") if "loss" in r] == [1, 2, 3, 4]


def test_async_save_writes_the_same_checkpoints(tmp_path):
    for name, async_save in (("blocking", False), ("async", True)):
        cfg = _write_config(tmp_path, f"{name}.yml", num_steps=4, save_interval=2,
                            async_save=async_save)
        assert _run(cfg, name) == 4
    for step in (2, 4):
        a = Path(ckpt.checkpoint_path(tmp_path / "runs" / "blocking", step)).read_bytes()
        b = Path(ckpt.checkpoint_path(tmp_path / "runs" / "async", step)).read_bytes()
        assert a == b


def test_async_writer_surfaces_a_failed_write(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = ckpt.AsyncCheckpointWriter()
    model = torch.nn.Linear(2, 2)
    opt = ts.AdamW(1e-3).init(model)
    writer.submit(str(blocker / "run"), 1, model.state_dict(), opt)
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()  # the error is raised once


def test_checkpoints_cross_the_two_packages(tmp_path):
    """A port ``step_N.pth`` goes through ``import_reference_run`` into
    the JAX package (parameters, AdamW moments and update count), and a
    ``.pth`` that ``export/to_torch.py`` writes resumes parameters in the
    port (``pretrained_model``)."""
    import optax

    from pl_bert_tpu.export.from_torch import import_reference_run
    from pl_bert_tpu.export.to_torch import export_reference_checkpoint
    from pl_bert_tpu.models.albert import build_model as jax_build_model
    from pl_bert_tpu.models.albert import init_params as jax_init_params
    from pl_bert_tpu.training import train_step as jax_ts

    cfg = _write_config(tmp_path, num_steps=3)
    assert _run(cfg, "cross") == 3
    path = ckpt.checkpoint_path(tmp_path / "runs" / "cross", 3)
    config = JaxConfig.load(cfg)
    template = jax_init_params(jax_build_model(config.model_params, "fp32"), 64, seed=0)
    tx = jax_ts.make_optimizer(config.training_params)
    params, opt_state, step, epoch = import_reference_run(path, template, tx)
    saved = torch.load(path, weights_only=True)
    assert (step, epoch) == (3, 1)
    back = bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, params))
    for k, v in saved["net"].items():
        assert torch.equal(back[k], v), k
    adam = next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda n: isinstance(
        n, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState))
    assert int(adam.count) == 3
    mu = bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, adam.mu))
    names = list(saved["net"])
    for i, name in enumerate(names):
        assert torch.equal(mu[name], saved["optimizer"]["state"][i]["exp_avg"]), name

    exported = str(tmp_path / "jax_step_7.pth")
    export_reference_checkpoint(template, optax.adamw(1e-4).init(template),
                                config.training_params, exported, step=7)
    warm = _write_config(tmp_path, "warm.yml", model={"pretrained_model": exported},
                         num_steps=1)
    trainer = port_train.Trainer(Config.load(warm), str(tmp_path / "runs" / "warm"),
                                 resuming=False, device="cpu")
    trainer.metrics.close()
    want = bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, template))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert ckpt.load_checkpoint_meta(exported)["step"] == 7


def test_trainer_refuses_what_is_not_ported(tmp_path):
    cfg = Config.load(_write_config(tmp_path, dataset={"sequence_packing": True}))
    with pytest.raises(ValueError, match="requires ondevice_masking"):
        port_train.Trainer(cfg, str(tmp_path / "r"), resuming=False, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        port_train.load_training_dataset("some/hub-id", "train")
    args = port_train.parse_args(["--config_path", "c.yml", "--run_name", "r"])
    assert args == {"config_path": "c.yml", "run_name": "r", "device": "cuda"}

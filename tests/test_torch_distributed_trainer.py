"""The port's Trainer on a (data, model) mesh: ``python -m
pl_bert_tpu_torch.training.train`` in two processes over gloo on the CPU
(``PLBERT_DISTRIBUTED=1`` and the ``PLBERT_*`` rendezvous), at a tiny size
(2 layers, hidden 128, L 64, global batch 8, fp32, dropout 0, 4 steps),
held against one-process runs of the same config:

- data 2, and data 2 with ZeRO-1: losses and grad norms within 1e-5
  relative of one process; ZeRO-1 bitwise the replicated update (losses,
  grad norms, the saved parameters and moments);
- model 2 + sequence parallelism + ZeRO-1 on the multi-task model (block
  path, accumulation 2, the grapheme head's gather; the head's 101 words
  split 51/50 over the model ranks, against the one-process run's whole
  head of 101), model 2 on the flash
  path, and model 2 + sequence parallelism with 3 heads (which do not
  divide the model axis: the attention runs whole on both ranks, on the
  eager path, as JAX's falls back to XLA): within 1e-5 of one process;
- only rank 0 writes ``metrics.jsonl``;
- a two-rank save at step 2 resumes on relaunch bit for bit, and loads
  into a one-process run with every moment bitwise the file's; a
  one-process save resumes on two ranks.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch
import yaml

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.training import checkpoint as ckpt
from pl_bert_tpu_torch.training import train as port_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=64, num_hidden_layers=2, embedding_size=32, dropout=0.0)
MULTITASK = dict(model={"num_token_vocab": 101}, grad_accum_steps=2, lm_head_capacity=8)
THREE_HEADS = {"hidden_size": 192, "num_attention_heads": 3}
RTOL = 1e-5


def _write(path, out_dir, model=None, **training):
    raw = {
        "training_params": {**dict(output_dir=str(out_dir), mixed_precision="fp32",
                                   batch_size=8, save_interval=2, log_interval=1, num_steps=4,
                                   learning_rate=1e-3, training_dataset="synthetic:160:0:8-30"),
                            **training},
        "dataset_params": {"max_seq_length": 64, "ondevice_masking": True},
        "model_params": dict(MODEL, **(model or {})),
    }
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(config_path, run_name, n=2):
    """The CLI in ``n`` processes, one per rank; returns the Popens."""
    env = dict(os.environ, PYTHONPATH=REPO, PLBERT_DISTRIBUTED="1",
               PLBERT_COORDINATOR=f"localhost:{_port()}", PLBERT_NUM_PROCESSES=str(n),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, "-m", "pl_bert_tpu_torch.training.train", "--config_path",
         config_path, "--run_name", run_name, "--device", "cpu"],
        env=dict(env, PLBERT_PROCESS_ID=str(rank)), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(n)]


def _wait(procs) -> list[str]:
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _run(config_path, run_name):
    return port_train.train({"config_path": config_path, "run_name": run_name,
                             "device": "cpu"})


def _steps(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "grad_norm" in r]


def _set_steps(path, steps):
    raw = yaml.safe_load(open(path).read())
    raw["training_params"]["num_steps"] = steps
    open(path, "w").write(yaml.safe_dump(raw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    out = tmp / "runs"
    cfgs = {
        "one": _write(tmp / "one.yml", out),
        "flash": _write(tmp / "flash.yml", out, model={"attention_impl": "pallas"}),
        "mt": _write(tmp / "mt.yml", out, **MULTITASK),
        "dp": _write(tmp / "dp.yml", out, data_axis=2),
        "split": _write(tmp / "split.yml", out, data_axis=2, zero1=True, num_steps=2),
        "mt_sp": _write(tmp / "mt_sp.yml", out, model_axis=2, zero1=True,
                        **dict(MULTITASK, model={"num_token_vocab": 101,
                                                 "sequence_parallel": True})),
        "tp_flash": _write(tmp / "tp_flash.yml", out, model_axis=2,
                           model={"attention_impl": "pallas"}),
        "half": _write(tmp / "half.yml", out, num_steps=2),
        "three": _write(tmp / "three.yml", out, model=THREE_HEADS),
        "whole": _write(tmp / "whole.yml", out, model_axis=2,
                        model=dict(THREE_HEADS, sequence_parallel=True)),
    }
    two = [(name, _launch(cfgs[name], name))
           for name in ("dp", "split", "mt_sp", "tp_flash", "whole")]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the ranks, on a shared host
    try:
        for name in ("one", "flash", "mt", "half", "three"):  # one process, here, meanwhile
            _run(cfgs[name], name)
    finally:
        torch.set_num_threads(threads)
    outs = {name: _wait(procs) for name, procs in two}
    # relaunches: the two-rank run resumes from its step 2, the
    # one-process run's step 2 resumes on two ranks
    for name in ("split", "half"):
        _set_steps(out / name / f"{name}.yml", 4)
    again = [(name, _launch(cfgs[name], name)) for name in ("split", "half")]
    for name, procs in again:
        outs[name + "_resumed"] = _wait(procs)
    # the two-rank ZeRO-1 run's step 2 resumes on one process
    shutil.copytree(out / "split", out / "back")
    os.remove(out / "back" / "step_4.pth")
    os.remove(out / "back" / "metrics.jsonl")
    os.remove(out / "back" / "split.yml")
    _write(out / "back" / "back.yml", out, zero1=True)  # the same run on one process
    shutil.copy(out / "back" / "back.yml", tmp / "back.yml")
    _run(str(tmp / "back.yml"), "back")
    return {"out": out, "outs": outs}


def _close(got, want, keys=("loss", "grad_norm")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        for k in keys:
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (k, g, w)


@pytest.mark.parametrize("name,ref", [("dp", "one"), ("split", "one"), ("mt_sp", "mt"),
                                      ("tp_flash", "flash"), ("whole", "three")])
def test_sharded_runs_follow_one_process(runs, name, ref):
    """Losses and grad norms of the two-rank runs within 1e-5 relative of
    the one-process run of the same config (the multi-task run's
    phoneme and token losses too)."""
    keys = ("loss", "grad_norm") + (("phoneme_loss", "token_loss") if ref == "mt" else ())
    _close(_steps(runs["out"] / name), _steps(runs["out"] / ref), keys)
    assert {r["token_loss"] > 0 for r in _steps(runs["out"] / name)} == {ref == "mt"}


def test_zero1_is_bitwise_the_replicated_update(runs):
    """ZeRO-1 against the replicated AdamW in the same world: the same
    losses and grad norms, and the same saved parameters and moments, bit
    for bit (tests/test_zero1.py:66 holds JAX to the same). The ZeRO-1
    run stopped at step 2 and was relaunched, so its resume is bitwise
    too."""
    out = runs["out"]
    keys = ("step", "loss", "grad_norm")
    assert ([{k: r[k] for k in keys} for r in _steps(out / "split")]
            == [{k: r[k] for k in keys} for r in _steps(out / "dp")])
    a = torch.load(out / "split" / "step_4.pth", weights_only=True)
    b = torch.load(out / "dp" / "step_4.pth", weights_only=True)
    assert a["net"].keys() == b["net"].keys()
    for name in a["net"]:
        assert torch.equal(a["net"][name], b["net"][name]), name
    for i, entry in a["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(entry[key], b["optimizer"]["state"][i][key]), (i, key)


def test_only_rank_zero_writes(runs):
    """One metrics.jsonl with one record a step, and the run's prints
    from rank 0 alone."""
    out = runs["out"]
    for name in ("dp", "split", "mt_sp", "tp_flash", "whole"):
        assert [r["step"] for r in _steps(out / name)] == [1, 2, 3, 4]
        assert set(os.listdir(out / name)) == {f"{name}.yml", "metrics.jsonl", "step_2.pth",
                                               "step_4.pth"}
        first, second = runs["outs"][name + "_resumed" if name == "split" else name]
        assert "Training completed at step 4" in first
        assert "Training completed" not in second and "Starting epoch" not in second


def test_resume_crosses_world_sizes(runs):
    """A two-rank ZeRO-1 save at step 2 resumes on relaunch (bit for bit:
    test_zero1_is_bitwise_the_replicated_update); it loads into one
    process with every moment bitwise the file's, and trains on within
    1e-5; a one-process save resumes on two ranks."""
    out = runs["out"]
    _close(_steps(out / "back"), _steps(out / "split")[2:])
    _close(_steps(out / "half"), _steps(out / "one"))
    # the two-rank file, loaded into a one-process Trainer
    config = Config.load(str(out / "back" / "back.yml"))
    trainer = port_train.Trainer(config, str(out / "back"), False, device="cpu")
    meta = ckpt.load_checkpoint(str(out / "split" / "step_2.pth"), trainer.model,
                                trainer.state.opt_state)
    assert meta["step"] == 2
    saved = torch.load(out / "split" / "step_2.pth", weights_only=True)
    names = [n for n, _ in trainer.model.named_parameters()]
    for i, name in enumerate(names):
        mu, nu = trainer.state.opt_state.moments[name]
        entry = saved["optimizer"]["state"][i]
        assert torch.equal(mu, entry["exp_avg"]) and torch.equal(nu, entry["exp_avg_sq"])
        assert torch.equal(dict(trainer.model.named_parameters())[name], saved["net"][name])
    trainer.metrics.close()


def test_vocab_parallel_checkpoint_is_whole_and_slices_back(runs, tmp_path):
    """The two-rank multi-task run's ``step_4.pth`` holds the whole head
    of 101 words (gathered from its 51 + 50 rows) with its moments; it
    loads into one process, and cut back to each model rank of a 1×2
    mesh gives that rank's rows; the export CLI writes the whole head."""
    from pl_bert_tpu_torch.export import cli
    from pl_bert_tpu_torch.models.albert import build_model
    from pl_bert_tpu_torch.parallel.mesh import Mesh, shard_model, split_bounds

    out = runs["out"]
    path = out / "mt_sp" / "step_4.pth"
    saved = torch.load(path, weights_only=True)
    names = list(saved["net"])
    i = names.index("token_predictor.weight")
    assert saved["net"]["token_predictor.weight"].shape == (101, 128)
    assert saved["net"]["token_predictor.bias"].shape == (101,)
    assert saved["optimizer"]["state"][i]["exp_avg"].shape == (101, 128)
    config = Config.load(str(out / "mt" / "mt.yml"))
    for rank in (0, 1):
        mesh = Mesh(1, 2, rank)
        model = shard_model(build_model(config.model_params, "fp32"), mesh)
        opt = port_train.make_optimizer(config.training_params).init(model)
        ckpt.load_checkpoint(str(path), model, opt, mesh)
        start, stop = split_bounds(101, 2, rank)
        head = dict(model.named_parameters())["token_predictor.weight"]
        assert head.shape == (stop - start, 128)
        assert torch.equal(head, saved["net"]["token_predictor.weight"][start:stop])
        assert torch.equal(opt.moments["token_predictor.weight"][1],
                           saved["optimizer"]["state"][i]["exp_avg_sq"][start:stop])
    cli.main(["--checkpoint_path", str(path), "--config_path", str(out / "mt" / "mt.yml"),
              "--output_dir", str(tmp_path / "hf")])
    full = torch.load(tmp_path / "hf" / "pl_bert_full_model.pt", weights_only=True)
    assert torch.equal(full["token_predictor.weight"], saved["net"]["token_predictor.weight"])

"""The port's Trainer and ``training/evaluate.py`` on the multi-task model,
on the CPU at a tiny size (2 layers, hidden 128, L 64, batch 4, a
grapheme vocabulary of 100): a packed, on-device-masked run with
gradient accumulation 2 on the flash path resumes bit for bit and logs
the grapheme head's validation metrics; ``evaluate`` and
``evaluate_all`` give the Trainer's own validation numbers, and on the
same weights JAX ``evaluate``'s within rtol 1e-5; the Trainer refuses
what JAX's refuses (tests/test_multitask.py:235-290); the
under-capacity warning's threshold; and a multi-task checkpoint serves
as the same encoder without its heads."""

import http.client
import json

import numpy as np
import pytest
import torch
import yaml

from pl_bert_tpu_torch.config import Config
from pl_bert_tpu_torch.models.albert import build_model, init_params
from pl_bert_tpu_torch.models.inference import PhonemeEncoder
from pl_bert_tpu_torch.ops import masked_ce
from pl_bert_tpu_torch.serving.server import build_server, serve_in_thread
from pl_bert_tpu_torch.training import checkpoint as ckpt
from pl_bert_tpu_torch.training import evaluate as port_evaluate
from pl_bert_tpu_torch.training import train as port_train

MODEL = dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
             max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
             num_token_vocab=100)
# packed rows of 64 hold about 5.8 valid masked positions on average; at
# capacity 8 some batches gather and some fall back
PACKED = dict(model={"attention_impl": "pallas", "dropout": 0.1},
              dataset={"ondevice_masking": True, "sequence_packing": True},
              grad_accum_steps=2, lm_head_capacity=8)
VAL_KEYS = ("val_phoneme_loss", "val_masked_accuracy", "val_token_loss", "val_token_accuracy")


def _write_config(path, out_dir, model=None, dataset=None, **training):
    raw = {
        "training_params": {
            **dict(output_dir=str(out_dir), mixed_precision="fp32", batch_size=4,
                   save_interval=3, log_interval=1, num_steps=6, learning_rate=1e-3,
                   training_dataset="synthetic:160:0:3-12"), **training},
        "dataset_params": dict(max_seq_length=64, **(dataset or {})),
        "model_params": dict(MODEL, **(model or {})),
    }
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _run(config_path, run_name):
    return port_train.train({"config_path": config_path, "run_name": run_name,
                             "device": "cpu"})


def _records(run_dir):
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _set_steps(path, steps):
    raw = yaml.safe_load(open(path).read())
    raw["training_params"]["num_steps"] = steps
    open(path, "w").write(yaml.safe_dump(raw))


@pytest.fixture(scope="module")
def packed_runs(tmp_path_factory):
    """6 steps in one run, and 3 steps, a resume and 3 more in another;
    the grapheme head's gather both fits and overflows in them."""
    tmp = tmp_path_factory.mktemp("mt")
    cfg = _write_config(tmp / "cfg.yml", tmp / "runs", **PACKED)
    for counter in (masked_ce.GATHERED, masked_ce.FALLBACKS):
        counter.reset()
    assert _run(cfg, "whole") == 6
    _set_steps(cfg, 3)
    assert _run(cfg, "split") == 3
    _set_steps(tmp / "runs" / "split" / "cfg.yml", 6)
    assert _run(cfg, "split") == 6
    assert masked_ce.GATHERED.count > 0 and masked_ce.FALLBACKS.count > 0
    return cfg, tmp / "runs" / "whole", tmp / "runs" / "split"


def test_packed_multitask_run_resumes_bit_for_bit(packed_runs):
    _, whole, split = packed_runs
    a = torch.load(ckpt.checkpoint_path(whole, 6), weights_only=True)
    b = torch.load(ckpt.checkpoint_path(split, 6), weights_only=True)
    assert a["net"]["token_predictor.weight"].shape == (100, 128)
    assert len(a["optimizer"]["state"]) == len(a["net"])
    for k in a["net"]:
        assert torch.equal(a["net"][k], b["net"][k]), k
    for i in a["optimizer"]["state"]:
        for part in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["optimizer"]["state"][i][part],
                               b["optimizer"]["state"][i][part]), (i, part)
    steps_w = [r for r in _records(whole) if "loss" in r]
    steps_s = [r for r in _records(split) if "loss" in r]
    assert [r["step"] for r in steps_s] == [1, 2, 3, 4, 5, 6]
    for k in ("loss", "phoneme_loss", "token_loss"):
        assert [r[k] for r in steps_s] == [r[k] for r in steps_w], k
    assert all(r["token_loss"] > 0 for r in steps_w)
    for r in steps_w:
        np.testing.assert_allclose(r["loss"], r["phoneme_loss"] + r["token_loss"], rtol=1e-6)
    vals = [r for r in _records(whole) if "val_phoneme_loss" in r]
    assert [r["step"] for r in vals] == [0, 3, 6]
    assert all(np.isfinite(r[k]) for r in vals for k in VAL_KEYS)
    assert vals == [r for r in _records(split) if "val_phoneme_loss" in r][:1] + vals[1:]


def test_evaluate_gives_the_trainers_validation(packed_runs, capsys):
    cfg, whole, _ = packed_runs
    vals = {r["step"]: r for r in _records(whole) if "val_phoneme_loss" in r}
    args = {"checkpoint": str(whole), "config_path": cfg, "device": "cpu"}
    one = port_evaluate.evaluate(args)  # a run dir: its latest step_N.pth
    assert one["checkpoint"] == ckpt.checkpoint_path(whole, 6)
    every = port_evaluate.evaluate_all(args)
    assert [r["checkpoint"] for r in every] == [ckpt.checkpoint_path(whole, s) for s in (3, 6)]
    for step, got in ((6, one), (3, every[0]), (6, every[1])):
        for k in VAL_KEYS:
            assert got[k] == round(vals[step][k], 6), (step, k)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[-1]["checkpoints_scored"] == 2


def test_evaluate_matches_jax_evaluate(tmp_path):
    """On the same weights (a ``.pth`` of the port's multi-task model) and
    host masking, the port's ``evaluate`` gives JAX ``evaluate``'s four
    numbers within rtol 1e-5 (batch 8: the JAX tests run on a mesh of
    eight host devices)."""
    from pl_bert_tpu.training import evaluate as jax_evaluate

    cfg = _write_config(tmp_path / "cfg.yml", tmp_path / "runs", model={"dropout": 0.0},
                        batch_size=8, training_dataset="synthetic:320:0:3-12")
    config = Config.load(cfg)
    model = init_params(build_model(config.model_params, "fp32"), seed=3)
    pth = str(tmp_path / "mt.pth")
    torch.save({"net": model.state_dict()}, pth)
    args = {"checkpoint": pth, "config_path": cfg, "device": "cpu"}
    got = port_evaluate.evaluate(args)
    want = jax_evaluate.evaluate(args)
    assert got["val_batches"] == want["val_batches"] > 0
    for k in VAL_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_evaluate_cli_defaults_to_the_card(packed_runs):
    cfg, whole, _ = packed_runs
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_evaluate.main(["--checkpoint", str(whole), "--config_path", cfg])


def test_multitask_checkpoint_serves_as_its_encoder(packed_runs):
    """A multi-task ``step_N.pth`` serves through ``PhonemeEncoder`` and the
    port's server: its hidden states equal those of the same encoder
    weights without the heads (JAX serves ``params["encoder"]`` alone)."""
    cfg, whole, _ = packed_runs
    path = ckpt.checkpoint_path(whole, 6)
    config = Config.load(cfg)
    enc = PhonemeEncoder.from_checkpoint(path, config, device="cpu", mixed_precision="fp32")
    net = torch.load(path, weights_only=True)["net"]
    bare = {k[len("encoder."):]: v for k, v in net.items() if k.startswith("encoder.")}
    plain = PhonemeEncoder(bare, config.model_params, 64, mixed_precision="fp32", device="cpu")
    texts = ["qalam", "kitaab ʃams"]
    h, _ = enc(texts)
    ref, _ = plain(texts)
    np.testing.assert_array_equal(h, ref)
    direct = PhonemeEncoder.from_checkpoint(path, config, device="cpu", batch_size=2,
                                            seq_buckets=(16,))
    server = build_server(["--checkpoint", path, "--config_path", cfg, "--port", "0",
                           "--device", "cpu", "--max_batch", "2", "--buckets", "16"])
    serve_in_thread(server)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("POST", "/encode", body=json.dumps({"phonemes": texts[1]}),
                     headers={"Content-Type": "application/json"})
        reply = json.loads(conn.getresponse().read())
    finally:
        server.shutdown()
        server.batcher.close()
        server.server_close()
    want, _ = direct([texts[1]])
    n = reply["length"]
    np.testing.assert_allclose(np.asarray(reply["hidden"]), want[0, :n], rtol=1e-6, atol=0)


def _mt_config(tmp_path, **model):
    return Config.from_dict({
        "training_params": {"output_dir": str(tmp_path), "batch_size": 8,
                            "mixed_precision": "fp32"},
        "dataset_params": {"max_seq_length": 64},
        "model_params": dict(MODEL, num_hidden_layers=1, **model),
    })


def _ondevice(config):
    config.dataset_params.ondevice_masking = True
    return config


@pytest.mark.parametrize("case", ["head_not_above_separator", "ondevice_without_token_ids",
                                  "host_without_token_ids", "ondevice_id_out_of_range",
                                  "host_id_out_of_range"])
def test_trainer_refuses_what_jax_refuses(tmp_path, case):
    corpus = port_train.make_synthetic_corpus(16, token_vocab=100)
    config, match = _mt_config(tmp_path), "token_ids"
    if case == "head_not_above_separator":
        config, match = _mt_config(tmp_path, num_token_vocab=64), "word_separator"
    elif case.endswith("without_token_ids"):
        corpus = [{"phonemes": r["phonemes"]} for r in corpus]
    else:
        corpus[3]["token_ids"][0] = 100
        match = "num_token_vocab"
    if case.startswith("ondevice"):
        config = _ondevice(config)
    with pytest.raises(ValueError, match=match):
        port_train.Trainer(config, str(tmp_path / "run"), False, dataset=corpus, device="cpu")


@pytest.mark.parametrize("capacity,warned", [(115, True), (128, True), (135, True),
                                             (144, False), (0, False), (64 * 8, False)])
def test_capacity_warning_catches_128(capacity, warned):
    """At the defaults (word_pred_prob 0.15, L 512) the warning's
    threshold is 2.4 × 57.6 = 138.2: 128, the capacity measured slower,
    is warned of (JAX's rule, below 115, misses it); the default 144 is
    not; 0 and L (no gather) never are."""
    config = Config.from_dict({"training_params": {"lm_head_capacity": capacity}})
    message = port_train.lm_head_capacity_warning(config.training_params,
                                                  config.dataset_params)
    assert (message is not None) == warned
    assert 1.5 * config.dataset_params.word_pred_prob * 512 < 128  # JAX's rule


def test_trainer_prints_the_capacity_warning(tmp_path, capsys):
    config = _mt_config(tmp_path)
    config.training_params.lm_head_capacity = 8
    port_train.Trainer(config, str(tmp_path / "run"), False, device="cpu", eval_only=True,
                       dataset=port_train.make_synthetic_corpus(16, token_vocab=100))
    assert "WARNING: lm_head_capacity (8)" in capsys.readouterr().out

"""Remat in the port (``training_params.remat``: each application of the
shared layer recomputed in the backward, as JAX's ``nn.remat``): bit for
bit the forward and backward without it at dropout 0.1 on every
attention path, JAX's ``remat: true`` train step within the train step's
gate, and a Trainer run."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pl_bert_tpu.config import ModelParams, TrainingParams
from pl_bert_tpu.models.albert import build_model as jax_build_model
from pl_bert_tpu.models.albert import init_params as jax_init_params
from pl_bert_tpu.training import train_step as jax_ts
from pl_bert_tpu_torch.data.collate import collate_fixed
from pl_bert_tpu_torch.data.dataset import MaskedPhonemeDataset
from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.models.albert import build_model, draw_dropout_seeds, init_params
from pl_bert_tpu_torch.training import train as port_train
from pl_bert_tpu_torch.training import train_step as ts

MP = ModelParams(
    hidden_size=128, num_attention_heads=2, intermediate_size=256,
    max_position_embeddings=64, num_hidden_layers=2, embedding_size=32, dropout=0.1,
)
B, L = 3, 64


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_remat_is_bitwise_no_remat(impl):
    """Loss and every gradient, dropout 0.1, padded rows and packed
    segments: the recomputed forward draws the same masks from the same
    seeds, so the backward sees the same saved tensors."""
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, 188, (B, L)))
    mask = torch.ones((B, L), dtype=torch.long)
    mask[1, 40:] = 0
    seg = torch.from_numpy((np.arange(L)[None] >= 30).repeat(B, 0).astype(np.int64))
    seeds = draw_dropout_seeds(torch.Generator().manual_seed(7), MP.num_hidden_layers)
    runs = []
    for remat in (False, True):
        model = init_params(build_model(dataclasses.replace(MP, attention_impl=impl), "fp32",
                                        remat=remat), seed=0)
        assert model.cfg.remat is remat
        logits = model(ids, mask, segment_ids=seg, deterministic=False, dropout_seeds=seeds)
        loss = (logits.float() ** 2).mean()
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()
                                     if p.grad is not None}))
    (loss0, grads0), (loss1, grads1) = runs
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys() and len(grads0) > 20
    for name, g in grads0.items():
        assert torch.equal(g, grads1[name]), name


def test_remat_trajectory_matches_jax_remat():
    """3 steps against JAX's step with ``remat: true``, dropout 0, from
    the same initialisation and batches, within the train step's gate
    (tests/test_torch_train_step.py, rtol 1e-4)."""
    mp = dataclasses.replace(MP, dropout=0.0)
    letters = list("abdfhiklmnqrstuwzθðʃʕħɣχːˈ")
    rng = np.random.default_rng(0)
    corpus = [{"phonemes": ["".join(rng.choice(letters, size=int(rng.integers(2, 9))))
                            for _ in range(int(rng.integers(3, 20)))]} for _ in range(12)]
    ds = MaskedPhonemeDataset(corpus, max_seq_length=L, seed=3)
    batches = []
    for i in range(3):
        b = collate_fixed([ds.get(j) for j in range(4 * i, 4 * i + 4)], L)
        batches.append({"masked_ids": b.masked_ids, "label_ids": b.label_ids,
                        "mask_positions": b.mask_positions, "lengths": b.lengths})
    tp = TrainingParams(learning_rate=1e-3, remat=True)
    params = jax_init_params(jax_build_model(mp, "fp32"), L, seed=0)
    tx = jax_ts.make_optimizer(tp)
    jstep = jax_ts.make_train_step(jax_build_model(mp, "fp32", remat=True), tx, donate=False)
    jstate = jax_ts.TrainState(params, tx.init(params), jnp.int32(0))
    model = build_model(mp, "fp32", remat=tp.remat)
    model.load_state_dict(bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    ptx = ts.make_optimizer(tp)
    state = ts.TrainState(model, ptx.init(model))
    step = ts.make_train_step(model, ptx)
    for s, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        state, m = step(state, batch)
        for k in ("loss", "phoneme_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-12,
                                       err_msg=f"step {s} {k}")


def test_trainer_runs_with_remat(tmp_path):
    """A Trainer run with ``remat: true`` (dropout 0.1) logs the losses
    of the same run without it, bit for bit."""
    losses = {}
    for remat in (False, True):
        raw = {
            "training_params": dict(output_dir=str(tmp_path / "runs"), mixed_precision="fp32",
                                    batch_size=4, save_interval=3, log_interval=1, num_steps=3,
                                    training_dataset="synthetic:80:0:3-12", remat=remat),
            "dataset_params": {"max_seq_length": L},
            "model_params": dict(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                                 max_position_embeddings=L, num_hidden_layers=2,
                                 embedding_size=32),
        }
        path = tmp_path / f"remat_{remat}.yml"
        path.write_text(yaml.safe_dump(raw))
        name = f"r{int(remat)}"
        assert port_train.train({"config_path": str(path), "run_name": name,
                                 "device": "cpu"}) == 3
        with open(tmp_path / "runs" / name / "metrics.jsonl") as f:
            losses[remat] = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses[True]) == 3 and losses[True] == losses[False]

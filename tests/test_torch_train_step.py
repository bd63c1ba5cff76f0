"""The port's train and eval steps against the JAX package's on the CPU,
from the same JAX initialisation and the same batches, dropout 0: 20
steps of loss, grad_norm and lr within rtol 1e-4, and the final
parameters within atol 3e-4 (about 4 × lr: Adam moves a parameter by
about lr a step whatever its gradient's size, so a near-zero gradient
whose last bit differs can move it the other way). Then the training
forward's dropout, and what is not ported yet."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_bert_tpu.config import Config, ModelParams, TrainingParams
from pl_bert_tpu.models.albert import build_model as jax_build_model
from pl_bert_tpu.models.albert import init_params as jax_init_params
from pl_bert_tpu.training import train_step as jax_ts
from pl_bert_tpu_torch.data.collate import collate_fixed
from pl_bert_tpu_torch.data.dataset import MaskedPhonemeDataset
from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.models.albert import build_model, draw_dropout_seeds
from pl_bert_tpu_torch.training import train_step as ts

MP = ModelParams(
    hidden_size=128, num_attention_heads=2, intermediate_size=256,
    max_position_embeddings=64, num_hidden_layers=2, embedding_size=32, dropout=0.0,
)
L, B, STEPS = 64, 4, 20
LETTERS = list("abdfhiklmnqrstuwzθðʃʕħɣχːˈ")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    corpus = [
        {"phonemes": ["".join(rng.choice(LETTERS, size=int(rng.integers(2, 9))))
                      for _ in range(int(rng.integers(3, 20)))]}
        for _ in range(2 * STEPS * B)
    ]
    ds = MaskedPhonemeDataset(corpus, max_seq_length=L, seed=3)
    out = []
    for i in range(2 * STEPS):
        b = collate_fixed([ds.get(j) for j in range(i * B, (i + 1) * B)], L)
        out.append({"masked_ids": b.masked_ids, "label_ids": b.label_ids,
                    "mask_positions": b.mask_positions, "lengths": b.lengths})
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_build_model(MP, "fp32"), L, seed=0)


def _port_state(params, mp=MP, tp=None):
    model = build_model(mp, "fp32")
    model.load_state_dict(bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    tx = ts.make_optimizer(tp or TrainingParams())
    return model, tx, ts.TrainState(model, tx.init(model))


def _step_batch(batches, s, accum):
    if accum == 1:
        return batches[s]
    group = batches[accum * s: accum * (s + 1)]
    return {k: np.stack([b[k] for b in group]) for k in group[0]}


@pytest.mark.parametrize("accum,schedule", [(1, False), (2, False), (1, True)],
                         ids=["accum1", "accum2", "warmup_linear_clip"])
def test_trajectory_matches_jax(batches, jax_params, accum, schedule):
    kw = dict(learning_rate=1e-3)
    if schedule:
        kw.update(lr_schedule="linear", warmup_steps=5, num_steps=STEPS, grad_clip_norm=0.5)
    tp = TrainingParams(**kw)
    tx = jax_ts.make_optimizer(tp)
    jstep = jax_ts.make_train_step(
        jax_build_model(MP, "fp32"), tx, donate=False, grad_accum=accum,
        lr_schedule=jax_ts.make_lr_schedule(tp),
    )
    jstate = jax_ts.TrainState(jax_params, tx.init(jax_params), jnp.int32(0))
    model, ptx, state = _port_state(jax_params, tp=tp)
    step = ts.make_train_step(model, ptx, grad_accum=accum)
    for s in range(STEPS):
        batch = _step_batch(batches, s, accum)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        state, m = step(state, batch)
        keys = ("loss", "phoneme_loss", "grad_norm") + (("lr",) if schedule else ())
        for k in keys:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-12,
                                       err_msg=f"step {s} {k}")
        assert float(m["token_loss"]) == 0.0
    assert state.step == STEPS and state.opt_state.count == STEPS
    final = bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=3e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("impl,steps", [("pallas", STEPS), ("xla", STEPS // 2)])
def test_trajectory_matches_jax_on_each_attention_path(batches, jax_params, impl, steps):
    """20 steps on the port's ``pallas`` path (K7/K8's plain versions
    between dense projections, on the CPU) and 10 on its ``xla`` path
    follow the JAX step configured the same way — off the TPU the JAX
    model falls back to its einsum attention, the same function — within
    the rtol 1e-4 of ``test_trajectory_matches_jax`` (which covers
    ``auto``)."""
    mp = dataclasses.replace(MP, attention_impl=impl)
    tp = TrainingParams(learning_rate=1e-3)
    tx = jax_ts.make_optimizer(tp)
    jstep = jax_ts.make_train_step(jax_build_model(mp, "fp32"), tx, donate=False)
    jstate = jax_ts.TrainState(jax_params, tx.init(jax_params), jnp.int32(0))
    model, ptx, state = _port_state(jax_params, mp=mp, tp=tp)
    assert model.encoder.encoder.layer.attention.impl == {"pallas": "flash",
                                                          "xla": "eager"}[impl]
    step = ts.make_train_step(model, ptx)
    for s in range(steps):
        jstate, jm = jstep(jstate, batches[s], jax.random.PRNGKey(0))
        state, m = step(state, batches[s])
        for k in ("loss", "phoneme_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-12,
                                       err_msg=f"step {s} {k}")
    final = bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=3e-4, rtol=0, err_msg=k)


def test_eval_step_matches_jax(batches, jax_params):
    jeval = jax_ts.make_eval_step(jax_build_model(MP, "fp32"))
    model, _, _ = _port_state(jax_params)
    ev = ts.make_eval_step(model)
    for batch in batches[:3]:
        ref = jeval(jax_params, batch, jax.random.PRNGKey(0))
        got = ev(batch)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(float(a), float(r), rtol=1e-5, atol=1e-6)
    empty = dict(batches[0], mask_positions=np.zeros_like(batches[0]["mask_positions"]))
    loss, _, n = ev(empty)
    assert float(loss) == 0.0 and int(n) == 0


def _dropout_model(jax_params, rate=0.1):
    mp = dataclasses.replace(MP, dropout=rate)
    model, tx, state = _port_state(jax_params, mp, TrainingParams(weight_decay=0.5))
    return model, tx, state


def test_dropout_seeded_and_every_parameter_learns(batches, jax_params):
    """Dropout 0.1: the same generator seed gives the same loss and
    another seed another; every parameter but the pooler gets a nonzero
    gradient; the pooler gets none."""
    model, _, _ = _dropout_model(jax_params)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batches[0].items()}

    def loss_at(seed):
        gen = torch.Generator().manual_seed(seed)
        seeds = draw_dropout_seeds(gen, MP.num_hidden_layers)
        assert len(seeds) == 1 + 3 * MP.num_hidden_layers
        _, loss = ts._forward_loss(model, batch, False, seeds)
        return loss

    model.zero_grad(set_to_none=True)
    loss = loss_at(7)
    loss.backward()
    assert float(loss.detach()) == float(loss_at(7).detach())
    assert float(loss.detach()) != float(loss_at(8).detach())
    for name, p in model.named_parameters():
        if name.startswith("encoder.pooler."):
            assert p.grad is None, name
        else:
            assert p.grad is not None and float(p.grad.abs().max()) > 0, name


def test_dropout_steps_reproducible_and_pooler_not_decayed(batches, jax_params):
    runs = []
    for _ in range(2):
        model, tx, state = _dropout_model(jax_params)
        pooler = model.encoder.pooler.weight.detach().clone()
        ffn = model.encoder.encoder.layer.ffn.weight.detach().clone()
        step = ts.make_train_step(model, tx, seed=5)
        losses = [float(step(state, batches[s])[1]["loss"]) for s in range(2)]
        runs.append(losses)
        assert torch.equal(model.encoder.pooler.weight, pooler)
        assert not torch.equal(model.encoder.encoder.layer.ffn.weight, ffn)
    assert runs[0] == runs[1]
    assert ts.decays("encoder.encoder.albert_layer_groups.0.albert_layers.0.ffn.weight")
    assert not ts.decays("encoder.pooler.weight")


@pytest.mark.parametrize("section,key", [
    ("training_params", "training_dataset"), ("training_params", "model_axis"),
    ("model_params", "num_token_vocab"), ("training_params", "remat"),
])
def test_not_yet_ported_raises(section, key, tmp_path):
    """What still waits raises: the multi-task head, a packed store
    directory, more than one device, remat (accepted and ignored would
    keep the values but not the peak memory JAX's ``nn.remat`` gives).
    On-device masking and sequence packing are ported and pass."""
    (tmp_path / "packed_meta.json").write_text("{}")
    value = {"training_dataset": str(tmp_path), "model_axis": 2, "num_token_vocab": 8,
             "remat": True}[key]
    cfg = Config.from_dict({section: {key: value}})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ts.check_ported(cfg)
    if key == "num_token_vocab":
        with pytest.raises(NotImplementedError, match="not yet ported"):
            build_model(cfg.model_params)
    ts.check_ported(Config.from_dict(
        {"dataset_params": {"ondevice_masking": True, "sequence_packing": True}}))


def test_step_refuses_packed_batches(batches, jax_params):
    """A packed batch (label ids and word ids, nothing masked yet) is
    refused by steps built for host masking, not trained on as if it
    were masked; a masked batch that carries segment ids trains."""
    model, tx, state = _port_state(jax_params)
    step = ts.make_train_step(model, tx)
    packed = {"label_ids": batches[0]["label_ids"], "lengths": batches[0]["lengths"],
              "word_ids": np.zeros((B, L), np.int32),
              "segment_ids": np.zeros((B, L), np.int32)}
    with pytest.raises(ValueError, match="masking_params"):
        step(state, packed)
    with pytest.raises(ValueError, match="masking_params"):
        ts.make_eval_step(model)(packed)
    _, m = step(state, dict(batches[0], segment_ids=np.zeros((B, L), np.int32)))
    assert np.isfinite(float(m["loss"]))

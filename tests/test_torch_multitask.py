"""The port's multi-task model (the phoneme head and the grapheme head)
against the JAX package's on the CPU, fp32, dropout 0, from the same JAX
initialisation and the same host-masked batches (2 layers, hidden 64,
L 64, B 4, a grapheme vocabulary of 251): the model's two outputs within
rtol 1e-5 / atol 5e-6; 20 train steps of ``loss``, ``phoneme_loss``,
``token_loss`` and ``grad_norm`` within rtol 1e-4 and the final
parameters within atol 3e-4 (the gates of tests/test_torch_train_step.py),
with gradient accumulation 1 and 2 and the fused head on and off, at a
capacity that sends some steps to the full-length fallback and gathers
in others; and the eval step's grapheme metrics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_bert_tpu.config import ModelParams, TrainingParams
from pl_bert_tpu.models.albert import build_model as jax_build_model
from pl_bert_tpu.models.albert import init_params as jax_init_params
from pl_bert_tpu.training import train_step as jax_ts
from pl_bert_tpu_torch.data.collate import collate_fixed
from pl_bert_tpu_torch.data.dataset import MaskedPhonemeDataset
from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.models.albert import MultiTaskModel, build_model
from pl_bert_tpu_torch.training import train_step as ts

TOKENS = 251
MP = ModelParams(
    hidden_size=64, num_attention_heads=2, intermediate_size=128,
    max_position_embeddings=64, num_hidden_layers=2, embedding_size=32, dropout=0.0,
    num_token_vocab=TOKENS,
)
L, B, STEPS = 64, 4, 20
# the largest row's valid masked positions exceed it in some batches
# and not in others (checked on the batches below)
CAPACITY = 12
LETTERS = list("abdfhiklmnqrstuwzθðʃʕħɣχːˈ")


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    corpus = []
    for _ in range(2 * STEPS * B):
        n = int(rng.integers(3, 20))
        corpus.append({
            "phonemes": ["".join(rng.choice(LETTERS, size=int(rng.integers(2, 9))))
                         for _ in range(n)],
            "token_ids": rng.integers(0, TOKENS, size=n).tolist(),
        })
    ds = MaskedPhonemeDataset(corpus, max_seq_length=L, seed=3, use_token_ids=True)
    out = []
    for i in range(2 * STEPS):
        b = collate_fixed([ds.get(j) for j in range(i * B, (i + 1) * B)], L)
        out.append(ts.batch_to_arrays(b))
    return out


def _max_counts(batches):
    return [int((b["mask_positions"] & (np.arange(L)[None] < b["lengths"][:, None]))
                .sum(1).max()) for b in batches]


@pytest.fixture(scope="module")
def jax_params():
    return jax_init_params(jax_build_model(MP, "fp32"), L, seed=0)


def _port_model(params, mp=MP):
    model = build_model(mp, "fp32")
    model.load_state_dict(bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model


def test_bridge_carries_the_token_head(jax_params):
    """The Flax kernel [H, V] is the torch weight [V, H], both ways; the
    phoneme-only map is unchanged."""
    tree = jax.tree.map(np.asarray, jax_params)
    sd = bridge.model_state_dict_from_jax(tree)
    assert tuple(sd["token_predictor.weight"].shape) == (TOKENS, MP.hidden_size)
    np.testing.assert_array_equal(sd["token_predictor.weight"].numpy(),
                                  tree["token_predictor"]["kernel"].T)
    back = bridge.jax_from_model_state_dict(sd)
    for head in ("token_predictor", "phoneme_predictor"):
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back[head][leaf], tree[head][leaf])
    phoneme_only = {k: v for k, v in tree.items() if k != "token_predictor"}
    assert "token_predictor.weight" not in bridge.model_state_dict_from_jax(phoneme_only)


@pytest.mark.parametrize("project_tokens", [True, False], ids=["tokens", "hidden"])
def test_model_matches_jax(batches, jax_params, project_tokens):
    model = _port_model(jax_params)
    assert isinstance(model, MultiTaskModel)
    b = batches[0]
    mask = (np.arange(L)[None] < b["lengths"][:, None]).astype(np.int32)
    ref = jax_build_model(MP, "fp32").apply(
        {"params": jax_params}, b["masked_ids"], mask, deterministic=True,
        project_tokens=project_tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(b["masked_ids"]).long(), torch.from_numpy(mask),
                    project_tokens=project_tokens)
    assert got[0].dtype == torch.float32
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=5e-6)


def _step_batch(batches, s, accum):
    if accum == 1:
        return batches[s]
    group = batches[accum * s: accum * (s + 1)]
    return {k: np.stack([b[k] for b in group]) for k in group[0]}


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_trajectory_matches_jax(batches, jax_params, accum, fused):
    counts = _max_counts(batches[: accum * STEPS])
    assert max(counts) > CAPACITY >= min(counts)  # both the fallback and the gather run
    tp = TrainingParams(learning_rate=1e-3)
    tx = jax_ts.make_optimizer(tp)
    jstep = jax_ts.make_train_step(
        jax_build_model(MP, "fp32"), tx, use_token_ids=True, donate=False, grad_accum=accum,
        fused_lm_head=fused, lm_head_capacity=CAPACITY,
    )
    jstate = jax_ts.TrainState(jax_params, tx.init(jax_params), jnp.int32(0))
    model = _port_model(jax_params)
    ptx = ts.make_optimizer(tp)
    state = ts.TrainState(model, ptx.init(model))
    step = ts.make_train_step(model, ptx, grad_accum=accum, fused_lm_head=fused,
                              lm_head_capacity=CAPACITY)
    for s in range(STEPS):
        batch = _step_batch(batches, s, accum)
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        state, m = step(state, batch)
        for k in ("loss", "phoneme_loss", "token_loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-12,
                                       err_msg=f"step {s} {k}")
        assert float(m["token_loss"]) > 0
    final = bridge.model_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), atol=3e-4, rtol=0, err_msg=k)


def test_eval_step_matches_jax(batches, jax_params):
    """(phoneme loss, accuracy, n_masked, token loss, token accuracy).
    JAX's eval step gathers at 192 (here: the full length) whatever the
    config says; the port's gathers at its capacity and takes the
    fallback where a row overflows, and the values agree either way."""
    jeval = jax_ts.make_eval_step(jax_build_model(MP, "fp32"), use_token_ids=True)
    model = _port_model(jax_params)
    ev = ts.make_eval_step(model, lm_head_capacity=CAPACITY)
    counts = _max_counts(batches[:6])
    assert max(counts) > CAPACITY >= min(counts)
    for batch in batches[:6]:
        ref = jeval(jax_params, batch, jax.random.PRNGKey(0))
        got = ev(batch)
        assert len(got) == len(ref) == 5
        for a, r in zip(got, ref):
            np.testing.assert_allclose(float(a), float(r), rtol=1e-5, atol=1e-6)
    empty = dict(batches[0], mask_positions=np.zeros_like(batches[0]["mask_positions"]))
    out = ev(empty)
    assert [float(v) for v in out] == [0.0, 0.0, 0.0, 0.0, 0.0]


def test_phoneme_only_step_ignores_token_ids(batches, jax_params):
    """A phoneme-only model's step takes a batch that carries token ids
    and reports a token loss of 0."""
    mp = dataclasses.replace(MP, num_token_vocab=0)
    params = {k: v for k, v in jax_params.items() if k != "token_predictor"}
    model = _port_model(params, mp)
    tx = ts.make_optimizer(TrainingParams())
    _, m = ts.make_train_step(model, tx)(ts.TrainState(model, tx.init(model)), batches[0])
    assert float(m["token_loss"]) == 0.0 and float(m["loss"]) == float(m["phoneme_loss"])

"""The port's vocabulary-parallel grapheme head (``ops/masked_ce.py`` with a
``VocabSlice``) at model 2 on the CPU, held against JAX's replicated head.

One pair of gloo processes runs every case in a single launch: they are
forked from this process after torch is imported (no CUDA), so neither
pays a cold import. Each rank holds ⌈V/2⌉ or fewer rows of the head
(``parallel.mesh.split_bounds``, V 64 and an uneven 65) and computes, at
B 4, L 32, H 8, chunk 8, fp32:

- the chunked and the fused loss, and ``masked_lm_loss``'s gather at
  capacity 16 and its overflow fallback at capacity 4 (as
  tests/test_tensor_parallel.py:270-300 and :392 run JAX's), with their
  gradients in the hidden states (summed over the model group) and in
  the rank's rows of the weight and bias;
- ``masked_lm_metrics``, also on a head whose two largest logits tie
  across the two slices (the lowest global index wins, as ``jnp.argmax``);
- a tiny ``MultiTaskModel``'s ``project_tokens=True`` logits, gathered
  whole from the slices, against the one-process model's.

The slices are concatenated here and held to JAX's replicated values and
gradients within JAX's own gate, rtol 5e-5 / atol 5e-6
(tests/test_tensor_parallel.py:262); both ranks' losses, ``dh`` and
metrics are bitwise equal.
"""

import multiprocessing as mp
import os
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_bert_tpu.ops import masked_ce as jce

B, L, H, CHUNK = 4, 32, 8, 8
RTOL, ATOL = 5e-5, 5e-6
VOCABS = (64, 65)
# name -> (the loss function of both packages, its keyword arguments)
LOSSES = {
    "chunked": ("masked_lm_loss_chunked", {}),
    "fused": ("masked_lm_loss_fused", {}),
    "gathered16": ("masked_lm_loss", {"capacity": 16}),
    "gathered16_fused": ("masked_lm_loss", {"capacity": 16, "fused": True}),
    "overflow4": ("masked_lm_loss", {"capacity": 4}),
    "overflow4_fused": ("masked_lm_loss", {"capacity": 4, "fused": True}),
}
METRICS = {"random": 16, "tie": L}  # the gather, and the full-length path
TIE = (5, 40)  # one row in each slice, at V 64 and 65 alike


def _inputs(V: int) -> dict:
    rng = np.random.default_rng(31 + V)
    mask = rng.random((B, L)) < 0.3
    mask[0, :10] = True  # 10 valid masked positions: over capacity 4, under 16
    kernel = (rng.standard_normal((H, V)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(V) * 0.01).astype(np.float32)
    labels = rng.integers(0, V, (B, L)).astype(np.int32)
    tie_kernel, tie_bias = kernel.copy(), bias.copy()
    tie_kernel[:, list(TIE)] = 0.0  # both logits exactly 10.0 on every row
    tie_bias[list(TIE)] = 10.0
    tie_labels = labels.copy()
    tie_labels[:, 0::2] = TIE[0]  # hits under jnp.argmax's rule
    tie_labels[:, 1::4] = TIE[1]  # misses under it
    return {
        "hidden": rng.standard_normal((B, L, H)).astype(np.float32),
        "kernel": kernel, "bias": bias, "labels": labels, "mask": mask,
        "lengths": np.array([32, 30, 12, 32], np.int32),
        "tie_kernel": tie_kernel, "tie_bias": tie_bias, "tie_labels": tie_labels,
    }


def _jax_loss(name: str, x: dict):
    fn, kw = LOSSES[name]
    value, grads = jax.value_and_grad(
        lambda h, k, b: getattr(jce, fn)(h, k, b, jnp.asarray(x["labels"]),
                                         jnp.asarray(x["mask"]), jnp.asarray(x["lengths"]),
                                         chunk_size=CHUNK, **kw),
        argnums=(0, 1, 2),
    )(x["hidden"], x["kernel"], x["bias"])
    return float(value), [np.asarray(g) for g in grads]


def _jax_metrics(name: str, x: dict):
    prefix = "tie_" if name == "tie" else ""
    loss, acc = jce.masked_lm_metrics(
        x["hidden"], x[prefix + "kernel"], x[prefix + "bias"],
        jnp.asarray(x[prefix + "labels"]), jnp.asarray(x["mask"]),
        jnp.asarray(x["lengths"]), capacity=METRICS[name], chunk_size=CHUNK)
    return float(loss), float(acc)


def _model_logits(mesh=None):
    """A tiny ``MultiTaskModel`` (head of 65 words; on ``mesh`` its slice
    of the head, the rest tensor-parallel): (its token logits from
    ``project_tokens=True``, the head's weight gradient of their sum
    weighted by a fixed plane)."""
    from pl_bert_tpu_torch.config import ModelParams
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.parallel.mesh import shard_model

    mp = ModelParams(hidden_size=32, num_attention_heads=2, intermediate_size=64,
                     max_position_embeddings=16, num_hidden_layers=1, embedding_size=16,
                     num_token_vocab=65)
    model = init_params(build_model(mp, "fp32", mesh=mesh), seed=0)
    if mesh is not None:
        shard_model(model, mesh)
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, 188, (2, 16), generator=gen)
    _, logits = model(ids, project_tokens=True)
    (logits * torch.randn(logits.shape, generator=gen)).sum().backward()
    return logits.detach(), model.token_predictor.weight.grad


def _rank_cases(rank: int, inputs: dict) -> dict:
    """Every case on this rank's slice of the head (runs in a forked rank)."""
    from pl_bert_tpu_torch.ops import masked_ce as ce
    from pl_bert_tpu_torch.parallel.mesh import make_mesh, split_bounds

    mesh = make_mesh(1, 2)
    out = {"collectives": {}, "model": _model_logits(mesh)}
    for V, x in inputs.items():
        start, stop = split_bounds(V, 2, mesh.model_index)
        vocab = ce.VocabSlice(mesh.model_group, start)
        t = {k: torch.from_numpy(v) for k, v in x.items()}
        out[V, "rows"] = stop - start
        for name, (fn, kw) in LOSSES.items():
            h = t["hidden"].clone().requires_grad_(True)
            w = t["kernel"].T[start:stop].clone().requires_grad_(True)
            b = t["bias"][start:stop].clone().requires_grad_(True)
            before = ce.VOCAB_COLLECTIVES.count
            value = getattr(ce, fn)(h, w, b, t["labels"], t["mask"], t["lengths"],
                                    chunk_size=CHUNK, vocab=vocab, **kw)
            value.backward()
            out["collectives"][V, name] = ce.VOCAB_COLLECTIVES.count - before
            out[V, name] = (value.detach(), h.grad, w.grad, b.grad)
        for name, capacity in METRICS.items():
            prefix = "tie_" if name == "tie" else ""
            out[V, "metrics", name] = ce.masked_lm_metrics(
                t["hidden"], t[prefix + "kernel"].T[start:stop], t[prefix + "bias"][start:stop],
                t[prefix + "labels"], t["mask"], t["lengths"], capacity=capacity,
                chunk_size=CHUNK, vocab=vocab)
    return out


def _rank_main(rank: int, port: int, inputs: dict, path: str) -> None:
    code = 1
    try:
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        torch.save(_rank_cases(rank, inputs), path)
        dist.destroy_process_group()
        code = 0
    except BaseException:  # noqa: BLE001 — reported through the exit code and file
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
    finally:
        os._exit(code)  # a forked pytest must not run the parent's exit handlers


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab_parallel")
    inputs = {V: _inputs(V) for V in VOCABS}
    ctx = mp.get_context("fork")
    port = _free_port()
    paths = [str(tmp / f"rank{r}.pt") for r in range(2)]
    procs = [ctx.Process(target=_rank_main, args=(r, port, inputs, paths[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
    for p, path in zip(procs, paths):
        err = path + ".err"
        assert p.exitcode == 0, open(err).read() if os.path.exists(err) else p.exitcode
    return inputs, [torch.load(path, weights_only=False) for path in paths]


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("name", list(LOSSES))
def test_vocab_parallel_loss_matches_jax_replicated(ranks, V, name):
    """The loss and its gradients at model 2 against JAX's replicated
    head; the two ranks' values and ``dh`` bitwise equal."""
    inputs, out = ranks
    want, (dh_want, dk_want, db_want) = _jax_loss(name, inputs[V])
    (v0, dh0, dw0, db0), (v1, dh1, dw1, db1) = (o[V, name] for o in out)
    assert torch.equal(v0, v1) and torch.equal(dh0, dh1)
    np.testing.assert_allclose(float(v0), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dh0.numpy(), dh_want, rtol=RTOL, atol=ATOL, err_msg="dh")
    dw = torch.cat([dw0, dw1]).numpy().T  # the slices' rows, whole, in JAX's [H, V]
    np.testing.assert_allclose(dw, dk_want, rtol=RTOL, atol=ATOL, err_msg="dW")
    np.testing.assert_allclose(torch.cat([db0, db1]).numpy(), db_want, rtol=RTOL, atol=ATOL,
                               err_msg="db")


@pytest.mark.parametrize("V", VOCABS)
@pytest.mark.parametrize("name", list(METRICS))
def test_vocab_parallel_metrics_match_jax(ranks, V, name):
    """(loss, accuracy) at model 2 against JAX's; on the tie head the two
    largest logits are equal and lie in different slices, and the lower
    global index is the prediction."""
    inputs, out = ranks
    loss_want, acc_want = _jax_metrics(name, inputs[V])
    (l0, a0), (l1, a1) = (o[V, "metrics", name] for o in out)
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    np.testing.assert_allclose(float(l0), loss_want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(a0), acc_want, rtol=RTOL, atol=ATOL)
    if name == "tie":
        assert 0.0 < float(a0) < 1.0  # hits and misses both occur


@pytest.mark.parametrize("V", VOCABS)
def test_each_rank_holds_at_most_half_the_head(ranks, V):
    """⌈V/2⌉ rows on rank 0, the rest on rank 1; every loss ran the
    head's collectives."""
    _, out = ranks
    rows = [o[V, "rows"] for o in out]
    assert rows == [-(-V // 2), V - -(-V // 2)]
    assert all(o[V, "chunked"][2].shape == (r, H) for o, r in zip(out, rows))
    assert all(out[0]["collectives"][V, name] > 0 for name in LOSSES)


def test_multitask_model_logits_are_whole_on_each_rank(ranks):
    """``MultiTaskModel(project_tokens=True)`` at model 2 gathers its two
    slices' logits (33 + 32 words) into the whole vocabulary, the
    one-process model's; each rank's head gradient is its rows of the
    one-process gradient."""
    _, out = ranks
    want, grad = _model_logits()
    (l0, g0), (l1, g1) = (o["model"] for o in out)
    assert torch.equal(l0, l1) and l0.shape == want.shape == (2, 16, 65)
    np.testing.assert_allclose(l0.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(torch.cat([g0, g1]).numpy(), grad.numpy(), rtol=RTOL, atol=ATOL)

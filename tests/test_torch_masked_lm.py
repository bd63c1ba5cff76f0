"""The port's large-vocabulary masked CE (``ops/masked_ce.py``) against the
JAX package's on the CPU, fp32, from the same numpy inputs: B 4, L 48,
H 32, V 211, chunk 8. Values within rtol 1e-6; gradients in hidden, the
head's weight and its bias within rtol 1e-5 / atol 1e-6, the fused path
against JAX's fused path and the chunked path against JAX's chunked
path; the fused value equals the chunked value bit for bit. Capacity 6
overflows (a row holds 33 valid masked positions) and falls back to the
full-length path, 40 gathers, 0 runs the full-length path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pl_bert_tpu.ops import masked_ce as jce
from pl_bert_tpu_torch.ops import masked_ce as ce

B, L, H, V, CHUNK = 4, 48, 32, 211, 8
OVERFLOW, GATHER = 6, 40
CAPACITIES = {"overflow": OVERFLOW, "gather": GATHER, "full": 0}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    mask = rng.random((B, L)) < 0.2
    mask[1, :30] = True
    lengths = np.array([48, 40, 33, 20], np.int32)
    counts = (mask & (np.arange(L)[None] < lengths[:, None])).sum(1)
    assert counts.max() > OVERFLOW and counts.max() <= GATHER
    return {
        "hidden": rng.standard_normal((B, L, H)).astype(np.float32),
        "kernel": (0.2 * rng.standard_normal((H, V))).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(V)).astype(np.float32),
        "labels": rng.integers(0, V, (B, L)).astype(np.int32),
        "mask": mask,
        "lengths": lengths,
    }


def _jax(fn, x, *args, **kw):
    """(value, grads in hidden, kernel, bias) of a JAX loss."""
    value, grads = jax.value_and_grad(
        lambda h, k, b: fn(h, k, b, jnp.asarray(x["labels"]), jnp.asarray(x["mask"]), *args,
                           **kw),
        argnums=(0, 1, 2),
    )(x["hidden"], x["kernel"], x["bias"])
    return float(value), [np.asarray(g) for g in grads]


def _port(fn, x, *args, **kw):
    """(value tensor, grads in hidden, kernel [H, V], bias) of a port loss."""
    h = torch.tensor(x["hidden"], requires_grad=True)
    w = torch.tensor(x["kernel"].T.copy(), requires_grad=True)
    b = torch.tensor(x["bias"], requires_grad=True)
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    value = fn(h, w, b, torch.from_numpy(x["labels"]), torch.from_numpy(x["mask"]), *args, **kw)
    value.backward()
    return value.detach(), [h.grad.numpy(), w.grad.numpy().T, b.grad.numpy()]


def _hold(port, ref):
    value, grads = port
    np.testing.assert_allclose(float(value), ref[0], rtol=1e-6)
    for name, g, r in zip(("hidden", "kernel", "bias"), grads, ref[1]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
@pytest.mark.parametrize("capacity", list(CAPACITIES.values()), ids=list(CAPACITIES))
def test_masked_lm_loss_matches_jax(inputs, fused, capacity):
    kw = dict(capacity=capacity, chunk_size=CHUNK, fused=fused)
    _hold(_port(ce.masked_lm_loss, inputs, inputs["lengths"], **kw),
          _jax(jce.masked_lm_loss, inputs, jnp.asarray(inputs["lengths"]), **kw))


@pytest.mark.parametrize("chunk", [8, 10, 64], ids=["chunk8", "shrunk_to_8", "one_chunk"])
@pytest.mark.parametrize("name", ["masked_lm_loss_chunked", "masked_lm_loss_fused"])
def test_inner_losses_match_jax(inputs, name, chunk):
    """Both inner losses with the padding crop; a chunk that does not
    divide L shrinks to the largest divisor below it (10 → 8), as in JAX,
    and one larger than L is one chunk."""
    assert ce.chunk_size_for(L, chunk) == {8: 8, 10: 8, 64: 48}[chunk]
    _hold(_port(getattr(ce, name), inputs, inputs["lengths"], chunk),
          _jax(getattr(jce, name), inputs, jnp.asarray(inputs["lengths"]), chunk))


@pytest.mark.parametrize("capacity", list(CAPACITIES.values()), ids=list(CAPACITIES))
def test_fused_value_is_the_chunked_value_bit_for_bit(inputs, capacity):
    kw = dict(capacity=capacity, chunk_size=CHUNK)
    fused, _ = _port(ce.masked_lm_loss, inputs, inputs["lengths"], fused=True, **kw)
    chunked, _ = _port(ce.masked_lm_loss, inputs, inputs["lengths"], fused=False, **kw)
    assert fused.item() == chunked.item()
    args = [torch.from_numpy(inputs[k]) for k in ("hidden", "kernel", "bias", "labels", "mask",
                                                  "lengths")]
    args[1] = args[1].T.contiguous()
    with torch.no_grad():  # undifferentiated, the fused loss is the chunked one
        assert ce.masked_lm_loss(*args, fused=True, **kw).item() == fused.item()


@pytest.mark.parametrize("capacity", [OVERFLOW, GATHER, 0], ids=["overflow", "gather", "full"])
def test_metrics_match_jax(inputs, capacity):
    """(loss, accuracy) of the eval-only pass. JAX's ``masked_lm_metrics``
    cannot trace capacity 0 (its gathered branch has no positions), so
    the port's full-length path is held against JAX's at capacity L."""
    args = [inputs[k] for k in ("hidden", "kernel", "bias", "labels", "mask", "lengths")]
    ref = jce.masked_lm_metrics(*args, capacity=capacity or L, chunk_size=CHUNK)
    t = [torch.from_numpy(a) for a in args]
    t[1] = t[1].T.contiguous()
    got = ce.masked_lm_metrics(*t, capacity=capacity, chunk_size=CHUNK)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    loss = ce.masked_lm_loss(*t, capacity=capacity, chunk_size=CHUNK)
    assert float(got[0]) == float(loss)


def test_no_masks_give_zero(inputs):
    args = [torch.from_numpy(inputs[k]) for k in ("hidden", "kernel", "bias", "labels")]
    args[1] = args[1].T.contiguous()
    none = torch.zeros(B, L, dtype=torch.bool)
    for fused in (False, True):
        assert float(ce.masked_lm_loss(*args, none, capacity=GATHER, fused=fused)) == 0.0
    assert [float(v) for v in ce.masked_lm_metrics(*args, none, capacity=GATHER)] == [0.0, 0.0]


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
def test_no_logits_plane_is_kept_for_the_backward(inputs, fused):
    """What autograd keeps for the backward holds nothing of a chunk's
    [B, chunk, V] logits: the chunked path recomputes each chunk, the
    fused one keeps dh, dW and db."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _port(ce.masked_lm_loss, inputs, inputs["lengths"], capacity=0, chunk_size=CHUNK,
              fused=fused)
    assert shapes and not [s for s in shapes if len(s) > 1 and s[-1] == V], shapes

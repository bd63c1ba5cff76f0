"""The training kernels' autograd Functions on the CPU (where each runs
its plain forward and its explicit plain backward) against ``jax.grad``
through the JAX package's Pallas kernels in interpret mode: K3/K4 (the
attention block) at tests/test_attention_block.py's gate (atol 5e-4,
rtol 2e-3), K6 (the fused LN) at tests/test_fused_ln.py's (atol 5e-4,
rtol 1e-3); fp32, dropout 0. Then the dropout that the CPU versions
share with the kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.models.albert import attention_bias_from_mask as jax_bias
from pl_bert_tpu.ops import attention_block as jax_ab
from pl_bert_tpu.ops import fused_ln as jax_ln
from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops import fused_ln

B, L, E, H = 2, 128, 256, 4  # head_dim 64, the JAX kernel's L % 128


def _block_inputs(seed, masked, segments):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, E)) * 0.5).astype(np.float32)
    ws = {n: (rng.standard_normal((E, E)) * 0.05).astype(np.float32) for n in "qkvo"}
    bs = {n: (rng.standard_normal(E) * 0.02).astype(np.float32) for n in "qkvo"}
    mask = np.ones((B, L), np.int32)
    if masked:
        mask[0, L * 3 // 4:] = 0
    seg = np.zeros((B, L), np.int32)
    seg[:, L // 2:] = 1
    return x, ws, bs, (mask if masked else None), (seg if segments else None)


def _copies(ws, bs):
    """The compute-dtype weight copies, packed as the model packs them."""
    return ab.pack_weights(
        *(torch.from_numpy(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.float32)


def _loss_torch(o):
    return (o * torch.cos(o)).sum()


@pytest.mark.parametrize("masked,segments", [(True, False), (False, True), (True, True)])
def test_attention_block_function_matches_jax_grad(masked, segments):
    x, ws, bs, mask, seg = _block_inputs(1, masked, segments)

    def loss_jax(x, ws, bs):
        o = jax_ab.attention_block(
            x, ws["q"], bs["q"], ws["k"], bs["k"], ws["v"], bs["v"], ws["o"], bs["o"], H,
            bias=None if mask is None else jax_bias(jnp.asarray(mask)),
            segment_ids=None if seg is None else jnp.asarray(seg), out_dtype=jnp.float32,
        )
        return jnp.sum(o * jnp.cos(o))

    with pltpu.force_tpu_interpret_mode():
        gx, gw, gb = jax.grad(loss_jax, argnums=(0, 1, 2))(
            jnp.asarray(x), {n: jnp.asarray(a) for n, a in ws.items()},
            {n: jnp.asarray(a) for n, a in bs.items()},
        )

    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    xt, w, b = t(x), {n: t(a) for n, a in ws.items()}, {n: t(a) for n, a in bs.items()}
    wqkv, _, wo, _ = _copies(ws, bs)
    before = (ab.LAUNCHES_TRAIN.count, ab.LAUNCHES_BWD.count)
    out = ab.attention_block_train(
        xt, torch.cat([w["q"], w["k"], w["v"]], dim=1), torch.cat([b["q"], b["k"], b["v"]]),
        w["o"], b["o"], wqkv, wo, H,
        bias=None if mask is None else attention_bias_from_mask(torch.from_numpy(mask)),
        segment_ids=None if seg is None else torch.from_numpy(seg),
    )
    _loss_torch(out).backward()
    assert (ab.LAUNCHES_TRAIN.count, ab.LAUNCHES_BWD.count) == before  # CPU: plain
    tol = dict(atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), err_msg="dx", **tol)
    for n in "qkvo":
        np.testing.assert_allclose(w[n].grad.numpy(), np.asarray(gw[n]), err_msg=f"dw{n}", **tol)
        np.testing.assert_allclose(b[n].grad.numpy(), np.asarray(gb[n]), err_msg=f"db{n}", **tol)


def test_fused_ln_function_matches_jax_grad():
    rng = np.random.default_rng(0)
    N, W = 512, 256
    x, res = (rng.standard_normal((N, W)).astype(np.float32) for _ in range(2))
    gamma = (rng.standard_normal(W) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(W) * 0.1).astype(np.float32)

    def loss_jax(*args):
        o = jax_ln.dropout_add_layernorm(*args)
        return jnp.sum(o * jnp.cos(o))

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(x, res, gamma, beta)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, res, gamma, beta)]
    before = fused_ln.LAUNCHES_BWD.count
    _loss_torch(fused_ln.dropout_add_layernorm_train(*args)).backward()
    assert fused_ln.LAUNCHES_BWD.count == before
    for name, a, r in zip(("dx", "dres", "dgamma", "dbeta"), args, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), atol=5e-4, rtol=1e-3,
                                   err_msg=name)


def test_light_and_training_forward_agree_with_dropout():
    """The light forward (K1's plain version) and the saving forward (K3's)
    drop the same probabilities and return the same values; the mask is
    the kernels' Philox mask, kept near 1 - rate."""
    x, ws, bs, mask, _ = _block_inputs(2, True, False)
    t = torch.from_numpy
    packed = ab.pack_weights(*(t(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.float32)
    bias = attention_bias_from_mask(t(mask))
    light = ab.attention_block_packed(t(x), *packed, H, bias=bias, dropout_rate=0.1,
                                      dropout_seed=99)
    bias_row, _ = ab.rows(bias, None, B, L)
    train, _ = ab.train_forward(t(x), *packed, H, bias_row, None, 0.1, 99)
    torch.testing.assert_close(light, train, rtol=0, atol=0)
    keep = ab.dropout_keep(99, 0.1, B, H, L)
    plain = ab.attention_block_plain(t(x), *packed, H, bias=bias, dropout_rate=0.1,
                                     dropout_seed=99, keep=keep)
    torch.testing.assert_close(light, plain, rtol=0, atol=0)
    no_drop = ab.attention_block_packed(t(x), *packed, H, bias=bias)
    assert not torch.equal(light, no_drop)
    assert abs(float(keep.float().mean()) - 0.9) < 5e-3


def test_philox_known_answer():
    """Philox4x32-10's first word at counter 0, key 0 (Random123's test
    vector 6627e8d5 e169c58d bc57ac4c 9b00dbd8)."""
    z = torch.zeros(1, dtype=torch.int64)
    assert int(ab.philox_bits(0, z, z, z)) == 0x6627E8D5


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_attention_dropout_backward_matches_autograd(rate):
    """With dropout on, the explicit backward (K4's plain version)
    regenerates the mask and equals autograd through the plain forward."""
    x, ws, bs, mask, seg = _block_inputs(3, True, True)
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    xt = t(x)
    wqkv = t(np.concatenate([ws["q"], ws["k"], ws["v"]], axis=1))
    bqkv = t(np.concatenate([bs["q"], bs["k"], bs["v"]]))
    wo, bo = t(ws["o"]), t(bs["o"])
    kw = dict(bias=attention_bias_from_mask(torch.from_numpy(mask)),
              segment_ids=torch.from_numpy(seg), dropout_rate=rate, dropout_seed=5)
    params = [xt, wqkv, bqkv, wo, bo]
    ref = torch.autograd.grad(_loss_torch(ab.attention_block_plain(*params, H, **kw)), params)
    wqkv_c, _, wo_c, _ = _copies(ws, bs)
    got = torch.autograd.grad(
        _loss_torch(ab.attention_block_train(*params, wqkv_c, wo_c, H, **kw)), params)
    for name, a, r in zip(("dx", "dwqkv", "dbqkv", "dwo", "dbo"), got, ref):
        torch.testing.assert_close(a, r, atol=2e-5, rtol=1e-4, msg=name)


def test_ln_dropout_backward_regenerates_the_mask():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
            for s in ((64, 96), (64, 96), (96,), (96,))]
    ref = torch.autograd.grad(
        _loss_torch(fused_ln.dropout_add_layernorm_plain(*args, seed=3, rate=0.2)), args)
    got = torch.autograd.grad(
        _loss_torch(fused_ln.dropout_add_layernorm_train(*args, seed=3, rate=0.2)), args)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=2e-5, rtol=1e-4)
    assert float((got[0] == 0).float().mean()) == pytest.approx(0.2, abs=0.03)

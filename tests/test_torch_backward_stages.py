"""The plain versions of the block backward's CUDA-core stages -- the
delta pass, the dk/dv kernel with its ds scratch, the dq GEMM over that
scratch -- composed into the block's gradients, on the CPU: against
``jax.grad`` through the JAX package's Pallas kernels (``_bwd_kernel``)
in interpret mode at tests/test_attention_block.py's gate (atol 5e-4,
rtol 2e-3), fp32, dropout 0; and bit for bit against the one-pass plain
backward (``attention_backward_plain``) that the card's checks use, with
and without dropout, in fp32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.models.albert import attention_bias_from_mask as jax_bias
from pl_bert_tpu.ops import attention_block as jax_ab
from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
from pl_bert_tpu_torch.ops import attention_block as ab

B, L, E, H = 2, 128, 256, 4  # head_dim 64, the JAX kernel's L % 128


def _inputs(seed, masked, segments):
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


def _staged_dqkv(do, saved, bias_row, seg_row, rate=0.0, seed=None):
    """[dq|dk|dv] [B·L, 3P] in the compute dtype from the three stages."""
    delta = ab.attention_delta_plain(do, saved, H, bias_row, seg_row, rate, seed)
    dk, dv, ds = ab.attention_dkdv_plain(do, saved, delta, H, bias_row, seg_row, rate, seed)
    dq = ab.attention_dq_plain(ds, saved, H)
    P = saved[0].shape[1] // 3
    return torch.cat([t.reshape(-1, P) for t in (dq, dk, dv)], dim=1).to(saved[0].dtype)


@pytest.mark.parametrize("masked,segments", [(True, False), (False, True), (True, True)])
def test_staged_backward_matches_jax_bwd_kernel(masked, segments):
    x, ws, bs, mask, seg = _inputs(1, masked, segments)

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

    t = torch.from_numpy
    wqkv, bqkv, wo, bo = ab.pack_weights(
        *(t(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.float32)
    bias = None if mask is None else attention_bias_from_mask(t(mask))
    bias_row, seg_row = ab.rows(bias, None if seg is None else t(seg), B, L)
    out, saved = ab.train_forward_plain(t(x), wqkv, bqkv, wo, bo, H, bias_row, seg_row)
    dout = (torch.cos(out) - out * torch.sin(out)).reshape(B * L, E)  # d(o·cos o)/do
    do = dout @ wo.T  # the do GEMM: one fp32 sum an output, as the kernel
    dqkv = _staged_dqkv(do, saved, bias_row, seg_row)
    x2 = t(x).reshape(B * L, E)
    got = {"dx": (dqkv @ wqkv.T).reshape(B, L, E), "dwqkv": x2.T @ dqkv,
           "dbqkv": dqkv.sum(0), "dwo": saved[1].T @ dout, "dbo": dout.sum(0)}
    want = {"dx": gx, "dwqkv": np.concatenate([gw[n] for n in "qkv"], axis=1),
            "dbqkv": np.concatenate([gb[n] for n in "qkv"]), "dwo": gw["o"], "dbo": gb["o"]}
    for name, a in got.items():
        np.testing.assert_allclose(a.numpy(), np.asarray(want[name]), atol=5e-4, rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_staged_backward_is_the_one_pass_plain_backward(dtype, rate):
    """The three stages compute the one-pass plain backward's dqkv and
    delta bit for bit: the same formulas, each rounded at the same point."""
    x, ws, bs, mask, seg = _inputs(2, True, True)
    t = torch.from_numpy
    packed = ab.pack_weights(*(t(a) for n in "qkvo" for a in (ws[n], bs[n])), dtype)
    bias_row, seg_row = ab.rows(attention_bias_from_mask(t(mask)), t(seg), B, L)
    seed = 7 if rate else None
    _, saved = ab.train_forward_plain(t(x).to(dtype), *packed, H, bias_row, seg_row, rate, seed)
    do = torch.from_numpy(np.random.default_rng(3).standard_normal((B * L, E)).astype(
        np.float32)).to(dtype)
    dqkv, delta = ab.attention_backward_plain(do, saved, H, bias_row, seg_row, rate, seed)
    assert torch.equal(ab.attention_delta_plain(do, saved, H, bias_row, seg_row, rate, seed),
                       delta)
    assert torch.equal(_staged_dqkv(do, saved, bias_row, seg_row, rate, seed), dqkv)


def test_ds_is_zero_at_masked_keys():
    """ds vanishes where p does: keys a padded row masks out of its softmax
    hold NEG scores, so their p and ds underflow to 0."""
    x, ws, bs, mask, _ = _inputs(4, True, False)
    t = torch.from_numpy
    packed = ab.pack_weights(*(t(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.float32)
    bias_row, _ = ab.rows(attention_bias_from_mask(t(mask)), None, B, L)
    _, saved = ab.train_forward_plain(t(x), *packed, H, bias_row)
    do = torch.ones(B * L, E)
    delta = ab.attention_delta_plain(do, saved, H, bias_row)
    _, _, ds = ab.attention_dkdv_plain(do, saved, delta, H, bias_row)
    assert ds.shape == (B, H, L, L)
    assert not ds[0, :, :, L * 3 // 4:].any()
    assert ds[1].abs().sum() > 0

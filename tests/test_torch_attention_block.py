"""PyTorch port of the attention block against the JAX kernel (Pallas
interpret mode on the CPU), at the shapes of tests/test_attention_block.py
and its gate (atol 3e-5, rtol 1e-4), fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.models.albert import attention_bias_from_mask as jax_bias
from pl_bert_tpu.ops import attention_block as jax_ab
from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops.attention import eager_attention

B, L, E, H = 2, 128, 256, 4  # head_dim 64


def _inputs(seed=0, masked=False, segments=False, length=L):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, length, E)) * 0.5).astype(np.float32)
    ws = {n: (rng.standard_normal((E, E)) * 0.05).astype(np.float32) for n in "qkvo"}
    bs = {n: (rng.standard_normal(E) * 0.02).astype(np.float32) for n in "qkvo"}
    mask = None
    if masked:
        mask = np.ones((B, length), np.int32)
        mask[0, length * 3 // 4:] = 0
    seg = None
    if segments:
        seg = np.zeros((B, length), np.int32)
        seg[:, length // 2:] = 1
    return x, ws, bs, mask, seg


def _port(x, ws, bs, mask, seg, out_dtype=torch.float32):
    t = torch.from_numpy
    bias = None if mask is None else attention_bias_from_mask(t(mask))
    return ab.attention_block(
        t(x), t(ws["q"]), t(bs["q"]), t(ws["k"]), t(bs["k"]), t(ws["v"]),
        t(bs["v"]), t(ws["o"]), t(bs["o"]), H, bias=bias,
        segment_ids=None if seg is None else t(seg), out_dtype=out_dtype,
    )


@pytest.mark.parametrize(
    "masked,segments", [(False, False), (True, False), (False, True), (True, True)]
)
def test_plain_matches_jax_kernel(masked, segments):
    """fp32 runs the JAX side's grouped (B, G) light kernel — the one the
    port's single kernel must agree with in fp32."""
    x, ws, bs, mask, seg = _inputs(masked=masked, segments=segments)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_ab.attention_block(
            jnp.asarray(x), *(jnp.asarray(a) for n in "qkvo" for a in (ws[n], bs[n])),
            H, bias=None if mask is None else jax_bias(jnp.asarray(mask)),
            segment_ids=None if seg is None else jnp.asarray(seg),
            out_dtype=jnp.float32,
        )
    out = _port(x, ws, bs, mask, seg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_fully_masked_rows_finite():
    """A padded serving batch carries all-zero mask rows: the NEG clamp
    keeps them finite."""
    x, ws, bs, _, _ = _inputs(seed=2)
    mask = np.zeros((B, L), np.int32)
    mask[1, :] = 1
    out = _port(x, ws, bs, mask, None)
    assert torch.isfinite(out).all()


def test_ragged_length_matches_composition():
    """L = 100: no L % 128 rule in the port. Checked against a plain
    projection + eager attention composition."""
    x, ws, bs, mask, seg = _inputs(seed=3, masked=True, segments=True, length=100)
    out = _port(x, ws, bs, mask, seg)
    t = torch.from_numpy
    D = E // H
    q, k, v = ((t(x) @ t(ws[n]) + t(bs[n])).reshape(B, 100, H, D) for n in "qkv")
    ctx = eager_attention(
        q, k, v, attention_bias_from_mask(t(mask)), t(seg), dtype=torch.float32
    )
    ref = ctx.reshape(B, 100, E) @ t(ws["o"]) + t(bs["o"])
    torch.testing.assert_close(out, ref, atol=3e-5, rtol=1e-4)


def test_wrapper_cpu_is_plain_and_uncounted():
    x, ws, bs, mask, _ = _inputs(seed=4, masked=True)
    before = ab.LAUNCHES.count
    out = _port(x, ws, bs, mask, None)
    t = torch.from_numpy
    packed = ab.pack_weights(
        *(t(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.float32
    )
    plain = ab.attention_block_plain(
        t(x), *packed, H, bias=attention_bias_from_mask(t(mask)),
        out_dtype=torch.float32,
    )
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert ab.LAUNCHES.count == before


@pytest.mark.parametrize("heads", [8, 3])
def test_unsupported_head_dim_raises(heads):
    x, ws, bs, _, _ = _inputs(seed=5)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="head_dim"):
        ab.attention_block(
            t(x), *(t(a) for n in "qkvo" for a in (ws[n], bs[n])), heads,
        )


def test_dropout_not_yet_ported():
    """Attention dropout is ported now: with a seed and a rate the block
    drops the kernels' Philox mask (the name is kept from when it
    raised); without a seed the rate is ignored, as in JAX."""
    x, ws, bs, _, _ = _inputs(seed=7)
    t = torch.from_numpy
    args = (t(x), *(t(a) for n in "qkvo" for a in (ws[n], bs[n])), H)
    dropped = ab.attention_block(*args, dropout_rate=0.1, dropout_seed=3,
                                 out_dtype=torch.float32)
    packed = ab.pack_weights(*args[1:9], torch.float32)
    plain = ab.attention_block_plain(
        t(x), *packed, H, dropout_rate=0.1, dropout_seed=3,
        keep=ab.dropout_keep(3, 0.1, B, H, L),
    )
    torch.testing.assert_close(dropped, plain, rtol=0, atol=0)
    out = ab.attention_block(*args, dropout_rate=0.1, out_dtype=torch.float32)
    assert torch.isfinite(out).all() and not torch.equal(out, dropped)
    torch.testing.assert_close(
        out, ab.attention_block(*args, out_dtype=torch.float32), rtol=0, atol=0
    )


def test_bf16_rounding_points():
    """bf16 compute: q/k/v, probabilities and context are rounded to
    bf16, the output projection adds bo in fp32; the result stays within
    bf16 rounding of the fp32 block."""
    x, ws, bs, mask, _ = _inputs(seed=6, masked=True)
    t = torch.from_numpy
    packed32 = ab.pack_weights(
        *(t(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.float32
    )
    packed16 = ab.pack_weights(
        *(t(a) for n in "qkvo" for a in (ws[n], bs[n])), torch.bfloat16
    )
    bias = attention_bias_from_mask(t(mask))
    ref = ab.attention_block_packed(t(x), *packed32, H, bias=bias)
    out = ab.attention_block_packed(
        t(x).bfloat16(), *packed16, H, bias=bias, out_dtype=torch.float32
    )
    assert out.dtype == torch.float32 and packed16[0].dtype == torch.bfloat16
    rel = (out - ref).norm() / ref.norm()
    assert rel < 2e-2


@pytest.mark.parametrize("width,offset", [(132, 0), (256, 1)])
def test_bf16_kernels_refuse_what_tma_cannot_read(width, offset):
    """The bf16 forward loads through TMA, whose bases and row strides
    are multiples of 16 bytes: a width that is not a multiple of 8, or an
    input that starts off a 16-byte boundary, raises (on a CUDA tensor;
    the check itself needs no card)."""
    x = torch.zeros(width + offset, dtype=torch.bfloat16)[offset:]
    with pytest.raises(ValueError, match="multiple of 8|16-byte aligned"):
        ab._check_tma(width, x=x)
    ab._check_tma(256, x=torch.zeros(256, dtype=torch.bfloat16))


def test_softmax_stats_plain_are_the_training_forwards():
    """The statistics the checks hold K3's saved m and l against, from
    a qkv buffer, are the ones the plain training forward saves."""
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x = t(rng.standard_normal((B, L, E)) * 0.5)
    wqkv, bqkv = t(rng.standard_normal((E, 3 * E)) * 0.05), t(rng.standard_normal(3 * E) * 0.02)
    wo, bo = t(rng.standard_normal((E, E)) * 0.05), t(rng.standard_normal(E) * 0.02)
    mask = np.ones((B, L), np.int32)
    mask[1, L // 3:] = 0
    seg = torch.from_numpy((np.arange(L)[None] >= L // 2).repeat(B, 0).astype(np.int32))
    bias_row, seg_row = ab.rows(attention_bias_from_mask(torch.from_numpy(mask)), seg, B, L)
    _, (qkv, _, m, l) = ab.train_forward_plain(x, wqkv, bqkv, wo, bo, H, bias_row, seg_row)
    got_m, got_l = ab.softmax_stats_plain(qkv, H, B, L, bias_row, seg_row)
    assert got_m.shape == got_l.shape == (B, H, L)
    torch.testing.assert_close(got_m, m, rtol=0, atol=0)
    torch.testing.assert_close(got_l, l, rtol=1e-6, atol=0)

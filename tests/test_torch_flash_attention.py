"""PyTorch port of the per-head flash attention (K7, K8) against the JAX
kernel (Pallas interpret mode on the CPU) and against itself.

On the CPU the port's wrappers run their plain versions. Tolerances:
fp32 rtol 1e-5 / atol 5e-6 (the gate of tests/test_flash_attention.py:
the same arithmetic in another summation order); bf16 one bf16 ulp of
the largest value (2^-8 relative: both sides round p and the output to
bf16 at the same points, after differently ordered fp32 sums)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.ops import flash_attention as jax_fa
from pl_bert_tpu.ops.attention import xla_attention
from pl_bert_tpu_torch.config import ModelParams
from pl_bert_tpu_torch.models.albert import build_model, init_params
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops import flash_attention as fa
from pl_bert_tpu_torch.ops.attention import IMPL_PATHS, fused_attention, resolve_impl

B, L, H, D = 2, 128, 2, 64
FP32 = dict(rtol=1e-5, atol=5e-6)
BF16_ULP = 2.0 ** -8


def _inputs(seed=0, length=L, padding=False, segments=False):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, length, H, D)).astype(np.float32) for _ in range(4))
    lengths = np.array([length, length * 3 // 5]) if padding else np.array([length] * B)
    valid = np.arange(length)[None, :] < lengths[:, None]
    bias = seg = None
    if padding:
        bias = ((1.0 - valid) * np.finfo(np.float32).min).astype(np.float32)[:, None, None, :]
    if segments:  # two packed samples a row, -1 at padding
        seg = np.where(valid, (np.arange(length)[None, :] >= length // 3), -1).astype(np.int32)
    return q, k, v, g, bias, seg


def _jax(q, k, v, g, bias, seg, dtype):
    """Forward and (dq, dk, dv) of the JAX kernel in interpret mode."""
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    jb = None if bias is None else jnp.asarray(bias)
    js = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return jax_fa.flash_attention(q, k, v, jb, js, out_dtype=dtype)

    with pltpu.force_tpu_interpret_mode():
        out = f(cast(q), cast(k), cast(v))
        grads = jax.grad(
            lambda q, k, v: (f(q, k, v).astype(jnp.float32) * jnp.asarray(g)).sum(),
            argnums=(0, 1, 2),
        )(cast(q), cast(k), cast(v))
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _port(q, k, v, g, bias, seg, dtype):
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(
        tq, tk, tv, None if bias is None else torch.tensor(bias),
        None if seg is None else torch.tensor(seg),
    )
    assert out.dtype == dtype and out.shape == tq.shape
    (out.float() * torch.tensor(g)).sum().backward()
    return [a.detach().float().numpy() for a in (out, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("padding,segments", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_flash_matches_jax_kernel_fp32(padding, segments):
    inputs = _inputs(padding=padding, segments=segments)
    for got, want in zip(_port(*inputs, torch.float32), _jax(*inputs, jnp.float32)):
        np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("padding,segments", [(False, False), (True, True)])
def test_flash_matches_jax_kernel_bf16(padding, segments):
    inputs = _inputs(seed=1, padding=padding, segments=segments)
    for got, want in zip(_port(*inputs, torch.bfloat16), _jax(*inputs, jnp.bfloat16)):
        assert np.abs(got - want).max() <= BF16_ULP * np.abs(want).max()


def test_fully_masked_rows_stay_finite():
    """A row whose every key is masked (padding bias on all of them, and
    segment −1 everywhere) stays finite through the NEG clamp, forward
    and backward (tests/test_flash_attention.py:59)."""
    q, k, v, g, _, _ = _inputs(seed=2)
    bias = np.zeros((B, 1, 1, L), np.float32)
    bias[1] = np.finfo(np.float32).min
    seg = np.zeros((B, L), np.int32)
    seg[1] = -1
    for got, want in zip(_port(q, k, v, g, bias, seg, torch.float32),
                         _jax(q, k, v, g, bias, seg, jnp.float32)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **FP32)


def test_any_length_against_xla_attention():
    """L = 200 is no multiple of 128: the TPU gate
    (pl_bert_tpu/ops/attention.py:44) sends it to ``xla_attention``, the
    port's kernel path takes it — a deliberate difference."""
    q, k, v, _, bias, seg = _inputs(seed=3, length=200, padding=True, segments=True)
    want = xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
                         jnp.asarray(seg), dtype=jnp.float32)
    got = fused_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(bias), torch.tensor(seg))
    # padded query rows carry no meaning (the kernels clamp the bias to
    # NEG, the einsum path does not): compare the real positions
    valid = seg >= 0
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], **FP32)


def test_other_head_widths_raise_on_the_kernel_path():
    """head_dim 64 only, a deliberate difference (the TPU takes multiples
    of 64): the kernel's checks refuse another width, they do not fall
    back. They run before any launch, so a CPU test can reach them."""
    q = torch.zeros(1, 16, 2, 128)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa._check(q.to("meta"), q.to("meta"), q.to("meta"), None, None)
    fake = torch.empty(0, device="meta")

    class Cuda:  # a tensor's facts, as _check reads them
        device = torch.device("cuda", 0)
        dtype = torch.float32
        shape = (1, 16, 2, 128)

        def dim(self):
            return 4

    with pytest.raises(ValueError, match=r"\[B, L, H, 64\]"):
        fa._check(Cuda(), fake, fake, None, None)


def test_plain_backward_gradcheck_fp64():
    """The written-out backward (K8's formulas) is the gradient of the
    plain forward: ``autograd.gradcheck`` in fp64 at a tiny shape, with
    padding and segments."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 12, 2, 8, dtype=torch.float64, generator=gen).requires_grad_()
               for _ in range(3))
    # the last two keys are padding; every query keeps some key (a row
    # with none has a constant score, whose true gradient is 0)
    bias = torch.zeros(1, 1, 1, 12)
    bias[..., 10:] = torch.finfo(torch.float32).min
    seg = torch.tensor([[0] * 4 + [1] * 8], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, bias, seg), (q, k, v), fast_mode=True)


def test_dropout_forward_and_backward_share_one_mask():
    """With dropout 0.1 the plain forward and backward regenerate one
    mask from the seed: a finite-difference check with the mask fixed
    (fp64), the keep rate is 0.9 ± 0.01, and another seed drops other
    elements."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 12, 2, 8, dtype=torch.float64, generator=gen).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, dropout_rate=0.1, dropout_seed=5),
        (q, k, v), fast_mode=True)
    keep = ab.dropout_keep(5, 0.1, 4, 8, 128)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    assert not torch.equal(keep, ab.dropout_keep(6, 0.1, 4, 8, 128))
    a = fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=5)
    assert torch.equal(a, fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=5))
    assert not torch.equal(a, fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=6))
    # no seed means rate 0 (pl_bert_tpu/ops/flash_attention.py:219-221)
    assert torch.equal(fa.flash_attention(q, k, v, dropout_rate=0.1),
                       fa.flash_attention(q, k, v))


@pytest.mark.parametrize("impl,path", [
    ("auto", "block"), ("kernel", "block"), ("pallas_block", "block"), ("pallas", "flash"),
    ("eager", "eager"), ("xla", "eager"),
])
def test_resolve_impl_maps_each_config_value_to_its_path(impl, path):
    assert resolve_impl(impl) == path and IMPL_PATHS[impl] == path


def test_resolve_impl_refuses_unknown_values():
    with pytest.raises(ValueError, match="unsupported attention_impl"):
        resolve_impl("flashier")


def _layer_model(impl, dropout):
    mp = ModelParams(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                     max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                     dropout=dropout, attention_impl=impl)
    return init_params(build_model(mp, "fp32"), seed=3)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_flash_path_and_block_path_of_a_layer_agree(dropout):
    """Same weights, same seeds: the flash path (K7/K8 between cuBLAS
    projections) and the block path drop the same probabilities and
    return the same hidden states and gradients (fp32, other summation
    order: rtol 1e-4 / atol 1e-5), and each runs its own wrappers only."""
    rng = np.random.default_rng(4)
    hidden = torch.tensor(rng.standard_normal((2, 64, 128)).astype(np.float32))
    mask = torch.ones(2, 64, dtype=torch.int32)
    mask[1, 40:] = 0
    seg = torch.where(mask.bool(), (torch.arange(64)[None] >= 20).int(), -1)
    from pl_bert_tpu_torch.models.albert import attention_bias_from_mask

    outs = {}
    for impl in ("auto", "pallas"):
        model = _layer_model(impl, dropout)
        attn = model.encoder.encoder.layer.attention
        calls = []
        for mod, name in ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
                          (ab, "train_forward"), (ab, "train_backward")):
            orig = getattr(mod, name)

            def spy(*a, _orig=orig, _name=name, **kw):
                calls.append(_name)
                return _orig(*a, **kw)

            setattr(mod, name, spy)
        try:
            x = hidden.clone().requires_grad_()
            w = model.encoder.train_weights()["encoder"]["layer"]["attention"]
            seeds = (11, 12, 13) if dropout else (None, None, None)
            out = attn(x, attention_bias_from_mask(mask), seg, w, seeds)
            out.square().sum().backward()
        finally:
            for mod, name in ((fa, "flash_attention_fwd"), (fa, "flash_attention_bwd"),
                              (ab, "train_forward"), (ab, "train_backward")):
                setattr(mod, name, getattr(mod, name).__kwdefaults__["_orig"])
        want = (["flash_attention_fwd", "flash_attention_bwd"] if impl == "pallas"
                else ["train_forward", "train_backward"])
        assert calls == want
        outs[impl] = (out.detach(), x.grad, attn.query.weight.grad, attn.dense.weight.grad)
    for a, b in zip(outs["pallas"], outs["auto"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_one_state_dict_drives_all_three_paths():
    base = _layer_model("auto", 0.0)
    ids = torch.arange(64)[None].repeat(2, 1) % 100
    mask = torch.ones(2, 64, dtype=torch.int32)
    want = base(ids, mask)
    for impl in ("pallas", "xla"):
        other = build_model(dataclasses.replace(
            ModelParams(hidden_size=128, num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=64, num_hidden_layers=2, embedding_size=32,
                        dropout=0.0), attention_impl=impl), "fp32")
        other.load_state_dict(base.state_dict(), strict=True)
        np.testing.assert_allclose(other(ids, mask).detach().numpy(), want.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)

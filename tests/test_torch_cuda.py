"""The port's kernels on a CUDA card against their plain versions.

Marked ``cuda``: each test skips without a card. On a machine with one
(no jax needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pl_bert_tpu_torch.models.albert import attention_bias_from_mask
from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops import fused_ln

pytestmark = pytest.mark.cuda

# fp32: same arithmetic, other summation order; bf16: one-ulp (2^-8)
# rounding flips after differently ordered fp32 sums
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (6e-2, 1e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, dtype):
    atol, rel = TOL[dtype]
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    assert (o - r).abs().max() <= atol * max(1.0, float(r.abs().max()))
    assert (o - r).norm() / r.norm() <= rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,heads,segments", [(128, 4, False), (100, 4, True), (200, 2, False)])
def test_attention_block_kernel_matches_plain(dev, dtype, L, heads, segments):
    B, E = 3, 256  # head_dim 64, or 128 with 2 heads
    rng = np.random.default_rng(L + heads)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.standard_normal((B, L, E)) * 0.5).to(dtype)
    args = [t(rng.standard_normal(s) * sc) for s, sc in
            [((E, E), 0.05), ((E,), 0.02)] * 4]
    lengths = np.array([L, L // 3, 0])  # a fully masked row
    mask = t((np.arange(L)[None] < lengths[:, None]).astype(np.float32))
    seg = t((np.arange(L)[None] >= L // 2).repeat(B, 0)).int() if segments else None
    packed = ab.pack_weights(*args, dtype)
    bias = attention_bias_from_mask(mask)
    before = ab.LAUNCHES.count
    out = ab.attention_block_packed(x, *packed, heads, bias=bias, segment_ids=seg)
    assert ab.LAUNCHES.count == before + 1
    ref = ab.attention_block_plain(x, *packed, heads, bias=bias, segment_ids=seg)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, L, E)
    _close(out, ref, dtype)


@pytest.mark.parametrize("kwargs", [{"out_dtype": torch.bfloat16}], ids=["out_dtype"])
def test_attention_block_refuses_what_is_not_built_on_cuda(dev, kwargs):
    """The kernel writes the compute dtype, so no mixed output pair is
    built."""
    x = torch.zeros(1, 64, 128, device=dev)
    w = [torch.zeros(s, device=dev) for s in [(128, 128), (128,)] * 4]
    with pytest.raises(NotImplementedError):
        ab.attention_block(x, *w, 2, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 768), (3, 100, 200)])
def test_fused_ln_kernel_matches_plain(dev, dtype, shape):
    rng = np.random.default_rng(0)
    x, res = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(dev, dtype) for _ in range(2))
    H = shape[-1]
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    beta = torch.from_numpy(0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    before = fused_ln.LAUNCHES.count
    out = fused_ln.dropout_add_layernorm(x, res, gamma, beta)
    assert fused_ln.LAUNCHES.count == before + 1
    ref = fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == shape
    _close(out, ref, dtype)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_fused_ln_dropout_keep_rate(dev, rate):
    """x = 1, residual = 0: a row holds kept 1/(1-rate) and dropped 0,
    and after normalisation the dropped ones are the negative ones."""
    ones = torch.ones(2048, 768, device=dev)
    g, b = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    y = fused_ln.dropout_add_layernorm(ones, torch.zeros_like(ones), g, b, seed=5, rate=rate)
    again = fused_ln.dropout_add_layernorm(ones, torch.zeros_like(ones), g, b, seed=5, rate=rate)
    other = fused_ln.dropout_add_layernorm(ones, torch.zeros_like(ones), g, b, seed=6, rate=rate)
    assert abs(float((y < 0).float().mean()) - rate) < 0.01
    assert torch.equal(y, again) and not torch.equal(y, other)


def _block_case(dev, dtype, B=3, L=100, E=256, heads=4):
    rng = np.random.default_rng(L + heads + 7)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    x = t(rng.standard_normal((B, L, E)) * 0.5).to(dtype)
    wqkv32, bqkv = t(rng.standard_normal((E, 3 * E)) * 0.05), t(rng.standard_normal(3 * E) * 0.02)
    wo32, bo = t(rng.standard_normal((E, E)) * 0.05), t(rng.standard_normal(E) * 0.02)
    lengths = np.array([L, L // 3, 0])[:B]
    mask = t((np.arange(L)[None] < lengths[:, None]).astype(np.float32))
    seg = t((np.arange(L)[None] >= L // 2).repeat(B, 0)).int()
    bias_row, seg_row = ab.rows(attention_bias_from_mask(mask), seg, B, L)
    return (x, wqkv32.to(dtype).contiguous(), bqkv, wo32.to(dtype).contiguous(), bo,
            heads, bias_row, seg_row)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_training_kernels_match_plain(dev, dtype, rate):
    """K3 and K4 against their plain versions on the same inputs, the
    plain ones dropping with the mask the kernels' Philox code writes."""
    x, wqkv, bqkv, wo, bo, heads, bias_row, seg_row = _block_case(dev, dtype)
    B, L, E = x.shape
    seed = 11 if rate else None
    keep = ab.dropout_mask(11, rate, B, heads, L, dev) if rate else None
    counts = (ab.LAUNCHES_TRAIN.count, ab.LAUNCHES_BWD.count)
    out, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, heads, bias_row, seg_row, rate, seed)
    ref, ref_saved = ab.train_forward_plain(x, wqkv, bqkv, wo, bo, heads, bias_row, seg_row,
                                            rate, seed, keep=keep)
    dout = torch.randn(B, L, E, device=dev, generator=torch.Generator(dev).manual_seed(0))
    dout = dout.to(dtype)
    dx, dqkv = ab.train_backward(dout, x, wqkv, wo, saved, heads, bias_row, seg_row, rate, seed)
    rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, heads, bias_row, seg_row,
                                         rate, seed, keep=keep)
    torch.cuda.synchronize()
    assert (ab.LAUNCHES_TRAIN.count, ab.LAUNCHES_BWD.count) == (counts[0] + 1, counts[1] + 1)
    for a, r in [(out, ref), *zip(saved, ref_saved), (dx, rdx), (dqkv, rdqkv)]:
        _close(a, r, dtype if a.dtype == dtype else torch.float32)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_light_forward_equals_training_forward(dev, rate):
    x, wqkv, bqkv, wo, bo, heads, bias_row, seg_row = _block_case(dev, torch.bfloat16)
    out, _ = ab.train_forward(x, wqkv, bqkv, wo, bo, heads, bias_row, seg_row, rate, 5)
    light, _ = ab._launch_fwd(x, wqkv, bqkv, wo, bo, heads, bias_row, seg_row, rate, 5,
                              save=False)
    assert torch.equal(out, light)


def test_attention_dropout_mask_is_the_plain_philox(dev):
    keep = ab.dropout_mask(1234, 0.1, 4, 12, 128, dev)
    assert torch.equal(keep.bool(), ab.dropout_keep(1234, 0.1, 4, 12, 128, dev))
    assert abs(float(keep.float().mean()) - 0.9) < 2e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_backward_kernel_matches_plain(dev, dtype, rate):
    rng = np.random.default_rng(1)
    N, H = 1000, 768
    x, res, dy = (torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
                  .to(dev, dtype) for _ in range(3))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    seed = 9 if rate else None
    keep = fused_ln.dropout_mask((N, H), 9, rate, dev) if rate else None
    before = fused_ln.LAUNCHES_BWD.count
    got = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
    ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, seed, rate, keep=keep)
    torch.cuda.synchronize()
    assert fused_ln.LAUNCHES_BWD.count == before + 1
    for a, r in zip(got, ref):
        _close(a, r, dtype if a.dtype == dtype else torch.float32)


def test_train_step_kernel_path_follows_plain_path(dev):
    """Three fp32 steps of a small model on the kernel path (K3-K6) and
    on the plain path under autograd, dropout 0, from the same weights
    and batches: loss and grad_norm agree to fp32 summation order."""
    import dataclasses

    from pl_bert_tpu_torch.config import ModelParams, TrainingParams
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.training import train_step as ts

    mp = ModelParams(hidden_size=256, num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128, num_hidden_layers=2, embedding_size=64,
                     dropout=0.0)
    pool = full_length_batches(3, 4, 128)
    metrics = {}
    for impl in ("auto", "eager"):
        model = init_params(build_model(dataclasses.replace(mp, attention_impl=impl), "fp32"))
        model = model.to(dev)
        tx = ts.make_optimizer(TrainingParams(learning_rate=1e-3))
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx)
        metrics[impl] = [{k: float(v) for k, v in step(state, b)[1].items()} for b in pool]
    for k, p in zip(metrics["auto"], metrics["eager"]):
        assert k["loss"] == pytest.approx(p["loss"], rel=1e-5)
        assert k["grad_norm"] == pytest.approx(p["grad_norm"], rel=1e-4)

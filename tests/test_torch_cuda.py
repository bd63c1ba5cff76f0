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


@pytest.mark.parametrize(
    "kwargs",
    [{"dropout_rate": 0.1, "dropout_seed": 3}, {"out_dtype": torch.bfloat16}],
    ids=["dropout", "out_dtype"],
)
def test_attention_block_refuses_what_is_not_built_on_cuda(dev, kwargs):
    """Attention dropout comes with the training slice; the kernel writes
    the compute dtype, so no mixed output pair is built."""
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

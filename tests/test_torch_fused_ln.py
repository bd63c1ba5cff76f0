"""PyTorch port of the fused dropout+add+LayerNorm against the JAX
kernel (Pallas interpret mode on the CPU): same numpy inputs, rate 0,
fp32, at the gate of tests/test_fused_ln.py (atol 2e-5, rtol 1e-5)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.ops import fused_ln as jax_ln
from pl_bert_tpu_torch.ops import fused_ln

N, H = 512, 256


def _inputs(seed=0, n=N, h=H):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    res = rng.standard_normal((n, h)).astype(np.float32)
    gamma = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(h) * 0.1).astype(np.float32)
    return x, res, gamma, beta


def test_plain_matches_jax_kernel():
    x, res, gamma, beta = _inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_ln.dropout_add_layernorm(x, res, gamma, beta))
    out = fused_ln.dropout_add_layernorm(*map(torch.from_numpy, (x, res, gamma, beta)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_wrapper_takes_plain_on_cpu_and_counts_nothing():
    x, res, gamma, beta = (torch.from_numpy(a) for a in _inputs(seed=1))
    before = fused_ln.LAUNCHES.count
    out = fused_ln.dropout_add_layernorm(x, res, gamma, beta)
    plain = fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert fused_ln.LAUNCHES.count == before


@pytest.mark.parametrize("shape", [(3, 100, 200), (7, 768)])
def test_ragged_rows_and_width(shape):
    """No rows % 256 or H % 128 rule in the port: any [..., H] works."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    h = shape[-1]
    out = fused_ln.dropout_add_layernorm(x, res, torch.ones(h), torch.zeros(h))
    assert out.shape == shape
    ref = torch.nn.functional.layer_norm(x + res, (h,), eps=1e-12)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-5)


def test_bf16_output_dtype_and_fp32_stats():
    x, res, gamma, beta = (torch.from_numpy(a) for a in _inputs(seed=3))
    xb, rb = x.bfloat16(), res.bfloat16()
    out = fused_ln.dropout_add_layernorm(xb, rb, gamma, beta)
    assert out.dtype == torch.bfloat16
    ref = fused_ln.dropout_add_layernorm_plain(xb.float(), rb.float(), gamma, beta)
    torch.testing.assert_close(out.float(), ref, atol=4e-2, rtol=1e-2)


def test_dropout_plain_keep_rate_and_scale():
    rate = 0.3
    x = torch.ones(256, 512)
    res = torch.zeros(256, 512)
    y = fused_ln.dropout_add_layernorm_plain(
        x, res, torch.ones(512), torch.zeros(512), seed=7, rate=rate
    )
    again = fused_ln.dropout_add_layernorm_plain(
        x, res, torch.ones(512), torch.zeros(512), seed=7, rate=rate
    )
    torch.testing.assert_close(y, again, rtol=0, atol=0)  # seed-determined
    # with x = 1 and res = 0 a row holds two values: dropped (0) and
    # kept (1/(1-rate)), normalised; the lower one marks the dropped
    dropped = (y < 0).float().mean().item()
    assert abs(dropped - rate) < 0.01


def test_tl_rand_known_answer():
    """Random123's Philox4x32-10 known answer at key 0, counter 0 (first
    word 6627e8d5) through Triton's float conversion: a positive int32,
    times 4.6566127342e-10 in fp32."""
    bits = fused_ln.ab.philox_bits(0, 0, torch.zeros(1, dtype=torch.int64), 0)
    assert int(bits) == 0x6627E8D5
    want = np.float32(0x6627E8D5) * np.float32(4.6566127342e-10)
    assert fused_ln.tl_rand(0, torch.zeros(1, dtype=torch.int64)).item() == want


def test_tl_rand_folds_negative_words():
    """A first word >= 2^31 is a negative int32 x, which Triton maps to
    -x - 1 before scaling; every float lies in [0, 1)."""
    offsets = torch.arange(4096)
    bits = fused_ln.ab.philox_bits(3, 0, offsets, 0)
    high = bits >= 2**31
    assert 0 < int(high.sum()) < 4096
    u = fused_ln.tl_rand(3, offsets)
    folded = (2**32 - 1 - bits[high]).to(torch.float32) * torch.tensor(4.6566127342e-10)
    torch.testing.assert_close(u[high], folded, rtol=0, atol=0)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_tl_rand_takes_int32_offsets_as_unsigned():
    """The kernels hand tl.rand int32 offsets, which Triton bitcasts to
    uint32: -1 is 2^32 - 1."""
    a = fused_ln.tl_rand(11, torch.tensor([-1, -2], dtype=torch.int32))
    b = fused_ln.tl_rand(11, torch.tensor([2**32 - 1, 2**32 - 2]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# tl.rand(seed, offset) at offsets 0-7 and the keep decisions at rate 0.1,
# read from Triton 3.6.0's tl.rand in a Triton kernel on an NVIDIA H100
# (``fused_ln.triton_rand`` and ``fused_ln.dropout_mask``, K5's mask kernel)
TRITON_RAND = {
    0: ([0.7980929017066956, 0.055517591536045074, 0.03889884054660797, 0.4252644181251526,
         0.13092762231826782, 0.9006523489952087, 0.5727753043174744, 0.6820338368415833],
        [1, 0, 0, 1, 1, 1, 1, 1]),
    1: ([0.21948163211345673, 0.6560034155845642, 0.49480292201042175, 0.48474693298339844,
         0.49552640318870544, 0.3205564022064209, 0.8907782435417175, 0.9613848328590393],
        [1, 1, 1, 1, 1, 1, 1, 1]),
    12345: ([0.3595506250858307, 0.005566734820604324, 0.8451180458068848, 0.5762218832969666,
             0.833573579788208, 0.9319268465042114, 0.040818288922309875, 0.7578627467155457],
            [1, 0, 1, 1, 1, 1, 0, 1]),
    2**31 - 2: ([0.441071093082428, 0.21371276676654816, 0.37638965249061584, 0.641473114490509,
                 0.19668060541152954, 0.35104119777679443, 0.5855880379676819,
                 0.9973425269126892],
                [1, 1, 1, 1, 1, 1, 1, 1]),
}


@pytest.mark.parametrize("seed", sorted(TRITON_RAND))
def test_tl_rand_reproduces_tritons_floats_and_keep_decisions(seed):
    """The plain tl_rand gives Triton's uniform floats bit for bit, and
    tl_rand_keep K5's keep decisions: the CUDA K6 draws the same function
    (held against K5's mask on the card), so this ties K6's mask to K5's."""
    floats, keep = TRITON_RAND[seed]
    offsets = torch.arange(8)
    np.testing.assert_array_equal(fused_ln.tl_rand(seed, offsets).numpy(),
                                  np.asarray(floats, dtype=np.float32))
    np.testing.assert_array_equal(fused_ln.tl_rand_keep(seed, offsets, 0.1).numpy(),
                                  np.asarray(keep, dtype=bool))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_tl_rand_keep_rate(rate):
    offsets = torch.arange(200_000)
    keep = fused_ln.tl_rand_keep(17, offsets, rate)
    assert keep.dtype == torch.bool
    assert abs(float(keep.float().mean()) - (1 - rate)) < 5e-3
    torch.testing.assert_close(keep, fused_ln.tl_rand(17, offsets) >= rate, rtol=0, atol=0)


@pytest.mark.parametrize("op", ["backward", "copy"])
def test_k6_k9_wrappers_take_plain_on_cpu_and_count_nothing(op):
    x, res, gamma, _ = (torch.from_numpy(a) for a in _inputs(seed=4, n=64, h=96))
    if op == "backward":
        counter = fused_ln.LAUNCHES_BWD
        dy = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 96), np.float32))
        before = counter.count
        got = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed=3, rate=0.2)
        want = fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, seed=3, rate=0.2)
    else:
        counter = fused_ln.LAUNCHES_COPY
        before = counter.count
        got = (fused_ln.add_copy(x.bfloat16(), res.bfloat16()),)
        want = (fused_ln.add_copy_plain(x.bfloat16(), res.bfloat16()),)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert counter.count == before


# width → whether K5 and K6 take it
REFUSAL_WIDTHS = {8: True, 768: True, 1024: True, 1032: True, 1536: True, 2048: True,
                  2056: False, 100: False}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("width", sorted(REFUSAL_WIDTHS))
def test_ln_kernel_refusal(width, dtype):
    """The LN kernels take a width that is a multiple of 8 up to 2048, in
    the forward and in training alike; the reason names the rule it
    breaks, and other dtypes are refused."""
    reason = fused_ln.ln_kernel_refusal(width, dtype)
    assert (reason is None) == REFUSAL_WIDTHS[width], reason
    if width % 8:
        assert "multiple of 8" in reason
    elif not REFUSAL_WIDTHS[width]:
        assert str(fused_ln.MAX_WIDTH) in reason
    assert "float16" in fused_ln.ln_kernel_refusal(width, torch.float16)


def test_plain_fed_tl_rand_mask_matches_jax_kernel_math():
    """With the mask the kernels draw (``tl_rand_keep``), the plain K5
    computes the JAX ``_fwd_kernel``'s body: x / (1 - rate) where kept,
    the residual added, ``_ln_stats`` and the affine, in fp32. The TPU's
    own mask cannot be reproduced, so the mask stands in for it."""
    import jax.numpy as jnp

    n, h, seed, rate, eps = 7, 768, 12345, 0.1, 1e-12
    x, res, gamma, beta = _inputs(seed=6, n=n, h=h)
    keep = fused_ln.tl_rand_keep(seed, torch.arange(n * h), rate).reshape(n, h)
    assert 0 < int((~keep).sum()) < n * h
    y = np.where(keep.numpy(), x / (1.0 - rate), 0.0).astype(np.float32) + res
    xhat, _ = jax_ln._ln_stats(jnp.asarray(y), eps)
    ref = np.asarray(xhat * gamma + beta)
    out = fused_ln.dropout_add_layernorm_plain(
        *map(torch.from_numpy, (x, res, gamma, beta)), seed=seed, rate=rate, eps=eps, keep=keep)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-5)

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
@pytest.mark.parametrize("L,heads,segments", [(128, 4, False), (100, 4, True), (200, 2, False),
                                               (100, 2, True)])
def test_attention_block_kernel_matches_plain(dev, dtype, L, heads, segments):
    # head_dim 64, or 128 with 2 heads; M = B*L = 300 and 600 are not
    # multiples of the bf16 GEMM's 128-row tile; row 2 is fully masked
    B, E = 3, 256
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


@pytest.mark.parametrize("heads", [6, 3])
def test_block_fp32_output_of_a_tensor_parallel_shard(dev, heads):
    """K1 and K3 write a shard's fp32 partial output (P = 384 or 192 of
    E = 768, zero output bias): its plain version's within the bf16
    tolerance, K1 the same as K3, and rounded to bf16 K3's bf16 output bit
    for bit (the epilogue stores the sum it would round)."""
    B, L, E, P = 2, 256, 768, 64 * heads
    rng = np.random.default_rng(heads)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)  # noqa: E731
    x = t(rng.standard_normal((B, L, E)) * 0.5).to(torch.bfloat16)
    wqkv = t(rng.standard_normal((E, 3 * P)) * 0.05).to(torch.bfloat16)
    bqkv = t(rng.standard_normal(3 * P) * 0.02)
    wo = t(rng.standard_normal((P, E)) * 0.05).to(torch.bfloat16)
    zero = torch.zeros(E, device=dev)
    out, _ = ab.train_forward(x, wqkv, bqkv, wo, zero, heads, out_dtype=torch.float32)
    light = ab.attention_block_packed(x, wqkv, bqkv, wo, zero, heads, out_dtype=torch.float32)
    rounded, _ = ab.train_forward(x, wqkv, bqkv, wo, zero, heads)
    ref, _ = ab.train_forward_plain(x, wqkv, bqkv, wo, zero, heads, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.equal(light, out)
    assert torch.equal(out.to(torch.bfloat16), rounded)
    _close(out, ref, torch.bfloat16)


@pytest.mark.parametrize("kwargs", [{"out_dtype": torch.bfloat16}], ids=["out_dtype"])
def test_attention_block_refuses_what_is_not_built_on_cuda(dev, kwargs):
    """The kernel writes the compute dtype, so no mixed output pair is
    built."""
    x = torch.zeros(1, 64, 128, device=dev)
    w = [torch.zeros(s, device=dev) for s in [(128, 128), (128,)] * 4]
    with pytest.raises(NotImplementedError):
        ab.attention_block(x, *w, 2, **kwargs)


def test_attention_block_bf16_refuses_what_tma_cannot_read(dev):
    """E = 132 is not a multiple of 8: the tensor-core forward's TMA
    cannot read its rows, and the wrapper raises rather than route
    elsewhere; fp32 (the CUDA cores) takes it."""
    B, L, E, heads = 1, 64, 132, 2
    x = torch.zeros(B, L, E, device=dev)
    w = [torch.zeros(s, device=dev) for s in [(E, 128), (128,)] * 3 + [((128, E)), (E,)]]
    packed32 = ab.pack_weights(*w, torch.float32)
    assert ab.attention_block_packed(x, *packed32, heads).shape == (B, L, E)
    packed16 = ab.pack_weights(*w, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ab.attention_block_packed(x.bfloat16(), *packed16, heads)


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


@pytest.mark.parametrize("rate,seed", [(0.0, None), (0.1, 0), (0.1, 1), (0.1, 2**31 - 2)])
@pytest.mark.parametrize("H", [8, 200, 768, 1000, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ln_forward_draws_tritons_mask(dev, dtype, H, rate, seed):
    """K5 against its plain version fed Triton's own tl.rand mask (a
    Triton kernel), at widths of one to eight 256-column slices, the last
    partly idle: one element dropped differently moves its output by
    about a standard deviation of its row, past the gate, so this holds
    K5's mask to Triton's bit for bit."""
    rng = np.random.default_rng(H)
    N = 300
    x, res = (torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    beta = torch.from_numpy(0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    keep = fused_ln.dropout_mask((N, H), seed, rate, dev) if rate else None
    before = fused_ln.LAUNCHES.count
    out = fused_ln.dropout_add_layernorm(x, res, gamma, beta, seed, rate)
    assert fused_ln.LAUNCHES.count == before + 1
    ref = fused_ln.dropout_add_layernorm_plain(x, res, gamma, beta, seed, rate, keep=keep)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (N, H)
    _close(out, ref, dtype)


@pytest.mark.parametrize("H,seed", [(100, 1), (2056, 1), (4, 1), (768, -1), (768, 2**31 - 1)])
def test_fused_ln_forward_refuses_what_it_does_not_take(dev, H, seed):
    """A width that is no multiple of 8 or above 2048, or a seed outside
    the range whose masks were held against Triton's, raises; so does a
    dtype K5 is not built for."""
    x = torch.zeros(4, H, device=dev, dtype=torch.bfloat16)
    g, b = torch.ones(H, device=dev), torch.zeros(H, device=dev)
    with pytest.raises(ValueError):
        fused_ln.dropout_add_layernorm(x, x, g, b, seed, 0.1)
    with pytest.raises(TypeError):
        fused_ln.dropout_add_layernorm(x.half(), x.half(), g, b)


def test_fused_ln_forward_is_deterministic(dev):
    rng = np.random.default_rng(9)
    x, res = (torch.from_numpy(rng.standard_normal((2048, 768)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    g, b = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    first = fused_ln.dropout_add_layernorm(x, res, g, b, 77, 0.1)
    again = fused_ln.dropout_add_layernorm(x, res, g, b, 77, 0.1)
    assert torch.equal(first, again)


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
    plain ones dropping with the mask the kernels' Philox code writes;
    K3's saved row max and denominator against the plain statistics of
    its own qkv (the bf16 projection rounds on the tensor cores)."""
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
    stats = ab.softmax_stats_plain(saved[0], heads, B, L, bias_row, seg_row)
    for a, r in [(out, ref), *zip(saved[:2], ref_saved[:2]), *zip(saved[2:], stats),
                 (dx, rdx), (dqkv, rdqkv)]:
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


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 2, "drawn"])
def test_fused_ln_backward_regenerates_k5s_mask(dev, seed):
    """K6 drops with K5's tl.rand mask bit for bit (seeds 0, 1, 2^31 - 2
    and one the training step draws): its dx is zero exactly where K5's
    mask drops (or dres is zero); and the plain tl_rand equals Triton's
    uniform floats."""
    from pl_bert_tpu_torch.models.albert import draw_dropout_seeds

    if seed == "drawn":
        seed = draw_dropout_seeds(torch.Generator().manual_seed(0), 1)[1]
    rng = np.random.default_rng(3)
    N, H = 4096, 768
    x, res, dy = (torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
                  .to(dev, torch.bfloat16) for _ in range(3))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    dx, dres, _, _ = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, 0.1)
    keep = fused_ln.dropout_mask((N, H), seed, 0.1, dev).bool()
    assert torch.equal(dx != 0, keep & (dres != 0))
    u = fused_ln.triton_rand(8192, seed, dev).cpu()
    assert torch.equal(u, fused_ln.tl_rand(seed, torch.arange(8192)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fused_ln_backward_is_deterministic(dev, rate):
    """Two calls give the same bits (no float atomics in the dγ/dβ sums)."""
    rng = np.random.default_rng(3)
    N, H = 3000, 768
    x, res, dy = (torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
                  .to(dev, torch.bfloat16) for _ in range(3))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    seed = 21 if rate else None
    got = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
    again = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, seed, rate)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("H", [8, 256, 512, 1000, 1024, 1032, 1536, 2048])
def test_fused_ln_backward_widths(dev, H, dtype):
    """Any width that is a multiple of 8 up to 2048: one to eight
    256-column slices a lane, the last one partly idle; above four slices
    the dγ/dβ partials live in shared memory."""
    rng = np.random.default_rng(H)
    N = 300
    x, res, dy = (torch.from_numpy(rng.standard_normal((N, H)).astype(np.float32))
                  .to(dev, dtype) for _ in range(3))
    gamma = torch.from_numpy(1 + 0.1 * rng.standard_normal(H).astype(np.float32)).to(dev)
    keep = fused_ln.dropout_mask((N, H), 4, 0.1, dev)
    before = fused_ln.LAUNCHES_BWD.count
    got = fused_ln.dropout_add_layernorm_bwd(dy, x, res, gamma, 4, 0.1)
    ref = fused_ln.dropout_add_layernorm_bwd_plain(dy, x, res, gamma, 4, 0.1, keep=keep)
    assert fused_ln.LAUNCHES_BWD.count == before + 1
    for a, r in zip(got, ref):
        _close(a, r, dtype if a.dtype == dtype else torch.float32)


@pytest.mark.parametrize("H,seed", [(100, 1), (2056, 1), (768, -1), (768, 2**31 - 1)])
def test_fused_ln_backward_refuses_what_it_does_not_take(dev, H, seed):
    """A width that is no multiple of 8 or above 2048, or a seed outside
    the range whose masks were held against K5's, raises."""
    x = torch.zeros(4, H, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_ln.dropout_add_layernorm_bwd(x, x, x, torch.ones(H, device=dev), seed, 0.1)


def test_encoder_fetches_its_own_batch(dev):
    """Two batches dispatched before the first fetch (the serving
    pipeline's order on the card: pinned uploads, copies on the encoder's
    copy stream); each answer equals a direct call."""
    from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel
    from pl_bert_tpu_torch.models.inference import PhonemeEncoder

    cfg = AlbertConfig(hidden_size=256, num_attention_heads=4, intermediate_size=512,
                       max_position_embeddings=128, num_hidden_layers=2, embedding_size=64)
    torch.manual_seed(0)
    enc = PhonemeEncoder(AlbertModel(cfg).state_dict(), cfg, 128, mixed_precision="bf16",
                         batch_size=4, device=dev)
    chunks = (["qalam", "bajt ʃams", "ab"], ["ˈmaʕna θaːbit", "ʃ" * 70])
    handles = [enc.dispatch(c) for c in chunks]
    for chunk, handle in zip(chunks, handles):
        hidden, lengths = enc.fetch(handle)
        direct, direct_lengths = enc(chunk)
        np.testing.assert_array_equal(lengths, direct_lengths)
        np.testing.assert_array_equal(hidden, direct)


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


@pytest.mark.parametrize("width,heads,kernels", [(1536, 24, True), (2560, 40, False)])
def test_wide_model_trains_on_the_block_path(dev, width, heads, kernels):
    """24 heads of 64 (width 1536) trains with K5/K6 at its LayerNorms,
    as JAX fuses that width; 40 heads of 64 (width 2560, above what the
    LN kernels take) runs its LN plain (decided when it is built) and the
    attention on the kernels. Three fp32 steps without raising, which
    follow the plain path as test_train_step_kernel_path_follows_plain_path
    does."""
    import dataclasses

    from pl_bert_tpu_torch.config import ModelParams, TrainingParams
    from pl_bert_tpu_torch.data.synthetic import full_length_batches
    from pl_bert_tpu_torch.models.albert import build_model, init_params
    from pl_bert_tpu_torch.ops import attention_block as ab
    from pl_bert_tpu_torch.training import train_step as ts

    mp = ModelParams(hidden_size=width, num_attention_heads=heads, intermediate_size=512,
                     max_position_embeddings=64, num_hidden_layers=1, embedding_size=64,
                     dropout=0.0)
    pool = full_length_batches(3, 2, 64)
    metrics = {}
    counters = (ab.LAUNCHES_BWD, fused_ln.LAUNCHES, fused_ln.LAUNCHES_BWD)
    for impl in ("auto", "eager"):
        model = init_params(build_model(dataclasses.replace(mp, attention_impl=impl), "fp32"))
        model = model.to(dev)
        tx = ts.make_optimizer(TrainingParams(learning_rate=1e-3))
        state = ts.TrainState(model, tx.init(model))
        step = ts.make_train_step(model, tx)
        before = [c.count for c in counters]
        metrics[impl] = [{k: float(v) for k, v in step(state, b)[1].items()} for b in pool]
        ran = [c.count > b for c, b in zip(counters, before)]
        if impl == "auto":
            assert ran == [True, kernels, kernels]
    for k, p in zip(metrics["auto"], metrics["eager"]):
        assert k["loss"] == pytest.approx(p["loss"], rel=1e-5)
        assert k["grad_norm"] == pytest.approx(p["grad_norm"], rel=1e-4)


def _flash_case(dev, dtype, B=3, L=100, H=4, segments=True, fused=False, D=64, lengths=None):
    """q, k, v, dout [B, L, H, D] (``fused``: views of one [B, L, 3·H·D]
    projection), a padding bias with a fully masked row (or ``lengths``),
    packed segments."""
    rng = np.random.default_rng(L + H + D)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    qkv = t(rng.standard_normal((B, L, 3 * H * D)) * 0.7).to(dtype)
    q, k, v = (s.reshape(B, L, H, D) for s in qkv.split(H * D, dim=-1))
    if not fused:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = t(rng.standard_normal((B, L, H, D))).to(dtype)
    lengths = np.array([L, L // 3, 0])[:B] if lengths is None else np.asarray(lengths)
    valid = np.arange(L)[None] < lengths[:, None]
    seg = None
    if segments:
        seg = t(np.where(valid, (np.arange(L)[None] >= L // 4).astype(np.int32), -1)).int()
    bias_row, seg_row = ab.rows(attention_bias_from_mask(t(valid)), seg, B, L)
    return q, k, v, dout, bias_row, seg_row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,H,segments,fused,rate,D", [
    (128, 4, False, False, 0.0, 64), (100, 4, True, True, 0.0, 64),
    (200, 2, True, False, 0.1, 64), (512, 12, True, True, 0.1, 64),
    (100, 2, True, True, 0.0, 128), (200, 6, True, True, 0.1, 128),
])
def test_flash_attention_kernels_match_plain(dev, dtype, L, H, segments, fused, rate, D):
    """K7 and K8 against their plain versions on the same inputs, the
    plain ones dropping with the mask the kernels' Philox code writes;
    head_dim 64 and 128."""
    from pl_bert_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, bias_row, seg_row = _flash_case(dev, dtype, 3, L, H, segments, fused, D)
    B = q.shape[0]
    seed = 11 if rate else None
    keep = ab.dropout_mask(11, rate, B, H, L, dev) if rate else None
    counts = (fa.LAUNCHES.count, fa.LAUNCHES_BWD.count)
    out = fa.flash_attention_fwd(q, k, v, bias_row, seg_row, rate, seed)
    grads = fa.flash_attention_bwd(dout, q, k, v, bias_row, seg_row, rate, seed)
    ref = fa.flash_attention_plain(q, k, v, bias_row, seg_row, rate, seed, keep=keep)
    rgrads = fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, seg_row, rate, seed, keep=keep)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES.count, fa.LAUNCHES_BWD.count) == (counts[0] + 1, counts[1] + 1)
    assert out.shape == q.shape and out.dtype == dtype
    for a, r in [(out, ref), *zip(grads, rgrads)]:
        _close(a, r, dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [64, 100, 200, 512])
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backward_matches_plain(dev, D, L, segments, rate):
    """The bf16 backwards against the plain backward: K8 (the dq and dk/dv
    kernels on wgmma, statistics recomputed) and K4 (statistics from K3,
    its dx projection on the wgmma GEMM): rows of length L, 5 and 0,
    packed segments or none, dropout 0 and 0.1."""
    from pl_bert_tpu_torch.ops import flash_attention as fa

    H, dtype = 2, torch.bfloat16
    q, k, v, dout, bias_row, seg_row = _flash_case(dev, dtype, 3, L, H, segments, True, D,
                                                    lengths=[L, 5, 0])
    seed = 13 if rate else None
    keep = ab.dropout_mask(13, rate, 3, H, L, dev) if rate else None
    grads = fa.flash_attention_bwd(dout, q, k, v, bias_row, seg_row, rate, seed)
    rgrads = fa.flash_attention_bwd_plain(dout, q, k, v, bias_row, seg_row, rate, seed, keep=keep)
    torch.cuda.synchronize()
    for a, r in zip(grads, rgrads):
        _close(a, r, dtype)

    x, wqkv, bqkv, wo, bo, _, _, _ = _block_case(dev, dtype, 3, L, H * D, H)
    dx_out = torch.randn(3, L, H * D, device=dev, generator=torch.Generator(dev).manual_seed(1))
    dx_out = dx_out.to(dtype)
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, seg_row, rate, seed)
    got = ab.train_backward(dx_out, x, wqkv, wo, saved, H, bias_row, seg_row, rate, seed)
    ref = ab.train_backward_plain(dx_out, x, wqkv, wo, saved, H, bias_row, seg_row, rate, seed,
                                  keep=keep)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        _close(a, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("L", [1, 63, 65, 200, 512])
@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_core_backward_stages_match_plain(dev, dtype, D, L, segments, rate):
    """K4's CUDA-core kernels stage by stage against their plain versions
    on the same inputs, at ragged lengths (rows of length L, 5 and 0):
    ``do`` (the register-blocked GEMM) bitwise the plain ``do`` in bf16,
    delta (the delta pass) fed K4's ``do``, the ds scratch (the dk/dv
    kernel) fed K4's ``do`` and delta, its padding zero, then dqkv and dx."""
    H = 2
    x, wqkv, bqkv, wo, bo, _, _, _ = _block_case(dev, dtype, 3, L, H * D, H)
    _, _, _, _, bias_row, seg_row = _flash_case(dev, dtype, 3, L, H, segments, True, D,
                                                lengths=[L, min(L, 5), 0])
    seed = 17 if rate else None
    keep = ab.dropout_mask(17, rate, 3, H, L, dev) if rate else None
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, seg_row, rate, seed)
    dout = torch.randn(3, L, H * D, device=dev, generator=torch.Generator(dev).manual_seed(2))
    dout = dout.to(dtype)
    before = ab.LAUNCHES_BWD.count
    dx, dqkv, (do, delta, ds) = ab._launch_bwd(dout, x, wqkv, wo, saved, H, bias_row, seg_row,
                                               rate, seed, scratch=True)
    args = (saved, H, bias_row, seg_row, rate, seed, keep)
    rdx, rdqkv = ab.train_backward_plain(dout, x, wqkv, wo, saved, H, bias_row, seg_row, rate,
                                         seed, keep=keep)
    torch.cuda.synchronize()
    assert ab.LAUNCHES_BWD.count == before + 1
    # (bitwise only where cuBLAS also sums each output in one sequential
    # chain: at the smoke's shape, the next test; small GEMMs it may split)
    _close(do, (dout.reshape(3 * L, H * D).float() @ wo.float().T).to(dtype), dtype)
    _close(delta, ab.attention_delta_plain(do, *args), torch.float32)
    ref_ds = ab.attention_dkdv_plain(do, saved, delta, H, bias_row, seg_row, rate, seed,
                                     keep)[2]
    if L > 1:
        _close(ds[:, :, :L, :L], ref_ds, dtype)
    else:  # one key: ds = pd·dpd − p·delta with p = pd = 1, delta = dpd, is 0
        assert ds[:, :, :1, :1].float().abs().max() <= 1e-6 >= ref_ds.float().abs().max()
    assert not ds[:, :, :, L:].any() and not ds[:, :, L:, :].any()
    for a, r in [(dqkv, rdqkv), (dx, rdx)]:
        _close(a, r, dtype)


def test_do_is_bitwise_the_plain_do_at_the_smokes_shape(dev):
    """K4's ``do = dout·Woᵀ`` at the smoke's phase 10 shape ([8, 512, 768]
    bf16): each output is one fmaf chain over the 768 inputs in order, the
    bits of the plain version's cuBLAS fp32 GEMM."""
    B, L, E, H = 8, 512, 768, 12
    rng = np.random.default_rng(5)
    t = lambda a, s=1.0: torch.from_numpy((a * s).astype(np.float32)).to(dev)  # noqa: E731
    wqkv, bqkv = t(rng.standard_normal((E, 3 * E)), 0.05), t(rng.standard_normal(3 * E), 0.02)
    wo, bo = t(rng.standard_normal((E, E)), 0.05), t(rng.standard_normal(E), 0.02)
    wqkv, wo = wqkv.to(torch.bfloat16), wo.to(torch.bfloat16)
    x = t(rng.standard_normal((B, L, E)), 0.5).to(torch.bfloat16)
    valid = np.arange(L)[None] < np.array([512, 480, 384, 256, 128, 64, 5, 0])[:, None]
    bias_row, _ = ab.rows(attention_bias_from_mask(t(valid)), None, B, L)
    _, saved = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, None)
    dout = torch.randn(B, L, E, device=dev, generator=torch.Generator(dev).manual_seed(3))
    dout = dout.to(torch.bfloat16)
    *_, (do, _, _) = ab._launch_bwd(dout, x, wqkv, wo, saved, H, bias_row, None, 0.0, None,
                                    scratch=True)
    assert torch.equal(do, (dout.reshape(B * L, E).float() @ wo.float().T).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("segments", [False, True])
def test_flash_backward_statistics_equal_the_block_forwards(dev, dtype, D, segments):
    """K8's first pass recomputes the row max and denominator with the
    forward's own functions: on views of K3's qkv they equal K3's saved m
    and l bit for bit (bf16: the tensor-core kernels; fp32: the CUDA-core
    delta pass against the fp32 forward)."""
    from pl_bert_tpu_torch.ops import flash_attention as fa

    B, L, H = 3, 200, 768 // D
    x, wqkv, bqkv, wo, bo, _, bias_row, seg_row = _block_case(dev, dtype, B, L, 768, H)
    seg_row = seg_row if segments else None
    _, (qkv, _, m, l) = ab.train_forward(x, wqkv, bqkv, wo, bo, H, bias_row, seg_row, 0.1, 3)
    q, k, v = (t.reshape(B, L, H, D) for t in qkv.reshape(B, L, 3 * H * D).split(H * D, dim=-1))
    *_, m8, l8 = fa._launch_bwd(torch.zeros_like(q), q, k, v, bias_row, seg_row, 0.1, 3)
    torch.cuda.synchronize()
    assert torch.equal(m8, m) and torch.equal(l8, l)


def test_flash_attention_autograd_runs_the_kernels(dev):
    """``flash_attention`` under autograd launches K7 once forward and K8
    once backward, and drops what the block path drops at one seed."""
    from pl_bert_tpu_torch.ops import flash_attention as fa

    q, k, v, dout, _, _ = _flash_case(dev, torch.bfloat16, 2, 128, 4, False)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    counts = (fa.LAUNCHES.count, fa.LAUNCHES_BWD.count)
    out = fa.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3)
    out.backward(dout)
    assert (fa.LAUNCHES.count, fa.LAUNCHES_BWD.count) == (counts[0] + 1, counts[1] + 1)
    keep = ab.dropout_mask(3, 0.1, 2, 4, 128, dev)
    ref = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(), None, None, 0.1, 3,
                                   keep=keep)
    _close(out, ref, torch.bfloat16)
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_flash_attention_refuses_what_is_not_built_on_cuda(dev):
    from pl_bert_tpu_torch.ops import flash_attention as fa

    q = torch.zeros(1, 64, 2, 96, device=dev)  # head_dim 96: neither 64 nor 128
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 64, 2, 64, device=dev)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q, q, q, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 768), (3, 100, 200)])
def test_add_copy_kernel_is_bitwise_the_plain_version(dev, dtype, shape):
    rng = np.random.default_rng(2)
    x, res = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(dev, dtype) for _ in range(2))
    before = fused_ln.LAUNCHES_COPY.count
    out = fused_ln.add_copy(x, res)
    assert fused_ln.LAUNCHES_COPY.count == before + 1
    assert out.dtype == dtype and torch.equal(out, fused_ln.add_copy_plain(x, res))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "unaligned view"])
def test_add_copy_kernel_ragged_and_unaligned(dev, dtype, case):
    """A count that is no whole number of 16-byte vectors takes the scalar
    tail; views one element past an aligned base take the scalar loop."""
    rng = np.random.default_rng(5)
    n = 1001 * 769
    x, res = (torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    if case == "ragged":
        x, res = x[:n], res[:n]
    else:
        x, res = x[1:], res[1:]
    x, res = x.view(1001, 769), res.view(1001, 769)
    assert torch.equal(fused_ln.add_copy(x, res), fused_ln.add_copy_plain(x, res))


@pytest.mark.parametrize("M,K,N", [(3, 20, 36), (8, 768, 768), (4096, 768, 2048)])
def test_int8_matmul_matches_the_fp64_product(dev, M, K, N):
    """``torch._int_mm`` on the padded operands (M ≤ 16, K and N not
    multiples of 8 among them) against the exact fp64 product, bit for
    bit, counted once a call."""
    from pl_bert_tpu_torch.ops import quant

    rng = np.random.default_rng(M + K + N)
    a, b = (torch.from_numpy(rng.integers(-127, 128, s).astype(np.int8)).to(dev)
            for s in ((M, K), (N, K)))
    before = quant.LAUNCHES.count
    acc = quant.int8_matmul(a, b)
    assert quant.LAUNCHES.count == before + 1
    assert acc.dtype == torch.int32 and acc.shape == (M, N)
    assert torch.equal(acc, quant.int8_matmul_plain(a, b))

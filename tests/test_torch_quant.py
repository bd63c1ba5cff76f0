"""The port's int8 serving path against the JAX package's: ``quantize_rows``
and the int8 dense layer bit for bit, the int8 encoder on each attention
path within a stated gate, the weights quantized once per weight set,
and the JAX package's cosine test carried over."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.config import ModelParams
from pl_bert_tpu.models.albert import AlbertConfig as JaxConfig
from pl_bert_tpu.models.albert import AlbertModel as JaxAlbertModel
from pl_bert_tpu.models.albert import build_model, init_params
from pl_bert_tpu.ops import quant as jax_quant
from pl_bert_tpu_torch.export.bridge import state_dict_from_jax
from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel, PhonemeOnlyModel
from pl_bert_tpu_torch.models.albert import init_params as init_params_port
from pl_bert_tpu_torch.models.inference import PhonemeEncoder
from pl_bert_tpu_torch.ops import quant

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _x(shape, dtype, seed=0, zero_row=True):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if zero_row:
        x.reshape(-1, shape[-1])[1] = 0.0
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(37, 96), (2, 5, 52), (3, 13)])
def test_quantize_rows_bitwise_jax(dtype, shape):
    tx, jx = _x(shape, dtype)
    q, scale = quant.quantize_rows(tx)
    jq, jscale = jax_quant.quantize_rows(jx, axis=-1)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert not q.reshape(-1, shape[-1])[1].any()  # the all-zero row


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lead,K,N", [((40,), 64, 48), ((2, 7), 52, 24), ((5,), 64, 30),
                                      ((16,), 20, 36)])
def test_int8_linear_bitwise_flax_dense(dtype, lead, K, N):
    """Flax's ``Dense(dot_general=int8_dot_general)`` at the compute dtype
    (kernel and bias cast before the product, the bias added after the
    cast) against ``int8_linear`` on the same fp32 parameters: rank 2 and
    3, an all-zero row, M ≤ 16, K or N not a multiple of 8."""
    tx, jx = _x(lead + (K,), dtype, seed=K + N)
    rng = np.random.default_rng(N)
    kernel = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=(N,)) * 0.02).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    dense = nn.Dense(N, dtype=jdt, param_dtype=jnp.float32,
                     dot_general=jax_quant.int8_dot_general)
    ref = dense.apply({"params": {"kernel": kernel, "bias": bias}}, jx)
    wq, ws = quant.quantize_weight(torch.from_numpy(kernel.T.copy()), tdt)
    out = quant.int8_linear(tx, wq, ws, torch.from_numpy(bias), tdt)
    assert out.dtype == tdt and out.shape == lead + (N,)
    np.testing.assert_array_equal(_np(out), np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(_np(quant.int8_linear_plain(tx, wq, ws, torch.from_numpy(bias),
                                                              tdt)), _np(out))


@pytest.mark.parametrize("M,K,N", [(3, 20, 36), (16, 64, 30), (40, 13, 8), (17, 8, 9)])
def test_padding_for_int_mm_is_exact(M, K, N):
    """``int8_matmul`` pads the operands to ``torch._int_mm``'s CUDA limits
    (more than 16 rows; K, N multiples of 8); the library call on the
    padded operands (here on the CPU), cut back, equals the fp64 product."""
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
    pa, pb = quant.pad_operands(a, b)
    assert pa.shape[0] > 16 and pa.shape[1] % 8 == 0 and pb.shape[0] % 8 == 0
    assert pa.shape[1] == pb.shape[1]
    acc = torch._int_mm(pa, pb.t())[:M, :N]
    assert acc.dtype == torch.int32
    assert torch.equal(acc, quant.int8_matmul_plain(a, b))
    assert torch.equal(acc, (a.long() @ b.long().t()).int())


MP = ModelParams(
    hidden_size=128, num_attention_heads=2, intermediate_size=256,
    max_position_embeddings=128, num_hidden_layers=2, embedding_size=64,
    dropout=0.0, attention_impl="pallas_block",
)
B, L = 2, 128
# the int8 encoder against JAX's, fp32, valid positions. The two sides
# form the same fp32 values in other summation orders (~1e-6 relative);
# where such a difference straddles a rounding boundary of the
# quantizer, one int8 value moves by one step (its row's abs-max / 127)
# and carries into the next layer. Measured here (2 layers of width
# 128): 1.1e-7 rel-L2 on the block path, 1.4e-5 on the flash and the
# eager path, at most 6.5e-4 max-abs. The gate, 2e-4 rel-L2 and 5e-3
# max-abs, stays more than 10x below the int8-against-unquantized gap on
# the same inputs (8.4e-3 rel-L2; checked below), so a site quantized on
# one side only fails it.
INT8_TOL = {"rel_l2": 2e-4, "max_abs": 5e-3}


@pytest.fixture(scope="module")
def jax_params():
    return init_params(build_model(MP, "fp32"), L, seed=0)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 188, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 90:] = 0
    return ids, mask


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("impl", ["pallas_block", "pallas", "xla"])
def test_int8_encoder_matches_jax_on_each_path(jax_params, monkeypatch, impl):
    """The port's int8 encoder (block path ``auto``: the attention
    projections stay in the kernel; flash and eager: q, k, v and dense
    int8 too) against JAX's with ``quantize="int8"`` configured the same
    way, its TPU gates forced on so that its Pallas kernels run in
    interpret mode, as ``test_forward_matches_jax_on_each_attention_path``
    does."""
    from pl_bert_tpu.ops import attention as jax_attn
    from pl_bert_tpu.ops import fused_ln as jax_ln

    if impl != "xla":
        gate = "fused_block_supported" if impl == "pallas_block" else "pallas_supported"
        monkeypatch.setattr(jax_attn, gate, lambda *a, **k: True)
        monkeypatch.setattr(jax_ln, "fused_supported", lambda *a, **k: True)
    mp = dataclasses.replace(MP, attention_impl=impl)
    ids, mask = _batch(seed=4)
    jcfg = dataclasses.replace(JaxConfig.from_params(mp, dtype=jnp.float32), quantize="int8")
    with pltpu.force_tpu_interpret_mode():
        ref_h, ref_p = JaxAlbertModel(jcfg).apply(
            {"params": jax_params["encoder"]}, jnp.asarray(ids), jnp.asarray(mask),
            deterministic=True)
    sd = state_dict_from_jax(jax_params["encoder"])
    cfg = AlbertConfig.from_params(mp)
    model = AlbertModel.from_state_dict(dataclasses.replace(cfg, quantize="int8"), sd)
    assert model.encoder.layer.attention.impl == {"pallas_block": "block", "pallas": "flash",
                                                  "xla": "eager"}[impl]
    sites = model.compute_weights()
    assert ("qkv" in sites["encoder"]["layer"]["attention"]) == (impl != "pallas_block")
    with torch.inference_mode():
        h, p = model(torch.from_numpy(ids), torch.from_numpy(mask))
        unquantized = AlbertModel.from_state_dict(cfg, sd)(torch.from_numpy(ids),
                                                          torch.from_numpy(mask))[0]
    valid = mask.astype(bool)
    got, want, unq = (np.asarray(t)[valid] for t in (h.numpy(), ref_h, unquantized.numpy()))
    err = _rel(got, want)
    assert err <= INT8_TOL["rel_l2"] and np.abs(got - want).max() <= INT8_TOL["max_abs"], err
    assert _rel(unq, want) > 10 * INT8_TOL["rel_l2"]  # the gate sees a missing site
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=2e-3)


SMALL = ModelParams(
    hidden_size=96, num_attention_heads=4, intermediate_size=192,
    max_position_embeddings=64, num_hidden_layers=3, embedding_size=48,
    dropout=0.0, attention_impl="xla",
)


@pytest.fixture(scope="module")
def small_sd():
    return init_params_port(AlbertModel(AlbertConfig.from_params(SMALL)), seed=0).state_dict()


def _enc(sd, **kw):
    return PhonemeEncoder(sd, SMALL, 64, mixed_precision="fp32", device="cpu", **kw)


def test_phoneme_encoder_int8_matches_fp32(small_sd):
    """tests/test_quant.py's test on the port: per-token cosine ≥ 0.99."""
    texts = ["mˈaʃiːn lˈɜːnɪŋ", "tˌiːpˌiːjˈuː", "ʔabc dˈef"]
    h_base, len_base = _enc(small_sd)(texts)
    h_quant, len_quant = _enc(small_sd, quantize="int8")(texts)
    np.testing.assert_array_equal(len_base, len_quant)
    assert h_quant.shape == h_base.shape
    for i, n in enumerate(len_base):
        a, b = h_base[i, :n], h_quant[i, :n]
        cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
        assert cos.min() > 0.99, f"row {i}: min cosine {cos.min()}"
    assert not np.array_equal(h_base, h_quant)


def test_unknown_quantize_mode_raises_when_built(small_sd):
    enc = _enc(small_sd, quantize="int8")
    assert enc.cfg.quantize == "int8"
    with pytest.raises(ValueError, match="only 'int8'"):
        _enc(small_sd, quantize="int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_quantized_once_with_jax_bits(small_sd, dtype):
    """A deliberate difference: JAX quantizes every kernel on every call,
    the port once per weight set. The bits are the same: the set's int8
    weights and scales are JAX's ``quantize_rows`` of the kernel cast to
    the compute dtype (not of the fp32 parameter)."""
    tdt, jdt = DTYPES[dtype]
    cfg = dataclasses.replace(AlbertConfig.from_params(SMALL, dtype=tdt), quantize="int8")
    w = AlbertModel.from_state_dict(cfg, small_sd).compute_weights()
    site = w["encoder"]["layer"]["ffn"]
    kernel = jnp.asarray(small_sd[
        "encoder.albert_layer_groups.0.albert_layers.0.ffn.weight"].numpy().T)
    jq, jscale = jax_quant.quantize_rows(kernel.astype(jdt), axis=0)
    np.testing.assert_array_equal(site["wq"].numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(site["ws"].numpy(), np.asarray(jscale)[0])
    qkv = w["encoder"]["layer"]["attention"]["qkv"]  # the eager path: q|k|v int8 too
    assert qkv["wq"].dtype == torch.int8 and qkv["wq"].shape == (3 * 96, 96)


def test_swap_and_clone_requantize(small_sd):
    """After a swap the encoder gives a fresh int8 encoder's bits on the
    new weights; a clone carries the int8 weight set."""
    texts = ["qalam", "bajt ʃams"]
    enc = _enc(small_sd, quantize="int8")
    before, _ = enc(texts)
    new = {k: v + 0.01 for k, v in small_sd.items()}
    enc.swap_params(new)
    assert enc.weights["pooler"]["wq"].dtype == torch.int8
    after, _ = enc(texts)
    fresh, _ = _enc(new, quantize="int8")(texts)
    np.testing.assert_array_equal(after, fresh)
    assert not np.array_equal(before, after)
    clone = enc.clone_to("cpu")
    assert clone.weights is not enc.weights
    assert clone.weights["pooler"]["wq"].dtype == torch.int8
    np.testing.assert_array_equal(clone(texts)[0], after)


def test_training_forward_refuses_int8(small_sd):
    cfg = dataclasses.replace(AlbertConfig.from_params(SMALL), quantize="int8")
    model = PhonemeOnlyModel(cfg)
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="inference-only"):
        model(ids, deterministic=False)

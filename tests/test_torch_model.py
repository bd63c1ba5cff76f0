"""PyTorch ALBERT encoder against the JAX one: the weight bridge, the
reference ``.pth`` layout, the fp32 forward with both JAX kernels on the
compared path, and the config defaults."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pl_bert_tpu.config import Config, ModelParams, TrainingParams
from pl_bert_tpu.models.albert import AlbertModel as JaxAlbertModel
from pl_bert_tpu.models.albert import build_model, init_params
from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel

MP = ModelParams(
    hidden_size=256, num_attention_heads=4, intermediate_size=512,
    max_position_embeddings=128, num_hidden_layers=2, embedding_size=64,
    dropout=0.0, attention_impl="pallas_block",
)
B, L = 2, 128


@pytest.fixture(scope="module")
def jax_params():
    return init_params(build_model(MP, "fp32"), L, seed=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_bridge_roundtrip_bitwise(jax_params):
    enc = jax_params["encoder"]
    model = AlbertModel.from_state_dict(
        AlbertConfig.from_params(MP), bridge.state_dict_from_jax(enc)
    )
    back = dict(_leaves(bridge.jax_from_state_dict(model.state_dict())))
    orig = dict(_leaves(enc))
    assert back.keys() == orig.keys()
    for path, arr in orig.items():
        np.testing.assert_array_equal(back[path], arr, err_msg="/".join(path))


@pytest.mark.parametrize("ddp_prefix", [False, True])
def test_reference_pth_loads_strict(jax_params, tmp_path, ddp_prefix):
    """The {'net', 'step', 'epoch', 'optimizer'} save that
    export/to_torch.py writes (heads and all) loads into the port with
    strict=True; so does the bare model state dict with DDP's prefix."""
    from pl_bert_tpu.export.to_torch import export_reference_checkpoint

    path = str(tmp_path / "step_3.pth")
    export_reference_checkpoint(
        jax_params, optax.adamw(1e-4).init(jax_params), TrainingParams(), path,
        step=3,
    )
    if ddp_prefix:
        net = torch.load(path, weights_only=True)["net"]
        torch.save({f"module.{k}": v for k, v in net.items()}, path)
    sd = bridge.load_reference_pth(path)
    model = AlbertModel(AlbertConfig.from_params(MP))
    model.load_state_dict(sd, strict=True)
    expect = bridge.state_dict_from_jax(jax_params["encoder"])
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, expect[k], rtol=0, atol=0)


def test_encoder_state_dict_keeps_hf_encoder_keys(jax_params):
    """A bare HF encoder dict keeps its own ``encoder.`` layer keys."""
    sd = bridge.state_dict_from_jax(jax_params["encoder"])
    assert bridge.encoder_state_dict(sd).keys() == sd.keys()


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 188, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 90:] = 0
    return ids, mask


def test_forward_matches_jax_kernels(jax_params, monkeypatch):
    """fp32 port vs the JAX AlbertModel on its pallas_block path with
    BOTH Pallas kernels (attention block and fused LN) forced on under
    interpret mode; gate of tests/test_attention_block.py:155-157."""
    from pl_bert_tpu.models.albert import AlbertConfig as JaxConfig
    from pl_bert_tpu.ops import attention as jax_attn
    from pl_bert_tpu.ops import fused_ln as jax_ln

    monkeypatch.setattr(jax_attn, "fused_block_supported", lambda *a, **k: True)
    monkeypatch.setattr(jax_ln, "fused_supported", lambda *a, **k: True)
    ids, mask = _batch()
    jax_model = JaxAlbertModel(JaxConfig.from_params(MP, dtype=jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        ref_h, ref_p = jax_model.apply(
            {"params": jax_params["encoder"]}, jnp.asarray(ids), jnp.asarray(mask),
            deterministic=True,
        )
    model = AlbertModel.from_state_dict(
        AlbertConfig.from_params(MP), bridge.state_dict_from_jax(jax_params["encoder"])
    )
    with torch.inference_mode():
        h, p = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_jax_on_each_attention_path(jax_params, monkeypatch, impl):
    """The port's ``pallas`` (per-head flash kernels between dense
    projections) and ``xla`` (plain) paths against the JAX model
    configured the same way, fp32, at the gate of
    ``test_forward_matches_jax_kernels`` (which covers ``auto``). For
    ``pallas`` the JAX side's TPU gates are forced on, so its flash
    kernel and fused LN run in interpret mode; ``xla`` is its einsum
    attention."""
    from pl_bert_tpu.models.albert import AlbertConfig as JaxConfig
    from pl_bert_tpu.ops import attention as jax_attn
    from pl_bert_tpu.ops import fused_ln as jax_ln

    if impl == "pallas":
        monkeypatch.setattr(jax_attn, "pallas_supported", lambda *a, **k: True)
        monkeypatch.setattr(jax_ln, "fused_supported", lambda *a, **k: True)
    mp = dataclasses.replace(MP, attention_impl=impl)
    ids, mask = _batch(seed=3)
    jax_model = JaxAlbertModel(JaxConfig.from_params(mp, dtype=jnp.float32))
    with pltpu.force_tpu_interpret_mode():
        ref_h, ref_p = jax_model.apply(
            {"params": jax_params["encoder"]}, jnp.asarray(ids), jnp.asarray(mask),
            deterministic=True,
        )
    model = AlbertModel.from_state_dict(
        AlbertConfig.from_params(mp), bridge.state_dict_from_jax(jax_params["encoder"])
    )
    assert model.encoder.layer.attention.impl == {"pallas": "flash", "xla": "eager"}[impl]
    with torch.inference_mode():
        h, p = model(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(p.numpy(), np.asarray(ref_p), atol=5e-4, rtol=1e-3)


def test_eager_and_kernel_impls_agree_on_cpu(jax_params):
    """On CPU tensors the kernel path's wrappers run the plain versions,
    so both impls give the same numbers; bf16 stays within rounding."""
    sd = bridge.state_dict_from_jax(jax_params["encoder"])
    ids, mask = (torch.from_numpy(a) for a in _batch(seed=1))
    outs = {}
    for impl in ("auto", "eager"):
        for dtype in (torch.float32, torch.bfloat16):
            cfg = dataclasses.replace(
                AlbertConfig.from_params(MP, dtype=dtype), attention_impl=impl
            )
            with torch.inference_mode():
                outs[impl, dtype] = AlbertModel.from_state_dict(cfg, sd)(ids, mask)[0]
    torch.testing.assert_close(
        outs["auto", torch.float32], outs["eager", torch.float32], rtol=0, atol=0
    )
    ref = outs["auto", torch.float32]
    rel = (outs["auto", torch.bfloat16].float() - ref).norm() / ref.norm()
    assert outs["auto", torch.bfloat16].dtype == torch.bfloat16 and rel < 3e-2


def test_forward_without_weight_set_reads_current_parameters(jax_params):
    """Without an explicit weight set, a forward runs on the parameters
    as they are now, written in place or not."""
    sd = bridge.state_dict_from_jax(jax_params["encoder"])
    model = AlbertModel.from_state_dict(
        AlbertConfig.from_params(MP), {k: v.clone() for k, v in sd.items()}
    )
    ids, mask = (torch.from_numpy(a) for a in _batch(seed=2))
    with torch.no_grad():
        before = model(ids, mask)[0]
        assert model(ids, mask)[0].equal(before)
        model.encoder.layer.ffn.bias.add_(0.5)
        assert not model(ids, mask)[0].equal(before)


def test_config_defaults_match_config_yml():
    from pathlib import Path

    yml = Path(__file__).resolve().parent.parent / "configs" / "config.yml"
    mp = Config.load(str(yml)).model_params
    cfg = AlbertConfig()
    for f in dataclasses.fields(cfg):
        if hasattr(mp, f.name):
            assert getattr(cfg, f.name) == getattr(mp, f.name), f.name
    assert AlbertConfig.from_params(mp) == cfg


@pytest.mark.parametrize("width,heads,kernels", [(1536, 24, True), (2560, 40, False)])
def test_wide_model_ln_route(caplog, width, heads, kernels):
    """A kernel-path model decides its LayerNorm route when it is built:
    at 24 heads of 64 (width 1536) K5, and K5/K6 in training, as JAX
    fuses that width; at 40 heads of 64 (width 2560, above what the LN
    kernels take) the plain LN in both, with a warning that says why, as
    JAX falls back to nn.LayerNorm where its kernels refuse. On the CPU
    its forward equals the eager model's."""
    import logging

    from pl_bert_tpu_torch.ops import fused_ln

    mp = dataclasses.replace(MP, hidden_size=width, num_attention_heads=heads,
                             intermediate_size=64, max_position_embeddings=16,
                             num_hidden_layers=1, embedding_size=32, attention_impl="auto")
    cfg = AlbertConfig.from_params(mp)
    with caplog.at_level(logging.WARNING, logger="pl_bert_tpu_torch.models.albert"):
        torch.manual_seed(0)
        model = AlbertModel(cfg)
    warned = [r.getMessage() for r in caplog.records if "LayerNorm" in r.getMessage()]
    assert model.encoder.layer.attention.impl == "block"
    if kernels:
        assert not warned
        assert model.encoder.layer.attention.ln_fns == (fused_ln.dropout_add_layernorm,
                                                        fused_ln.dropout_add_layernorm_train)
    else:
        assert len(warned) == 1 and str(fused_ln.MAX_WIDTH) in warned[0]
        assert model.encoder.layer.attention.ln_fns == (fused_ln.dropout_add_layernorm_plain,) * 2
    eager = AlbertModel.from_state_dict(dataclasses.replace(cfg, attention_impl="eager"),
                                        model.state_dict())
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    mask = torch.from_numpy((np.arange(16)[None] < np.array([[16], [9]])).astype(np.int64))
    with torch.inference_mode():
        got, want = model(ids, mask)[0], eager(ids, mask)[0]
    assert got.shape == (2, 16, width)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

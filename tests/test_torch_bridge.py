"""The port's own flax ↔ state-dict key map against the JAX package's
(pl_bert_tpu/export/to_hf.py), bitwise in both directions, for the
encoder and for the whole phoneme-only model."""

import jax
import numpy as np
import pytest
import torch

from pl_bert_tpu.config import ModelParams
from pl_bert_tpu.export import to_hf
from pl_bert_tpu.models.albert import build_model, init_params
from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.models.albert import AlbertConfig, PhonemeOnlyModel

MP = ModelParams(
    hidden_size=128, num_attention_heads=2, intermediate_size=256,
    max_position_embeddings=64, num_hidden_layers=2, embedding_size=32, dropout=0.0,
)


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, init_params(build_model(MP, "fp32"), 64, seed=5))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_state_dicts(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert a[k].is_contiguous() and b[k].is_contiguous(), k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _same_trees(a: dict, b: dict) -> None:
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for path, arr in la.items():
        assert arr.dtype == lb[path].dtype
        np.testing.assert_array_equal(arr, lb[path], err_msg="/".join(path))


def test_encoder_map_equals_jax_package(params):
    enc = params["encoder"]
    sd = bridge.state_dict_from_jax(enc)
    _same_state_dicts(sd, to_hf.flax_encoder_to_hf_state_dict(enc))
    _same_trees(bridge.jax_from_state_dict(sd), to_hf.hf_state_dict_to_flax_encoder(sd))


def test_model_map_equals_jax_package(params):
    sd = bridge.model_state_dict_from_jax(params)
    _same_state_dicts(sd, to_hf.full_model_state_dict(params))
    tree = bridge.jax_from_model_state_dict(sd)
    _same_trees(tree, params)


def test_model_state_dict_loads_strict(params):
    """The reference .pth keys are the port's PhonemeOnlyModel's."""
    model = PhonemeOnlyModel(AlbertConfig.from_params(MP), MP.vocab_size)
    model.load_state_dict(bridge.model_state_dict_from_jax(params), strict=True)
    _same_trees(bridge.jax_from_model_state_dict(model.state_dict()), params)

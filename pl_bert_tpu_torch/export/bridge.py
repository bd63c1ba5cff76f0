"""Weights across the two packages, in the reference's torch naming.

The port's ``AlbertModel`` state dict has HF ``AlbertModel``'s keys,
which are also the ``encoder.`` part of the reference's ``step_N.pth``;
``PhonemeOnlyModel`` adds ``phoneme_predictor.weight/bias`` and
``MultiTaskModel`` also ``token_predictor.weight/bias``. So:

- a Flax param tree (numpy leaves) converts with the key map below, a
  copy of ``pl_bert_tpu/export/to_hf.py:28-113`` kept here so the port
  imports nothing of the JAX package: the encoder alone
  (:func:`state_dict_from_jax` / :func:`jax_from_state_dict`) or the
  whole model, phoneme-only or multi-task
  (:func:`model_state_dict_from_jax` / :func:`jax_from_model_state_dict`);
- a reference ``.pth`` — the ``{'net', 'step', 'epoch', ...}`` save that
  ``pl_bert_tpu/export/to_torch.py`` writes, or a bare state dict — loads
  with :func:`load_reference_pth`. An orbax run reaches the port through
  ``python -m pl_bert_tpu.export.to_torch`` on the JAX side.
"""

from __future__ import annotations

import numpy as np
import torch

HEADS = ("phoneme_predictor.", "token_predictor.")
# HF registers position ids as a buffer; older versions saved it
BUFFERS = ("embeddings.position_ids",)

# Flax-side path of every HF AlbertModel tensor, relative to the encoder
# param sub-tree: (hf_name, flax_path, transpose). torch nn.Linear stores
# [out, in], Flax Dense kernels [in, out]; embedding tables carry over as
# they are.
_HF_LAYER_PREFIX = "encoder.albert_layer_groups.0.albert_layers.0."
_LAYER = ("encoder", "albert_layer")
_ENCODER_MAP: list[tuple[str, tuple[str, ...], bool]] = [
    ("embeddings.word_embeddings.weight",
     ("embeddings", "word_embeddings", "embedding"), False),
    ("embeddings.position_embeddings.weight",
     ("embeddings", "position_embeddings", "embedding"), False),
    ("embeddings.token_type_embeddings.weight",
     ("embeddings", "token_type_embeddings", "embedding"), False),
    ("embeddings.LayerNorm.weight", ("embeddings", "LayerNorm", "scale"), False),
    ("embeddings.LayerNorm.bias", ("embeddings", "LayerNorm", "bias"), False),
    ("encoder.embedding_hidden_mapping_in.weight",
     ("encoder", "embedding_hidden_mapping_in", "kernel"), True),
    ("encoder.embedding_hidden_mapping_in.bias",
     ("encoder", "embedding_hidden_mapping_in", "bias"), False),
    *(
        (_HF_LAYER_PREFIX + f"attention.{name}.{hf}", _LAYER + ("attention", name, fx), hf == "weight")
        for name in ("query", "key", "value", "dense")
        for hf, fx in (("weight", "kernel"), ("bias", "bias"))
    ),
    (_HF_LAYER_PREFIX + "attention.LayerNorm.weight",
     _LAYER + ("attention", "LayerNorm", "scale"), False),
    (_HF_LAYER_PREFIX + "attention.LayerNorm.bias",
     _LAYER + ("attention", "LayerNorm", "bias"), False),
    *(
        (_HF_LAYER_PREFIX + f"{name}.{hf}", _LAYER + (name, fx), hf == "weight")
        for name in ("ffn", "ffn_output")
        for hf, fx in (("weight", "kernel"), ("bias", "bias"))
    ),
    (_HF_LAYER_PREFIX + "full_layer_layer_norm.weight",
     _LAYER + ("full_layer_layer_norm", "scale"), False),
    (_HF_LAYER_PREFIX + "full_layer_layer_norm.bias",
     _LAYER + ("full_layer_layer_norm", "bias"), False),
    ("pooler.weight", ("pooler", "kernel"), True),
    ("pooler.bias", ("pooler", "bias"), False),
]
# HF AlbertModel's keys, which are the port's AlbertModel's
ENCODER_KEYS = tuple(name for name, _, _ in _ENCODER_MAP)
# the phoneme-only model: the encoder under "encoder", plus its head
_MODEL_MAP = [
    (f"encoder.{hf}", ("encoder",) + path, transpose)
    for hf, path, transpose in _ENCODER_MAP
] + [
    ("phoneme_predictor.weight", ("phoneme_predictor", "kernel"), True),
    ("phoneme_predictor.bias", ("phoneme_predictor", "bias"), False),
]
# the multi-task model's grapheme head (pl_bert_tpu/export/from_torch.py:55-62)
_TOKEN_MAP = [
    ("token_predictor.weight", ("token_predictor", "kernel"), True),
    ("token_predictor.bias", ("token_predictor", "bias"), False),
]


def _get(tree: dict, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _to_state_dict(params: dict, key_map) -> dict[str, torch.Tensor]:
    out = {}
    for name, path, transpose in key_map:
        arr = np.asarray(_get(params, path), dtype=np.float32)
        if transpose:
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr, order="C"))  # a writable copy
    return out


def _to_tree(state_dict: dict, key_map) -> dict:
    tree: dict = {}
    for name, path, transpose in key_map:
        arr = state_dict[name].detach().cpu().numpy().astype(np.float32)
        if transpose:
            arr = arr.T
        _set(tree, path, arr)
    return tree


def state_dict_from_jax(encoder_params: dict) -> dict[str, torch.Tensor]:
    """Flax encoder param tree (numpy leaves) → the port's fp32 state dict."""
    return _to_state_dict(encoder_params, _ENCODER_MAP)


def jax_from_state_dict(state_dict: dict) -> dict:
    """The port's encoder state dict → Flax encoder param tree (numpy leaves)."""
    return _to_tree(state_dict, _ENCODER_MAP)


def model_state_dict_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A model's Flax tree ``{"encoder": …, "phoneme_predictor": {kernel,
    bias}[, "token_predictor": {kernel, bias}]}`` → the reference
    ``.pth``'s keys (``encoder.*``, ``phoneme_predictor.weight/bias``[,
    ``token_predictor.weight/bias``]), fp32; a kernel [H, V] becomes a
    weight [V, H]."""
    return _to_state_dict(params, _model_map("token_predictor" in params))


def jax_from_model_state_dict(state_dict: dict) -> dict:
    """The inverse of :func:`model_state_dict_from_jax`."""
    return _to_tree(state_dict, _model_map("token_predictor.weight" in state_dict))


def _model_map(multitask: bool) -> list:
    return _MODEL_MAP + _TOKEN_MAP if multitask else _MODEL_MAP


def encoder_state_dict(state_dict: dict) -> dict[str, torch.Tensor]:
    """A reference model state dict (``encoder.*`` plus heads) or an HF
    encoder state dict → the encoder's part, in the port's keys. The DDP
    ``module.`` prefix is stripped where it leads a key (as
    from_torch.py:29-36), and the model's ``encoder.`` prefix where the
    dict is a model's (HF's own keys also start with ``encoder.``, for
    the layer stack). The prediction heads and HF's position-id buffer
    are left out; anything else passes through, so a strict load
    reports it."""
    sd = {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }
    model_level = any(k.startswith("encoder.embeddings.") for k in sd)
    out = {}
    for key, value in sd.items():
        if key.startswith(HEADS):
            continue
        if model_level and key.startswith("encoder."):
            key = key[len("encoder."):]
        if key in BUFFERS:
            continue
        out[key] = value
    return out


def load_reference_pth(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` (training save with ``net``, or a bare state
    dict) → the encoder's fp32 state dict on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: not a state dict or a training save")
    state_dict = ckpt["net"] if "net" in ckpt else ckpt
    return encoder_state_dict(state_dict)

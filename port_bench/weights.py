"""The model's parameters, named and made from the run's seed.

Names are HF ``AlbertModel``'s under ``encoder.`` with PL-BERT's
``phoneme_predictor`` and, in the multi-task model, its
``token_predictor`` (the reference's ``model.py``); shapes follow the
configuration file. The values are made on the device in one call of a
``torch.Generator``: matrices and embedding tables N(0, 0.02²), biases
0, LayerNorm scales 1 and shifts 0 (the port's ``init_params`` and HF's
``initializer_range``). Both the program and the reference start from
this dict.
"""

from __future__ import annotations

import torch

_LAYER = "encoder.encoder.albert_layer_groups.0.albert_layers.0."


def param_shapes(model: dict) -> dict:
    """name → shape of every parameter, in the program's order."""
    H, E, F = model["hidden_size"], model["embedding_size"], model["intermediate_size"]
    shapes = {
        "encoder.embeddings.word_embeddings.weight": (model["vocab_size"], E),
        "encoder.embeddings.position_embeddings.weight": (model["max_position_embeddings"], E),
        "encoder.embeddings.token_type_embeddings.weight": (model["type_vocab_size"], E),
        "encoder.embeddings.LayerNorm.weight": (E,),
        "encoder.embeddings.LayerNorm.bias": (E,),
        "encoder.encoder.embedding_hidden_mapping_in.weight": (H, E),
        "encoder.encoder.embedding_hidden_mapping_in.bias": (H,),
    }
    for name in ("query", "key", "value", "dense"):
        shapes[f"{_LAYER}attention.{name}.weight"] = (H, H)
        shapes[f"{_LAYER}attention.{name}.bias"] = (H,)
    shapes.update({
        f"{_LAYER}attention.LayerNorm.weight": (H,),
        f"{_LAYER}attention.LayerNorm.bias": (H,),
        f"{_LAYER}ffn.weight": (F, H),
        f"{_LAYER}ffn.bias": (F,),
        f"{_LAYER}ffn_output.weight": (H, F),
        f"{_LAYER}ffn_output.bias": (H,),
        f"{_LAYER}full_layer_layer_norm.weight": (H,),
        f"{_LAYER}full_layer_layer_norm.bias": (H,),
        "encoder.pooler.weight": (H, H),
        "encoder.pooler.bias": (H,),
        "phoneme_predictor.weight": (model["vocab_size"], H),
        "phoneme_predictor.bias": (model["vocab_size"],),
    })
    if model.get("num_token_vocab", 0) > 0:
        shapes["token_predictor.weight"] = (model["num_token_vocab"], H)
        shapes["token_predictor.bias"] = (model["num_token_vocab"],)
    return shapes


def layer_name(short: str) -> str:
    """The shared layer's parameter ``short`` (e.g. ``ffn.weight``)."""
    return _LAYER + short


def make_weights(model: dict, seed: int, device) -> dict:
    """name → fp32 tensor on ``device``, from ``seed``."""
    shapes = param_shapes(model)
    drawn = [n for n, s in shapes.items() if len(s) == 2]
    total = sum(torch.Size(shapes[n]).numel() for n in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device) * model["initializer_range"]
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            n = torch.Size(shape).numel()
            out[name] = flat[at:at + n].view(shape)
            at += n
        elif "LayerNorm.weight" in name or "layer_norm.weight" in name:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out

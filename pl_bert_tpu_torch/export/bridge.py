"""Weights across the two packages, in the reference's torch naming.

The port's ``AlbertModel`` state dict has HF ``AlbertModel``'s keys
(``pl_bert_tpu/export/to_hf.py:28-76``), which are also the ``encoder.``
part of the reference's ``step_N.pth``. So:

- a JAX encoder param tree converts with the JAX package's own mapping
  (``state_dict_from_jax`` / ``jax_from_state_dict``; the JAX side's
  module needs pyyaml, so it is imported inside those two functions);
- a reference ``.pth`` — the ``{'net', 'step', 'epoch', ...}`` save that
  ``pl_bert_tpu/export/to_torch.py`` writes, or a bare state dict — loads
  with :func:`load_reference_pth`, which needs neither yaml nor jax. An
  orbax run reaches the port through ``python -m
  pl_bert_tpu.export.to_torch`` on the JAX side.
"""

from __future__ import annotations

import torch

_HEADS = ("phoneme_predictor.", "token_predictor.")
# HF registers position ids as a buffer; older versions saved it
_BUFFERS = ("embeddings.position_ids",)


def state_dict_from_jax(encoder_params: dict) -> dict[str, torch.Tensor]:
    """Flax encoder param tree (numpy leaves) → the port's fp32 state dict."""
    from pl_bert_tpu.export.to_hf import flax_encoder_to_hf_state_dict

    return flax_encoder_to_hf_state_dict(encoder_params)


def jax_from_state_dict(state_dict: dict) -> dict:
    """The port's state dict → Flax encoder param tree (numpy leaves)."""
    from pl_bert_tpu.export.to_hf import hf_state_dict_to_flax_encoder

    return hf_state_dict_to_flax_encoder(state_dict)


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
        if key.startswith(_HEADS):
            continue
        if model_level and key.startswith("encoder."):
            key = key[len("encoder."):]
        if key in _BUFFERS:
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

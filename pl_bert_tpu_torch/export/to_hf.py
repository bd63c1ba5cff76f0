"""A checkpoint of the port → the HF ``AlbertModel`` directory, and back.

The counterpart of ``pl_bert_tpu/export/to_hf.py`` (:129-213), the
reference's export contract (convert_to_hf.py:16-102): the encoder saves
as an HF ``AlbertModel`` directory that StyleTTS loads unchanged, beside
the full model's state (``pl_bert_full_model.pt``),
``training_metadata.txt`` and a copy of the training config. The config
always carries the real vocab size, which the reference leaves out.

The port's checkpoints already use the reference's torch names
(``encoder.*``, ``phoneme_predictor.*``, ``token_predictor.*``), so
nothing is renamed: ``model.safetensors`` is the ``encoder.`` part with
that prefix taken off, which is HF ``AlbertModel``'s own key set. The
port writes ``config.json`` and ``model.safetensors`` itself
(``export/safetensors.py``) and imports neither ``transformers`` nor
``safetensors``. ``pyyaml`` is imported where ``config.yml`` is read or
written.

``pl_bert_tpu/export/to_torch.py`` and ``from_torch.py`` have no
counterpart here: they convert orbax runs, and the port's checkpoints
already are ``.pth`` files.
"""

from __future__ import annotations

import json
import os

import torch

from pl_bert_tpu_torch.export import bridge
from pl_bert_tpu_torch.export import safetensors as st

# HF AlbertConfig's defaults for every field JAX's hf_albert_config does
# not set (transformers' configuration_albert.py), so that the file reads
# back to the values JAX's export writes through save_pretrained
_HF_DEFAULTS = {
    "architectures": ["AlbertModel"],
    "model_type": "albert",
    "attention_probs_dropout_prob": 0,
    "hidden_dropout_prob": 0,
    "classifier_dropout_prob": 0.1,
    "initializer_range": 0.02,
    "inner_group_num": 1,
    "num_hidden_groups": 1,
    "position_embedding_type": "absolute",
    "type_vocab_size": 2,
    "pad_token_id": 0,
    "bos_token_id": 2,
    "eos_token_id": 3,
    "dtype": "float32",
}


def hf_albert_config(model_params: dict) -> dict:
    """The ``config.json`` of the export, as a dict: the fields JAX's
    ``hf_albert_config`` (pl_bert_tpu/export/to_hf.py:143) sets from
    ``model_params`` — the vocab size the reference forgot, the
    activation and the LayerNorm epsilon among them — over HF's defaults
    for the rest."""
    cfg = dict(_HF_DEFAULTS)
    cfg.update(
        vocab_size=int(model_params.get("vocab_size", 188)),
        embedding_size=int(model_params.get("embedding_size", 128)),
        hidden_size=int(model_params["hidden_size"]),
        num_attention_heads=int(model_params["num_attention_heads"]),
        intermediate_size=int(model_params["intermediate_size"]),
        max_position_embeddings=int(model_params["max_position_embeddings"]),
        num_hidden_layers=int(model_params["num_hidden_layers"]),
        hidden_act=str(model_params.get("hidden_act", "gelu_new")),
        layer_norm_eps=float(model_params.get("layer_norm_eps", 1e-12)),
    )
    return dict(sorted(cfg.items()))


def full_model_state_dict(state_dict: dict) -> dict[str, torch.Tensor]:
    """A model's state dict (a ``.pth``'s ``net``, a bare encoder state
    dict, or either with DDP's ``module.`` prefix) → the reference
    model's keys (``encoder.*`` and the heads it has), fp32 and on the
    CPU."""
    out = {f"encoder.{k}": v for k, v in bridge.encoder_state_dict(state_dict).items()}
    for key, value in state_dict.items():
        key = key.removeprefix("module.")
        if key.startswith(bridge.HEADS):
            out[key] = value
    return {k: v.detach().to("cpu", torch.float32).contiguous() for k, v in out.items()}


def _check_keys(keys, where: str) -> None:
    missing = sorted(set(bridge.ENCODER_KEYS) - set(keys))
    unexpected = sorted(set(keys) - set(bridge.ENCODER_KEYS))
    if missing or unexpected:
        raise ValueError(f"{where}: not an ALBERT encoder: missing={missing} "
                         f"unexpected={unexpected}")


def export_checkpoint(state_dict: dict, config: dict, output_dir: str, step: int = 0,
                      epoch: int = 0, checkpoint_path: str = "") -> None:
    """Write the reference's artifact set to ``output_dir``: ``config.json``
    and ``model.safetensors`` (the encoder, fp32, HF's names),
    ``pl_bert_full_model.pt`` (every tensor of the model, heads
    included), ``training_metadata.txt`` and ``config.yml``. ``config``
    is the training config as a dict; the encoder's keys and shapes are
    checked against its ``model_params`` before anything is written."""
    import yaml

    from pl_bert_tpu_torch.config import Config
    from pl_bert_tpu_torch.models.albert import AlbertConfig, AlbertModel

    full = full_model_state_dict(state_dict)
    encoder = {k.removeprefix("encoder."): v for k, v in full.items()
               if k.startswith("encoder.")}
    _check_keys(encoder, "export")
    AlbertModel.from_state_dict(  # raises on a shape the config does not give
        AlbertConfig.from_params(Config.from_dict(config).model_params), encoder)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf_albert_config(config.get("model_params", {})), f, indent=2)
        f.write("\n")
    st.save_file(encoder, os.path.join(output_dir, "model.safetensors"))
    torch.save(full, os.path.join(output_dir, "pl_bert_full_model.pt"))
    with open(os.path.join(output_dir, "training_metadata.txt"), "w", encoding="utf-8") as f:
        f.write(f"Original checkpoint: {checkpoint_path}\n")
        f.write(f"Step: {step}\n")
        f.write(f"Epoch: {epoch}\n")
    with open(os.path.join(output_dir, "config.yml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def load_pl_bert_model(model_dir: str) -> tuple[dict[str, torch.Tensor], dict]:
    """An exported directory — the port's, or one JAX's exporter wrote
    through ``save_pretrained`` — → ``(encoder state dict, config)``: the
    encoder's fp32 tensors in HF's names (the port's ``AlbertModel``
    keys) from ``model.safetensors``, else ``pytorch_model.bin``, and
    the training config from ``config.yml``. HF's position-id buffer is
    skipped; any other key missing or extra raises, and so does a
    sharded checkpoint."""
    import yaml

    for index in ("model.safetensors.index.json", "pytorch_model.bin.index.json"):
        if os.path.exists(os.path.join(model_dir, index)):
            raise ValueError(f"{model_dir}: a sharded checkpoint ({index}) is not "
                             "supported; save the encoder as one file")
    safetensors = os.path.join(model_dir, "model.safetensors")
    pickled = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(safetensors):
        tensors = st.read(safetensors)[0]
    elif os.path.exists(pickled):
        tensors = torch.load(pickled, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"{model_dir}: no model.safetensors or pytorch_model.bin")
    encoder = {k: v.float() for k, v in tensors.items() if k not in bridge.BUFFERS}
    _check_keys(encoder, model_dir)
    with open(os.path.join(model_dir, "config.yml"), encoding="utf-8") as f:
        config = yaml.safe_load(f)
    return encoder, config

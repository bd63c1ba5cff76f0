"""ALBERT encoder in PyTorch, the counterpart of ``pl_bert_tpu/models/albert.py``.

A shared-layer ALBERT (one layer applied ``num_hidden_layers`` times,
factorized embedding vocab → embedding_size → hidden_size), forward only:
the serving path. The training forward, ``PhonemeOnlyModel``,
``MultiTaskModel``, int8 and remat come with later slices.

Submodules carry HF ``AlbertModel``'s names, so ``state_dict()`` keys are
exactly the names of ``pl_bert_tpu/export/to_hf.py:28-76`` and a
reference ``.pth`` loads with ``strict=True`` and no renaming.

Parameters stay fp32. The forward runs on a *weight set*: the
compute-dtype copies of the weights (Wq|Wk|Wv packed for the attention
kernel, matrices in the compute dtype, LayerNorm affine and kernel
biases in fp32), made once per load by :meth:`AlbertModel.compute_weights`
and not per call. A caller that swaps weights while forwards are in
flight (the serving encoder) passes the set explicitly and rebinds it;
a plain ``model(ids, mask)`` builds one and caches it until the
parameters change.

The attention block and both dropout+add+LayerNorm sites run the
hand-written kernels (``ops/attention_block.py``, ``ops/fused_ln.py``)
unless ``attention_impl`` is ``eager`` (or the JAX value ``xla``), which
runs their plain versions on any device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from pl_bert_tpu_torch.ops.attention import resolve_impl, self_attention
from pl_bert_tpu_torch.ops.attention_block import pack_weights
from pl_bert_tpu_torch.ops.fused_ln import (
    dropout_add_layernorm,
    dropout_add_layernorm_plain,
)


@dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 188
    embedding_size: int = 128
    hidden_size: int = 768
    num_attention_heads: int = 12
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    num_hidden_layers: int = 12
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    hidden_act: str = "gelu_new"
    attention_impl: str = "auto"  # auto/kernel | eager (JAX names accepted)
    dtype: torch.dtype = torch.float32  # compute dtype (params stay fp32)

    @classmethod
    def from_params(cls, p, dtype: torch.dtype = torch.float32) -> "AlbertConfig":
        """From any object with ``ModelParams``' attribute names
        (``pl_bert_tpu.config.ModelParams``, or another AlbertConfig)."""
        return cls(
            vocab_size=int(p.vocab_size),
            embedding_size=int(p.embedding_size),
            hidden_size=int(p.hidden_size),
            num_attention_heads=int(p.num_attention_heads),
            intermediate_size=int(p.intermediate_size),
            max_position_embeddings=int(p.max_position_embeddings),
            num_hidden_layers=int(p.num_hidden_layers),
            dropout=float(p.dropout),
            layer_norm_eps=float(p.layer_norm_eps),
            initializer_range=float(p.initializer_range),
            hidden_act=str(p.hidden_act),
            attention_impl=str(p.attention_impl),
            dtype=dtype,
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _act(name: str):
    if name == "gelu_new":  # HF's tanh-approximated gelu
        return lambda x: F.gelu(x, approximate="tanh")
    if name in ("gelu", "gelu_python"):
        # both are the EXACT erf gelu in HF's ACT2FN
        return lambda x: F.gelu(x, approximate="none")
    if name == "relu":
        return F.relu
    raise ValueError(f"unsupported activation: {name}")


def attention_bias_from_mask(attention_mask) -> torch.Tensor:
    """[B, L] validity mask → additive fp32 [B, 1, 1, L] bias (0 /
    finfo(f32).min, as HF's extended attention mask); the kernels clamp
    it to the finite ``NEG``."""
    neg = torch.finfo(torch.float32).min
    bias = (1.0 - attention_mask.float()) * neg
    return bias[:, None, None, :]


def _linear_weights(layer: nn.Linear, dtype) -> dict:
    return {"w": layer.weight.to(dtype), "b": layer.bias.to(dtype)}


def _ln_weights(ln: nn.LayerNorm) -> dict:
    return {"g": ln.weight.float(), "b": ln.bias.float()}


class AlbertEmbeddings(nn.Module):
    """word + position + token-type embeddings at ``embedding_size``:
    fp32 tables and fp32 LayerNorm, output cast to the compute dtype."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.embedding_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.embedding_size
        )
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.embedding_size
        )
        self.LayerNorm = nn.LayerNorm(cfg.embedding_size, eps=cfg.layer_norm_eps)

    def compute_weights(self, dtype) -> dict:
        return {
            "word": self.word_embeddings.weight.float(),
            "position": self.position_embeddings.weight.float(),
            "token_type": self.token_type_embeddings.weight.float(),
            "ln": _ln_weights(self.LayerNorm),
        }

    def forward(self, input_ids, token_type_ids, position_ids, w: dict):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (
            F.embedding(input_ids, w["word"])
            + F.embedding(position_ids, w["position"])
            + F.embedding(token_type_ids, w["token_type"])
        )
        x = F.layer_norm(
            x, (x.shape[-1],), w["ln"]["g"], w["ln"]["b"], self.cfg.layer_norm_eps
        )
        return x.to(self.cfg.dtype)


class AlbertSelfAttention(nn.Module):
    """The attention block (QKV + attention + output projection), then
    dropout + residual add + LayerNorm."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.impl = resolve_impl(cfg.attention_impl)
        H = cfg.hidden_size
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)
        self.dense = nn.Linear(H, H)
        self.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def compute_weights(self, dtype) -> dict:
        # nn.Linear stores [out, in]; the kernel takes JAX's [in, out]
        wqkv, bqkv, wo, bo = pack_weights(
            self.query.weight.T, self.query.bias, self.key.weight.T,
            self.key.bias, self.value.weight.T, self.value.bias,
            self.dense.weight.T, self.dense.bias, dtype,
        )
        return {"wqkv": wqkv, "bqkv": bqkv, "wo": wo, "bo": bo,
                "ln": _ln_weights(self.LayerNorm)}

    def forward(self, hidden, attention_bias, segment_ids, w: dict):
        cfg = self.cfg
        out = self_attention(
            self.impl, hidden, w["wqkv"], w["bqkv"], w["wo"], w["bo"],
            cfg.num_attention_heads, bias=attention_bias,
            segment_ids=segment_ids, out_dtype=cfg.dtype,
        )
        return _add_layernorm(self.impl, out, hidden, w["ln"], cfg.layer_norm_eps)


def _add_layernorm(impl: str, x, residual, ln: dict, eps: float):
    fn = dropout_add_layernorm if impl == "kernel" else dropout_add_layernorm_plain
    return fn(x, residual, ln["g"], ln["b"], eps=eps)


class AlbertLayer(nn.Module):
    """One transformer block; instantiated ONCE and applied N times."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.attention = AlbertSelfAttention(cfg)
        self.ffn = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_output = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.full_layer_layer_norm = nn.LayerNorm(
            cfg.hidden_size, eps=cfg.layer_norm_eps
        )
        self.act = _act(cfg.hidden_act)

    def compute_weights(self, dtype) -> dict:
        return {
            "attention": self.attention.compute_weights(dtype),
            "ffn": _linear_weights(self.ffn, dtype),
            "ffn_output": _linear_weights(self.ffn_output, dtype),
            "ln": _ln_weights(self.full_layer_layer_norm),
        }

    def forward(self, hidden, attention_bias, segment_ids, w: dict):
        attn_out = self.attention(hidden, attention_bias, segment_ids, w["attention"])
        ffn = F.linear(attn_out, w["ffn"]["w"], w["ffn"]["b"])
        ffn = self.act(ffn)
        ffn = F.linear(ffn, w["ffn_output"]["w"], w["ffn_output"]["b"])
        return _add_layernorm(
            self.attention.impl, ffn, attn_out, w["ln"], self.cfg.layer_norm_eps
        )


class AlbertLayerGroup(nn.Module):
    """HF's one-layer group (``albert_layer_groups.0.albert_layers.0``)."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.albert_layers = nn.ModuleList([AlbertLayer(cfg)])


class AlbertEncoder(nn.Module):
    """128→hidden mapping, then the one shared layer applied N times."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embedding_hidden_mapping_in = nn.Linear(cfg.embedding_size, cfg.hidden_size)
        self.albert_layer_groups = nn.ModuleList([AlbertLayerGroup(cfg)])

    @property
    def layer(self) -> AlbertLayer:
        return self.albert_layer_groups[0].albert_layers[0]

    def compute_weights(self, dtype) -> dict:
        return {
            "mapping": _linear_weights(self.embedding_hidden_mapping_in, dtype),
            "layer": self.layer.compute_weights(dtype),
        }

    def forward(self, embeddings, attention_bias, segment_ids, w: dict):
        hidden = F.linear(embeddings, w["mapping"]["w"], w["mapping"]["b"])
        for _ in range(self.cfg.num_hidden_layers):
            hidden = self.layer(hidden, attention_bias, segment_ids, w["layer"])
        return hidden


class AlbertModel(nn.Module):
    """Encoder trunk; returns ``(last_hidden_state, pooled)`` in the
    compute dtype, as HF ``AlbertModel`` and the JAX module do."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embeddings = AlbertEmbeddings(cfg)
        self.encoder = AlbertEncoder(cfg)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    @classmethod
    def from_state_dict(cls, cfg: AlbertConfig, state_dict: dict) -> "AlbertModel":
        """A model whose parameters ARE ``state_dict``'s tensors (no
        initialisation, no copy); keys and shapes are checked strictly."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state_dict, strict=True, assign=True)
        return model

    @torch.no_grad()
    def compute_weights(self, device=None) -> dict:
        """The weight set a forward runs on: compute-dtype copies made
        from the current parameters, moved to ``device`` (default: where
        the parameters are)."""
        dtype = self.cfg.dtype
        w = {
            "embeddings": self.embeddings.compute_weights(dtype),
            "encoder": self.encoder.compute_weights(dtype),
            "pooler": _linear_weights(self.pooler, dtype),
        }
        return move_weights(w, device) if device is not None else w

    def forward(
        self,
        input_ids,
        attention_mask=None,
        token_type_ids=None,
        segment_ids=None,
        position_ids=None,
        deterministic: bool = True,
        weights: dict | None = None,
    ):
        if not deterministic:
            raise NotImplementedError(
                "the training forward (dropout) comes with the training slice"
            )
        # a caller that runs many forwards (PhonemeEncoder) passes the
        # weight set it made once; without one, it is made from the
        # current parameters on every call
        w = self.compute_weights() if weights is None else weights
        emb = self.embeddings(input_ids, token_type_ids, position_ids, w["embeddings"])
        bias = (
            attention_bias_from_mask(attention_mask)
            if attention_mask is not None else None
        )
        hidden = self.encoder(emb, bias, segment_ids, w["encoder"])
        pooled = torch.tanh(
            F.linear(hidden[:, 0], w["pooler"]["w"], w["pooler"]["b"])
        )
        return hidden, pooled


def move_weights(weights: dict, device) -> dict:
    """A (nested) weight set on ``device``. Tensors already there are
    shared, not copied: a weight set is never written in place."""
    return {
        k: move_weights(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in weights.items()
    }


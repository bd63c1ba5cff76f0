"""ALBERT encoder in PyTorch, the counterpart of ``pl_bert_tpu/models/albert.py``.

A shared-layer ALBERT (one layer applied ``num_hidden_layers`` times,
factorized embedding vocab → embedding_size → hidden_size), its serving
forward and its training forward (``deterministic=False``: dropout, and
gradients through the kernels' ``autograd.Function``s), and
``PhonemeOnlyModel``, the encoder with the masked-phoneme head.
``MultiTaskModel``, int8 and remat come with later slices.

Submodules carry HF ``AlbertModel``'s names, so ``state_dict()`` keys are
exactly the names of ``pl_bert_tpu/export/to_hf.py:28-76`` and a
reference ``.pth`` loads with ``strict=True`` and no renaming.

Parameters stay fp32. The serving forward runs on a *weight set*: the
compute-dtype copies of the weights (Wq|Wk|Wv packed for the attention
kernel, matrices in the compute dtype, LayerNorm affine and kernel
biases in fp32), made once per load by :meth:`AlbertModel.compute_weights`
and not per call. A caller that swaps weights while forwards are in
flight (the serving encoder) passes the set explicitly and rebinds it;
a plain ``model(ids, mask)`` makes one from the current parameters.
The training forward makes its own set once per forward, inside
autograd (:meth:`AlbertModel.train_weights`): the fp32 parameters in
the kernel layout, whose gradients come back fp32 and are summed over
the layer's applications in fp32, beside compute-dtype copies without
gradients for the kernels to read. The dense layers cast their fp32
weights per application, as flax does, so their gradients are rounded
per application and summed in fp32, as in JAX.

``attention_impl`` picks the attention path (``ops/attention.py``):
``auto`` the attention-block kernels (``ops/attention_block.py``),
``pallas`` the per-head flash kernels (``ops/flash_attention.py``)
between cuBLAS projections, as the JAX model's ``pallas`` branch
(pl_bert_tpu/models/albert.py:399-459) leaves its projections to XLA.
Both run the fused dropout+add+LayerNorm kernels (``ops/fused_ln.py``)
at the two LayerNorm sites, where those take the width (a multiple of 8
up to 2048; else the plain LayerNorm, chosen when the model is built and
logged, as JAX falls back to ``nn.LayerNorm``). ``eager`` (or the JAX value ``xla``) runs
the plain versions of all of them on any device, under autograd when
training; a kernel path whose kernels do not take the model's shapes
(head_dim other than 64 or 128, say) falls back to it when the model is
built, and the model logs why. All three read the same parameters, so
one state dict drives them all.

Dropout draws one seed per site per layer application per forward —
the embedding, then (attention, first LayerNorm, second LayerNorm) for
each application — as host ints (:func:`draw_dropout_seeds`), the
counterpart of ``_dropout_rate_seed`` (pl_bert_tpu/models/albert.py:110-119).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from pl_bert_tpu_torch.ops.attention import (
    fused_attention,
    kernel_refusal,
    resolve_impl,
    self_attention,
    self_attention_train,
)
from pl_bert_tpu_torch.ops.attention_block import pack_weights
from pl_bert_tpu_torch.ops.fused_ln import (
    dropout_add_layernorm,
    dropout_add_layernorm_plain,
    dropout_add_layernorm_train,
    ln_kernel_refusal,
)

logger = logging.getLogger(__name__)


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
    attention_impl: str = "auto"  # auto (block) | pallas (flash) | eager/xla
    dtype: torch.dtype = torch.float32  # compute dtype (params stay fp32)

    @classmethod
    def from_params(cls, p, dtype: torch.dtype = torch.float32) -> "AlbertConfig":
        """From any object with ``ModelParams``' attribute names
        (``pl_bert_tpu_torch.config.ModelParams``, or another AlbertConfig)."""
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


def _linear(x, w: dict, dtype):
    """A dense layer in the compute dtype; a training set's fp32 weights
    are cast here, per application (a serving set's already are)."""
    return F.linear(x, w["w"].to(dtype), w["b"].to(dtype))


def draw_dropout_seeds(generator: torch.Generator, num_layers: int) -> list[int]:
    """One int32 seed per dropout site of a training forward: the
    embedding, then (attention, first LayerNorm, second LayerNorm) for
    each of ``num_layers`` applications; host ints from ``generator``."""
    return torch.randint(0, 2**31 - 1, (1 + 3 * num_layers,), generator=generator).tolist()


def _dropout(x, seed, rate: float):
    """Embedding dropout (no kernel in the JAX package either): a mask
    from a ``torch.Generator`` on ``x``'s device seeded with ``seed``."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0).to(x.dtype)


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

    def forward(self, input_ids, token_type_ids, position_ids, w: dict, seed=None):
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
        return _dropout(x.to(self.cfg.dtype), seed, self.cfg.dropout)

    def train_weights(self) -> dict:
        return {
            "word": self.word_embeddings.weight,
            "position": self.position_embeddings.weight,
            "token_type": self.token_type_embeddings.weight,
            "ln": {"g": self.LayerNorm.weight, "b": self.LayerNorm.bias},
        }


class AlbertSelfAttention(nn.Module):
    """The attention block (QKV + attention + output projection), then
    dropout + residual add + LayerNorm. On the ``flash`` path the
    projections are cuBLAS GEMMs around the per-head kernel."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.impl = resolve_impl(cfg.attention_impl, cfg.head_dim, cfg.hidden_size, cfg.dtype)
        if self.impl == "eager" and resolve_impl(cfg.attention_impl) != "eager":
            logger.warning("attention_impl %r falls back to the eager path: %s",
                           cfg.attention_impl,
                           kernel_refusal(cfg.head_dim, cfg.hidden_size, cfg.dtype))
        else:
            logger.info("attention_impl %r runs the %s path", cfg.attention_impl, self.impl)
        self.ln_fns = _ln_fns(self.impl, cfg)
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

    def train_weights(self, dtype) -> dict:
        """The fp32 parameters in the kernel layout, inside autograd,
        and (``wqkv``, ``wo``) their compute-dtype copies without
        gradients."""
        wqkv32 = torch.cat(
            [self.query.weight.T, self.key.weight.T, self.value.weight.T], dim=1
        )
        wo32 = self.dense.weight.T
        return {
            "wqkv32": wqkv32,
            "bqkv": torch.cat([self.query.bias, self.key.bias, self.value.bias]),
            "wo32": wo32, "bo": self.dense.bias,
            "wqkv": wqkv32.detach().to(dtype).contiguous(),
            "wo": wo32.detach().to(dtype).contiguous(),
            "ln": {"g": self.LayerNorm.weight, "b": self.LayerNorm.bias},
        }

    def _flash(self, hidden, attention_bias, segment_ids, w: dict, seed=None):
        """The ``pallas`` branch of the JAX model: q, k, v from one GEMM
        on the packed [E, 3P] weight (three dense layers' worth; the
        kernel reads the three sections in place), K7 (K8 under
        autograd), then the ``dense`` projection. A training set's fp32
        weights are cast here, per application, as :func:`_linear` does."""
        cfg = self.cfg
        B, L, E = hidden.shape
        dtype, nh = cfg.dtype, cfg.num_attention_heads
        wqkv, wo = (w["wqkv32"], w["wo32"]) if "wqkv32" in w else (w["wqkv"], w["wo"])
        qkv = torch.addmm(w["bqkv"].to(dtype), hidden.reshape(B * L, E), wqkv.to(dtype))
        q, k, v = (t.reshape(B, L, nh, cfg.head_dim) for t in qkv.split(E, dim=1))
        ctx = fused_attention(
            q, k, v, attention_bias, segment_ids, dtype=dtype,
            dropout_rate=cfg.dropout if seed is not None else 0.0, dropout_seed=seed,
        )
        out = torch.addmm(w["bo"].to(dtype), ctx.reshape(B * L, E), wo.to(dtype))
        return out.reshape(B, L, E)

    def forward(self, hidden, attention_bias, segment_ids, w: dict, seeds=None):
        cfg = self.cfg
        if self.impl == "flash":
            train = seeds is not None
            out = self._flash(hidden, attention_bias, segment_ids, w,
                              seeds[0] if train else None)
            return _add_layernorm(
                self.ln_fns, out, hidden, w["ln"], cfg.layer_norm_eps, train,
                seeds[1] if train else None, cfg.dropout if train else 0.0,
            )
        if seeds is None:
            out = self_attention(
                self.impl, hidden, w["wqkv"], w["bqkv"], w["wo"], w["bo"],
                cfg.num_attention_heads, bias=attention_bias,
                segment_ids=segment_ids, out_dtype=cfg.dtype,
            )
            return _add_layernorm(self.ln_fns, out, hidden, w["ln"], cfg.layer_norm_eps)
        out = self_attention_train(
            self.impl, hidden, w, cfg.num_attention_heads, bias=attention_bias,
            segment_ids=segment_ids, dropout_rate=cfg.dropout, dropout_seed=seeds[0],
        )
        return _add_layernorm(
            self.ln_fns, out, hidden, w["ln"], cfg.layer_norm_eps, True, seeds[1],
            cfg.dropout,
        )


def _ln_fns(impl: str, cfg: AlbertConfig) -> tuple:
    """(serving, training) function of the model's two LayerNorm sites,
    chosen when the model is built: on a kernel path K5, and K5/K6's
    autograd Function in training; the plain version on the eager path
    and wherever the LN kernels do not take the width
    (:func:`ln_kernel_refusal`), as JAX falls back to ``nn.LayerNorm``
    (pl_bert_tpu/models/albert.py:445-453, 477-480). Logs why."""
    plain = dropout_add_layernorm_plain
    if impl == "eager":
        return plain, plain
    reason = ln_kernel_refusal(cfg.hidden_size, cfg.dtype)
    if reason:
        logger.warning("the LayerNorm runs its plain version: %s", reason)
        return plain, plain
    return dropout_add_layernorm, dropout_add_layernorm_train


def _add_layernorm(fns: tuple, x, residual, ln: dict, eps: float, train: bool = False,
                   seed=None, rate: float = 0.0):
    """Dropout + residual add + LayerNorm through ``fns`` (:func:`_ln_fns`):
    its serving function, or with ``train`` its training one."""
    return fns[train](x, residual, ln["g"], ln["b"], seed=seed, rate=rate, eps=eps)


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

    def train_weights(self, dtype) -> dict:
        ln = self.full_layer_layer_norm
        return {
            "attention": self.attention.train_weights(dtype),
            "ffn": {"w": self.ffn.weight, "b": self.ffn.bias},
            "ffn_output": {"w": self.ffn_output.weight, "b": self.ffn_output.bias},
            "ln": {"g": ln.weight, "b": ln.bias},
        }

    def forward(self, hidden, attention_bias, segment_ids, w: dict, seeds=None):
        """``seeds`` (attention, first LN, second LN) makes it the
        training forward; None the serving one."""
        dtype = self.cfg.dtype
        attn_out = self.attention(hidden, attention_bias, segment_ids, w["attention"], seeds)
        ffn = self.act(_linear(attn_out, w["ffn"], dtype))
        ffn = _linear(ffn, w["ffn_output"], dtype)
        return _add_layernorm(
            self.attention.ln_fns, ffn, attn_out, w["ln"], self.cfg.layer_norm_eps,
            seeds is not None, None if seeds is None else seeds[2], self.cfg.dropout,
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

    def train_weights(self, dtype) -> dict:
        m = self.embedding_hidden_mapping_in
        return {"mapping": {"w": m.weight, "b": m.bias},
                "layer": self.layer.train_weights(dtype)}

    def forward(self, embeddings, attention_bias, segment_ids, w: dict, seeds=None):
        """``seeds``: one (attention, LN, LN) triple per application for
        the training forward; None for the serving one."""
        hidden = _linear(embeddings, w["mapping"], self.cfg.dtype)
        for i in range(self.cfg.num_hidden_layers):
            hidden = self.layer(
                hidden, attention_bias, segment_ids, w["layer"],
                None if seeds is None else seeds[i],
            )
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
        """The serving weight set: compute-dtype copies made from the
        current parameters, moved to ``device`` (default: where the
        parameters are)."""
        dtype = self.cfg.dtype
        w = {
            "embeddings": self.embeddings.compute_weights(dtype),
            "encoder": self.encoder.compute_weights(dtype),
            "pooler": _linear_weights(self.pooler, dtype),
        }
        return move_weights(w, device) if device is not None else w

    def train_weights(self) -> dict:
        """The training weight set, made once per forward inside
        autograd (see the module docstring)."""
        return {
            "embeddings": self.embeddings.train_weights(),
            "encoder": self.encoder.train_weights(self.cfg.dtype),
            "pooler": {"w": self.pooler.weight, "b": self.pooler.bias},
        }

    def forward(
        self,
        input_ids,
        attention_mask=None,
        token_type_ids=None,
        segment_ids=None,
        position_ids=None,
        deterministic: bool = True,
        weights: dict | None = None,
        dropout_seeds=None,
    ):
        """``deterministic=False`` is the training forward: dropout at
        rate ``cfg.dropout`` with ``dropout_seeds`` (see
        :func:`draw_dropout_seeds`; unused at rate 0), and the kernels'
        autograd Functions. ``weights``: a serving weight set made once
        (the serving encoder passes one); without one, it is made from
        the current parameters on every call."""
        cfg = self.cfg
        seeds = emb_seed = None
        if deterministic:
            w = self.compute_weights() if weights is None else weights
        else:
            w = self.train_weights()
            n = cfg.num_hidden_layers
            if cfg.dropout > 0.0:
                if dropout_seeds is None or len(dropout_seeds) != 1 + 3 * n:
                    raise ValueError(
                        f"the training forward needs {1 + 3 * n} dropout seeds "
                        "(draw_dropout_seeds)"
                    )
                emb_seed = dropout_seeds[0]
                seeds = [tuple(dropout_seeds[1 + 3 * i: 4 + 3 * i]) for i in range(n)]
            else:
                seeds = [(None, None, None)] * n
        emb = self.embeddings(input_ids, token_type_ids, position_ids, w["embeddings"],
                              emb_seed)
        bias = (
            attention_bias_from_mask(attention_mask)
            if attention_mask is not None else None
        )
        hidden = self.encoder(emb, bias, segment_ids, w["encoder"], seeds)
        pooled = torch.tanh(_linear(hidden[:, 0], w["pooler"], cfg.dtype))
        return hidden, pooled


class PhonemeOnlyModel(nn.Module):
    """Encoder + masked-phoneme head, the counterpart of
    ``pl_bert_tpu/models/albert.py:562-578``: fp32 logits [B, L, V]. Its
    state dict has the reference ``.pth``'s keys (``encoder.*``,
    ``phoneme_predictor.weight/bias``)."""

    def __init__(self, cfg: AlbertConfig, num_phonemes: int = 188) -> None:
        super().__init__()
        self.cfg = cfg
        self.encoder = AlbertModel(cfg)
        self.phoneme_predictor = nn.Linear(cfg.hidden_size, num_phonemes)

    def forward(self, input_ids, attention_mask=None, segment_ids=None,
                position_ids=None, deterministic: bool = True, dropout_seeds=None):
        hidden, _ = self.encoder(
            input_ids, attention_mask, segment_ids=segment_ids,
            position_ids=position_ids, deterministic=deterministic,
            dropout_seeds=dropout_seeds,
        )
        head = self.phoneme_predictor
        logits = _linear(hidden, {"w": head.weight, "b": head.bias}, self.cfg.dtype)
        return logits.float()


def build_model(params, mixed_precision: str = "bf16") -> PhonemeOnlyModel:
    """The counterpart of ``pl_bert_tpu/models/albert.py::build_model``
    (:609-621) for the phoneme-only model; ``params`` has
    ``ModelParams``' attribute names. Parameters are created with
    torch's default init; :func:`init_params` gives the JAX package's
    initial distribution, and ``export/bridge.py`` loads JAX's own."""
    if getattr(params, "num_token_vocab", 0) > 0:
        raise NotImplementedError(
            "num_token_vocab > 0 (the multi-task grapheme head) is not yet ported"
        )
    dtype = torch.bfloat16 if mixed_precision in ("bf16", "fp16") else torch.float32
    return PhonemeOnlyModel(AlbertConfig.from_params(params, dtype=dtype), params.vocab_size)


@torch.no_grad()
def init_params(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise in place as the JAX package does (albert.py:285-302,
    :134-164): matrices and embeddings N(0, initializer_range), biases
    0, LayerNorm scale 1 and bias 0; from a ``torch.Generator`` seeded
    with ``seed`` (not JAX's bits)."""
    gen = torch.Generator().manual_seed(seed)
    std = model.cfg.initializer_range
    for name, param in model.named_parameters():
        if "LayerNorm" in name or "layer_norm" in name:
            param.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            param.zero_()
        else:
            param.copy_(torch.randn(param.shape, generator=gen) * std)
    return model


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def move_weights(weights: dict, device) -> dict:
    """A (nested) weight set on ``device``. Tensors already there are
    shared, not copied: a weight set is never written in place."""
    return {
        k: move_weights(v, device) if isinstance(v, dict) else v.to(device)
        for k, v in weights.items()
    }

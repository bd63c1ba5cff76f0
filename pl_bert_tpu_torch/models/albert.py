"""ALBERT encoder in PyTorch, the counterpart of ``pl_bert_tpu/models/albert.py``.

A shared-layer ALBERT (one layer applied ``num_hidden_layers`` times,
factorized embedding vocab → embedding_size → hidden_size), its serving
forward and its training forward (``deterministic=False``: dropout, and
gradients through the kernels' ``autograd.Function``s), and
``PhonemeOnlyModel``, the encoder with the masked-phoneme head, and
``MultiTaskModel``, which adds the grapheme (token) head.

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

``quantize="int8"`` makes the serving weight set quantize JAX's
``_dense`` sites on the path the model runs (``ops/quant.py`` says
which: on the ``auto`` path the attention-block kernel keeps its bf16
weights); the forward then runs each such site as an int8 dense layer.
It is inference-only, as in JAX. ``remat`` recomputes each application
of the shared layer in the backward (``torch.utils.checkpoint``), as JAX
wraps the layer in ``nn.remat`` (pl_bert_tpu/models/albert.py:508-509).

Dropout draws one seed per site per layer application per forward —
the embedding, then (attention, first LayerNorm, second LayerNorm) for
each application — as host ints (:func:`draw_dropout_seeds`), the
counterpart of ``_dropout_rate_seed`` (pl_bert_tpu/models/albert.py:110-119).

``mesh`` (``parallel/mesh.py``) runs the model on one cell of a (data,
model) mesh, as JAX's ``mesh`` does (pl_bert_tpu/models/albert.py:
176-241): the model holds this rank's shard of the parameters
(``parallel.mesh.shard_model``) and a batch slice. With ``model`` > 1
the query/key/value and ``ffn`` layers are column-parallel (this rank's
heads and FFN columns) and ``dense``/``ffn_output`` row-parallel: their
fp32 partial sums are all-reduced over the model group (the block
kernel writes them, as JAX's TP shard does; a dense layer's are one
GEMM's fp32 accumulators over its compute-dtype operands, as GSPMD's
all-reduce is fp32 in JAX's bf16 step) and the bias added once, before
the one rounding. ``sequence_parallel`` keeps the
activations between the attention and the FFN as this rank's L/m rows:
the partials are reduce-scattered over L, the LayerNorms run on the
local rows, and each attention and FFN input is all-gathered over L
first (``parallel/tp.py``, ``parallel/collectives.py``). Dropout seeds
take JAX's shard offsets, and the embedding's mask is drawn at the
global batch shape and sliced, so a data-parallel run drops as a
one-process run of the global batch does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pl_bert_tpu_torch.ops import quant
from pl_bert_tpu_torch.ops.attention import (
    eager_attention,
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
from pl_bert_tpu_torch.parallel import collectives as col
from pl_bert_tpu_torch.parallel import tp

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
    remat: bool = False  # recompute each layer application in the backward
    quantize: str | None = None  # None | "int8" (inference-only)
    mesh: object = None  # parallel.mesh.Mesh: this rank's cell (None: one device)
    sequence_parallel: bool = False  # with mesh.model > 1

    def __post_init__(self) -> None:
        m = self.tp_size
        if m > 1:
            for what, n in (("hidden_size", self.hidden_size),
                            ("intermediate_size", self.intermediate_size)):
                if n % m:
                    raise ValueError(f"{what} {n} is not divisible by model_axis {m}")
            if self.quantize is not None:
                raise ValueError("quantize is inference-only and runs on one device")

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.model

    @property
    def attention_shards(self) -> int:
        """The model ranks the attention's heads split over: all of them,
        or 1 where the heads do not divide (the attention then runs whole
        on every rank, as JAX's falls back to XLA attention,
        pl_bert_tpu/models/albert.py:190-193)."""
        m = self.tp_size
        return m if self.num_attention_heads % m == 0 else 1

    @property
    def local_heads(self) -> int:
        return self.num_attention_heads // self.attention_shards

    def sp_active(self, L: int) -> bool:
        """Sequence parallelism applies (JAX's ``_sp_active``, :213-229):
        asked for, with more than one model rank; an indivisible sequence
        raises, since silently dropping it would hide a misconfiguration."""
        m = self.tp_size
        if not (self.sequence_parallel and m > 1):
            return False
        if L % m:
            raise ValueError(f"model_params.sequence_parallel requires seq_len {L} "
                             f"divisible by model_axis {m}")
        return True

    @classmethod
    def from_params(cls, p, dtype: torch.dtype = torch.float32,
                    remat: bool = False, mesh=None) -> "AlbertConfig":
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
            remat=remat,
            mesh=mesh,
            sequence_parallel=bool(getattr(p, "sequence_parallel", False)),
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


def _linear_weights(layer: nn.Linear, dtype, int8: bool = False) -> dict:
    """A dense layer's serving weights in the compute dtype; with
    ``int8``, its int8 weight and per-channel scales (``ops/quant.py``)."""
    if int8:
        wq, ws = quant.quantize_weight(layer.weight, dtype)
        return {"wq": wq, "ws": ws, "b": layer.bias.to(dtype)}
    return {"w": layer.weight.to(dtype), "b": layer.bias.to(dtype)}


def _ln_weights(ln: nn.LayerNorm) -> dict:
    return {"g": ln.weight.float(), "b": ln.bias.float()}


def _linear(x, w: dict, dtype):
    """A dense layer in the compute dtype; a training set's fp32 weights
    are cast here, per application (a serving set's already are); an int8
    site of a serving set runs as ``quant.int8_linear``."""
    if "wq" in w:
        return quant.int8_linear(x, w["wq"], w["ws"], w["b"], dtype)
    return F.linear(x, w["w"].to(dtype), w["b"].to(dtype))


class _PartialProduct(torch.autograd.Function):
    """``x @ w.T`` of compute-dtype operands with the product kept in
    fp32 (a row-parallel layer's partial sum): on the card one cuBLAS GEMM
    that reads the bf16 operands on the tensor cores and writes its fp32
    accumulators (``torch.mm``'s ``out_dtype``), elsewhere the fp32
    product of the same values. The backward takes the output gradient
    in the compute dtype (it holds compute-dtype values: it comes back
    through the one rounding after the sum) and returns ``dx`` and ``dw``
    in it, as the layer's own backward in the compute dtype would."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            part = torch.mm(x2, w.t(), out_dtype=torch.float32)
        else:
            part = x2.float() @ w.float().t()
        return part.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        dx = (g2 @ w).reshape(x.shape)
        return dx, g2.t() @ x.reshape(-1, x.shape[-1])


def _row_parallel(x, weight, bias, cfg: AlbertConfig, sp: bool):
    """A row-parallel dense layer (``weight`` [out, in/m], this rank's
    input slice): the fp32 partial product of the compute-dtype operands
    (:class:`_PartialProduct`), summed over the model group
    (reduce-scattered over L under ``sp``), then the bias added once and
    the one rounding."""
    part = _PartialProduct.apply(x.to(cfg.dtype), weight.to(cfg.dtype))
    return (tp.leave(part, cfg.mesh, sp) + bias.float()).to(cfg.dtype)


def _project(x, w: dict, name: str, dtype):
    """The attention's packed q|k|v (``name`` "qkv") or output ("o")
    projection of [rows, in] ``x``: an int8 site (``w[name]``), or the
    [in, out] matrix and bias of a serving set (``wqkv``, ``bqkv``) or a
    training set (``wqkv32``; cast here, per application)."""
    if name in w:
        return _linear(x, w[name], dtype)
    mat = w[f"w{name}32"] if f"w{name}32" in w else w[f"w{name}"]
    return torch.addmm(w[f"b{name}"].to(dtype), x, mat.to(dtype))


def draw_dropout_seeds(generator: torch.Generator, num_layers: int) -> list[int]:
    """One int32 seed per dropout site of a training forward: the
    embedding, then (attention, first LayerNorm, second LayerNorm) for
    each of ``num_layers`` applications; host ints from ``generator``."""
    return torch.randint(0, 2**31 - 1, (1 + 3 * num_layers,), generator=generator).tolist()


def _dropout(x, seed, rate: float, mesh=None):
    """Embedding dropout (no kernel in the JAX package either): a mask
    from a ``torch.Generator`` on ``x``'s device seeded with ``seed``,
    drawn at the global batch shape and sliced to this rank's rows, as
    ``jax.random`` draws depend on the shape only."""
    if seed is None or rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    data = 1 if mesh is None else mesh.data
    shape = (x.shape[0] * data, *x.shape[1:])
    keep = torch.rand(shape, generator=gen, device=x.device) >= rate
    if data > 1:
        keep = keep[mesh.data_index * x.shape[0]:(mesh.data_index + 1) * x.shape[0]]
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
        return _dropout(x.to(self.cfg.dtype), seed, self.cfg.dropout, self.cfg.mesh)

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
        # heads that do not divide the model axis: the attention runs
        # whole on every model rank, on the eager path
        self.whole = cfg.tp_size > 1 and cfg.attention_shards == 1
        if self.whole and self.impl != "eager":
            self.impl = "eager"
            logger.warning("attention_impl %r falls back to the eager path: %d heads do not "
                           "divide model_axis %d", cfg.attention_impl,
                           cfg.num_attention_heads, cfg.tp_size)
        elif self.impl == "eager" and resolve_impl(cfg.attention_impl) != "eager":
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

    def _params(self) -> tuple:
        """(query, key, value, dense) weights and biases, nn.Linear's
        layout: this rank's shards, or where the attention runs whole the
        full tensors gathered over the model group (their gradients come
        back as this rank's shard of them)."""
        layers = (self.query, self.key, self.value, self.dense)
        if not self.whole:
            return tuple(t for layer in layers for t in (layer.weight, layer.bias))
        mesh = self.cfg.mesh
        out = []
        for layer in layers[:3]:
            out += [col.unsplit(layer.weight, mesh, 0), col.unsplit(layer.bias, mesh, 0)]
        return (*out, col.unsplit(self.dense.weight, mesh, 1), self.dense.bias)

    def compute_weights(self, dtype) -> dict:
        if self.cfg.quantize and self.impl != "block":
            # JAX's query, key, value and dense sites, q|k|v as one int8
            # layer: per-channel weight scales and one per-row activation
            # scale give the bits of three
            q, k, v = self.query, self.key, self.value
            wq, ws = quant.quantize_weight(torch.cat([q.weight, k.weight, v.weight]), dtype)
            bqkv = torch.cat([q.bias, k.bias, v.bias]).to(dtype)
            return {"qkv": {"wq": wq, "ws": ws, "b": bqkv},
                    "o": _linear_weights(self.dense, dtype, int8=True),
                    "ln": _ln_weights(self.LayerNorm)}
        # nn.Linear stores [out, in]; the kernel takes JAX's [in, out]
        wq, bq, wk, bk, wv, bv, wd, bd = self._params()
        wqkv, bqkv, wo, bo = pack_weights(wq.T, bq, wk.T, bk, wv.T, bv, wd.T, bd, dtype)
        return {"wqkv": wqkv, "bqkv": bqkv, "wo": wo, "bo": bo,
                "ln": _ln_weights(self.LayerNorm)}

    def train_weights(self, dtype) -> dict:
        """The fp32 parameters in the kernel layout, inside autograd,
        and (``wqkv``, ``wo``) their compute-dtype copies without
        gradients."""
        wq, bq, wk, bk, wv, bv, wd, bd = self._params()
        wqkv32 = torch.cat([wq.T, wk.T, wv.T], dim=1)
        wo32 = wd.T
        return {
            "wqkv32": wqkv32,
            "bqkv": torch.cat([bq, bk, bv]),
            "wo32": wo32, "bo": bd,
            "wqkv": wqkv32.detach().to(dtype).contiguous(),
            "wo": wo32.detach().to(dtype).contiguous(),
            "ln": {"g": self.LayerNorm.weight, "b": self.LayerNorm.bias},
        }

    def _projected(self, hidden, attention_bias, segment_ids, w: dict, seed=None,
                   sp: bool = False):
        """JAX's ``pallas`` and ``xla`` branches: q, k, v from one
        projection (three dense layers' worth; the flash kernel reads the
        three sections in place), the attention — K7 (K8 under autograd)
        on the flash path (``tp.tp_flash_attention``, which offsets the
        site's ``seed`` by the shard's), the plain attention on the eager
        path of an int8 weight set (one device, no dropout) — then the
        ``dense`` projection. Under tensor parallelism ``hidden`` is the
        region's input and the heads are this rank's; ``dense`` is
        row-parallel."""
        cfg = self.cfg
        B, L, _ = hidden.shape
        dtype, nh, D = cfg.dtype, cfg.local_heads, cfg.head_dim
        P = nh * D
        qkv = _project(hidden.reshape(B * L, -1), w, "qkv", dtype)
        q, k, v = (t.reshape(B, L, nh, D) for t in qkv.split(P, dim=1))
        if self.impl == "flash":
            ctx = tp.tp_flash_attention(
                cfg.mesh, q, k, v, attention_bias, segment_ids, out_dtype=dtype,
                dropout_rate=cfg.dropout if seed is not None else 0.0, dropout_seed=seed,
            )
        else:
            ctx = eager_attention(q, k, v, attention_bias, segment_ids, dtype=dtype)
        ctx = ctx.reshape(B, L, P)
        if cfg.attention_shards > 1:
            wo = w["wo32"] if "wo32" in w else w["wo"]
            return _row_parallel(ctx, wo.T, w["bo"], cfg, sp)
        return _project(ctx.reshape(B * L, P), w, "o", dtype).reshape(B, L, -1)

    def forward(self, hidden, attention_bias, segment_ids, w: dict, seeds=None):
        """``hidden``: [B, L, E], or this rank's [B, L/m, E] rows under
        sequence parallelism (and so is the output). Sharded, the
        attention runs through ``tp.tp_attention_block`` (the block and
        eager paths) or ``tp.tp_flash_attention``, the LayerNorm through
        ``tp.tp_dropout_add_layernorm``; each offsets its site's seed by
        the shard's."""
        cfg = self.cfg
        mesh = cfg.mesh
        train = seeds is not None
        seeds = seeds if train else (None, None)
        sp = cfg.sp_active(hidden.shape[1] * cfg.tp_size)
        if self.whole:
            out = self._whole(hidden, attention_bias, segment_ids, w, seeds[0], sp)
        elif self.impl == "flash" or "qkv" in w:
            out = self._projected(tp.enter(hidden, mesh, sp), attention_bias, segment_ids, w,
                                  seeds[0], sp)
        elif cfg.attention_shards > 1:
            out = tp.tp_attention_block(
                mesh, hidden, w, cfg.num_attention_heads, impl=self.impl, bias=attention_bias,
                segment_ids=segment_ids, out_dtype=cfg.dtype, dropout_rate=cfg.dropout,
                dropout_seed=seeds[0], sp=sp)
        elif train:
            out = self_attention_train(
                self.impl, hidden, w, cfg.num_attention_heads, bias=attention_bias,
                segment_ids=segment_ids, dropout_rate=cfg.dropout,
                dropout_seed=tp.attention_seed(seeds[0], mesh), out_dtype=cfg.dtype)
        else:
            out = self_attention(self.impl, hidden, w["wqkv"], w["bqkv"], w["wo"], w["bo"],
                                 cfg.num_attention_heads, bias=attention_bias,
                                 segment_ids=segment_ids, out_dtype=cfg.dtype)
        return tp.tp_dropout_add_layernorm(
            mesh, out, hidden, w["ln"]["g"], w["ln"]["b"], seeds[1], cfg.dropout,
            cfg.layer_norm_eps, sp=sp, fn=self.ln_fns[train])

    def _whole(self, hidden, attention_bias, segment_ids, w: dict, seed, sp: bool):
        """Heads that do not divide the model axis: every model rank runs
        the whole attention on the eager path (under ``sp`` on the rows
        gathered over L) with the data offset of its seed only, so the
        ranks agree. It writes fp32 with a zero output bias; ``bo`` is
        added after the split over L, so that under sequence parallelism
        each rank's ``bo`` sees its rows, as every layer parameter
        does."""
        cfg = self.cfg
        x = col.unsplit(hidden, cfg.mesh) if sp else hidden
        kwargs = dict(bias=attention_bias, segment_ids=segment_ids, out_dtype=torch.float32)
        zero = torch.zeros_like(w["bo"])
        if "wqkv32" in w:  # a training set
            out = self_attention_train(
                self.impl, x, dict(w, bo=zero), cfg.num_attention_heads,
                dropout_rate=cfg.dropout, dropout_seed=tp.replicated_seed(seed, cfg.mesh),
                **kwargs)
        else:
            out = self_attention(self.impl, x, w["wqkv"], w["bqkv"], w["wo"], zero,
                                 cfg.num_attention_heads, **kwargs)
        if sp:
            out = col.split(out, cfg.mesh)
        return (out + w["bo"].float()).to(cfg.dtype)


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
        int8 = self.cfg.quantize is not None
        return {
            "attention": self.attention.compute_weights(dtype),
            "ffn": _linear_weights(self.ffn, dtype, int8),
            "ffn_output": _linear_weights(self.ffn_output, dtype, int8),
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
        training forward; None the serving one. Under tensor parallelism
        ``ffn`` is column-parallel and ``ffn_output`` row-parallel."""
        cfg = self.cfg
        dtype, mesh, m = cfg.dtype, cfg.mesh, cfg.tp_size
        sp = cfg.sp_active(hidden.shape[1] * m)
        attn_out = self.attention(hidden, attention_bias, segment_ids, w["attention"], seeds)
        if m > 1:
            ffn = self.act(_linear(tp.enter(attn_out, mesh, sp), w["ffn"], dtype))
            out = w["ffn_output"]
            ffn = _row_parallel(ffn, out["w"], out["b"], cfg, sp)
        else:
            ffn = self.act(_linear(attn_out, w["ffn"], dtype))
            ffn = _linear(ffn, w["ffn_output"], dtype)
        return tp.tp_dropout_add_layernorm(
            mesh, ffn, attn_out, w["ln"]["g"], w["ln"]["b"],
            None if seeds is None else seeds[2], cfg.dropout, cfg.layer_norm_eps, sp=sp,
            fn=self.attention.ln_fns[seeds is not None])


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
            "mapping": _linear_weights(self.embedding_hidden_mapping_in, dtype,
                                       self.cfg.quantize is not None),
            "layer": self.layer.compute_weights(dtype),
        }

    def train_weights(self, dtype) -> dict:
        m = self.embedding_hidden_mapping_in
        return {"mapping": {"w": m.weight, "b": m.bias},
                "layer": self.layer.train_weights(dtype)}

    def forward(self, embeddings, attention_bias, segment_ids, w: dict, seeds=None):
        """``seeds``: one (attention, LN, LN) triple per application for
        the training forward; None for the serving one. With ``remat``, a
        training forward keeps only each application's input: the
        backward runs the application again from it. Its seeds are
        arguments, so the recomputation draws the same dropout masks
        (Philox for the attention, ``tl.rand`` for the LayerNorm) and
        needs no saved RNG state."""
        cfg = self.cfg
        hidden = _linear(embeddings, w["mapping"], cfg.dtype)
        sp = cfg.sp_active(hidden.shape[1])
        if sp:  # the layers keep this rank's L/m rows between their regions
            hidden = col.split(hidden, cfg.mesh)
        for i in range(cfg.num_hidden_layers):
            args = (hidden, attention_bias, segment_ids, w["layer"],
                    None if seeds is None else seeds[i])
            if seeds is not None and self.cfg.remat:
                hidden = checkpoint(self.layer, *args, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                hidden = self.layer(*args)
        return col.unsplit(hidden, cfg.mesh) if sp else hidden


class AlbertModel(nn.Module):
    """Encoder trunk; returns ``(last_hidden_state, pooled)`` in the
    compute dtype, as HF ``AlbertModel`` and the JAX module do."""

    def __init__(self, cfg: AlbertConfig) -> None:
        super().__init__()
        if cfg.quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode {cfg.quantize!r}; only 'int8'")
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
        current parameters (int8 ones at the int8 sites of a quantized
        model), moved to ``device`` (default: where the parameters are)."""
        cfg = self.cfg
        dtype = cfg.dtype
        w = {
            "embeddings": self.embeddings.compute_weights(dtype),
            "encoder": self.encoder.compute_weights(dtype),
            "pooler": _linear_weights(self.pooler, dtype, cfg.quantize is not None),
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
            if cfg.quantize is not None:
                raise ValueError(f"quantize={cfg.quantize!r} is inference-only: the "
                                 "training forward runs unquantized")
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


def _head(layer: nn.Linear, hidden, dtype):
    """A prediction head's fp32 logits, projected in the compute dtype."""
    return _linear(hidden, {"w": layer.weight, "b": layer.bias}, dtype).float()


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
        return _head(self.phoneme_predictor, hidden, self.cfg.dtype)


class MultiTaskModel(PhonemeOnlyModel):
    """Encoder + phoneme head + grapheme (token) head, the counterpart of
    ``pl_bert_tpu/models/albert.py:581-606``; its state dict adds
    ``token_predictor.weight/bias`` to the phoneme-only model's.

    Under a mesh with model ranks the head is vocabulary-parallel (JAX's
    ``P(None, model)``): built whole like every parameter,
    ``parallel.mesh.shard_model`` keeps this rank's rows
    [:meth:`vocab_slice`), ⌈V/m⌉ or fewer, and the losses
    (``ops/masked_ce.py``) take the slice's :class:`VocabSlice`. A V the
    model axis does not divide leaves the last ranks fewer rows."""

    def __init__(self, cfg: AlbertConfig, num_phonemes: int = 188,
                 num_tokens: int = 60_000) -> None:
        super().__init__(cfg, num_phonemes)
        self.num_tokens = num_tokens
        self.token_predictor = nn.Linear(cfg.hidden_size, num_tokens)

    def vocab_slice(self):
        """This rank's :class:`ops.masked_ce.VocabSlice` of the head, or
        None where it holds the whole head."""
        mesh = self.cfg.mesh
        if mesh is None or mesh.model == 1:
            return None
        from pl_bert_tpu_torch.ops.masked_ce import VocabSlice
        from pl_bert_tpu_torch.parallel.mesh import split_bounds

        start, _ = split_bounds(self.num_tokens, mesh.model, mesh.model_index)
        return VocabSlice(mesh.model_group, start)

    def forward(self, input_ids, attention_mask=None, segment_ids=None,
                position_ids=None, deterministic: bool = True, dropout_seeds=None,
                project_tokens: bool = True):
        """(phoneme logits, token logits), both fp32; with
        ``project_tokens=False`` (phoneme logits, hidden in the compute
        dtype), so the [B, L, num_tokens] logits never exist and the loss
        projects the hidden states chunk by chunk
        (``ops/masked_ce.py::masked_lm_loss``)."""
        hidden, _ = self.encoder(
            input_ids, attention_mask, segment_ids=segment_ids,
            position_ids=position_ids, deterministic=deterministic,
            dropout_seeds=dropout_seeds,
        )
        phoneme = _head(self.phoneme_predictor, hidden, self.cfg.dtype)
        if not project_tokens:
            return phoneme, hidden
        vocab = self.vocab_slice()
        if vocab is None:
            return phoneme, _head(self.token_predictor, hidden, self.cfg.dtype)
        part = _head(self.token_predictor, col.copy_to_group(hidden, vocab.group), self.cfg.dtype)
        return phoneme, col.gather_vocab(part, vocab.group)


def build_model(params, mixed_precision: str = "bf16", remat: bool = False,
                mesh=None) -> PhonemeOnlyModel:
    """The counterpart of ``pl_bert_tpu/models/albert.py::build_model``
    (:609-621): phoneme-only unless ``num_token_vocab`` is set, then
    :class:`MultiTaskModel`; ``params`` has ``ModelParams``' attribute
    names; ``remat`` recomputes each layer application in the backward;
    ``mesh`` (``parallel/mesh.py``) the cell this rank runs. Parameters
    are created full, with torch's default init
    (``parallel.mesh.shard_model`` keeps this rank's slices);
    :func:`init_params` gives the JAX package's initial distribution, and
    ``export/bridge.py`` loads JAX's own."""
    dtype = torch.bfloat16 if mixed_precision in ("bf16", "fp16") else torch.float32
    cfg = AlbertConfig.from_params(params, dtype=dtype, remat=remat, mesh=mesh)
    if getattr(params, "num_token_vocab", 0) > 0:
        return MultiTaskModel(cfg, params.vocab_size, params.num_token_vocab)
    return PhonemeOnlyModel(cfg, params.vocab_size)


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

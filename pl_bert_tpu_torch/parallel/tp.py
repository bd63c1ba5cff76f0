"""Tensor-parallel (and sequence-parallel) wrappers of the kernels.

The counterpart of ``pl_bert_tpu/parallel/tp.py``. There ``shard_map``
runs each Pallas kernel on every model shard's slice of the global
arrays; here each rank already holds its slice (``parallel/mesh.py``
shards the parameters), so a wrapper runs the kernel on its local heads
and rows and adds the collective (``parallel/collectives.py``). The
model (``models/albert.py``) runs its sharded attention and its
LayerNorms through them:

- :func:`tp_attention_block` — the attention block (K3 on a training
  weight set, K1 on a serving one) on ``num_heads // m`` heads with the
  column slice of Wq|Wk|Wv and the row slice of Wo, writing **fp32
  partials with a zero output bias**; the partials are all-reduced over
  the model group (reduce-scattered over L under sequence parallelism)
  and ``bo`` added once, before the one rounding (:93-130);
- :func:`tp_flash_attention` — K7/K8 on the local heads, no collective
  (:133-176);
- :func:`tp_dropout_add_layernorm` — K5/K6 on the local rows (:179-224).

Seeds (:37-48): shard (d, r) of a (data, m) mesh offsets its dropout
seed by (r + m·d)·2^20, wrapping as int32 as JAX adds it; the LN without
sequence parallelism by d·2^20 only, so model ranks stay bitwise equal.
:func:`shard_seed` maps the wrapped sum into the kernels' seed range
[0, 2^31 − 2] (the attention kernels read 32 bits, the LN kernels refuse
any other), the one place that does.

Under sequence parallelism the wrappers take and return this rank's L/m
rows of [B, L, E] activations (the model keeps them so between the
attention and the FFN); the attention block gathers them first.
"""

from __future__ import annotations

import torch

from pl_bert_tpu_torch.parallel import collectives as col

SEED_STRIDE = 1 << 20
# the kernels' dropout seeds lie in [0, SEED_MOD - 1] (ops/fused_ln.py's
# SEED_MAX + 1)
SEED_MOD = 2**31 - 1


def _wrap32(v: int) -> int:
    return (int(v) + 2**31) % 2**32 - 2**31


def shard_seed_offset(d: int, r: int, m: int) -> int:
    """JAX's ``_shard_seed_offset`` for shard (data d, model r) of a mesh
    with m model ranks: (r + m·d)·2^20 as an int32."""
    return _wrap32((r + m * d) * SEED_STRIDE)


def shard_seed(seed, offset: int):
    """``seed + offset`` as JAX's int32 add wraps it, mapped into the
    kernels' range (None stays None: no dropout)."""
    if seed is None:
        return None
    return _wrap32(int(seed) + offset) % SEED_MOD


def attention_seed(seed, mesh):
    """An attention site's seed on this rank: the full shard offset."""
    if mesh is None or mesh.size == 1:
        return seed
    return shard_seed(seed, shard_seed_offset(mesh.data_index, mesh.model_index, mesh.model))


def replicated_seed(seed, mesh):
    """The seed of a site the model ranks compute alike: the data offset
    only, so they stay bitwise equal."""
    if mesh is None or mesh.size == 1:
        return seed
    return shard_seed(seed, _wrap32(mesh.data_index * SEED_STRIDE))


def ln_seed(seed, mesh, sp: bool):
    """A LayerNorm site's seed on this rank: the full shard offset under
    sequence parallelism (model ranks hold other rows), else the data
    offset only (model ranks hold the same rows and stay bitwise equal)."""
    return attention_seed(seed, mesh) if sp else replicated_seed(seed, mesh)


def enter(x, mesh, sp: bool):
    """A tensor-parallel region's input: gathered over L under sequence
    parallelism, else passed on (its gradient all-reduced)."""
    return col.gather_seq(x, mesh) if sp else col.copy_to_model(x, mesh)


def leave(part, mesh, sp: bool):
    """A region's output from the ranks' partial sums: reduce-scattered
    over L under sequence parallelism, else all-reduced."""
    return col.scatter_seq(part, mesh) if sp else col.reduce_from_model(part, mesh)


def tp_attention_block(
    mesh, hidden, w: dict, num_heads: int, impl: str = "block", bias=None,
    segment_ids=None, out_dtype=torch.bfloat16, dropout_rate: float = 0.0,
    dropout_seed=None, sp: bool = False,
):
    """The attention block on this rank's shard (``impl``'s path: the
    kernels, K3 under a training set and K1 under a serving one, or the
    eager path's plain versions). ``w`` is the shard's weight set as
    ``AlbertSelfAttention`` makes it: the column slice of Wq|Wk|Wv
    (``wqkv`` [E, 3P], P = E/m, with ``bqkv``), the row slice of Wo
    (``wo`` [P, E]) and the replicated ``bo`` [E]; a training set also
    holds the fp32 ``wqkv32``/``wo32`` the gradients flow to.
    ``num_heads`` is the global count. ``hidden`` [B, L, E] (under ``sp``
    this rank's [B, L/m, E] rows); ``bias``/``segment_ids`` over the full
    L. Returns [B, L, E] (under ``sp`` [B, L/m, E]) in ``out_dtype``."""
    from pl_bert_tpu_torch.ops.attention import self_attention, self_attention_train

    m = 1 if mesh is None else mesh.model
    x = enter(hidden, mesh, sp)
    zero = torch.zeros_like(w["bo"])
    if "wqkv32" in w:
        part = self_attention_train(
            impl, x, dict(w, bo=zero), num_heads // m, bias=bias, segment_ids=segment_ids,
            dropout_rate=dropout_rate, dropout_seed=attention_seed(dropout_seed, mesh),
            out_dtype=torch.float32,
        )
    else:
        part = self_attention(impl, x, w["wqkv"], w["bqkv"], w["wo"], zero, num_heads // m,
                              bias=bias, segment_ids=segment_ids, out_dtype=torch.float32)
    return (leave(part, mesh, sp) + w["bo"].float()).to(out_dtype)


def tp_flash_attention(mesh, q, k, v, bias=None, segment_ids=None, out_dtype=None,
                       dropout_rate: float = 0.0, dropout_seed=None):
    """``flash_attention`` on this rank's heads (q/k/v [B, L, H/m, D]):
    attention is independent per head, so no collective."""
    from pl_bert_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, bias, segment_ids, out_dtype=out_dtype,
                           dropout_rate=dropout_rate,
                           dropout_seed=attention_seed(dropout_seed, mesh))


def tp_dropout_add_layernorm(mesh, x, residual, scale, bias, seed, rate: float, eps: float,
                             sp: bool = False, fn=None):
    """The fused dropout + add + LayerNorm on this rank's rows (under
    ``sp`` its L/m slice): row-local math, no collective. ``fn`` is the
    LayerNorm function the model chose (``models/albert.py``'s
    ``_ln_fns``); by default K5/K6's differentiable one."""
    if fn is None:
        from pl_bert_tpu_torch.ops.fused_ln import dropout_add_layernorm_train as fn

    return fn(x, residual, scale, bias, seed=ln_seed(seed, mesh, sp),
              rate=rate if seed is not None else 0.0, eps=eps)

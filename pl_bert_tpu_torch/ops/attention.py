"""Attention dispatch and the plain eager attention.

The counterpart of ``pl_bert_tpu/ops/attention.py``. There, the TPU
gates (``_on_tpu``, ``pallas_supported``, ``fused_block_supported``)
choose between the Pallas kernels and XLA einsum attention. Here, the
model's ``attention_impl`` names one of three paths, and the model's
shapes may send a kernel path to ``eager`` (:func:`resolve_impl`):

- ``block`` — the hand-written attention-block kernels
  (``ops/attention_block.py``: QKV projection, attention and output
  projection in one call), for serving (:func:`self_attention`) and for
  training (:func:`self_attention_train`, K3/K4's ``autograd.Function``);
- ``flash`` — the per-head flash-attention kernels
  (``ops/flash_attention.py``) between dense projections
  (:func:`fused_attention`), as ``attention_impl: pallas`` runs on the TPU;
- ``eager`` — the plain PyTorch path, differentiated by autograd, which
  is what the kernels are checked against on the card.

On a CPU tensor each kernel wrapper runs its plain version.
"""

from __future__ import annotations

import math

import torch

# _NEG of pl_bert_tpu/ops/attention_block.py:51 — a finite "minus
# infinity" for masked scores, so a fully masked row stays finite
NEG = -0.7 * torch.finfo(torch.float32).max

# a config's attention_impl → the path it runs; the JAX config's values
# carry over (pl_bert_tpu/models/albert.py:186-209): ``auto`` prefers the
# block as it does on the TPU, ``pallas`` is the per-head kernel, ``xla``
# the plain path
IMPL_PATHS = {
    "auto": "block", "kernel": "block", "pallas_block": "block",
    "pallas": "flash",
    "eager": "eager", "xla": "eager",
}
# the head widths the card's attention kernels are built for (both paths)
KERNEL_HEAD_DIMS = (64, 128)


def kernel_refusal(head_dim, width, dtype) -> str | None:
    """Why the card's attention kernels (block and flash alike) do not
    take a model of this head width, width and compute dtype, or None
    when they do: head_dim 64 or 128, and in bf16 a width that is a
    multiple of 8 (TMA reads rows 16-byte aligned)."""
    if head_dim not in KERNEL_HEAD_DIMS:
        return f"head_dim {head_dim} is not one of the kernels' {KERNEL_HEAD_DIMS}"
    if width % head_dim:
        return f"width {width} is not a whole number of heads of {head_dim}"
    if dtype == torch.bfloat16 and width % 8:
        return f"the bf16 kernels read rows through TMA and width {width} is no multiple of 8"
    return None


def resolve_impl(attention_impl: str, head_dim=None, width=None, dtype=None) -> str:
    """``"block"``, ``"flash"`` or ``"eager"`` for a config's
    ``attention_impl`` (see ``IMPL_PATHS``). With the model's shapes
    (``head_dim``, ``width`` = hidden size, compute ``dtype``) a kernel
    path whose kernels do not take them falls back to ``eager``, as JAX's
    ``_resolve_impl`` (pl_bert_tpu/models/albert.py:167-209) falls back
    to ``xla``; :func:`kernel_refusal` says why. Without shapes the name
    alone decides."""
    try:
        path = IMPL_PATHS[attention_impl]
    except KeyError:
        raise ValueError(
            f"unsupported attention_impl {attention_impl!r}: one of {tuple(IMPL_PATHS)}"
        ) from None
    if path != "eager" and head_dim is not None and kernel_refusal(head_dim, width, dtype):
        return "eager"
    return path


def eager_attention(q, k, v, bias=None, segment_ids=None, dtype=torch.bfloat16):
    """Plain softmax attention on [B, L, H, D] q/k/v, the counterpart of
    ``xla_attention`` (pl_bert_tpu/ops/attention.py:63-74): fp32 scores
    and softmax, probabilities cast to ``dtype`` before ``p·v``, fp32
    accumulation. ``bias`` is additive [B, 1, 1, L]; ``segment_ids``
    [B, L] makes attention block-diagonal."""
    head_dim = q.shape[-1]
    scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if bias is not None:
        scores = scores + bias.float()
    if segment_ids is not None:
        neq = segment_ids[:, None, :, None] != segment_ids[:, None, None, :]
        scores = scores.masked_fill(neq, NEG)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out_dtype = torch.promote_types(dtype, v.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", probs.float(), v.float())
    return out.to(out_dtype)


def fused_attention(q, k, v, bias=None, segment_ids=None, dtype=None,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """The per-head kernel path on [B, L, H, D] q/k/v, the counterpart of
    ``fused_attention`` (pl_bert_tpu/ops/attention.py:77-88) without its
    TPU gates: always the flash kernels (K7, and K8 under autograd), on
    any sequence length."""
    from pl_bert_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, bias, segment_ids, out_dtype=dtype,
                           dropout_rate=dropout_rate, dropout_seed=dropout_seed)


def self_attention(
    impl: str, hidden, wqkv, bqkv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=None,
):
    """The attention block on packed weights (see
    ``attention_block.pack_weights``) through ``impl``'s path."""
    from pl_bert_tpu_torch.ops import attention_block as ab

    fn = ab.attention_block_packed if impl == "block" else ab.attention_block_plain
    return fn(
        hidden, wqkv, bqkv, wo, bo, num_heads, bias=bias,
        segment_ids=segment_ids, out_dtype=out_dtype,
    )


def round_to(w, dtype):
    """``w`` rounded to ``dtype`` and back, with the gradient passed
    straight through in ``w``'s dtype: the plain training path reads the
    weights at the kernels' precision and returns fp32 gradients."""
    if w.dtype == dtype:
        return w
    return w + (w.detach().to(dtype).to(w.dtype) - w.detach())


def self_attention_train(
    impl: str, hidden, w: dict, num_heads: int, bias=None, segment_ids=None,
    dropout_rate: float = 0.0, dropout_seed=None,
):
    """The attention block of a training forward through ``impl``'s path.
    ``w`` is a training weight set (``AlbertSelfAttention.train_weights``):
    fp32 ``wqkv32``/``bqkv``/``wo32``/``bo`` and the compute-dtype copies
    ``wqkv``/``wo``. Both paths drop the same attention probabilities."""
    from pl_bert_tpu_torch.ops import attention_block as ab

    if impl == "block":
        return ab.attention_block_train(
            hidden, w["wqkv32"], w["bqkv"], w["wo32"], w["bo"], w["wqkv"], w["wo"],
            num_heads, bias=bias, segment_ids=segment_ids, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed,
        )
    cdt = hidden.dtype
    return ab.attention_block_plain(
        hidden, round_to(w["wqkv32"], cdt), w["bqkv"], round_to(w["wo32"], cdt), w["bo"],
        num_heads, bias=bias, segment_ids=segment_ids, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
    )

"""Attention dispatch and the plain eager attention.

The counterpart of ``pl_bert_tpu/ops/attention.py``. There, the TPU
gates (``_on_tpu``, ``fused_block_supported``) choose between the
Pallas kernels and XLA einsum attention. Here, the model's
``attention_impl`` chooses between the hand-written attention-block
kernels (``ops/attention_block.py``; on a CPU tensor its wrappers run
the plain versions) and the plain PyTorch path on every device, which is
what the kernels are checked against on the card: for serving
(:func:`self_attention`) and for training (:func:`self_attention_train`,
where the kernel path is K3/K4's ``autograd.Function`` and the plain
path is differentiated by autograd).
"""

from __future__ import annotations

import math

import torch

# _NEG of pl_bert_tpu/ops/attention_block.py:51 — a finite "minus
# infinity" for masked scores, so a fully masked row stays finite
NEG = -0.7 * torch.finfo(torch.float32).max

EAGER_IMPLS = ("eager", "xla")
KERNEL_IMPLS = ("auto", "kernel", "pallas_block", "pallas")


def resolve_impl(attention_impl: str) -> str:
    """``"kernel"`` or ``"eager"`` for a config's ``attention_impl``.
    JAX config values carry over: ``xla`` is the plain path, and
    ``auto``/``pallas_block``/``pallas`` are the kernel path."""
    if attention_impl in EAGER_IMPLS:
        return "eager"
    if attention_impl in KERNEL_IMPLS:
        return "kernel"
    raise ValueError(
        f"unsupported attention_impl {attention_impl!r}: one of "
        f"{EAGER_IMPLS + KERNEL_IMPLS}"
    )


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


def self_attention(
    impl: str, hidden, wqkv, bqkv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=None,
):
    """The attention block on packed weights (see
    ``attention_block.pack_weights``) through ``impl``'s path."""
    from pl_bert_tpu_torch.ops import attention_block as ab

    fn = ab.attention_block_packed if impl == "kernel" else ab.attention_block_plain
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

    if impl == "kernel":
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

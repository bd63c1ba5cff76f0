"""Attention block: QKV projection + softmax attention + output
projection, as one hand-written CUDA kernel sequence for Hopper.

Replaces the primal-only Pallas kernels of
``pl_bert_tpu/ops/attention_block.py``: ``_fwd_kernel_light_full``
(:253-312, bf16 serving) and ``_fwd_kernel_light`` (:185-250, fp32 or
wherever the fullwidth gate refuses), both reached through
``_block_fwd_light`` (:460-529). The kernels live in
``csrc/attention_block.cu``; its header says what bounds them on the
card. All four projections run in the hand-written GEMM there, not in
cuBLAS.

Differences from the TPU kernel, all deliberate:

- any sequence length (key tiles are masked at the ragged edge), where
  the TPU kernel needs ``L % 128 == 0``; head_dim 64 or 128, as there;
- one kernel for bf16 and fp32 (the TPU picked a grid by VMEM size);
- the weights arrive packed once per load (``pack_weights``): Wq|Wk|Wv
  concatenated to [E, 3P] in the compute dtype, fp32 biases. The TPU
  wrapper re-cast them on every call (:469).
- attention-probability dropout is not ported yet: the serving path
  runs rate 0, and a call with ``dropout_rate > 0`` and a seed raises
  (on every device) until the training slice adds Philox-keyed dropout;
- the kernel writes its output in the compute dtype: on a CUDA tensor
  an ``out_dtype`` other than ``hidden.dtype`` raises (the model always
  asks for the compute dtype).

``attention_block_plain`` is the same function in plain PyTorch; the
wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pl_bert_tpu_torch.ops.attention import NEG, eager_attention
from pl_bert_tpu_torch.runtime import build

LAUNCHES = build.LaunchCounter("attention_block")
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _head_dim(width: int, num_heads: int) -> int:
    if width % num_heads or width // num_heads not in HEAD_DIMS:
        raise ValueError(
            f"attention_block supports head_dim {HEAD_DIMS}; got width "
            f"{width} over {num_heads} heads"
        )
    return width // num_heads


def pack_weights(wq, bq, wk, bk, wv, bv, wo, bo, dtype):
    """JAX-layout params (``wq/wk/wv`` [E, P], ``wo`` [P, E], biases
    [P]/[E]) → ``(wqkv [E, 3P], bqkv [3P] fp32, wo [P, E], bo [E] fp32)``
    with the matrices in the compute ``dtype``, contiguous."""
    wqkv = torch.cat([wq, wk, wv], dim=1).to(dtype).contiguous()
    bqkv = torch.cat([bq, bk, bv]).float().contiguous()
    return wqkv, bqkv, wo.to(dtype).contiguous(), bo.float().contiguous()


def _rows(bias, segment_ids, B: int, L: int):
    """[B, 1, 1, L] additive bias → clamped fp32 [B, L] (or None);
    [B, L] segment ids → fp32 [B, L] (or None)."""
    bias_row = None
    if bias is not None:
        bias_row = torch.clamp(bias.reshape(B, L).float(), min=NEG).contiguous()
    seg_row = None
    if segment_ids is not None:
        seg_row = segment_ids.reshape(B, L).float().contiguous()
    return bias_row, seg_row


def attention_block(
    hidden, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=torch.bfloat16,
    dropout_rate: float = 0.0, dropout_seed=None,
):
    """Fused multi-head self-attention block with the signature and
    layouts of pl_bert_tpu/ops/attention_block.py:644-688.

    ``hidden`` [B, L, E] in the compute dtype; ``wq/wk/wv`` [E, P] and
    ``wo`` [P, E]; ``bq/bk/bv`` [P] and ``bo`` [E]; ``bias`` the additive
    [B, 1, 1, L] padding bias or None; ``segment_ids`` [B, L] or None.
    Returns ``dense(attn(x))`` [B, L, E] in ``out_dtype`` (the residual
    add, dropout and LayerNorm happen outside). Packs the weights on
    every call: callers that hold weights across calls pack them once
    and call :func:`attention_block_packed`."""
    packed = pack_weights(wq, bq, wk, bk, wv, bv, wo, bo, hidden.dtype)
    return attention_block_packed(
        hidden, *packed, num_heads, bias=bias, segment_ids=segment_ids,
        out_dtype=out_dtype, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
    )


def attention_block_packed(
    hidden, wqkv, bqkv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=None,
    dropout_rate: float = 0.0, dropout_seed=None,
):
    """:func:`attention_block` on weights from :func:`pack_weights`.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if dropout_seed is not None and dropout_rate > 0.0:
        raise NotImplementedError(
            "attention-probability dropout is not ported yet (serving runs "
            "rate 0; the training slice adds it to the kernel)"
        )
    if hidden.device.type == "cpu":
        return attention_block_plain(
            hidden, wqkv, bqkv, wo, bo, num_heads, bias=bias,
            segment_ids=segment_ids, out_dtype=out_dtype,
        )
    if hidden.device.type != "cuda":
        raise ValueError(f"attention_block runs on cpu or cuda, not {hidden.device}")
    return _launch(hidden, wqkv, bqkv, wo, bo, num_heads, bias, segment_ids, out_dtype)


def attention_block_plain(
    hidden, wqkv, bqkv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=None,
):
    """The kernel's function in plain PyTorch, with the TPU kernel's
    rounding points: q/k/v rounded to the compute dtype after an fp32
    bias add, probabilities rounded before ``p·v``, the context rounded,
    ``bo`` added in fp32 before the one cast to ``out_dtype``."""
    B, L, E = hidden.shape
    P = wo.shape[0]
    D = _head_dim(P, num_heads)
    cdt = hidden.dtype
    out_dtype = out_dtype or cdt
    bias_row, _ = _rows(bias, None, B, L)
    qkv = torch.addmm(bqkv.float(), hidden.reshape(B * L, E).float(), wqkv.float())
    q, k, v = (t.reshape(B, L, num_heads, D) for t in qkv.to(cdt).split(P, dim=1))
    ctx = eager_attention(
        q, k, v,
        None if bias_row is None else bias_row[:, None, None, :],
        None if segment_ids is None else segment_ids.reshape(B, L),
        dtype=cdt,
    )
    out = torch.addmm(bo.float(), ctx.reshape(B * L, P).float(), wo.float())
    return out.to(out_dtype).reshape(B, L, E)


@functools.cache
def _entry():
    """The C entry point, built and typed at first use."""
    fn = build.load("attention_block").plbt_attention_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(hidden, wqkv, bqkv, wo, bo, num_heads, bias, segment_ids, out_dtype):
    B, L, E = hidden.shape
    P = wo.shape[0]
    _head_dim(P, num_heads)
    cdt = hidden.dtype
    if cdt not in _DTYPE_CODES:
        raise TypeError(f"attention_block kernel takes float32/bfloat16, got {cdt}")
    if out_dtype not in (None, cdt):
        raise NotImplementedError(
            f"attention_block kernel writes {cdt}; out_dtype {out_dtype} is not built"
        )
    dev = hidden.device
    expect = {
        "wqkv": (wqkv, (E, 3 * P), cdt), "bqkv": (bqkv, (3 * P,), torch.float32),
        "wo": (wo, (P, E), cdt), "bo": (bo, (E,), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(
                f"attention_block {name}: expected {shape} {dtype} on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"attention_block {name} must be contiguous")
    x = hidden.contiguous()
    bias_row, seg_row = _rows(bias, segment_ids, B, L)
    for name, t in (("bias", bias_row), ("segment_ids", seg_row)):
        if t is not None and t.device != dev:
            raise ValueError(f"attention_block {name} is on {t.device}, hidden on {dev}")
    qkv = torch.empty((B * L, 3 * P), dtype=cdt, device=dev)
    ctx = torch.empty((B * L, P), dtype=cdt, device=dev)
    out = torch.empty((B, L, E), dtype=cdt, device=dev)
    fn = _entry()
    with torch.cuda.device(dev):
        status = fn(
            _ptr(x), _ptr(wqkv), _ptr(bqkv), _ptr(wo), _ptr(bo),
            _ptr(bias_row), _ptr(seg_row), _ptr(qkv), _ptr(ctx), _ptr(out),
            B, L, E, P, num_heads, _DTYPE_CODES[cdt],
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
        )
    build.check(status, "attention_block kernel")
    LAUNCHES.add()
    return out

"""Per-head flash attention, forward and backward, as hand-written CUDA
kernels for Hopper.

Replaces the Pallas kernels of ``pl_bert_tpu/ops/flash_attention.py``,
which the model runs where ``attention_impl`` is ``pallas``: the query,
key and value projections are dense layers outside the kernel, the
kernel computes ``softmax(q·kᵀ/√D + bias)·v`` per (batch, head), and the
output projection follows.

- K7, the forward ``_fwd_kernel`` (:47-70) via ``_flash_fwd`` (:157-170):
  :func:`flash_attention_fwd`;
- K8, the backward ``_bwd_kernel`` (:73-117) via ``_flash_bwd``
  (:173-189): :func:`flash_attention_bwd`. :class:`FlashAttentionFunction`
  joins them under autograd, and :func:`flash_attention` has the TPU
  wrapper's signature (:195-232).

The kernels live in ``csrc/flash_attention.cu`` (its header says what
bounds them on the card) on the tile code of ``csrc/attention_tiles.cuh``,
which the attention block shares. The custom-VJP contract is the TPU's:
the forward saves q, k, v, the bias and segment rows and the seed, no
statistics and no mask; the backward recomputes them. Dropout is the
Philox stream of the attention block (``attention_block.philox_bits``),
keyed by (seed, b·H + h) at (row, column), so with one seed the flash
path and the block path drop the same probabilities.

Differences from the TPU kernels, all deliberate:

- any sequence length (``pl_bert_tpu/ops/attention.py:44`` needs
  ``L % 128 == 0``, a TPU tiling gate); head_dim 64 or 128 (the TPU
  takes any multiple of 64) — another width raises here, and the model
  sends it to the eager path when it is built (``attention.resolve_impl``);
- q, k, v are read in their [B, L, H, D] layout, also as views of one
  fused projection, so the fold to [B·H, L, D] (:225-232) is never made;
- no bias or no segments means no row is passed (the TPU passes zeros);
- the kernels write the compute dtype: on a CUDA tensor an ``out_dtype``
  other than ``q.dtype`` raises;
- in bf16 both kernels run on the tensor cores and read q, k, v (and
  do) through TMA: a base or a row distance that is not a multiple of 16
  bytes raises. The backward's recomputed row max and denominator are
  the block forward's saved ones bit for bit (:func:`_launch_bwd` returns
  them for that check).

Each kernel has a plain PyTorch version with the TPU kernel's rounding
points beside it; a wrapper takes the plain version for CPU tensors only.
"""

from __future__ import annotations

import math

import torch

from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.ops.attention import KERNEL_HEAD_DIMS, NEG
from pl_bert_tpu_torch.runtime import build

LAUNCHES = build.LaunchCounter("flash_attention")  # K7
LAUNCHES_BWD = build.LaunchCounter("flash_attention_bwd")  # K8


# --- plain versions -----------------------------------------------------------


def _probs(q, k, bias_row, seg_row):
    """fp32 (fp64 for fp64 inputs) normalised probabilities [B, H, L, L]
    as the kernels form them: q·k summed in the accumulation type, times
    the scale, plus the key's padding bias; other segments at NEG; the
    softmax normalised before any rounding."""
    acc = torch.promote_types(torch.float32, q.dtype)
    D = q.shape[-1]
    s = torch.einsum("blhd,bmhd->bhlm", q.to(acc), k.to(acc)) * (1.0 / math.sqrt(D))
    if bias_row is not None:
        s = s + bias_row[:, None, None, :]
    if seg_row is not None:
        s = s.masked_fill(seg_row[:, None, :, None] != seg_row[:, None, None, :], NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def flash_attention_plain(q, k, v, bias_row=None, seg_row=None, dropout_rate: float = 0.0,
                          dropout_seed=None, keep=None, out_dtype=None):
    """K7's function in plain PyTorch on [B, L, H, D], with the TPU
    kernel's rounding points: the normalised, dropped-out probabilities
    are rounded to v's dtype before ``p·v``, summed in fp32, and the
    output rounded once (to ``out_dtype``, default q's dtype).
    ``bias_row``/``seg_row`` as made by ``attention_block.rows``;
    ``keep``: a [B, H, L, L] mask to drop with instead of the kernels'
    own (``attention_block.dropout_keep``)."""
    B, L, H, _ = q.shape
    acc = torch.promote_types(torch.float32, q.dtype)
    pd = ab._drop(_probs(q, k, bias_row, seg_row), keep, dropout_rate, dropout_seed, B, H, L)
    out = torch.einsum("bhlm,bmhd->blhd", pd.to(v.dtype).to(acc), v.to(acc))
    return out.to(out_dtype or q.dtype)


def flash_attention_bwd_plain(dout, q, k, v, bias_row=None, seg_row=None,
                              dropout_rate: float = 0.0, dropout_seed=None, keep=None):
    """K8's function in plain PyTorch, in the formulas of ``_bwd_kernel``
    (:83-117): p and the mask recomputed; ``dv = pdᵀ·do`` with pd rounded
    to v's dtype; ``dpd = do·vᵀ``; ``delta = Σ_j dpd·pd`` with the
    unrounded pd; ``ds = ((pd·dpd − p·delta)·scale)`` rounded to q's
    dtype before ``dq = ds·k`` and ``dk = dsᵀ·q``. Returns (dq, dk, dv) in
    the inputs' dtypes."""
    B, L, H, D = q.shape
    acc = torch.promote_types(torch.float32, q.dtype)
    do = dout.to(acc)
    p = _probs(q, k, bias_row, seg_row)
    pd = ab._drop(p, keep, dropout_rate, dropout_seed, B, H, L)
    dv = torch.einsum("bhlm,blhd->bmhd", pd.to(v.dtype).to(acc), do)
    dpd = torch.einsum("blhd,bmhd->bhlm", do, v.to(acc))
    delta = (dpd * pd).sum(dim=-1, keepdim=True)
    ds = ((pd * dpd - p * delta) * (1.0 / math.sqrt(D))).to(q.dtype).to(acc)
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k.to(acc))
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- wrappers -----------------------------------------------------------------


def flash_attention_fwd(q, k, v, bias_row=None, seg_row=None, dropout_rate: float = 0.0,
                        dropout_seed=None, out_dtype=None):
    """K7: [B, L, H, D] attention output in q's dtype. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias_row, seg_row, dropout_rate, dropout_seed,
                                     out_dtype=out_dtype)
    B, L, H, D = _check(q, k, v, bias_row, seg_row)
    if out_dtype not in (None, q.dtype):
        raise NotImplementedError(
            f"flash_attention kernel writes {q.dtype}; out_dtype {out_dtype} is not built"
        )
    q, k, v = (_rows_view(t) for t in (q, k, v))
    _check_tma(q=q, k=k, v=v)
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    fn = _entry("plbt_flash_attention_fwd", 6, 9)
    with torch.cuda.device(q.device):
        status = fn(
            ab._ptr(q), ab._ptr(k), ab._ptr(v), ab._ptr(bias_row), ab._ptr(seg_row),
            ab._ptr(out), B, L, H, D, q.stride(1), k.stride(1), v.stride(1), out.stride(1),
            ab._DTYPE_CODES[q.dtype], *ab._dropout_args(dropout_rate, dropout_seed),
            ab._stream(q.device),
        )
    build.check(status, "flash_attention kernel")
    LAUNCHES.add()
    return out


def flash_attention_bwd(dout, q, k, v, bias_row=None, seg_row=None,
                        dropout_rate: float = 0.0, dropout_seed=None):
    """K8: ``(dq, dk, dv)`` in the inputs' dtypes from ``dout`` [B, L, H, D]
    and the forward's inputs. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernels or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(dout, q, k, v, bias_row, seg_row, dropout_rate,
                                         dropout_seed)
    return _launch_bwd(dout, q, k, v, bias_row, seg_row, dropout_rate, dropout_seed)[:3]


def _launch_bwd(dout, q, k, v, bias_row, seg_row, dropout_rate, dropout_seed):
    """K8 on CUDA tensors: ``(dq, dk, dv, m, l)``, with the row max and
    denominator [B, H, L] fp32 that the dq kernel's first pass recomputed
    (rows past a batch item's L are not written)."""
    B, L, H, D = _check(q, k, v, bias_row, seg_row)
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(
            f"flash_attention dout: expected {tuple(q.shape)} {q.dtype} on {q.device}, got "
            f"{tuple(dout.shape)} {dout.dtype} on {dout.device}"
        )
    q, k, v, dout = (_rows_view(t) for t in (q, k, v, dout))
    _check_tma(q=q, k=k, v=v, dout=dout)
    dev = q.device
    dq, dk, dv = (torch.empty((B, L, H, D), dtype=q.dtype, device=dev) for _ in range(3))
    # scratch: the recomputed row max and denominator, and delta; in fp32
    # the CUDA-core kernels' ds and keep bits (the bf16 ones keep both on
    # the chip)
    m, den, delta = (torch.empty((B, H, L), dtype=torch.float32, device=dev) for _ in range(3))
    ds = keep_bits = None
    if q.dtype == torch.float32:
        ds, keep_bits = ab.bwd_scratch(B, H, L, q.dtype, dev, dropout_rate, dropout_seed)
    fn = _entry("plbt_flash_attention_bwd", 14, 9)
    with torch.cuda.device(dev):
        status = fn(
            ab._ptr(q), ab._ptr(k), ab._ptr(v), ab._ptr(dout), ab._ptr(bias_row),
            ab._ptr(seg_row), ab._ptr(m), ab._ptr(den), ab._ptr(delta), ab._ptr(ds),
            ab._ptr(keep_bits), ab._ptr(dq), ab._ptr(dk), ab._ptr(dv), B, L, H, D, q.stride(1),
            k.stride(1), v.stride(1), dout.stride(1), ab._DTYPE_CODES[q.dtype],
            *ab._dropout_args(dropout_rate, dropout_seed), ab._stream(dev),
        )
    build.check(status, "flash_attention backward kernel")
    LAUNCHES_BWD.add()
    return dq, dk, dv, m, den


class FlashAttentionFunction(torch.autograd.Function):
    """K7 forward, K8 backward under autograd (their plain versions on
    CPU tensors). Saves q, k, v and the bias and segment rows; the seed
    and the rate ride along as Python numbers. No statistics, no mask."""

    @staticmethod
    def forward(ctx, q, k, v, bias_row, seg_row, dropout_rate, dropout_seed, out_dtype):
        ctx.save_for_backward(q, k, v, bias_row, seg_row)
        ctx.args = (dropout_rate, dropout_seed)
        return flash_attention_fwd(q, k, v, bias_row, seg_row, dropout_rate, dropout_seed,
                                   out_dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias_row, seg_row = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(dout.to(q.dtype), q, k, v, bias_row, seg_row,
                                         *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, bias=None, segment_ids=None, out_dtype=None,
                    dropout_rate: float = 0.0, dropout_seed=None):
    """``softmax(q·kᵀ/√D + bias)·v`` for [B, L, H, D] inputs, with the
    signature of pl_bert_tpu/ops/flash_attention.py:195-232.

    ``bias`` is the additive [B, 1, 1, L] padding bias or None;
    ``segment_ids`` ([B, L] integers, −1 at padding) makes attention
    block-diagonal across packed segments; ``dropout_seed`` an int
    (None means rate 0). Returns [B, L, H, D] in ``out_dtype`` (default
    q's dtype), differentiable in q, k and v through K8."""
    B, L = q.shape[:2]
    bias_row, seg_row = ab.rows(bias, segment_ids, B, L)
    if dropout_seed is None:
        dropout_rate = 0.0
    return FlashAttentionFunction.apply(
        q, k, v, bias_row, seg_row, float(dropout_rate), dropout_seed, out_dtype
    )


# --- kernel launches ----------------------------------------------------------


def _entry(name: str, n_ptrs: int, n_ints: int):
    return ab._entry(name, n_ptrs, n_ints, ab._DROPOUT_ARGTYPES, lib="flash_attention")


def _check(q, k, v, bias_row, seg_row) -> tuple[int, int, int, int]:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if q.dtype not in ab._DTYPE_CODES:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16, got {q.dtype}")
    if q.dim() != 4 or q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"flash_attention supports [B, L, H, D] inputs with D in {KERNEL_HEAD_DIMS}; "
            f"got {tuple(q.shape)}"
        )
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(
                f"flash_attention {name}: expected {tuple(q.shape)} {q.dtype} on {q.device}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    B, L, H, D = q.shape
    ab._check_rows(q.device, B, L, bias_row, seg_row)
    return B, L, H, D


def _check_tma(**tensors) -> None:
    """The bf16 kernels read their inputs through TMA: each base and row
    distance a multiple of 16 bytes."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and (t.data_ptr() % 16 or t.stride(1) % 8):
            raise ValueError(f"flash_attention bf16 kernels read {name} through TMA: base "
                             "and row distance must be multiples of 16 bytes")


def _rows_view(t):
    """``t`` [B, L, H, D] as the kernels read it: a head's D columns
    contiguous, heads side by side, batch items L rows apart. A view of a
    fused projection's section already is (rows further apart than H·D);
    anything else is copied."""
    B, L, H, D = t.shape
    ok = (t.stride(3) == 1 and t.stride(2) == D and t.stride(1) >= H * D
          and (B == 1 or t.stride(0) == L * t.stride(1)))
    return t if ok else t.contiguous()

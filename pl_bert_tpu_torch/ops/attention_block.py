"""Attention block: QKV projection + softmax attention + output
projection, forward and backward, as hand-written CUDA kernels for Hopper.

Replaces the Pallas kernels of ``pl_bert_tpu/ops/attention_block.py``:

- K1/K2, the primal-only forward ``_fwd_kernel_light_full`` (:253-312,
  bf16 serving) and ``_fwd_kernel_light`` (:185-250), both reached
  through ``_block_fwd_light`` (:460-529): :func:`attention_block_packed`;
- K3, the training forward ``_fwd_kernel`` (:116-182) via ``_block_fwd``
  (:532-583), which saves what the backward needs: :func:`train_forward`;
- K4, its backward ``_bwd_kernel`` (:315-413) via ``_block_bwd``
  (:586-638): :func:`train_backward`. :class:`AttentionBlockFunction`
  joins the two under autograd.

The kernels live in ``csrc/attention_block.cu`` with
``csrc/gemm_sm90.cuh`` (the GEMMs) and ``csrc/attention_tiles.cuh`` (the
attention kernels, shared with ``ops/flash_attention.py``); the first's
header says what bounds them on the card. In bf16 the forward (K1, K3)
runs on the tensor cores (``wgmma`` fed by TMA, for the projections and
the attention alike), and so does the backward's last projection; the
backward's attention and ``do`` projection stay on the CUDA cores, whose
FMA chains reproduce the plain version's cuBLAS fp32 sums (the header of
``attention_block.cu`` says why): a delta pass, a dk/dv kernel that
writes the rounded ds once to a scratch, and dq as a GEMM over it
(:func:`bwd_scratch`), all on one register-blocked micro-tile that keeps
every sum's order. fp32 runs on the CUDA cores. All
projections, forward and backward (``do = dout·Woᵀ``,
``dx = [dq|dk|dv]·[Wq|Wk|Wv]ᵀ``), run in the hand-written GEMMs there,
not in cuBLAS. The weight and bias gradients are plain matmuls and sums
outside the kernels, as the TPU left them to XLA (:626-637).

The light and the training forward run the same kernels, so they return
identical values. Attention-probability dropout is a Philox4x32-10 keyed
by (seed, b·heads + head) with the counter at (query row, key column),
the TPU's stream numbering (:161); the backward regenerates the mask.
:func:`philox_bits` computes the same bits in PyTorch, so the plain
versions here drop exactly the elements the kernels drop.

Differences from the TPU kernels, all deliberate:

- any sequence length (key tiles are masked at the ragged edge), where
  the TPU kernel needs ``L % 128 == 0``; head_dim 64 or 128, as there;
- one design for bf16 and fp32 (the TPU picked a grid by VMEM size),
  bf16 on the tensor cores and fp32 on the CUDA cores;
- the bf16 kernels read through TMA, which needs 16-byte-aligned bases
  and row strides: on a CUDA tensor a width ``E`` that is not a multiple
  of 8, or a misaligned input or weight, raises;
- the serving weights arrive packed once per load (``pack_weights``):
  Wq|Wk|Wv concatenated to [E, 3P] in the compute dtype, fp32 biases;
- the training forward saves the row max and denominator as two fp32
  [B, H, L] arrays, and q/k/v and the context as the [B·L, 3P] and
  [B·L, P] tensors the forward writes anyway (the TPU: ``md`` [B,G,L,8]
  and q2/k2/v2/o2);
- the kernels write the compute dtype, or fp32 (the tensor-parallel
  shard's partial output, ``pl_bert_tpu/parallel/tp.py:101``): on a CUDA
  tensor any other ``out_dtype`` raises.

Each kernel has a plain PyTorch version with the TPU kernel's rounding
points beside it; a wrapper takes the plain version for CPU tensors only.
The plain backward is written out from the saved tensors in the formulas
of ``_bwd_kernel``, not derived by autograd, in one pass
(:func:`attention_backward_plain`) and stage by stage as the CUDA-core
kernels split it (:func:`attention_delta_plain`,
:func:`attention_dkdv_plain`, :func:`attention_dq_plain`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pl_bert_tpu_torch.ops.attention import KERNEL_HEAD_DIMS, NEG
from pl_bert_tpu_torch.runtime import build

LAUNCHES = build.LaunchCounter("attention_block")  # K1/K2, the light forward
LAUNCHES_TRAIN = build.LaunchCounter("attention_block_train")  # K3
LAUNCHES_BWD = build.LaunchCounter("attention_block_bwd")  # K4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF


def _head_dim(width: int, num_heads: int) -> int:
    if width % num_heads or width // num_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"attention_block supports head_dim {KERNEL_HEAD_DIMS}; got width "
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


def rows(bias, segment_ids, B: int, L: int):
    """[B, 1, 1, L] additive bias → clamped fp32 [B, L] (or None);
    [B, L] segment ids → fp32 [B, L] (or None)."""
    bias_row = None
    if bias is not None:
        bias_row = torch.clamp(bias.reshape(B, L).float(), min=NEG).contiguous()
    seg_row = None
    if segment_ids is not None:
        seg_row = segment_ids.reshape(B, L).float().contiguous()
    return bias_row, seg_row


# --- dropout ----------------------------------------------------------------


def dropout_threshold(rate: float) -> int:
    """An element is kept when its 32 random bits exceed this."""
    return min(int(rate * 2**32), _MASK32)


def _mulhilo(m: int, c):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m``
    and int64 tensor ``c`` < 2^32, without leaving int64's range."""
    t = (m & 0xFFFF) * c
    u = (m >> 16) * c
    hi = (u + (t >> 16)) >> 16
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    return hi, lo


def philox_bits(seed: int, stream, q, k):
    """First word of Philox4x32-10 at counter (q, k, 0, 0) under key
    (seed, stream) — the function ``philox_word0`` of
    ``csrc/philox.cuh``, on broadcastable int64 tensors (or ints)."""
    c0, c1 = q & _MASK32, k & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0 = torch.full_like(c0, seed & _MASK32)
    k1 = stream & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c0


def dropout_keep(seed: int, rate: float, B: int, H: int, L: int, device="cpu"):
    """The kernels' attention-dropout keep mask [B, H, L, L] (bool), in
    plain PyTorch: stream b·H + h, counter (query row, key column)."""
    ar = functools.partial(torch.arange, device=device, dtype=torch.int64)
    stream = ar(B * H).reshape(B, H, 1, 1)
    bits = philox_bits(int(seed), stream, ar(L).reshape(1, 1, L, 1), ar(L).reshape(1, 1, 1, L))
    return bits > dropout_threshold(rate)


def dropout_mask(seed: int, rate: float, B: int, H: int, L: int, device):
    """The same keep mask made by the CUDA code the kernels use
    (``plbt_attention_dropout_mask``), for checks on the card; uint8."""
    out = torch.empty((B, H, L, L), dtype=torch.uint8, device=device)
    fn = _entry("plbt_attention_dropout_mask", 1, 3, (ctypes.c_uint, ctypes.c_uint))
    with torch.cuda.device(device):
        status = fn(_ptr(out), B, H, L, int(seed) & _MASK32, dropout_threshold(rate),
                    _stream(device))
    build.check(status, "attention dropout mask")
    return out


def _dropout_args(rate: float, seed) -> tuple:
    """(on, seed, thresh, inv_keep) for the C entry points."""
    if seed is None or rate <= 0.0:
        return 0, 0, 0, 1.0
    return 1, int(seed) & _MASK32, dropout_threshold(rate), 1.0 / (1.0 - rate)


# --- forward ------------------------------------------------------------------


def attention_block(
    hidden, wq, bq, wk, bk, wv, bv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=torch.bfloat16,
    dropout_rate: float = 0.0, dropout_seed=None,
):
    """Fused multi-head self-attention block with the signature and
    layouts of pl_bert_tpu/ops/attention_block.py:644-688.

    ``hidden`` [B, L, E] in the compute dtype; ``wq/wk/wv`` [E, P] and
    ``wo`` [P, E]; ``bq/bk/bv`` [P] and ``bo`` [E]; ``bias`` the additive
    [B, 1, 1, L] padding bias or None; ``segment_ids`` [B, L] or None;
    ``dropout_seed`` an int (dropout runs only with a seed and a rate).
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
    """The light forward (K1/K2) on weights from :func:`pack_weights`.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises. Either way a head_dim the kernels are not built for
    raises (the plain version itself takes any)."""
    _head_dim(wo.shape[0], num_heads)
    if hidden.device.type == "cpu":
        return attention_block_plain(
            hidden, wqkv, bqkv, wo, bo, num_heads, bias=bias,
            segment_ids=segment_ids, out_dtype=out_dtype,
            dropout_rate=dropout_rate, dropout_seed=dropout_seed,
        )
    _check_device(hidden)
    bias_row, seg_row = rows(bias, segment_ids, *hidden.shape[:2])
    out, _ = _launch_fwd(hidden, wqkv, bqkv, wo, bo, num_heads, bias_row, seg_row,
                         dropout_rate, dropout_seed, save=False, out_dtype=out_dtype)
    return out


def attention_block_plain(
    hidden, wqkv, bqkv, wo, bo, num_heads: int,
    bias=None, segment_ids=None, out_dtype=None,
    dropout_rate: float = 0.0, dropout_seed=None, keep=None,
):
    """The light forward's function in plain PyTorch, at any head_dim;
    differentiable, so it is also the eager training path. ``keep``: a
    [B, H, L, L] mask to drop with instead of the kernels' own
    (:func:`dropout_keep`)."""
    B, L, _ = hidden.shape
    bias_row, seg_row = rows(bias, segment_ids, B, L)
    out, _ = train_forward_plain(
        hidden, wqkv, bqkv, wo, bo, num_heads, bias_row, seg_row,
        dropout_rate, dropout_seed, keep=keep, out_dtype=out_dtype,
    )
    return out


def train_forward(hidden, wqkv, bqkv, wo, bo, num_heads: int, bias_row=None,
                  seg_row=None, dropout_rate: float = 0.0, dropout_seed=None, out_dtype=None):
    """The training forward (K3): ``(out [B, L, E], saved)`` with saved
    = ``(qkv [B·L, 3P], ctx [B·L, P], m [B, H, L], l [B, H, L])``, what
    :func:`train_backward` needs; ``out`` in ``out_dtype`` (the compute
    dtype, or fp32). ``bias_row``/``seg_row`` as made by :func:`rows`. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernels
    or raises; a head_dim the kernels are not built for raises on either."""
    _head_dim(wo.shape[0], num_heads)
    if hidden.device.type == "cpu":
        return train_forward_plain(hidden, wqkv, bqkv, wo, bo, num_heads, bias_row,
                                   seg_row, dropout_rate, dropout_seed, out_dtype=out_dtype)
    _check_device(hidden)
    return _launch_fwd(hidden, wqkv, bqkv, wo, bo, num_heads, bias_row, seg_row,
                       dropout_rate, dropout_seed, save=True, out_dtype=out_dtype)


def _scores(qkv, num_heads: int, bias_row, seg_row, B: int, L: int):
    """(q, k, v [B, L, H, D] in the compute dtype, fp32 scores [B, H, L, L])
    as the kernels form them: q·k summed in fp32, times the scale, plus
    the key's padding bias; other segments at NEG."""
    P = qkv.shape[1] // 3
    D = P // num_heads
    q, k, v = (t.reshape(B, L, num_heads, D) for t in qkv.split(P, dim=1))
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * (1.0 / math.sqrt(D))
    if bias_row is not None:
        s = s + bias_row[:, None, None, :]
    if seg_row is not None:
        s = s.masked_fill(seg_row[:, None, :, None] != seg_row[:, None, None, :], NEG)
    return q, k, v, s


def softmax_stats_plain(qkv, num_heads: int, B: int, L: int, bias_row=None, seg_row=None):
    """The row max and denominator [B, H, L] that K3 saves, in plain
    PyTorch from a qkv buffer [B·L, 3P]. Checks hand it the kernels' own
    qkv, so that they hold the statistics on the q and k the kernel read:
    the bf16 projection sums on the tensor cores and rounds qkv one bf16
    ulp away from an fp32 GEMM's in a few elements in 10^4."""
    _, _, _, s = _scores(qkv, num_heads, bias_row, seg_row, B, L)
    m = s.amax(dim=-1)
    return m, torch.exp(s - m[..., None]).sum(dim=-1)


def _drop(p, keep, dropout_rate: float, dropout_seed, B: int, H: int, L: int):
    if dropout_seed is None or dropout_rate <= 0.0:
        return p
    if keep is None:
        keep = dropout_keep(dropout_seed, dropout_rate, B, H, L, p.device)
    return torch.where(keep.bool(), p * (1.0 / (1.0 - dropout_rate)), 0.0)


def train_forward_plain(hidden, wqkv, bqkv, wo, bo, num_heads: int, bias_row=None,
                        seg_row=None, dropout_rate: float = 0.0, dropout_seed=None,
                        keep=None, out_dtype=None):
    """K3's function in plain PyTorch, with the TPU kernel's rounding
    points: q/k/v rounded to the compute dtype after an fp32 bias add,
    the dropped-out probabilities rounded before ``p·v``, the context
    rounded, ``bo`` added in fp32 before the one cast (to ``out_dtype``,
    default the compute dtype). Returns what :func:`train_forward`
    returns."""
    B, L, E = hidden.shape
    P = wo.shape[0]
    cdt = hidden.dtype
    qkv = torch.addmm(bqkv.float(), hidden.reshape(B * L, E).float(), wqkv.float()).to(cdt)
    _, _, v, s = _scores(qkv, num_heads, bias_row, seg_row, B, L)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    pd = _drop(e / den, keep, dropout_rate, dropout_seed, B, num_heads, L)
    ctx = torch.einsum("bhlm,bmhd->blhd", pd.to(cdt).float(), v.float())
    ctx = ctx.reshape(B * L, P).to(cdt)
    out = torch.addmm(bo.float(), ctx.float(), wo.float()).to(out_dtype or cdt)
    out = out.reshape(B, L, E)
    return out, (qkv, ctx, m[..., 0], den[..., 0])


# --- backward -----------------------------------------------------------------


def train_backward(dout, hidden, wqkv, wo, saved, num_heads: int, bias_row=None,
                   seg_row=None, dropout_rate: float = 0.0, dropout_seed=None):
    """K4: ``(dx [B, L, E], dqkv [B·L, 3P])`` in the compute dtype from
    ``dout`` [B, L, E] and the training forward's ``saved``; ``dqkv`` is
    [dq|dk|dv], what the weight gradients are contracted from. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernels or
    raises; a head_dim the kernels are not built for raises on either."""
    _head_dim(wo.shape[0], num_heads)
    if dout.device.type == "cpu":
        return train_backward_plain(dout, hidden, wqkv, wo, saved, num_heads, bias_row,
                                    seg_row, dropout_rate, dropout_seed)
    _check_device(dout)
    return _launch_bwd(dout, hidden, wqkv, wo, saved, num_heads, bias_row, seg_row,
                       dropout_rate, dropout_seed)


def train_backward_plain(dout, hidden, wqkv, wo, saved, num_heads: int, bias_row=None,
                         seg_row=None, dropout_rate: float = 0.0, dropout_seed=None,
                         keep=None):
    """K4's function in plain PyTorch, written out from the saved tensors
    in the formulas of ``_bwd_kernel`` (:327-401): ``do = dout·Woᵀ``, the
    attention's backward (:func:`attention_backward_plain`), then
    ``dx = dqkv·Wqkvᵀ``, each product summed in fp32 and rounded once."""
    B, L, E = hidden.shape
    cdt = hidden.dtype
    do = (dout.reshape(B * L, E).to(cdt).float() @ wo.float().T).to(cdt)
    dqkv, _ = attention_backward_plain(do, saved, num_heads, bias_row, seg_row, dropout_rate,
                                       dropout_seed, keep)
    dx = (dqkv.float() @ wqkv.float().T).to(cdt).reshape(B, L, E)
    return dx, dqkv


def _backward_terms(do, saved, num_heads: int, bias_row, seg_row, dropout_rate, dropout_seed,
                    keep):
    """What every stage of the attention's backward forms from the saved
    tensors: ``(q, k, v, p, pd, dpd, scale)``, with ``p = exp(s − m)/l``
    from the saved statistics, ``pd`` dropped out and unrounded and
    ``dpd = do·vᵀ`` (fp32 [B, H, L, L]; q, k, v [B, L, H, D] in the
    compute dtype)."""
    qkv, _, m, den = saved
    B, _, L = m.shape
    D = qkv.shape[1] // 3 // num_heads
    do = do.reshape(B, L, num_heads, D).float()
    q, k, v, s = _scores(qkv, num_heads, bias_row, seg_row, B, L)
    p = torch.exp(s - m[..., None]) / den[..., None]
    pd = _drop(p, keep, dropout_rate, dropout_seed, B, num_heads, L)
    dpd = torch.einsum("blhd,bmhd->bhlm", do, v.float())
    return q, k, v, p, pd, dpd, 1.0 / math.sqrt(D)


def attention_delta_plain(do, saved, num_heads: int, bias_row=None, seg_row=None,
                          dropout_rate: float = 0.0, dropout_seed=None, keep=None):
    """The block backward's delta pass in plain PyTorch: ``delta = Σ_j
    dpd·pd`` [B, H, L] fp32, from the unrounded ``pd`` (what
    ``attention_bwd_delta`` computes)."""
    *_, pd, dpd, _ = _backward_terms(do, saved, num_heads, bias_row, seg_row, dropout_rate,
                                     dropout_seed, keep)
    return (dpd * pd).sum(dim=-1)


def attention_dkdv_plain(do, saved, delta, num_heads: int, bias_row=None, seg_row=None,
                         dropout_rate: float = 0.0, dropout_seed=None, keep=None):
    """The block backward's dk/dv kernel in plain PyTorch, fed ``delta``:
    ``(dk, dv, ds)`` with dk, dv [B, L, H, D] in fp32 (rounded on store by
    the kernel) and ``ds = ((pd·dpd − p·delta)·scale)`` rounded to the
    compute dtype, [B, H, L, L] (queries by keys) -- what
    ``attention_bwd_dkdv`` writes to its scratch for ``dq = ds·k`` (whose
    rows run to L rounded up to 64, the columns past L holding zeros)."""
    q, _, _, p, pd, dpd, scale = _backward_terms(do, saved, num_heads, bias_row, seg_row,
                                                 dropout_rate, dropout_seed, keep)
    cdt = saved[0].dtype
    B, L, H, D = q.shape
    ds = ((pd * dpd - p * delta[..., None]) * scale).to(cdt)
    dv = torch.einsum("bhlm,blhd->bmhd", pd.to(cdt).float(), do.reshape(B, L, H, D).float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds.float(), q.float())
    return dk, dv, ds


def attention_dq_plain(ds, saved, num_heads: int):
    """The block backward's dq GEMM in plain PyTorch: ``dq = ds·k``
    [B, L, H, D] fp32 from the ds of :func:`attention_dkdv_plain`."""
    qkv, _, m, _ = saved
    B, _, L = m.shape
    P = qkv.shape[1] // 3
    k = qkv[:, P:2 * P].reshape(B, L, num_heads, P // num_heads)
    return torch.einsum("bhlm,bmhd->blhd", ds.float(), k.float())


def attention_backward_plain(do, saved, num_heads: int, bias_row=None, seg_row=None,
                             dropout_rate: float = 0.0, dropout_seed=None, keep=None):
    """The attention part of K4's backward in plain PyTorch: ``(dqkv
    [B·L, 3P], delta [B, H, L])`` from ``do`` [B·L, P] in the compute
    dtype and the training forward's ``saved``. ``p = exp(s − m)/l`` from
    the saved statistics; the dropped-out ``pd`` rounded for ``dv``;
    ``delta = Σ_j dpd·pd`` with the unrounded ``pd``;
    ``ds = ((pd·dpd − p·delta)·scale)`` rounded before ``dq = ds·k`` and
    ``dk = dsᵀ·q``."""
    qkv, _, m, _ = saved
    B, _, L = m.shape
    P = qkv.shape[1] // 3
    D = P // num_heads
    cdt = qkv.dtype
    q, k, _, p, pd, dpd, scale = _backward_terms(do, saved, num_heads, bias_row, seg_row,
                                                 dropout_rate, dropout_seed, keep)
    dv = torch.einsum("bhlm,blhd->bmhd", pd.to(cdt).float(),
                      do.reshape(B, L, num_heads, D).float())
    delta = (dpd * pd).sum(dim=-1, keepdim=True)
    ds = ((pd * dpd - p * delta) * scale).to(cdt).float()
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k.float())
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.float())
    dqkv = torch.cat([t.reshape(B * L, P) for t in (dq, dk, dv)], dim=1).to(cdt)
    return dqkv, delta[..., 0]


class AttentionBlockFunction(torch.autograd.Function):
    """The attention block under autograd: K3 forward, K4 backward (their
    plain versions on CPU tensors).

    The inputs are the fp32 parameters in the kernel layout (``wqkv32``
    [E, 3P], ``bqkv32`` [3P], ``wo32`` [P, E], ``bo32`` [E]) and their
    compute-dtype copies ``wqkv``/``wo`` (no gradient), made once per
    model forward. The weight gradients come back in fp32, as in JAX
    where the cast sits inside the custom VJP (:544, :630-633), so
    autograd sums them over the layer's applications in fp32. The output
    is in ``out_dtype`` (the compute dtype, or fp32 for a tensor-parallel
    shard); the backward casts its cotangent to the compute dtype, as
    ``_block_bwd`` does (:594)."""

    @staticmethod
    def forward(ctx, hidden, wqkv32, bqkv32, wo32, bo32, wqkv, wo, bias_row, seg_row,
                num_heads, dropout_rate, dropout_seed, out_dtype=None):
        out, saved = train_forward(
            hidden, wqkv, bqkv32, wo, bo32, num_heads, bias_row, seg_row,
            dropout_rate, dropout_seed, out_dtype=out_dtype,
        )
        ctx.save_for_backward(hidden, wqkv, wo, bias_row, seg_row, *saved)
        ctx.args = (num_heads, dropout_rate, dropout_seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        hidden, wqkv, wo, bias_row, seg_row, *saved = ctx.saved_tensors
        num_heads, rate, seed = ctx.args
        B, L, E = hidden.shape
        dout = dout.to(hidden.dtype).contiguous()
        dx, dqkv = train_backward(dout, hidden, wqkv, wo, saved, num_heads, bias_row,
                                  seg_row, rate, seed)
        x2 = hidden.reshape(B * L, E).float()
        d2 = dout.reshape(B * L, E).float()
        dq32 = dqkv.float()
        dwqkv = x2.T @ dq32
        dwo = saved[1].float().T @ d2
        return (dx, dwqkv, dq32.sum(0), dwo, d2.sum(0),
                None, None, None, None, None, None, None, None)


def attention_block_train(hidden, wqkv32, bqkv32, wo32, bo32, wqkv, wo, num_heads: int,
                          bias=None, segment_ids=None, dropout_rate: float = 0.0,
                          dropout_seed=None, out_dtype=None):
    """The attention block with gradients through K3/K4. The fp32
    parameters come in the kernel layout (see :func:`pack_weights`);
    ``wqkv``/``wo`` are their compute-dtype copies (``hidden.dtype``),
    made once per model forward. Returns [B, L, E] in ``out_dtype`` (the
    compute dtype by default, or fp32)."""
    B, L, _ = hidden.shape
    bias_row, seg_row = rows(bias, segment_ids, B, L)
    if dropout_seed is None:
        dropout_rate = 0.0
    return AttentionBlockFunction.apply(
        hidden, wqkv32, bqkv32, wo32, bo32, wqkv, wo, bias_row, seg_row,
        num_heads, float(dropout_rate), dropout_seed, out_dtype,
    )


# --- kernel launches ----------------------------------------------------------


@functools.cache
def _entry(name: str, n_ptrs: int, n_ints: int, tail=(), lib: str = "attention_block"):
    """A C entry point of ``csrc/<lib>.cu``'s library, built and typed at
    first use: ``n_ptrs`` pointers, ``n_ints`` ints, ``tail``, the stream."""
    fn = getattr(build.load(lib), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + list(tail)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# (on, seed, thresh, inv_keep) of _dropout_args
_DROPOUT_ARGTYPES = (ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float)


def _ptr(t) -> ctypes.c_void_p | None:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_device(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"attention_block runs on cpu or cuda, not {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_block kernel takes float32/bfloat16, got {t.dtype}")


def _expect(dev, **tensors) -> None:
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(
                f"attention_block {name}: expected {shape} {dtype} on {dev}, "
                f"got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"attention_block {name} must be contiguous")


def _check_rows(dev, B: int, L: int, bias_row, seg_row) -> None:
    for name, t in (("bias", bias_row), ("segment_ids", seg_row)):
        if t is not None:
            _expect(dev, **{name: (t, (B, L), torch.float32)})


def _check_tma(width: int, **tensors) -> None:
    """The bf16 kernels load through TMA: every base and row stride a
    multiple of 16 bytes (P = heads·head_dim always is)."""
    if width % 8:
        raise ValueError(f"attention_block bf16 kernels need a width that is a multiple of 8; "
                         f"got {width}")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"attention_block bf16 kernels need {name} 16-byte aligned")


def _launch_fwd(hidden, wqkv, bqkv, wo, bo, num_heads, bias_row, seg_row, rate, seed,
                save: bool, out_dtype=None):
    B, L, E = hidden.shape
    P = wo.shape[0]
    H = num_heads
    _head_dim(P, H)
    cdt, dev = hidden.dtype, hidden.device
    out_dtype = out_dtype or cdt
    if out_dtype not in (cdt, torch.float32):
        raise NotImplementedError(
            f"attention_block kernel writes {cdt} or float32; out_dtype {out_dtype} is not built"
        )
    _expect(dev, wqkv=(wqkv, (E, 3 * P), cdt), bqkv=(bqkv, (3 * P,), torch.float32),
            wo=(wo, (P, E), cdt), bo=(bo, (E,), torch.float32))
    _check_rows(dev, B, L, bias_row, seg_row)
    x = hidden.contiguous()
    if cdt == torch.bfloat16:
        _check_tma(E, x=x, wqkv=wqkv, wo=wo)
    qkv = torch.empty((B * L, 3 * P), dtype=cdt, device=dev)
    ctx = torch.empty((B * L, P), dtype=cdt, device=dev)
    out = torch.empty((B, L, E), dtype=out_dtype, device=dev)
    m = l = None
    if save:
        m = torch.empty((B, H, L), dtype=torch.float32, device=dev)
        l = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    fn = _entry("plbt_attention_block_fwd", 12, 7, _DROPOUT_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(
            _ptr(x), _ptr(wqkv), _ptr(bqkv), _ptr(wo), _ptr(bo), _ptr(bias_row),
            _ptr(seg_row), _ptr(qkv), _ptr(ctx), _ptr(out), _ptr(m), _ptr(l),
            B, L, E, P, H, _DTYPE_CODES[cdt], int(out_dtype != cdt),
            *_dropout_args(rate, seed), _stream(dev),
        )
    build.check(status, "attention_block kernel")
    (LAUNCHES_TRAIN if save else LAUNCHES).add()
    return out, (qkv, ctx, m, l)


def bwd_scratch(B: int, H: int, L: int, dtype, device, rate: float, seed):
    """The CUDA-core backward's scratch, ``(ds, keep_bits)``: ds [B, H, Lp,
    Lp] in ``dtype`` with Lp = L rounded up to the kernels' 64-row tile
    (``ds_rows`` in ``csrc/attention_tiles.cuh``), written in full by the
    dk/dv kernel; with dropout the delta pass's keep mask [B, H, Lp, Lp/64]
    as 64-bit words (bit c of word t: key 64t + c), else None."""
    Lp = -(-L // 64) * 64
    ds = torch.empty((B, H, Lp, Lp), dtype=dtype, device=device)
    on = _dropout_args(rate, seed)[0]
    keep = torch.empty((B, H, Lp, Lp // 64), dtype=torch.int64, device=device) if on else None
    return ds, keep


def _launch_bwd(dout, hidden, wqkv, wo, saved, num_heads, bias_row, seg_row, rate, seed,
                scratch: bool = False):
    """K4 on CUDA tensors: ``(dx, dqkv)``, and with ``scratch`` also
    ``(do, delta, ds)``, the intermediates it wrote on the way (for
    checks)."""
    B, L, E = hidden.shape
    P = wo.shape[0]
    H = num_heads
    _head_dim(P, H)
    cdt, dev = hidden.dtype, hidden.device
    qkv, ctx, m, l = saved
    stats = (B, H, L)
    _expect(dev, dout=(dout, (B, L, E), cdt), wqkv=(wqkv, (E, 3 * P), cdt),
            wo=(wo, (P, E), cdt), qkv=(qkv, (B * L, 3 * P), cdt),
            m=(m, stats, torch.float32), l=(l, stats, torch.float32))
    _check_rows(dev, B, L, bias_row, seg_row)
    if cdt == torch.bfloat16:
        _check_tma(E, wqkv=wqkv)  # dx = dqkv·Wqkvᵀ reads it through TMA
    do = torch.empty((B * L, P), dtype=cdt, device=dev)
    delta = torch.empty(stats, dtype=torch.float32, device=dev)
    ds, keep_bits = bwd_scratch(B, H, L, cdt, dev, rate, seed)
    dqkv = torch.empty((B * L, 3 * P), dtype=cdt, device=dev)
    dx = torch.empty((B, L, E), dtype=cdt, device=dev)
    fn = _entry("plbt_attention_block_bwd", 14, 6, _DROPOUT_ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(
            _ptr(dout), _ptr(wqkv), _ptr(wo), _ptr(qkv), _ptr(m), _ptr(l), _ptr(bias_row),
            _ptr(seg_row), _ptr(do), _ptr(delta), _ptr(ds), _ptr(keep_bits), _ptr(dqkv),
            _ptr(dx), B, L, E, P, H, _DTYPE_CODES[cdt], *_dropout_args(rate, seed),
            _stream(dev),
        )
    build.check(status, "attention_block backward kernel")
    LAUNCHES_BWD.add()
    if scratch:
        return dx, dqkv, (do, delta, ds)
    return dx, dqkv

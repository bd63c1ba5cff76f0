"""Triton source of the fused dropout + residual add + LayerNorm kernel.

Imported only by ``fused_ln.dropout_add_layernorm`` when it launches on
a CUDA tensor (after ``runtime.build.import_triton``), because importing
this module needs ``triton``. See ``fused_ln.py`` for what the kernel
replaces and what bounds it.
"""

import triton
import triton.language as tl


@triton.jit
def _fwd_kernel(
    X, R, G, Bt, O, n_rows, H, seed, rate, scale, eps,
    HAS_DROPOUT: tl.constexpr, ROWS: tl.constexpr, BLOCK_H: tl.constexpr,
):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_H)
    col_ok = cols < H
    ok = (rows < n_rows)[:, None] & col_ok[None, :]
    offs = rows[:, None].to(tl.int64) * H + cols[None, :]
    x = tl.load(X + offs, mask=ok, other=0.0).to(tl.float32)
    if HAS_DROPOUT:
        keep = tl.rand(seed, offs.to(tl.int32)) >= rate
        x = tl.where(keep, x * scale, 0.0)
    y = x + tl.load(R + offs, mask=ok, other=0.0).to(tl.float32)
    mean = tl.sum(y, axis=1) / H
    centred = tl.where(ok, y - mean[:, None], 0.0)
    var = tl.sum(centred * centred, axis=1) / H
    rstd = 1.0 / tl.sqrt(var + eps)
    gamma = tl.load(G + cols, mask=col_ok, other=0.0).to(tl.float32)
    beta = tl.load(Bt + cols, mask=col_ok, other=0.0).to(tl.float32)
    out = centred * rstd[:, None] * gamma[None, :] + beta[None, :]
    tl.store(O + offs, out.to(O.dtype.element_ty), mask=ok)


def launch(x, res, gamma, beta, out, seed: int, rate: float, eps: float):
    """One program per block of rows of [N, H] ``x``; the block holds
    ``ROWS × next_pow2(H)`` elements, at most 4096."""
    n_rows, H = x.shape
    block_h = triton.next_power_of_2(H)
    rows = max(1, min(16, 4096 // block_h))
    grid = (triton.cdiv(n_rows, rows),)
    _fwd_kernel[grid](
        x, res, gamma, beta, out, n_rows, H, seed, rate,
        1.0 / (1.0 - rate) if rate > 0.0 else 1.0, eps,
        HAS_DROPOUT=rate > 0.0, ROWS=rows, BLOCK_H=block_h,
        num_warps=4 if rows * block_h <= 2048 else 8,
    )

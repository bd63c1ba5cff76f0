"""Triton source of the fused dropout + residual add + LayerNorm forward
(K5), and two kernels for checks: its keep mask alone, and the uniform
floats behind it.

Imported only by ``fused_ln`` when it launches on a CUDA tensor (after
``runtime.build.import_triton``), because importing this module needs
``triton``. See ``fused_ln.py`` for what the kernel replaces and what
bounds it. The forward draws the dropout mask as ``tl.rand(seed, offset)
>= rate`` with the element's flat int32 offset; the backward (K6, CUDA
C++ in ``csrc/fused_ln.cu``) regenerates that mask bit for bit, and the
copy anchor (K9) lives there too.
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


@triton.jit
def _mask_kernel(K, n, seed, rate, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    ok = offs < n
    keep = tl.rand(seed, offs) >= rate
    tl.store(K + offs, keep.to(tl.uint8), mask=ok)


@triton.jit
def _rand_kernel(U, n, seed, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    tl.store(U + offs, tl.rand(seed, offs), mask=offs < n)


def _shape(H: int):
    """(rows per block, padded width, warps): a block holds
    ``ROWS × next_pow2(H)`` elements, at most 4096."""
    block_h = triton.next_power_of_2(H)
    rows = max(1, min(16, 4096 // block_h))
    return rows, block_h, 4 if rows * block_h <= 2048 else 8


def launch(x, res, gamma, beta, out, seed: int, rate: float, eps: float):
    """K5: one program per block of rows of [N, H] ``x``."""
    n_rows, H = x.shape
    rows, block_h, warps = _shape(H)
    _fwd_kernel[(triton.cdiv(n_rows, rows),)](
        x, res, gamma, beta, out, n_rows, H, seed, rate,
        1.0 / (1.0 - rate) if rate > 0.0 else 1.0, eps,
        HAS_DROPOUT=rate > 0.0, ROWS=rows, BLOCK_H=block_h, num_warps=warps,
    )


def launch_mask(keep, seed: int, rate: float):
    """K5's keep mask (uint8, flat) at ``seed``, for checks."""
    n = keep.numel()
    _mask_kernel[(triton.cdiv(n, 1024),)](keep, n, seed, rate, BLOCK=1024)


def launch_rand(u, seed: int):
    """``tl.rand(seed, offset)`` at the flat offsets of ``u`` (fp32), the
    uniform floats behind K5's mask, for checks."""
    n = u.numel()
    _rand_kernel[(triton.cdiv(n, 1024),)](u, n, seed, BLOCK=1024)

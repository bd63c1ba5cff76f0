"""Triton sources of the fused dropout + residual add + LayerNorm kernels:
the forward (K5), its backward (K6), a mask-only kernel for checks, and
the copy anchor (K9): K5's loads, fp32 add and store over K5's row blocks
with nothing else, the floor of K5's traffic under the same launch shape.

Imported only by ``fused_ln`` when it launches on a CUDA tensor (after
``runtime.build.import_triton``), because importing this module needs
``triton``. See ``fused_ln.py`` for what the kernels replace and what
bounds them. All three draw the dropout mask as ``tl.rand(seed, offset)
>= rate`` with the element's flat int32 offset, so the backward and the
mask kernel regenerate the forward's mask.
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
def _bwd_kernel(
    X, R, G, DY, DX, DRES, DG, DB, n_rows, H, n_blocks, seed, rate, scale, eps,
    HAS_DROPOUT: tl.constexpr, ROWS: tl.constexpr, BLOCK_H: tl.constexpr,
):
    # program p takes row blocks p, p + programs, ... and writes its own
    # fp32 partial sums of dgamma/dbeta (row p of DG/DB), reduced outside
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_H)
    col_ok = cols < H
    gamma = tl.load(G + cols, mask=col_ok, other=0.0).to(tl.float32)
    dg_acc = tl.zeros((BLOCK_H,), tl.float32)
    db_acc = tl.zeros((BLOCK_H,), tl.float32)
    for blk in range(pid, n_blocks, tl.num_programs(0)):
        rows = blk * ROWS + tl.arange(0, ROWS)
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
        xhat = centred * rstd[:, None]
        g = tl.load(DY + offs, mask=ok, other=0.0).to(tl.float32)
        dg_acc += tl.sum(g * xhat, axis=0)
        db_acc += tl.sum(g, axis=0)
        gg = g * gamma[None, :]
        m1 = tl.sum(gg, axis=1) / H
        m2 = tl.sum(gg * xhat, axis=1) / H
        dres = (gg - m1[:, None] - xhat * m2[:, None]) * rstd[:, None]
        tl.store(DRES + offs, dres.to(DRES.dtype.element_ty), mask=ok)
        if HAS_DROPOUT:
            dres = tl.where(keep, dres * scale, 0.0)
        tl.store(DX + offs, dres.to(DX.dtype.element_ty), mask=ok)
    tl.store(DG + pid * H + cols, dg_acc, mask=col_ok)
    tl.store(DB + pid * H + cols, db_acc, mask=col_ok)


@triton.jit
def _copy_kernel(X, R, O, n_rows, H, ROWS: tl.constexpr, BLOCK_H: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    cols = tl.arange(0, BLOCK_H)
    ok = (rows < n_rows)[:, None] & (cols < H)[None, :]
    offs = rows[:, None].to(tl.int64) * H + cols[None, :]
    y = (tl.load(X + offs, mask=ok, other=0.0).to(tl.float32)
         + tl.load(R + offs, mask=ok, other=0.0).to(tl.float32))
    tl.store(O + offs, y.to(O.dtype.element_ty), mask=ok)


@triton.jit
def _mask_kernel(K, n, seed, rate, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    ok = offs < n
    keep = tl.rand(seed, offs) >= rate
    tl.store(K + offs, keep.to(tl.uint8), mask=ok)


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


def launch_bwd(x, res, gamma, dy, dx, dres, seed: int, rate: float, eps: float,
               programs: int):
    """K6 over [N, H]: writes ``dx`` and ``dres`` and returns the fp32
    partial sums ``(dgamma [programs, H], dbeta [programs, H])``."""
    import torch

    n_rows, H = x.shape
    rows, block_h, warps = _shape(H)
    n_blocks = triton.cdiv(n_rows, rows)
    programs = max(1, min(programs, n_blocks))
    dg = torch.empty((programs, H), dtype=torch.float32, device=x.device)
    db = torch.empty((programs, H), dtype=torch.float32, device=x.device)
    _bwd_kernel[(programs,)](
        x, res, gamma, dy, dx, dres, dg, db, n_rows, H, n_blocks, seed, rate,
        1.0 / (1.0 - rate) if rate > 0.0 else 1.0, eps,
        HAS_DROPOUT=rate > 0.0, ROWS=rows, BLOCK_H=block_h, num_warps=warps,
    )
    return dg, db


def launch_copy(x, res, out):
    """K9 over [N, H]: K5's grid and block shape."""
    n_rows, H = x.shape
    rows, block_h, warps = _shape(H)
    _copy_kernel[(triton.cdiv(n_rows, rows),)](
        x, res, out, n_rows, H, ROWS=rows, BLOCK_H=block_h, num_warps=warps,
    )


def launch_mask(keep, seed: int, rate: float):
    """The keep mask (uint8, flat) of K5/K6 at ``seed``, for checks."""
    n = keep.numel()
    _mask_kernel[(triton.cdiv(n, 1024),)](keep, n, seed, rate, BLOCK=1024)

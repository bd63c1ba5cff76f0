"""Fused dropout + residual add + LayerNorm, forward and backward, as
Triton kernels for Hopper.

Replaces the Pallas kernels of ``pl_bert_tpu/ops/fused_ln.py``, which
each ALBERT layer runs twice (after the attention block and after the
FFN): the forward ``_fwd_kernel`` (:72-85, via ``_fused_fwd`` :132-145),
K5, and the backward ``_bwd_kernel`` (:88-115, via ``_fused_bwd``
:148-170), K6. :class:`DropoutAddLayerNormFunction` joins them under
autograd.

What bounds them on the card: the forward reads x, the residual and γ/β
and writes the output once; the backward reads x, the residual and the
output gradient and writes dx and dres — 3 to 5 × rows × H × itemsize
bytes for ~10-20 flops per element — so both are bound by device-memory
bandwidth. Each makes one pass with the row statistics in registers; the
backward regenerates the dropout mask and recomputes the statistics
instead of reading saved ones. Triton is the route because the work is
a row reduction plus an elementwise pass. Differences from the TPU:

- one program per block of rows with the ragged tail masked, so the
  ``rows % 256`` and ``H % 128`` refusals (fused_ln.py:200-207) are gone;
- dropout keeps an element where ``tl.rand(seed, offset) >= rate``
  (Philox, keyed by the seed and the element's flat int32 index), scaled
  by 1/(1-rate); the TPU drew its own hardware bits, so masks differ;
- the backward's programs each walk many row blocks and write one fp32
  partial sum of dγ and dβ, reduced outside (the TPU wrote one per
  block, :104-105, :168-169).

:func:`add_copy` (K9) replaces the copy anchor of
``tools/bench_fused_ln.py`` (``_copy_kernel`` :110-113 via ``copy_op``
:115-127): ``(fp32(x) + fp32(res))`` cast back, over K5's row blocks —
K5's traffic with none of its arithmetic, so the bytes bound it
(3 × rows × H × itemsize). ``pl_bert_tpu_torch/tools/bench_fused_ln.py``
times K5 against it.

The plain versions are the same functions in plain PyTorch; a wrapper
takes them for CPU tensors only. On the CPU the dropout mask comes from a
``torch.Generator`` seeded with ``seed`` (the forward and the backward
draw the same one); a ``keep`` argument substitutes the kernels' mask
(:func:`dropout_mask`) where the two are compared.
"""

from __future__ import annotations

import functools

import torch

from pl_bert_tpu_torch.runtime import build

LAUNCHES = build.LaunchCounter("dropout_add_layernorm")  # K5
LAUNCHES_BWD = build.LaunchCounter("dropout_add_layernorm_bwd")  # K6
LAUNCHES_COPY = build.LaunchCounter("add_copy")  # K9


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if isinstance(seed, torch.Tensor) else int(seed)


def _triton_ln():
    build.import_triton()  # before the kernel source imports it
    from pl_bert_tpu_torch.ops import _ln_triton

    return _ln_triton


def _check_cuda(x, *others) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"dropout_add_layernorm runs on cpu or cuda, not {x.device}")
    for name, t in others:
        if t.device != x.device:
            raise ValueError(f"dropout_add_layernorm {name} on {t.device}, x on {x.device}")
    if x.numel() >= 2**31:
        # the kernels key the dropout on int32 element offsets
        raise ValueError(f"dropout_add_layernorm takes < 2^31 elements, got {x.numel()}")


def dropout_add_layernorm(
    x, residual, gamma, beta, seed=None, rate: float = 0.0, eps: float = 1e-12
):
    """LayerNorm(residual + dropout(x)) over the last axis, with the
    signature of pl_bert_tpu/ops/fused_ln.py:188-215 (K5).

    ``x``/``residual``: [..., H] in the compute dtype; ``gamma``/``beta``:
    [H]; ``seed``: an int or one-element int tensor (dropout runs only
    with a seed and ``rate`` > 0). fp32 statistics; output in
    ``x.dtype``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} != x {tuple(x.shape)}")
    if seed is None:
        rate = 0.0
    if x.device.type == "cpu":
        return dropout_add_layernorm_plain(x, residual, gamma, beta, seed, rate, eps)
    _check_cuda(x, ("residual", residual), ("gamma", gamma), ("beta", beta))
    H = x.shape[-1]
    if residual.dtype != x.dtype:
        raise TypeError(f"residual {residual.dtype} != x {x.dtype}")
    if gamma.shape != (H,) or beta.shape != (H,):
        raise ValueError(f"gamma/beta must be [{H}]")
    x2 = x.reshape(-1, H).contiguous()
    r2 = residual.reshape(-1, H).contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        _triton_ln().launch(
            x2, r2, gamma.contiguous(), beta.contiguous(), out,
            _seed_int(seed) if rate > 0.0 else 0, float(rate), float(eps),
        )
    LAUNCHES.add()
    return out.reshape(x.shape)


def _plain_keep(x, seed, rate: float, keep):
    if seed is None or rate <= 0.0:
        return None
    if keep is not None:
        return keep.reshape(x.shape).bool()
    gen = torch.Generator(device=x.device).manual_seed(_seed_int(seed))
    return torch.rand(x.shape, generator=gen, device=x.device) >= rate


def dropout_add_layernorm_plain(
    x, residual, gamma, beta, seed=None, rate: float = 0.0, eps: float = 1e-12,
    keep=None,
):
    """K5's function in plain PyTorch: fp32 dropout, residual add and
    statistics (biased variance, eps inside the root), output cast to
    ``x.dtype``. Differentiable, so it is also the eager training path."""
    y = x.float()
    keep = _plain_keep(x, seed, rate, keep)
    if keep is not None:
        y = torch.where(keep, y * (1.0 / (1.0 - rate)), 0.0)
    y = y + residual.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype)


def dropout_add_layernorm_bwd(
    dy, x, residual, gamma, seed=None, rate: float = 0.0, eps: float = 1e-12
):
    """K6: the gradients ``(dx, dres, dgamma, dbeta)`` of
    :func:`dropout_add_layernorm` at output gradient ``dy``; ``dx`` in
    ``x.dtype``, ``dres`` in ``residual.dtype``, dγ and dβ fp32. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if seed is None:
        rate = 0.0
    if x.device.type == "cpu":
        return dropout_add_layernorm_bwd_plain(dy, x, residual, gamma, seed, rate, eps)
    _check_cuda(x, ("residual", residual), ("gamma", gamma), ("dy", dy))
    H = x.shape[-1]
    x2 = x.reshape(-1, H).contiguous()
    r2 = residual.reshape(-1, H).contiguous()
    dy2 = dy.reshape(-1, H).to(x.dtype).contiguous()
    dx = torch.empty_like(x2)
    dres = torch.empty_like(r2)
    with torch.cuda.device(x.device):
        dg, db = _triton_ln().launch_bwd(
            x2, r2, gamma.contiguous(), dy2, dx, dres,
            _seed_int(seed) if rate > 0.0 else 0, float(rate), float(eps),
            _programs(x.device),
        )
    LAUNCHES_BWD.add()
    return dx.reshape(x.shape), dres.reshape(x.shape), dg.sum(0), db.sum(0)


@functools.cache
def _programs(device) -> int:
    """K6's grid: four programs per SM."""
    return 4 * torch.cuda.get_device_properties(device).multi_processor_count


def dropout_add_layernorm_bwd_plain(
    dy, x, residual, gamma, seed=None, rate: float = 0.0, eps: float = 1e-12,
    keep=None,
):
    """K6's function in plain PyTorch, in the formulas of ``_bwd_kernel``:
    the mask and statistics recomputed,
    ``dres = (gγ − mean(gγ) − x̂·mean(gγ·x̂))·rstd``, ``dx`` = ``dres``
    masked and scaled, dγ = Σ g·x̂ and dβ = Σ g over the rows."""
    H = x.shape[-1]
    xs = x.float()
    keep = _plain_keep(x, seed, rate, keep)
    if keep is not None:
        xs = torch.where(keep, xs * (1.0 / (1.0 - rate)), 0.0)
    y = xs + residual.float()
    mean = y.mean(dim=-1, keepdim=True)
    centred = y - mean
    rstd = torch.rsqrt(centred.square().mean(dim=-1, keepdim=True) + eps)
    xhat = centred * rstd
    g = dy.to(x.dtype).float()
    gg = g * gamma.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dres = (gg - m1 - xhat * m2) * rstd
    dx = dres if keep is None else torch.where(keep, dres * (1.0 / (1.0 - rate)), 0.0)
    dgamma = (g * xhat).reshape(-1, H).sum(0)
    dbeta = g.reshape(-1, H).sum(0)
    return dx.to(x.dtype), dres.to(residual.dtype), dgamma, dbeta


def add_copy(x, residual):
    """K9, the copy anchor: ``(fp32(x) + fp32(residual))`` cast to
    ``x.dtype``, [..., H]. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if residual.shape != x.shape or residual.dtype != x.dtype:
        raise ValueError(f"residual {tuple(residual.shape)} {residual.dtype} != x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return add_copy_plain(x, residual)
    _check_cuda(x, ("residual", residual))
    H = x.shape[-1]
    x2 = x.reshape(-1, H).contiguous()
    r2 = residual.reshape(-1, H).contiguous()
    out = torch.empty_like(x2)
    with torch.cuda.device(x.device):
        _triton_ln().launch_copy(x2, r2, out)
    LAUNCHES_COPY.add()
    return out.reshape(x.shape)


def add_copy_plain(x, residual):
    """K9's function in plain PyTorch."""
    return (x.float() + residual.float()).to(x.dtype)


def dropout_mask(shape, seed: int, rate: float, device):
    """The kernels' keep mask for ``shape`` at ``seed`` (uint8), made by
    the same ``tl.rand`` call in a mask-only Triton kernel, for checks."""
    keep = torch.empty(shape, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        _triton_ln().launch_mask(keep, int(seed), float(rate))
    return keep


class DropoutAddLayerNormFunction(torch.autograd.Function):
    """K5 forward and K6 backward under autograd (their plain versions on
    CPU tensors). Saves x and the residual, not the mask or the
    statistics. ``gamma``/``beta`` are the fp32 parameters, whose
    gradients come back fp32."""

    @staticmethod
    def forward(ctx, x, residual, gamma, beta, seed, rate, eps):
        ctx.save_for_backward(x, residual, gamma)
        ctx.args = (seed, rate, eps)
        return dropout_add_layernorm(x, residual, gamma, beta, seed, rate, eps)

    @staticmethod
    def backward(ctx, dy):
        x, residual, gamma = ctx.saved_tensors
        dx, dres, dgamma, dbeta = dropout_add_layernorm_bwd(dy, x, residual, gamma, *ctx.args)
        return dx, dres, dgamma, dbeta, None, None, None


def dropout_add_layernorm_train(
    x, residual, gamma, beta, seed=None, rate: float = 0.0, eps: float = 1e-12
):
    """:func:`dropout_add_layernorm` with gradients through K6. ``seed``
    a host int (no device sync to read it)."""
    if seed is None:
        rate = 0.0
    return DropoutAddLayerNormFunction.apply(
        x, residual, gamma, beta, seed, float(rate), float(eps)
    )

"""Fused dropout + residual add + LayerNorm, as a Triton kernel for Hopper.

Replaces the forward Pallas kernel of ``pl_bert_tpu/ops/fused_ln.py``
(``_fwd_kernel`` :72-85, via ``_fused_fwd`` :132-145), which each ALBERT
layer runs twice: after the attention block and after the FFN.

What bounds it on the card: it reads x, the residual and γ/β and writes
the output once — about 3 × rows × H × itemsize bytes for ~10 flops per
element — so it is bound by device-memory bandwidth; the design makes
one pass with the row statistics held in registers. Differences from
the TPU kernel:

- one program per block of rows with the ragged tail masked, so the
  ``rows % 256`` and ``H % 128`` refusals (fused_ln.py:200-207) are gone;
  Triton is the route because the work is a row reduction plus an
  elementwise pass, tuned by ``num_warps`` alone;
- dropout keeps an element where ``tl.rand(seed, offset) >= rate``
  (Philox, keyed by the seed and the element's flat index), scaled by
  1/(1-rate). The TPU drew its own hardware bits, so masks differ
  between the two; the serving path runs rate 0.

``dropout_add_layernorm_plain`` is the same function in plain PyTorch;
the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from pl_bert_tpu_torch.runtime import build

LAUNCHES = build.LaunchCounter("dropout_add_layernorm")


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if isinstance(seed, torch.Tensor) else int(seed)


def dropout_add_layernorm(
    x, residual, gamma, beta, seed=None, rate: float = 0.0, eps: float = 1e-12
):
    """LayerNorm(residual + dropout(x)) over the last axis, with the
    signature of pl_bert_tpu/ops/fused_ln.py:188-215.

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
    if x.device.type != "cuda":
        raise ValueError(f"dropout_add_layernorm runs on cpu or cuda, not {x.device}")
    H = x.shape[-1]
    for name, t in (("residual", residual), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device:
            raise ValueError(f"dropout_add_layernorm {name} on {t.device}, x on {x.device}")
    if residual.dtype != x.dtype:
        raise TypeError(f"residual {residual.dtype} != x {x.dtype}")
    if gamma.shape != (H,) or beta.shape != (H,):
        raise ValueError(f"gamma/beta must be [{H}]")
    x2 = x.reshape(-1, H).contiguous()
    r2 = residual.reshape(-1, H).contiguous()
    out = torch.empty_like(x2)
    build.import_triton()  # before the kernel source imports it
    from pl_bert_tpu_torch.ops import _ln_triton

    with torch.cuda.device(x.device):
        _ln_triton.launch(
            x2, r2, gamma.contiguous(), beta.contiguous(), out,
            _seed_int(seed) if rate > 0.0 else 0, float(rate), float(eps),
        )
    LAUNCHES.add()
    return out.reshape(x.shape)


def dropout_add_layernorm_plain(
    x, residual, gamma, beta, seed=None, rate: float = 0.0, eps: float = 1e-12
):
    """The kernel's function in plain PyTorch: fp32 dropout, residual add
    and statistics (biased variance, eps inside the root), output cast to
    ``x.dtype``. Dropout draws from a ``torch.Generator`` seeded with
    ``seed``; its mask is not the kernel's."""
    y = x.float()
    if seed is not None and rate > 0.0:
        gen = torch.Generator(device=x.device).manual_seed(_seed_int(seed))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
        y = torch.where(keep, y / (1.0 - rate), 0.0)
    y = y + residual.float()
    mean = y.mean(dim=-1, keepdim=True)
    var = (y - mean).square().mean(dim=-1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return out.to(x.dtype)

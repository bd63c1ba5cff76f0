"""Fused dropout + residual add + LayerNorm, forward and backward, as
hand-written CUDA C++ kernels for Hopper (``csrc/fused_ln.cu``).

Replaces the Pallas kernels of ``pl_bert_tpu/ops/fused_ln.py``, which
each ALBERT layer runs twice (after the attention block and after the
FFN): the forward ``_fwd_kernel`` (:72-85, via ``_fused_fwd`` :132-145),
K5 (``ln_fwd``), and the backward ``_bwd_kernel`` (:88-115, via
``_fused_bwd`` :148-170), K6 (``ln_bwd``). The source's header says what
bounds them and how they are laid out: a warp a row, one routine for the
row's mask and statistics that both call, the row sums in warp shuffles,
γ/β (K5) and the dγ/dβ partials (K6) in registers (in shared memory above
width 1024), the latter reduced in a fixed order. :class:`DropoutAddLayerNormFunction` joins them under
autograd.

What bounds them on the card: the forward reads x and the residual and
writes the output once; the backward reads x, the residual and the
output gradient and writes dx and dres — 3 and 5 × rows × H × itemsize
bytes for ~10-20 flops per element — so device-memory bandwidth bounds
both, and with dropout their Philox draws are work of the same order on
the integer units. Each makes one pass with the row statistics in
registers; the backward regenerates the dropout mask and recomputes the
statistics instead of reading saved ones. Differences from the TPU:

- any row count, so the ``rows % 256`` and ``H % 128`` refusals
  (fused_ln.py:200-207) are gone; the kernels take a width that is a
  multiple of 8 (their 16-byte loads) up to 2048, and raise on others. :func:`ln_kernel_refusal` says which widths they
  take; the model sends the others to the plain version when it is
  built, as JAX falls back to ``nn.LayerNorm``;
- dropout keeps an element where ``tl.rand(seed, offset) >= rate``
  (Triton's Philox, keyed by the seed and the element's flat int32
  index), scaled by 1/(1-rate); both kernels draw it in CUDA
  (:func:`tl_rand` is the same draw in plain PyTorch, and a Triton kernel
  that calls ``tl.rand`` itself, :func:`dropout_mask`, is the oracle on
  the card); the TPU drew its own hardware bits, so masks differ from
  JAX's;
- the backward's blocks each write one fp32 partial row of dγ and dβ,
  summed in a fixed order by a second small kernel in the same call (the
  TPU wrote one per block, :104-105, :168-169, reduced outside).

:func:`add_copy` (K9, CUDA C++ in the same file) replaces the copy anchor
of ``tools/bench_fused_ln.py`` (``_copy_kernel`` :110-113 via ``copy_op``
:115-127): ``(fp32(x) + fp32(res))`` cast back over the flat elements in
16-byte vectors — K5's traffic (3 × rows × H × itemsize) with none of its
work, the card's floor for that traffic.
``pl_bert_tpu_torch/tools/bench_fused_ln.py`` times K5 against it.

The plain versions are the same functions in plain PyTorch; a wrapper
takes them for CPU tensors only. On the CPU the dropout mask comes from a
``torch.Generator`` seeded with ``seed`` (the forward and the backward
draw the same one); a ``keep`` argument substitutes the kernels' mask
(:func:`dropout_mask`) where the two are compared.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pl_bert_tpu_torch.ops import attention_block as ab
from pl_bert_tpu_torch.runtime import build

LAUNCHES = build.LaunchCounter("dropout_add_layernorm")  # K5
LAUNCHES_BWD = build.LaunchCounter("dropout_add_layernorm_bwd")  # K6
LAUNCHES_COPY = build.LaunchCounter("add_copy")  # K9


# K5's and K6's widths: 16-byte loads of 8 elements, at most eight
# 256-column slices a lane
MAX_WIDTH = 2048
# the seeds whose masks are held against Triton's tl.rand on the card
# (models/albert.py draws them in [0, 2^31 - 1))
SEED_MAX = 2**31 - 2
# triton/language/random.py, uint_to_uniform_float: the int32 scale
_TL_RAND_SCALE = 4.6566127342e-10
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if isinstance(seed, torch.Tensor) else int(seed)


def _checked_seed(seed) -> int:
    s = _seed_int(seed)
    if not 0 <= s <= SEED_MAX:
        raise ValueError(f"the fused LN kernels take dropout seeds in [0, {SEED_MAX}], got {s}")
    return s


def ln_kernel_refusal(width: int, dtype) -> str | None:
    """Why the card's LN kernels (K5 and K6 take the same shapes) do not
    take a LayerNorm of this width and compute dtype, or None when they
    do: a multiple of 8 (16-byte loads) up to 2048, in float32 or
    bfloat16."""
    if dtype not in _DTYPE_CODES:
        return f"the LN kernels take float32 or bfloat16, not {dtype}"
    if width < 8 or width % 8:
        return f"width {width} is no multiple of 8 (the LN kernels' 16-byte loads)"
    if width > MAX_WIDTH:
        return f"width {width} is above the LN kernels' {MAX_WIDTH}"
    return None


def tl_rand(seed: int, offsets):
    """Triton's ``tl.rand(seed, offsets)`` in plain PyTorch (fp32 in [0,
    1)): Philox4x32-10 (:func:`attention_block.philox_bits`) under key
    (seed's low word, its high word) at counter (offset, 0, 0, 0), the
    first word read as int32, ``x < 0 → −x − 1``, times 4.6566127342e-10
    in fp32 — ``triton/language/random.py``'s ``rand``, ``randint``,
    ``philox`` and ``uint_to_uniform_float``. ``offsets``: an int tensor
    of flat element offsets (int32 in the kernels)."""
    seed = int(seed)
    bits = ab.philox_bits(seed & _M32, seed >> 32, offsets.to(torch.int64) & _M32, 0)
    v = torch.where(bits >= 2**31, bits - 2**32, bits)
    v = torch.where(v < 0, -v - 1, v)
    return v.to(torch.float32) * torch.tensor(_TL_RAND_SCALE, dtype=torch.float32)


def tl_rand_keep(seed: int, offsets, rate: float):
    """The kernels' keep decision ``tl.rand(seed, offset) >= rate``,
    compared in fp32 as they compare it: the mask K5 draws and K6
    regenerates."""
    return tl_rand(seed, offsets) >= torch.tensor(rate, dtype=torch.float32)


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
    _check_kernel_args(x, residual, H, train=False)
    if gamma.shape != (H,) or beta.shape != (H,):
        raise ValueError(f"gamma/beta must be [{H}]")
    seed_i = _checked_seed(seed) if rate > 0.0 else 0
    x2, r2 = (_aligned(t.reshape(-1, H)) for t in (x, residual))
    g, b = _aligned(gamma.float()), _aligned(beta.float())
    out = torch.empty_like(x2)
    n_rows, code = x2.shape[0], _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        blocks = min(_blocks(x.device, H, code, rate > 0.0, False), -(-n_rows // 4))
        status = _fn("plbt_ln_fwd")(
            ab._ptr(x2), ab._ptr(r2), ab._ptr(g), ab._ptr(b), ab._ptr(out), n_rows, H, code,
            blocks, seed_i & _M32, seed_i >> 32, float(rate), float(eps), ab._stream(x.device),
        )
    build.check(status, "fused LN forward")
    LAUNCHES.add()
    return out.reshape(x.shape)


def _check_kernel_args(x, residual, H: int, train: bool) -> None:
    if x.dtype not in _DTYPE_CODES or residual.dtype != x.dtype:
        raise TypeError(f"the fused LN kernels take float32/bfloat16 x and residual alike, "
                        f"got {x.dtype} and {residual.dtype}")
    reason = ln_kernel_refusal(H, x.dtype)
    if reason:
        raise ValueError(f"fused LN {'backward' if train else 'forward'}: {reason}")


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
    _check_kernel_args(x, residual, H, train=True)
    seed_i = _checked_seed(seed) if rate > 0.0 else 0
    x2, r2 = (_aligned(t.reshape(-1, H)) for t in (x, residual))
    dy2 = _aligned(dy.reshape(-1, H).to(x.dtype))
    g = _aligned(gamma.float())
    n_rows, code = x2.shape[0], _DTYPE_CODES[x.dtype]
    dx = torch.empty_like(x2)
    dres = torch.empty_like(r2)
    dgdb = torch.empty((2, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        # a K6 block's four warps take a row each: no more blocks than that needs
        blocks = min(_blocks(x.device, H, code, rate > 0.0, True), -(-n_rows // 4))
        part = torch.empty((2, blocks, H), dtype=torch.float32, device=x.device)
        status = _fn("plbt_ln_bwd")(
            ab._ptr(x2), ab._ptr(r2), ab._ptr(g), ab._ptr(dy2), ab._ptr(dx), ab._ptr(dres),
            ab._ptr(part), ab._ptr(dgdb), n_rows, H, code, blocks, seed_i & _M32,
            seed_i >> 32, float(rate), float(eps), ab._stream(x.device),
        )
    build.check(status, "fused LN backward")
    LAUNCHES_BWD.add()
    return dx.reshape(x.shape), dres.reshape(x.shape), dgdb[0], dgdb[1]


# the C entry points of csrc/fused_ln.cu: name -> argument types (the last
# pointer of a launch is the stream)
_P, _I, _U, _F, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                       ctypes.c_longlong)
_SIGNATURES = {
    "plbt_ln_blocks": (_I,) * 4,
    "plbt_ln_fwd": (_P,) * 5 + (_I,) * 4 + (_U, _U, _F, _F, _P),
    "plbt_ln_bwd": (_P,) * 8 + (_I,) * 4 + (_U, _U, _F, _F, _P),
    "plbt_add_copy": (_P, _P, _P, _LL, _I, _I, _P),
}


@functools.cache
def _fn(name: str):
    """A C entry point of ``csrc/fused_ln.cu``'s library, built and typed
    at first use."""
    fn = getattr(build.load("fused_ln"), name)
    fn.argtypes = list(_SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _blocks(device, H: int, code: int, dropout: bool, backward: bool) -> int:
    """K5's or K6's grid at this width, dtype and dropout: blocks that
    fill every SM once (the occupancy the compiled kernel allows)."""
    with torch.cuda.device(device):
        blocks = _fn("plbt_ln_blocks")(H, code, int(dropout), int(backward))
    if blocks < 1:
        raise RuntimeError(f"fused LN {'backward' if backward else 'forward'}: no grid for "
                           f"width {H}")
    return blocks


@functools.cache
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t):
    """``t`` contiguous with a 16-byte-aligned base (the kernels' vector
    loads): a misaligned view is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dropout_add_layernorm_bwd_plain(
    dy, x, residual, gamma, seed=None, rate: float = 0.0, eps: float = 1e-12,
    keep=None,
):
    """K6's function in plain PyTorch, in the formulas of the TPU's
    ``_bwd_kernel``:
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
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"add_copy takes float32/bfloat16, got {x.dtype}")
    xf, rf = x.contiguous().view(-1), residual.contiguous().view(-1)
    out = torch.empty_like(xf)
    n = xf.numel()
    # 256 threads a block, four 16-byte vectors each an operand; at most
    # 32 blocks an SM (of 4, 8, 16 and 32, 32 timed best on an H100), the
    # rest in the grid-stride loop
    per_block = 256 * 4 * (16 // x.element_size())
    blocks = max(1, min(-(-n // per_block), 32 * _sms(x.device)))
    with torch.cuda.device(x.device):
        status = _fn("plbt_add_copy")(ab._ptr(xf), ab._ptr(rf), ab._ptr(out), n,
                                      _DTYPE_CODES[x.dtype], blocks, ab._stream(x.device))
    build.check(status, "add_copy")
    LAUNCHES_COPY.add()
    return out.view(x.shape)


def add_copy_plain(x, residual):
    """K9's function in plain PyTorch."""
    return (x.float() + residual.float()).to(x.dtype)


def dropout_mask(shape, seed: int, rate: float, device):
    """The kernels' keep mask for ``shape`` at ``seed`` (uint8), made by
    Triton's own ``tl.rand`` in a mask-only Triton kernel: the oracle that
    K5 and K6 are held to on the card."""
    keep = torch.empty(shape, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        _triton_ln().launch_mask(keep, int(seed), float(rate))
    return keep


def triton_rand(n: int, seed: int, device):
    """``tl.rand(seed, offset)`` at offsets 0 .. n-1 (fp32), from a Triton
    kernel, for holding :func:`tl_rand` to Triton on the card."""
    u = torch.empty(n, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        _triton_ln().launch_rand(u, int(seed))
    return u


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

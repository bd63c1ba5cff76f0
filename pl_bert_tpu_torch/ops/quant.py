"""Dynamic int8 dense layers for the serving path, the counterpart of
``pl_bert_tpu/ops/quant.py``.

The same scheme as JAX's (AQT-style, no calibration): activations get
one symmetric scale per row (abs-max over the contracting dimension),
weights one per output channel; the product accumulates in int32 and is
rescaled in fp32, cast to the output dtype, and only then is the bias
added in that dtype, as ``flax.linen.Dense`` adds it after
``int8_dot_general`` (quant.py:54-94). JAX's int8 product is XLA, not
Pallas, so the port's is a library call: ``torch._int_mm`` (cuBLASLt's
int8 GEMM with int32 accumulation) on a CUDA tensor, counted by
:data:`LAUNCHES`. Its plain version, :func:`int8_matmul_plain`, forms
the product in fp64, which is exact while every sum stays below 2^53: a
product of two int8 values is at most 127², so K up to 2048 keeps the
sums below 2^25, and the two give the same int32 bits. On a CPU tensor
:func:`int8_matmul` runs the plain version.

``torch._int_mm`` on CUDA takes more than 16 rows and K and N that are
multiples of 8, so :func:`int8_matmul` zero-pads every operand up to
those limits before the call, always. The padding is exact: a zero row
or column changes neither a scale nor a sum.

Where the model applies it (``models/albert.py``): the sites are JAX's
``_dense`` sites on the attention path the model runs. The embedding
mapping, both FFN layers and the pooler are int8 on every path; the
query, key, value and output projections only on the flash and the
eager path. The attention-block kernels (K1, the ``auto`` path) read the
weights as they are and keep their bf16 internals, as JAX's fused block
does (pl_bert_tpu/models/albert.py:360-385): int8 on the block path
leaves the attention projections unquantized. Weights are quantized
once per weight set from the kernel in the compute dtype, as flax casts
the kernel before ``int8_dot_general``; JAX quantizes them on every call,
to the same bits. The int8 forward is inference-only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pl_bert_tpu_torch.runtime import build

QMAX = 127.0
LAUNCHES = build.LaunchCounter("int8_matmul")  # torch._int_mm calls
# torch._int_mm on CUDA: more than 16 rows, K and N multiples of 8
MIN_ROWS, ALIGN = 17, 8


def quantize_rows(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with one scale per slice along ``dim``
    (the contracting dimension): ``(q int8, scale fp32)`` with ``scale``
    keeping ``dim`` as size 1 and ``q * scale ≈ x``; JAX's
    ``quantize_rows`` (quant.py:43) step for step. ``torch.round``
    rounds half to even, as ``jnp.round`` does. An all-zero slice gets
    the scale 1e-12/127 and ``q`` 0 exactly."""
    xf = x.float()
    scale = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / QMAX
    q = torch.round(xf / scale).clamp(-QMAX, QMAX)
    return q.to(torch.int8), scale


def quantize_weight(weight: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """An ``nn.Linear`` weight [N, K] → ``(wq [N, K] int8, scale [N] fp32)``,
    one scale per output channel, from the weight cast to the compute
    ``dtype`` first (flax's ``promote_dtype``)."""
    q, scale = quantize_rows(weight.detach().to(dtype), dim=-1)
    return q.contiguous(), scale[:, 0].contiguous()


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = t.shape
    return t if (r, c) == (rows, cols) else F.pad(t, (0, cols - c, 0, rows - r))


def _up(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def pad_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a`` [M, K] and ``b`` [N, K] zero-padded to what ``torch._int_mm``
    takes on CUDA: more than 16 rows of ``a``, K and N multiples of 8
    (the operands themselves where they already are)."""
    (M, K), N = a.shape, b.shape[0]
    return _pad(a, max(M, MIN_ROWS), _up(K)), _pad(b, _up(N), _up(K))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] · bᵀ`` for int8 ``a`` and ``b [N, K]`` → int32 [M, N]:
    ``torch._int_mm`` on a CUDA tensor, on the operands of
    :func:`pad_operands`; on a CPU tensor, :func:`int8_matmul_plain`."""
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    pa, pb = pad_operands(a, b)
    acc = torch._int_mm(pa, pb.t())
    LAUNCHES.add()
    return acc[:a.shape[0], :b.shape[0]]


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The int32 product of :func:`int8_matmul`, formed exactly in fp64."""
    return (a.double() @ b.double().t()).to(torch.int32)


def rescale(acc, x_scale, w_scale, bias, out_dtype) -> torch.Tensor:
    """int32 accumulators [M, N] → ``acc · x_scale · w_scale`` in fp32,
    in that order, cast to ``out_dtype``, then ``+ bias`` in
    ``out_dtype``."""
    out = (acc.float() * x_scale * w_scale).to(out_dtype)
    return out if bias is None else out + bias.to(out_dtype)


def _int8_linear(matmul, x, wq, w_scale, bias, out_dtype):
    lead = x.shape[:-1]
    q, x_scale = quantize_rows(x.reshape(-1, x.shape[-1]))
    out = rescale(matmul(q, wq), x_scale, w_scale, bias, out_dtype or x.dtype)
    return out.reshape(*lead, out.shape[-1])


def int8_linear(x, wq, w_scale, bias=None, out_dtype=None) -> torch.Tensor:
    """A dense layer with int8 operands, flax's ``Dense`` with
    ``dot_general=int8_dot_general``: ``x [..., K]`` quantized per row,
    times ``wq`` [N, K] (:func:`quantize_weight`) in int32
    (:func:`int8_matmul`), rescaled into ``out_dtype`` (default ``x``'s)
    and the bias added there → [..., N]."""
    return _int8_linear(int8_matmul, x, wq, w_scale, bias, out_dtype)


def int8_linear_plain(x, wq, w_scale, bias=None, out_dtype=None) -> torch.Tensor:
    """:func:`int8_linear` with the product formed by
    :func:`int8_matmul_plain` on any device."""
    return _int8_linear(int8_matmul_plain, x, wq, w_scale, bias, out_dtype)

"""Triton kernels that call ``tl.rand`` itself: the oracle of the fused
LayerNorm's dropout mask on the card.

The fused LN kernels (K5 forward, K6 backward: CUDA C++ in
``csrc/fused_ln.cu``) keep an element where ``tl.rand(seed, offset) >=
rate``, with the element's flat int32 offset, drawn in CUDA. These two
kernels draw that mask, and the uniform floats behind it, with Triton's
own ``tl.rand``, so that ``chip_smoke.py`` and the card's tests hold the
CUDA draws to Triton bit for bit.

Imported only by ``fused_ln.dropout_mask`` and ``fused_ln.triton_rand``
(after ``runtime.build.import_triton``), because importing this module
needs ``triton``.
"""

import triton
import triton.language as tl


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


def launch_mask(keep, seed: int, rate: float):
    """The keep mask (uint8, flat) at ``seed``."""
    n = keep.numel()
    _mask_kernel[(triton.cdiv(n, 1024),)](keep, n, seed, rate, BLOCK=1024)


def launch_rand(u, seed: int):
    """``tl.rand(seed, offset)`` at the flat offsets of ``u`` (fp32), the
    uniform floats behind the mask."""
    n = u.numel()
    _rand_kernel[(triton.cdiv(n, 1024),)](u, n, seed, BLOCK=1024)

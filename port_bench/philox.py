"""Philox4x32-10 and the two dropout streams of the training step.

The step's dropout is part of what it computes, so the reference draws
the same masks from the same published generator (Salmon et al., SC'11,
"Parallel random numbers: as easy as 1, 2, 3"):

- attention probabilities: the first word of Philox4x32-10 under key
  (seed, b·heads + head) at counter (query row, key column, 0, 0); an
  element is kept where that word exceeds ``rate·2³²``;
- the dropout in front of each residual LayerNorm: Triton's
  ``tl.rand(seed, offset)`` (key (seed's low word, its high word),
  counter (flat element offset, 0, 0, 0), the word read as int32,
  ``x < 0 → −x − 1``, times 4.6566127342e-10 in fp32), kept where it is
  at least the rate.

Plain int64 PyTorch on any device; 32-bit products are formed from
16-bit halves so that nothing leaves int64's range.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_TL_RAND_SCALE = 4.6566127342e-10


def _mulhilo(m: int, c):
    t = (m & 0xFFFF) * c
    u = (m >> 16) * c
    return (u + (t >> 16)) >> 16, (((u & 0xFFFF) << 16) + t) & M32


def word0(k0, k1, c0, c1):
    """First output word of Philox4x32-10 at counter (c0, c1, 0, 0) under
    key (k0, k1); broadcastable int64 tensors (or ints) below 2³²."""
    c2 = c3 = 0
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0


def attention_keep(seed: int, rate: float, stream, q, k):
    """Keep decisions of attention dropout at (stream, query, key),
    broadcast together (int64 tensors)."""
    threshold = min(int(rate * 2**32), M32)
    return word0(int(seed) & M32, stream & M32, q, k) > threshold


def layernorm_keep(seed: int, rate: float, offsets):
    """Keep decisions of the LayerNorm-site dropout at flat element
    ``offsets`` (an int64 tensor)."""
    seed = int(seed)
    bits = word0(seed & M32, seed >> 32, offsets & M32, 0)
    v = torch.where(bits >= 2**31, bits - 2**32, bits)
    v = torch.where(v < 0, -v - 1, v)
    u = v.to(torch.float32) * torch.tensor(_TL_RAND_SCALE, dtype=torch.float32,
                                           device=v.device)
    return u >= torch.tensor(rate, dtype=torch.float32, device=v.device)

// Philox4x32-10, the port's one counter-based generator: the attention
// kernels' dropout (attention_tiles.cuh) and the fused LayerNorm backward's
// regeneration of Triton's tl.rand mask (fused_ln.cu) draw from it.

#pragma once

#include <stdint.h>

namespace {

// Philox4x32-10 (Salmon et al., SC'11): counter (c0, c1, 0, 0), key (k0, k1);
// returns the first output word. The port's plain version
// (ops/attention_block.py::philox_bits) computes the same function.
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1, uint32_t k0,
                                                 uint32_t k1) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

}  // namespace

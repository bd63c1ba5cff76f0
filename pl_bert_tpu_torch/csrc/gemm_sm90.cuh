// The attention block's bf16 projection GEMMs on Hopper's tensor cores:
//   forward   C[M, N] = A[M, K] . B[K, N] + bias[N]
//   backward  C[M, N] = A[M, K] . B[N, K]^T          (BT)
// A row-major (K-major). In the forward B is the packed weight [E, 3P] or
// [P, E], row-major (MN-major, read by wgmma with its transpose flag); in
// the backward (do = dout . Wo^T, dx = dqkv . Wqkv^T) the same weight is
// read as its transpose, which is K-major, wgmma's native form. No weight
// is ever repacked, so the training path can hand in freshly cast weights
// every step. bf16 operands, fp32 accumulation, the fp32 bias added before
// the one rounding to bf16 -- the rounding point of the SIMT gemm_bias in
// attention_block.cu and of the TPU kernel
// (pl_bert_tpu/ops/attention_block.py:128-131, 168, 331-334, 389-401).
//
// What bounds it: at the flagship width the products are far above the
// card's ridge (x.Wqkv at M = 4096 is 14.5 GFLOP against 29 MB), so the
// tensor-core rate does. The design keeps the tensor cores fed:
//   - a block owns a 128 x 128 output tile; two consumer warpgroups each
//     issue wgmma.m64n128k16 on their 64 rows, the accumulator in registers,
//     each K tile's products summed on its own and added to the fp32 total
//     with round-to-nearest adds (promote, sm90.cuh);
//   - one producer warp keeps a ring of 4 stages of 64-deep K tiles in
//     flight with TMA (a stage: one 128 x 64 box of A, and of B two 64 x 64
//     boxes, or with BT one 64 x 128 box; 32 KB), signalling a "full"
//     mbarrier per stage; each consumer warp releases a stage on its
//     "empty" mbarrier once its products on it have completed;
//   - TMA zero-fills rows past M, columns past N and depth past K, so any
//     M = B*L works; the epilogue masks the M and N tails on store.
// No split-K and no atomics: one block owns each output element, so the
// result is deterministic.

#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace {

constexpr int WG_BM = 128, WG_BN = 128, WG_BK = 64, WG_STAGES = 4;
constexpr int WG_CONSUMERS = 2;                          // warpgroups, 64 rows each
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;      // and one producer warp
constexpr uint32_t WG_A_BYTES = WG_BM * WG_BK * 2;       // 16 KB
constexpr uint32_t WG_B_BYTES = WG_BK * WG_BN * 2;       // 16 KB: two 64-column boxes
constexpr size_t WG_SMEM =
    1024 + WG_STAGES * (WG_A_BYTES + WG_B_BYTES) + 2 * WG_STAGES * sizeof(uint64_t);

template <bool BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_bias_sm90(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ C, int M, int N,
               int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align_1k(smem_raw);                   // [stage][128 rows][128 B]
  uint8_t* Bs = As + WG_STAGES * WG_A_BYTES;  // [stage][2 boxes][64 rows][128 B] or BT [128][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + WG_STAGES * WG_B_BYTES);
  uint64_t* empty = full + WG_STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int KT = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG_CONSUMERS);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * WG_CONSUMERS) {  // the producer
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(&empty[s], (kt / WG_STAGES - 1) & 1);
        mbar_expect_tx(&full[s], WG_A_BYTES + WG_B_BYTES);
        tma_load_2d(As + s * WG_A_BYTES, &amap, &full[s], kt * WG_BK, m0);
        if (BT) {
          tma_load_2d(Bs + s * WG_B_BYTES, &bmap, &full[s], kt * WG_BK, n0);
        } else {
          tma_load_2d(Bs + s * WG_B_BYTES, &bmap, &full[s], n0, kt * WG_BK);
          tma_load_2d(Bs + s * WG_B_BYTES + WG_B_BYTES / 2, &bmap, &full[s], n0 + 64,
                      kt * WG_BK);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  float acc[64], part[64];  // the fp32 sum; this K tile's products (see promote)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (kt / WG_STAGES) & 1);
    __syncwarp();
    const uint8_t* a = As + s * WG_A_BYTES + wg * 64 * 128;
    const uint8_t* b = Bs + s * WG_B_BYTES;
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      if (BT)
        wgmma_m64n128k16_ss<0, 0>(part, kmajor_desc(a, kk), kmajor_desc(b, kk), kk > 0);
      else
        wgmma_m64n128k16_ss<0, 1>(part, kmajor_desc(a, kk), mnmajor_desc(b, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(part);
    if (lane == 0) mbar_arrive(&empty[s]);
    promote(acc, part);
  }

  // epilogue: bias in fp32, one rounding, bf16 pairs (N is even)
  const int g = lane / 4, t = lane % 4;
  const int row = m0 + 64 * wg + 16 * (warp % 4) + g;
#pragma unroll
  for (int c = 0; c < WG_BN / 8; ++c) {
    const int col = n0 + 8 * c + 2 * t;
    if (col >= N) continue;
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * N + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] + b0, acc[4 * c + 2 * i + 1] + b1);
    }
  }
}

// C = A . B + bias on `stream`; bf16 A [M, K], B [K, N] (or with BT B [N, K]
// and C = A . B^T), C [M, N] row-major, bias [N] fp32 or NULL. Every
// pointer 16-byte aligned and K, N multiples of 8 (TMA's 16-byte rule for
// bases and row strides); otherwise the map is refused and this returns
// cudaErrorInvalidValue before launching.
template <bool BT = false>
cudaError_t launch_gemm_sm90(const void* A, const void* B, const void* bias, void* C, int M,
                             int N, int K, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M}, astride[1] = {(cuuint64_t)K * 2};
  const cuuint64_t bdims[2] = {(cuuint64_t)(BT ? K : N), (cuuint64_t)(BT ? N : K)};
  const cuuint64_t bstride[1] = {(cuuint64_t)(BT ? K : N) * 2};
  const cuuint32_t abox[2] = {WG_BK, WG_BM};
  const cuuint32_t bbox[2] = {64, BT ? WG_BN : WG_BK};
  if (N % 8 || K % 8 || !bf16_map(&amap, A, 2, adims, astride, abox) ||
      !bf16_map(&bmap, B, 2, bdims, bstride, bbox))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(gemm_bias_sm90<BT>, WG_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM);
  gemm_bias_sm90<BT><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      amap, bmap, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(C), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Attention block for Hopper: QKV projection, softmax attention and output
// projection, forward and backward, all in kernels written here.
//
// Replaces the Pallas kernels of pl_bert_tpu/ops/attention_block.py:
//   - the primal-only ("light") forward, _fwd_kernel_light_full (one grid
//     program per batch item, bf16) and _fwd_kernel_light (per 128-lane head
//     group, fp32) -- K1/K2 -- via plbt_attention_block_fwd with no stats;
//   - the saving training forward _fwd_kernel (K3), via the same entry
//     with stats: the same kernels, so both forwards return identical
//     values, as the JAX custom-VJP contract requires (:196-198);
//   - its backward _bwd_kernel (K4), via plbt_attention_block_bwd.
// One design covers bf16 and fp32, any sequence length, head_dim 64 or 128.
// The attention kernels (steps 2 of the forward, 2-3 of the backward) are
// those of attention_tiles.cuh, shared with flash_attention.cu; the GEMM is
// here.
//
// Forward, three launches on the caller's stream (the wrapper allocates):
//   1. gemm:           qkv[M, 3P] = x[M, E] . [Wq|Wk|Wv][E, 3P] + [bq|bk|bv]
//   2. attention_fwd:  ctx[M, P]  = dropout(softmax(q k^T / sqrt(D) + bias
//                                   [+ seg])) v, and for the training forward
//                                   the row max m and denominator l [B, H, L]
//   3. gemm:           out[M, E]  = ctx[M, P] . Wo[P, E] + bo
// M = B*L. Accumulation, the bias adds and the softmax are fp32; q/k/v, the
// (dropped-out) probabilities and ctx are rounded to the compute type T at
// the points where the TPU kernel rounds them (attention_block.py:128-139,
// 159-168). The training forward saves qkv, ctx and (m, l): the TPU's
// q2/k2/v2/o2 and md [B,G,L,8].
//
// Backward, four launches:
//   1. gemm (B^T):       do[M, P]   = dout[M, E] . Wo[P, E]^T          (:331-334)
//   2. attention_bwd_dq: per query tile, pass 1 delta = sum_j dpd.pd, pass 2
//                        dq = ds . k, with p = exp(s - m)/l recomputed bitwise
//                        as the forward made it (:350-354) and
//                        ds = ((pd.dpd - p.delta) * scale) rounded (:372-373)
//   3. attention_bwd_dkdv: per key tile, looping over the query tiles:
//                        dv = pd^T . do (pd rounded), dk = ds^T . q; one
//                        program owns each key tile, so no float atomics
//                        and the sums are deterministic
//   4. gemm (B^T):       dx[M, E]   = [dq|dk|dv][M, 3P] . [Wq|Wk|Wv]^T  (:389-401)
// The weight and bias gradients stay outside, as plain matmuls and sums
// (:626-637).
//
// Attention-probability dropout: a Philox4x32-10 (attention_tiles.cuh), keyed by
// (seed, stream = b*H + head) -- the TPU's b*G*heads + g*heads + h (:161) --
// with the counter at (query row, key column). An element is kept when its
// first output word > rate * 2^32 and kept values are scaled by 1/(1-rate)
// (:111-113); the forward rounds after the scaling. The backward
// regenerates the mask; nothing stores it. plbt_attention_dropout_mask
// writes the same mask out, for checks only.
//
// What bounds it on the card: at [8, 512, 768] the forward is 25.7 GFLOP of
// products (19.3 in the two projections, 6.4 in q.k and p.v) against ~60 MB
// of device-memory traffic, so it is bound by arithmetic; the backward does
// about 2.3x that. This version does the arithmetic on the CUDA cores in
// fp32 (no tensor cores), so it runs far below the card's bf16 tensor rate;
// the attention kernels recompute q.k (twice in the forward, to round the
// normalised probabilities; three times in the backward) rather than store
// [L, L] tiles. Scores never leave shared memory. Right first: tensor cores
// (mma.sync, then wgmma with TMA) are the next steps.

#include "attention_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] . op(B) (+ bias[N]); op(B) = B[K, N] row-major, or with
// TB the transpose of B[N, K] row-major. fp32 accumulation, the bias added
// in fp32 before the one rounding to T. A 128x128 tile per block, 16 deep;
// each of 256 threads holds 8x8 outputs at rows ty + 16i and columns
// tx + 16j, so shared-memory reads are broadcast or conflict-free and
// global stores are 16 consecutive elements.
constexpr int GBM = 128, GBN = 128, GBK = 16, GTHREADS = 256;

template <typename T, bool TB>
__global__ void __launch_bounds__(GTHREADS)
gemm_bias(const T* __restrict__ A, const T* __restrict__ B,
          const float* __restrict__ bias, T* __restrict__ C,
          int M, int N, int K) {
  __shared__ float As[GBK][GBM + 4];  // transposed: As[k][m]
  __shared__ float Bs[GBK][GBN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    for (int i = tid; i < GBM * GBK; i += GTHREADS) {
      const int m = i / GBK, k = i % GBK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? to_f(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int i = tid; i < GBK * GBN; i += GTHREADS) {
      int k, n;
      if (TB) {  // consecutive threads walk B's rows, which are contiguous in k
        n = i / GBK;
        k = i % GBK;
      } else {
        k = i / GBN;
        n = i % GBN;
      }
      const int gk = k0 + k, gn = n0 + n;
      float v = 0.f;
      if (gk < K && gn < N) v = to_f(TB ? B[(size_t)gn * K + gk] : B[(size_t)gk * N + gn]);
      Bs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GBK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[(size_t)gm * N + gn] = from_f<T>(acc[i][j] + (bias ? bias[gn] : 0.f));
    }
  }
}

// keep[b, h, q, k] = 1 where the dropout keeps the element, else 0
__global__ void dropout_mask(uint8_t* __restrict__ out, int B, int H, int L, Dropout drop) {
  const size_t n = (size_t)B * H * L * L;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(i % L), q = (int)((i / L) % L);
    const uint32_t stream = (uint32_t)(i / ((size_t)L * L));
    out[i] = drop.keep(stream, q, k) ? 1 : 0;
  }
}

template <typename T, bool TB>
cudaError_t launch_gemm(const void* A, const void* B, const void* bias, void* C,
                        int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_bias<T, TB><<<grid, GTHREADS, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const float*>(bias), static_cast<T*>(C), M, N, K);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                    const void* bo, const void* bias_row, const void* seg_row, void* qkv,
                    void* ctx, void* out, void* stat_m, void* stat_l, int B, int L, int E,
                    int P, int H, Dropout drop, cudaStream_t stream) {
  const int M = B * L;
  cudaError_t err = launch_gemm<T, false>(x, wqkv, bqkv, qkv, M, 3 * P, E, stream);
  if (err != cudaSuccess) return err;
  // q, k and v are the three P-wide sections of a qkv row
  const T* sec = static_cast<const T*>(qkv);
  err = launch_attention_fwd<T, D>(
      Rows<const T>{sec, 3 * P}, Rows<const T>{sec + P, 3 * P}, Rows<const T>{sec + 2 * P, 3 * P},
      static_cast<const float*>(bias_row), static_cast<const float*>(seg_row),
      Rows<T>{static_cast<T*>(ctx), P}, static_cast<float*>(stat_m),
      static_cast<float*>(stat_l), B, L, H, drop, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, false>(ctx, wo, bo, out, M, E, P, stream);
}

template <typename T, int D>
cudaError_t run_bwd(const void* dout, const void* wqkv, const void* wo, const void* qkv,
                    const void* stat_m, const void* stat_l, const void* bias_row,
                    const void* seg_row, void* dO, void* delta, void* dqkv, void* dx, int B,
                    int L, int E, int P, int H, Dropout drop, cudaStream_t stream) {
  const int M = B * L;
  cudaError_t err = launch_gemm<T, true>(dout, wo, nullptr, dO, M, P, E, stream);
  if (err != cudaSuccess) return err;
  const T* sec = static_cast<const T*>(qkv);
  T* dsec = static_cast<T*>(dqkv);
  // the saved statistics are only read (RECOMPUTE = false)
  err = launch_attention_bwd<T, D, false>(
      Rows<const T>{sec, 3 * P}, Rows<const T>{sec + P, 3 * P}, Rows<const T>{sec + 2 * P, 3 * P},
      Rows<const T>{static_cast<const T*>(dO), P},
      const_cast<float*>(static_cast<const float*>(stat_m)),
      const_cast<float*>(static_cast<const float*>(stat_l)), static_cast<float*>(delta),
      static_cast<const float*>(bias_row), static_cast<const float*>(seg_row),
      Rows<T>{dsec, 3 * P}, Rows<T>{dsec + P, 3 * P}, Rows<T>{dsec + 2 * P, 3 * P},
      B, L, H, drop, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, true>(dqkv, wqkv, nullptr, dx, M, E, 3 * P, stream);
}

bool shape_ok(int B, int L, int E, int P, int H) {
  if (B < 1 || L < 1 || E < 1 || H < 1 || P % H) return false;
  const int D = P / H;
  return D == 64 || D == 128;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; x, the matrices, qkv, ctx and
// out are all of that type. Each entry returns cudaGetLastError() after its
// launches (0 = success), or -1 for arguments it refuses.
// bias_row [B, L] fp32 is already clamped to _NEG, or NULL for none;
// seg_row [B, L] fp32, or NULL for no segments. qkv [B*L, 3P] and
// ctx [B*L, P] are written; stat_m and stat_l [B, H, L] fp32 are written
// when not NULL (the training forward), else the light forward runs.
// dropout != 0 drops attention probabilities with (seed, thresh, inv_keep).
extern "C" int plbt_attention_block_fwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias_row, const void* seg_row, void* qkv, void* ctx, void* out,
    void* stat_m, void* stat_l, int B, int L, int E, int P, int H, int dtype,
    int dropout, unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!shape_ok(B, L, E, P, H) || (stat_m == nullptr) != (stat_l == nullptr)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = P / H == 64;
  cudaError_t err;
  if (dtype == 0) {
    err = d64 ? run_fwd<float, 64>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx, out,
                                   stat_m, stat_l, B, L, E, P, H, drop, st)
              : run_fwd<float, 128>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx, out,
                                    stat_m, stat_l, B, L, E, P, H, drop, st);
  } else if (dtype == 1) {
    err = d64 ? run_fwd<__nv_bfloat16, 64>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx,
                                           out, stat_m, stat_l, B, L, E, P, H, drop, st)
              : run_fwd<__nv_bfloat16, 128>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv,
                                            ctx, out, stat_m, stat_l, B, L, E, P, H, drop, st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

// The backward of the training forward. dout [B*L, E], wqkv [E, 3P],
// wo [P, E], qkv [B*L, 3P] (saved) in the compute type; stat_m/stat_l
// [B, H, L] fp32 (saved); bias_row/seg_row and the dropout as in the
// forward. Scratch: dO [B*L, P] of the compute type, delta [B, H, L] fp32.
// Writes dqkv [B*L, 3P] (= [dq|dk|dv], the compute type) and dx [B*L, E].
extern "C" int plbt_attention_block_bwd(
    const void* dout, const void* wqkv, const void* wo, const void* qkv, const void* stat_m,
    const void* stat_l, const void* bias_row, const void* seg_row, void* dO, void* delta,
    void* dqkv, void* dx, int B, int L, int E, int P, int H, int dtype, int dropout,
    unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!shape_ok(B, L, E, P, H)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = P / H == 64;
  cudaError_t err;
  if (dtype == 0) {
    err = d64 ? run_bwd<float, 64>(dout, wqkv, wo, qkv, stat_m, stat_l, bias_row, seg_row, dO,
                                   delta, dqkv, dx, B, L, E, P, H, drop, st)
              : run_bwd<float, 128>(dout, wqkv, wo, qkv, stat_m, stat_l, bias_row, seg_row,
                                    dO, delta, dqkv, dx, B, L, E, P, H, drop, st);
  } else if (dtype == 1) {
    err = d64 ? run_bwd<__nv_bfloat16, 64>(dout, wqkv, wo, qkv, stat_m, stat_l, bias_row,
                                           seg_row, dO, delta, dqkv, dx, B, L, E, P, H, drop,
                                           st)
              : run_bwd<__nv_bfloat16, 128>(dout, wqkv, wo, qkv, stat_m, stat_l, bias_row,
                                            seg_row, dO, delta, dqkv, dx, B, L, E, P, H, drop,
                                            st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

// The attention dropout's keep mask [B, H, L, L] uint8, from the same
// Philox code the kernels use; for checks (nothing on the training path
// stores a mask).
extern "C" int plbt_attention_dropout_mask(void* out, int B, int H, int L, unsigned int seed,
                                           unsigned int thresh, void* stream) {
  if (B < 1 || H < 1 || L < 1) return -1;
  const Dropout drop = make_dropout(1, seed, thresh, 1.f);
  dropout_mask<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), B, H, L, drop);
  return static_cast<int>(cudaGetLastError());
}
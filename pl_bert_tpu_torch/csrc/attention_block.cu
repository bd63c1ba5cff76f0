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
// Attention-probability dropout: a Philox4x32-10 written here, keyed by
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// _NEG of attention_block.py:51: a finite "minus infinity" for masked
// keys, so a fully masked row stays finite
constexpr float kNeg = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al., SC'11): counter (c0..c3), key (k0, k1);
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

struct Dropout {
  int on;            // 0: no dropout
  uint32_t seed;     // Philox key word 0
  uint32_t thresh;   // keep when bits > thresh = rate * 2^32
  float inv_keep;    // 1 / (1 - rate)
  __device__ __forceinline__ bool keep(uint32_t stream, int q, int k) const {
    return philox_word0((uint32_t)q, (uint32_t)k, seed, stream) > thresh;
  }
  __device__ __forceinline__ float apply(float p, uint32_t stream, int q, int k) const {
    if (!on) return p;
    return keep(stream, q, k) ? p * inv_keep : 0.f;
  }
};

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

// ---------------------------------------------------------------------------
// Attention tiles: 64 query rows x 64 key columns, 256 threads. Thread
// (ty, tx) owns rows 4ty..4ty+3 of a tile and columns tx + 16j (j < 4); a
// row's 64 entries are spread over the 16 lanes of one half-warp, which
// reduce row sums with shuffles. Any L: key columns past L score -inf (they
// do not exist), query rows past L are computed and not stored.
constexpr int AQ = 64, AK = 64, ATHREADS = 256;

// Loads rows r0..r0+63 of the head's q, k or v section (sec 0, 1, 2) of
// qkv [B*L, 3P] as fp32 into dst[64][D+1]; rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* base, int sec, int r0, int L,
                                          int P) {
  const size_t row3 = (size_t)3 * P;
  for (int i = threadIdx.x; i < 64 * D; i += ATHREADS) {
    const int r = i / D, d = i % D, g = r0 + r;
    dst[r * (D + 1) + d] = g < L ? to_f(base[(size_t)g * row3 + (size_t)sec * P + d]) : 0.f;
  }
}

// Loads rows r0..r0+63 of a [B*L, P] tensor's head columns (base points at
// batch b's row 0, column h*D) into dst[64][D+1]; rows past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_ctx_rows(float* dst, const T* base, int r0, int L, int P) {
  for (int i = threadIdx.x; i < 64 * D; i += ATHREADS) {
    const int r = i / D, d = i % D, g = r0 + r;
    dst[r * (D + 1) + d] = g < L ? to_f(base[(size_t)g * P + d]) : 0.f;
  }
}

// s[i][j] = sum_d A[4ty+i][d] * Bm[tx+16j][d], the products added in
// order d = 0..D-1 with fmaf: every kernel below computes q.k this way,
// so the backward reproduces the forward's scores bitwise.
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int tx, int ty,
                                         float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// The score of query q against key k from the raw product: scaled, the
// key's padding bias added, other segments masked, keys past L -inf.
__device__ __forceinline__ float score(float qk, float scale, float kbias, bool use_seg,
                                       float qseg, float kseg, int k, int L) {
  float v = qk * scale + kbias;
  if (use_seg && qseg != kseg) v = kNeg;
  if (k >= L) v = -CUDART_INF_F;
  return v;
}

// o[i][c] += sum_k P[4ty+i][k] * V[k][tx+16c] over a 64-wide tile; P has
// row stride 65, V row stride D+1.
template <int D>
__device__ __forceinline__ void pv_tile(const float* Pm, const float* V, int tx, int ty,
                                        float (&o)[4][D / 16]) {
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = Pm[(4 * ty + i) * 65 + k];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float vv = V[k * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
    }
  }
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * AQ * (D + 1) + AQ * 65 + 3 * AK;
}

// One block per (64-row query tile, head, batch item), two passes over
// the key tiles:
//   pass 1: the row max m and the denominator l = sum exp(s - m), kept
//           online (fp32);
//   pass 2: p = exp(s - m) / l, dropped out, rounded to T as the TPU kernel
//           rounds its probabilities before p.v, and ctx += p . v.
// With stat_m/stat_l (the training forward) m and l are saved [B, H, L].
template <typename T, int D>
__global__ void __launch_bounds__(ATHREADS)
attention_fwd(const T* __restrict__ qkv, const float* __restrict__ bias_row,
              const float* __restrict__ seg_row, T* __restrict__ ctx,
              float* __restrict__ stat_m, float* __restrict__ stat_l,
              int L, int P, float scale, Dropout drop) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + AQ * (D + 1);
  float* Vs = Ks + AK * (D + 1);
  float* Ps = Vs + AK * (D + 1);
  float* kbias = Ps + AQ * 65;
  float* kseg = kbias + AK;
  float* qseg = kseg + AK;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const T* base = qkv + (size_t)b * L * 3 * P + (size_t)h * D;
  const bool use_seg = seg_row != nullptr;

  load_rows<T, D>(Qs, base, 0, q0, L, P);
  if (tid < AQ) {
    const int q = q0 + tid;
    qseg[tid] = (use_seg && q < L) ? seg_row[(size_t)b * L + q] : 0.f;
  }

  auto score_tile = [&](int k0, bool with_v, float (&s)[4][4]) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_rows<T, D>(Ks, base, 1, k0, L, P);
    if (with_v) load_rows<T, D>(Vs, base, 2, k0, L, P);
    if (tid < AK) {
      const int k = k0 + tid;
      kbias[tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
      kseg[tid] = (use_seg && k < L) ? seg_row[(size_t)b * L + k] : 0.f;
    }
    __syncthreads();
    dot_tile<D>(Qs, Ks, tx, ty, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = score(s[i][j], scale, kbias[c], use_seg, qseg[4 * ty + i], kseg[c],
                        k0 + c, L);
      }
  };

  float m_run[4], l_run[4], s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += AK) {
    score_tile(k0, false, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx =
          half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      // column 0 of the first tile is always a real key, so m_new is
      // finite and exp(-inf - m_new) is 0, never exp(-inf + inf)
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + half_warp_sum(sum);
      m_run[i] = m_new;
    }
  }

  // pass 2; l >= 1 (the row's max contributes exp(0)), so the division is safe
  float o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  for (int k0 = 0; k0 < L; k0 += AK) {
    score_tile(k0, true, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(s[i][j] - m_run[i]) / l_run[i];
        Ps[(4 * ty + i) * 65 + c] =
            round_to<T>(drop.apply(p, stream, q0 + 4 * ty + i, k0 + c));
      }
    __syncthreads();
    pv_tile<D>(Ps, Vs, tx, ty, o);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * ty + i;
    if (q >= L) continue;
    T* dst = ctx + ((size_t)b * L + q) * P + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f<T>(o[i][c]);
    if (stat_m && tx == 0) {
      const size_t at = ((size_t)b * H + h) * L + q;
      stat_m[at] = m_run[i];
      stat_l[at] = l_run[i];
    }
  }
}

template <int D>
constexpr size_t bwd_dq_smem_floats() {
  return 4 * 64 * (D + 1) + 64 * 65 + 3 * 64;
}

// dq, and delta = sum_j dpd.pd, for one (64-row query tile, head, batch
// item): pass 1 over the key tiles sums delta (it uses the unrounded pd, so
// it is not rowsum(do * o) once o is rounded or dropout applies); pass 2
// forms ds and accumulates dq = ds . k.
template <typename T, int D>
__global__ void __launch_bounds__(ATHREADS)
attention_bwd_dq(const T* __restrict__ qkv, const T* __restrict__ dO,
                 const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                 const float* __restrict__ bias_row, const float* __restrict__ seg_row,
                 float* __restrict__ delta_out, T* __restrict__ dqkv,
                 int L, int P, float scale, Dropout drop) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * (D + 1);
  float* Ks = dOs + 64 * (D + 1);
  float* Vs = Ks + 64 * (D + 1);
  float* DSs = Vs + 64 * (D + 1);
  float* kbias = DSs + 64 * 65;
  float* kseg = kbias + 64;
  float* qseg = kseg + 64;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const T* base = qkv + (size_t)b * L * 3 * P + (size_t)h * D;
  const bool use_seg = seg_row != nullptr;

  load_rows<T, D>(Qs, base, 0, q0, L, P);
  load_ctx_rows<T, D>(dOs, dO + (size_t)b * L * P + (size_t)h * D, q0, L, P);
  if (tid < 64) {
    const int q = q0 + tid;
    qseg[tid] = (use_seg && q < L) ? seg_row[(size_t)b * L + q] : 0.f;
  }
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * ty + i;
    const size_t at = ((size_t)b * H + h) * L + q;
    m[i] = q < L ? stat_m[at] : 0.f;
    l[i] = q < L ? stat_l[at] : 1.f;
  }

  // p (the forward's probability), pd (dropped out, unrounded) and
  // dpd = do . v for this thread's 4x4 entries of key tile k0
  float p[4][4], pd[4][4], dpd[4][4];
  auto tile = [&](int k0) {
    __syncthreads();
    load_rows<T, D>(Ks, base, 1, k0, L, P);
    load_rows<T, D>(Vs, base, 2, k0, L, P);
    if (tid < 64) {
      const int k = k0 + tid;
      kbias[tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
      kseg[tid] = (use_seg && k < L) ? seg_row[(size_t)b * L + k] : 0.f;
    }
    __syncthreads();
    float s[4][4];
    dot_tile<D>(Qs, Ks, tx, ty, s);
    dot_tile<D>(dOs, Vs, tx, ty, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, q = q0 + 4 * ty + i;
        const float sc = score(s[i][j], scale, kbias[c], use_seg, qseg[4 * ty + i], kseg[c],
                               k0 + c, L);
        p[i][j] = q < L ? expf(sc - m[i]) / l[i] : 0.f;
        pd[i][j] = drop.apply(p[i][j], stream, q, k0 + c);
      }
  };

  float delta[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < L; k0 += AK) {
    tile(k0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) delta[i] = fmaf(dpd[i][j], pd[i][j], delta[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) delta[i] = half_warp_sum(delta[i]);

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;
  for (int k0 = 0; k0 < L; k0 += AK) {
    tile(k0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        DSs[(4 * ty + i) * 65 + tx + 16 * j] =
            round_to<T>((pd[i][j] * dpd[i][j] - p[i][j] * delta[i]) * scale);
    __syncthreads();
    pv_tile<D>(DSs, Ks, tx, ty, dq);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * ty + i;
    if (q >= L) continue;
    T* dst = dqkv + ((size_t)b * L + q) * 3 * P + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f<T>(dq[i][c]);
    if (tx == 0) delta_out[((size_t)b * H + h) * L + q] = delta[i];
  }
}

template <int D>
constexpr size_t bwd_dkdv_smem_floats() {
  return 4 * 64 * (D + 1) + 2 * 64 * 65 + 6 * 64;
}

// dk and dv for one (64-row key tile, head, batch item), looping over the
// query tiles. The tile is the transpose of the forward's: thread (ty, tx)
// owns key rows 4ty+i and query columns tx+16j, so sT[i][j] = k . q is the
// forward's score with the factors swapped (the same products in the same
// order, so the same bits).
template <typename T, int D>
__global__ void __launch_bounds__(ATHREADS)
attention_bwd_dkdv(const T* __restrict__ qkv, const T* __restrict__ dO,
                   const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                   const float* __restrict__ delta_in, const float* __restrict__ bias_row,
                   const float* __restrict__ seg_row, T* __restrict__ dqkv,
                   int L, int P, float scale, Dropout drop) {
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * (D + 1);
  float* Qs = Vs + 64 * (D + 1);
  float* dOs = Qs + 64 * (D + 1);
  float* PdT = dOs + 64 * (D + 1);  // [key][query], rounded pd
  float* DsT = PdT + 64 * 65;       // [key][query], rounded ds
  float* qm = DsT + 64 * 65;
  float* ql = qm + 64;
  float* qdelta = ql + 64;
  float* qseg = qdelta + 64;
  float* kbias = qseg + 64;
  float* kseg = kbias + 64;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * AK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const T* base = qkv + (size_t)b * L * 3 * P + (size_t)h * D;
  const T* dO_base = dO + (size_t)b * L * P + (size_t)h * D;
  const bool use_seg = seg_row != nullptr;

  load_rows<T, D>(Ks, base, 1, k0, L, P);
  load_rows<T, D>(Vs, base, 2, k0, L, P);
  if (tid < 64) {
    const int k = k0 + tid;
    kbias[tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
    kseg[tid] = (use_seg && k < L) ? seg_row[(size_t)b * L + k] : 0.f;
  }

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += AQ) {
    __syncthreads();  // the previous query tile's reads are done
    load_rows<T, D>(Qs, base, 0, q0, L, P);
    load_ctx_rows<T, D>(dOs, dO_base, q0, L, P);
    if (tid < 64) {
      const int q = q0 + tid;
      const size_t at = ((size_t)b * H + h) * L + q;
      const bool ok = q < L;
      qm[tid] = ok ? stat_m[at] : 0.f;
      ql[tid] = ok ? stat_l[at] : 1.f;
      qdelta[tid] = ok ? delta_in[at] : 0.f;
      qseg[tid] = (use_seg && ok) ? seg_row[(size_t)b * L + q] : 0.f;
    }
    __syncthreads();
    float s[4][4], dpd[4][4];
    dot_tile<D>(Ks, Qs, tx, ty, s);
    dot_tile<D>(Vs, dOs, tx, ty, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 4 * ty + i, k = k0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, q = q0 + qc;
        const float sc = score(s[i][j], scale, kbias[kr], use_seg, qseg[qc], kseg[kr], k, L);
        const float p = q < L ? expf(sc - qm[qc]) / ql[qc] : 0.f;
        const float pd = drop.apply(p, stream, q, k);
        PdT[kr * 65 + qc] = round_to<T>(pd);
        DsT[kr * 65 + qc] = round_to<T>((pd * dpd[i][j] - p * qdelta[qc]) * scale);
      }
    }
    __syncthreads();
    pv_tile<D>(PdT, dOs, tx, ty, dv);
    pv_tile<D>(DsT, Qs, tx, ty, dk);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= L) continue;
    T* row = dqkv + ((size_t)b * L + k) * 3 * P + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      row[P + tx + 16 * c] = from_f<T>(dk[i][c]);
      row[2 * P + tx + 16 * c] = from_f<T>(dv[i][c]);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Dropout make_dropout(int on, unsigned int seed, unsigned int thresh, float inv_keep) {
  Dropout d;
  d.on = on;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  return d;
}

template <typename T, int D>
cudaError_t run_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                    const void* bo, const void* bias_row, const void* seg_row, void* qkv,
                    void* ctx, void* out, void* stat_m, void* stat_l, int B, int L, int E,
                    int P, int H, Dropout drop, cudaStream_t stream) {
  const int M = B * L;
  cudaError_t err = launch_gemm<T, false>(x, wqkv, bqkv, qkv, M, 3 * P, E, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  err = allow_smem(attention_fwd<T, D>, smem);
  if (err != cudaSuccess) return err;
  attention_fwd<T, D><<<dim3((L + AQ - 1) / AQ, H, B), ATHREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias_row),
      static_cast<const float*>(seg_row), static_cast<T*>(ctx), static_cast<float*>(stat_m),
      static_cast<float*>(stat_l), L, P, 1.f / sqrtf((float)D), drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<T, false>(ctx, wo, bo, out, M, E, P, stream);
}

template <typename T, int D>
cudaError_t run_bwd(const void* dout, const void* wqkv, const void* wo, const void* qkv,
                    const void* stat_m, const void* stat_l, const void* bias_row,
                    const void* seg_row, void* dO, void* delta, void* dqkv, void* dx, int B,
                    int L, int E, int P, int H, Dropout drop, cudaStream_t stream) {
  const int M = B * L;
  const float scale = 1.f / sqrtf((float)D);
  cudaError_t err = launch_gemm<T, true>(dout, wo, nullptr, dO, M, P, E, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + 63) / 64, H, B);
  size_t smem = sizeof(float) * bwd_dq_smem_floats<D>();
  err = allow_smem(attention_bwd_dq<T, D>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<T, D><<<grid, ATHREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dO),
      static_cast<const float*>(stat_m), static_cast<const float*>(stat_l),
      static_cast<const float*>(bias_row), static_cast<const float*>(seg_row),
      static_cast<float*>(delta), static_cast<T*>(dqkv), L, P, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = sizeof(float) * bwd_dkdv_smem_floats<D>();
  err = allow_smem(attention_bwd_dkdv<T, D>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv<T, D><<<grid, ATHREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dO),
      static_cast<const float*>(stat_m), static_cast<const float*>(stat_l),
      static_cast<const float*>(delta), static_cast<const float*>(bias_row),
      static_cast<const float*>(seg_row), static_cast<T*>(dqkv), L, P, scale, drop);
  err = cudaGetLastError();
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

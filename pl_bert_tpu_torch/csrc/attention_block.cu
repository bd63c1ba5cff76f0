// Attention-block forward for Hopper: QKV projection, softmax attention
// and output projection, all in kernels written here.
//
// Replaces the primal-only ("light") Pallas kernels of
// pl_bert_tpu/ops/attention_block.py: _fwd_kernel_light_full (one grid
// program per batch item, bf16) and _fwd_kernel_light (per 128-lane head
// group with an fp32 accumulator over groups, fp32). One design covers
// both, at any sequence length and head_dim 64 or 128.
//
// Three launches on the caller's stream, no allocation (the wrapper
// passes the qkv and ctx scratch):
//   1. gemm_bias:      qkv[M, 3P] = x[M, E] . [Wq|Wk|Wv][E, 3P] + [bq|bk|bv]
//   2. attention_fwd:  ctx[M, P]  = softmax(q k^T / sqrt(D) + bias [+ seg]) v
//   3. gemm_bias:      out[M, E]  = ctx[M, P] . Wo[P, E] + bo
// M = B*L. Accumulation, the bias adds and the softmax are fp32; q/k/v,
// p and ctx are rounded to the compute type T at the points where the
// TPU kernel rounds them (attention_block.py:204-215, 233-237, 250).
//
// What bounds it on the card: at the serving shape [8, 512, 768] the
// block is 25.7 GFLOP of products (19.3 in the two projections, 6.4 in
// q.k and p.v) against ~60 MB of device-memory traffic (x, q/k/v, ctx and
// out), so it is bound by arithmetic. This first version does that
// arithmetic on the CUDA cores in fp32 (no tensor cores), so it runs far
// below the card's bf16 tensor rate, and its attention kernel computes
// q.k twice (once for the softmax statistics, once for the probabilities:
// 9.7 GFLOP done for 6.4 needed) so that it rounds the normalised
// probabilities as the TPU kernel does. The scores never leave shared
// memory. It is written to be right first; tensor cores (mma.sync, then
// wgmma with TMA) and fusing the projections into the attention kernel
// are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>

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

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] . B[K, N] + bias[N]; row-major, fp32 accumulation,
// bias added in fp32 before the one rounding to T. A 128x128 tile per
// block, 16 deep; each of 256 threads holds 8x8 outputs at rows
// ty + 16i and columns tx + 16j, so shared-memory reads are broadcast or
// conflict-free and global stores are 16 consecutive elements.
constexpr int GBM = 128, GBN = 128, GBK = 16, GTHREADS = 256;

template <typename T>
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
      const int k = i / GBN, n = i % GBN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < K && gn < N) ? to_f(B[(size_t)gk * N + gn]) : 0.f;
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
      if (gn < N) C[(size_t)gm * N + gn] = from_f<T>(acc[i][j] + bias[gn]);
    }
  }
}

// ---------------------------------------------------------------------------
// One block per (64-row query tile, head, batch item), in two passes over
// 64-column key tiles, so any L works: key columns past L are -inf (they
// do not exist), query rows past L are computed and not stored.
//   pass 1: the row max m and the denominator l = sum exp(s - m), kept
//           online (fp32) over the key tiles;
//   pass 2: the scores again, p = exp(s - m) / l, rounded to T as the TPU
//           kernel rounds its normalised probabilities before p.v
//           (attention_block.py:100, 233-235), and ctx += p . v.
// Thread (ty, tx) owns query rows 4ty..4ty+3; a row's 64 scores are
// spread over the 16 lanes of one half-warp, which reduce the row max
// and sum with shuffles.
constexpr int AQ = 64, AK = 64, ATHREADS = 256;

template <int D>
constexpr size_t attention_smem_floats() {
  return AQ * (D + 1) + AK * (D + 1) + AK * D + AQ * (AK + 1) + 2 * AK + AQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(ATHREADS)
attention_fwd(const T* __restrict__ qkv, const float* __restrict__ bias_row,
              const float* __restrict__ seg_row, T* __restrict__ ctx,
              int L, int P, float scale) {
  constexpr int QST = D + 1, KST = D + 1, VST = D, PST = AK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + AQ * QST;
  float* Vs = Ks + AK * KST;
  float* Ps = Vs + AK * VST;
  float* kbias = Ps + AQ * PST;
  float* kseg = kbias + AK;
  float* qseg = kseg + AK;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z;
  const size_t row3 = (size_t)3 * P;
  const T* base = qkv + (size_t)b * L * row3 + (size_t)h * D;
  const bool use_seg = seg_row != nullptr;

  for (int i = tid; i < AQ * D; i += ATHREADS) {
    const int r = i / D, d = i % D, q = q0 + r;
    Qs[r * QST + d] = q < L ? to_f(base[(size_t)q * row3 + d]) : 0.f;
  }
  if (tid < AQ) {
    const int q = q0 + tid;
    qseg[tid] = (use_seg && q < L) ? seg_row[(size_t)b * L + q] : 0.f;
  }

  // Loads key tile k0 (and its values when with_v) into shared memory and
  // leaves this thread's scaled, biased and masked scores in s.
  auto score_tile = [&](int k0, bool with_v, float (&s)[4][4]) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    for (int i = tid; i < AK * D; i += ATHREADS) {
      const int r = i / D, d = i % D, k = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (k < L) {
        const T* row = base + (size_t)k * row3 + d;
        kv = to_f(row[P]);
        if (with_v) vv = to_f(row[2 * P]);
      }
      Ks[r * KST + d] = kv;
      if (with_v) Vs[r * VST + d] = vv;
    }
    if (tid < AK) {
      const int k = k0 + tid;
      kbias[tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
      kseg[tid] = (use_seg && k < L) ? seg_row[(size_t)b * L + k] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * QST + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KST + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float sq = qseg[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float v = s[i][j] * scale + kbias[c];
        if (use_seg && sq != kseg[c]) v = kNeg;
        if (k0 + c >= L) v = -CUDART_INF_F;
        s[i][j] = v;
      }
    }
  };

  // pass 1: row max and denominator
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
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // column 0 of the first tile is always a real key, so m_new is
      // finite and exp(-inf - m_new) is 0, never exp(-inf + inf)
      const float m_new = fmaxf(m_run[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
    }
  }

  // pass 2: normalised probabilities, rounded to T, times v. l >= 1 (the
  // row's max contributes exp(0)), so the division is safe.
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
      for (int j = 0; j < 4; ++j)
        Ps[(4 * ty + i) * PST + tx + 16 * j] =
            to_f(from_f<T>(expf(s[i][j] - m_run[i]) / l_run[i]));
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < AK; ++k) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * PST + k];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[k * VST + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + 4 * ty + i;
    if (q >= L) continue;
    T* dst = ctx + ((size_t)b * L + q) * P + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f<T>(o[i][c]);
  }
}

template <typename T>
cudaError_t launch_gemm(const void* A, const void* B, const void* bias, void* C,
                        int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_bias<T><<<grid, GTHREADS, 0, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const float*>(bias), static_cast<T*>(C), M, N, K);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_attention(const void* qkv, const void* bias_row, const void* seg_row,
                             void* ctx, int B, int L, int P, int H, cudaStream_t stream) {
  const size_t smem = sizeof(float) * attention_smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + AQ - 1) / AQ, H, B);
  attention_fwd<T, D><<<grid, ATHREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias_row),
      static_cast<const float*>(seg_row), static_cast<T*>(ctx), L, P,
      1.f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_block(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                      const void* bo, const void* bias_row, const void* seg_row,
                      void* qkv, void* ctx, void* out, int B, int L, int E, int P,
                      int H, cudaStream_t stream) {
  const int M = B * L, D = P / H;
  cudaError_t err = launch_gemm<T>(x, wqkv, bqkv, qkv, M, 3 * P, E, stream);
  if (err != cudaSuccess) return err;
  err = D == 64 ? launch_attention<T, 64>(qkv, bias_row, seg_row, ctx, B, L, P, H, stream)
                : launch_attention<T, 128>(qkv, bias_row, seg_row, ctx, B, L, P, H, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm<T>(ctx, wo, bo, out, M, E, P, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; x, the matrices, the scratch
// and out are all of that type. Returns cudaGetLastError() after the
// launches (0 = success), or -1 for arguments it refuses.
// bias_row [B, L] fp32 is already clamped to _NEG, or NULL for none;
// seg_row [B, L] fp32, or NULL for no segments. qkv [B*L, 3P] and
// ctx [B*L, P] are scratch.
extern "C" int plbt_attention_block_fwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias_row, const void* seg_row, void* qkv, void* ctx, void* out,
    int B, int L, int E, int P, int H, int dtype, void* stream) {
  if (B < 1 || L < 1 || E < 1 || H < 1 || P % H) return -1;
  const int D = P / H;
  if (D != 64 && D != 128) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = run_block<float>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx, out,
                           B, L, E, P, H, st);
  } else if (dtype == 1) {
    err = run_block<__nv_bfloat16>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx,
                                   out, B, L, E, P, H, st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

// Softmax-attention kernels for Hopper shared by the attention block
// (attention_block.cu: K1-K4) and the per-head flash attention
// (flash_attention.cu: K7, K8): the Philox dropout, the score rule, the
// 64x64 tile products, and the three kernels built from them
//   attention_fwd       o = dropout(softmax(q k^T / sqrt(D) + bias [+ seg])) v
//   attention_bwd_dq    delta = sum_j dpd.pd and dq = ds . k, per query tile
//   attention_bwd_dkdv  dv = pd^T . do and dk = ds^T . q, per key tile
// Each takes q, k, v (and do, and the outputs) as Rows: a base pointer and
// the distance between rows, so the same kernel reads the three sections of
// the block's qkv [B*L, 3P] buffer or three separate [B, L, H, D] tensors
// (contiguous, or views of one fused projection) without a transposed copy.
//
// Accumulation and the softmax are fp32; the normalised, dropped-out
// probabilities are rounded to the compute type T before p.v, and ds before
// ds.k and ds^T.q, where the TPU kernels round them
// (pl_bert_tpu/ops/attention_block.py:128-139, :372-373;
// pl_bert_tpu/ops/flash_attention.py:65-69, :110). The arithmetic runs on
// the CUDA cores in fp32 (no tensor cores yet); q.k is recomputed rather
// than an [L, L] tile stored, and scores never leave shared memory.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// _NEG of attention_block.py:51 and flash_attention.py:34: a finite "minus
// infinity" for masked keys, so a fully masked row stays finite
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

// Attention-probability dropout keyed by (seed, stream = b*H + head) with
// the counter at (query row, key column): an element is kept when its
// first output word > rate * 2^32, and kept values are scaled by 1/(1-rate).
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

inline Dropout make_dropout(int on, unsigned int seed, unsigned int thresh, float inv_keep) {
  Dropout d;
  d.on = on;
  d.seed = seed;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  return d;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One of q, k, v, do, o or a gradient: element (b, row, h, d) sits at
// ptr[(b*L + row)*ld + h*D + d], so rows are ld elements apart, batch
// items L rows apart, and a head's D columns are contiguous.
template <typename T>
struct Rows {
  T* ptr;
  int ld;
  __device__ __forceinline__ T* head(int b, int h, int L, int D) const {
    return ptr + (size_t)b * L * ld + (size_t)h * D;
  }
};

// ---------------------------------------------------------------------------
// Attention tiles: 64 query rows x 64 key columns, 256 threads. Thread
// (ty, tx) owns rows 4ty..4ty+3 of a tile and columns tx + 16j (j < 4); a
// row's 64 entries are spread over the 16 lanes of one half-warp, which
// reduce row sums with shuffles. Any L: key columns past L score -inf (they
// do not exist), query rows past L are computed and not stored.
constexpr int AQ = 64, AK = 64, ATHREADS = 256;

// Loads rows r0..r0+63 of one head (base points at the batch item's row 0,
// the head's column 0; rows are ld apart) as fp32 into dst[64][D+1]; rows
// past L are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int ld, int r0, int L) {
  for (int i = threadIdx.x; i < 64 * D; i += ATHREADS) {
    const int r = i / D, d = i % D, g = r0 + r;
    dst[r * (D + 1) + d] = g < L ? to_f(base[(size_t)g * ld + d]) : 0.f;
  }
}

// The padding bias and segment id of rows r0..r0+63 of batch item b; 0 past L
// and where the caller has none.
__device__ __forceinline__ void load_row_info(float* rbias, float* rseg,
                                              const float* __restrict__ bias_row,
                                              const float* __restrict__ seg_row, int b, int r0,
                                              int L) {
  if (threadIdx.x < 64) {
    const int r = r0 + threadIdx.x;
    if (rbias) rbias[threadIdx.x] = (r < L && bias_row) ? bias_row[(size_t)b * L + r] : 0.f;
    rseg[threadIdx.x] = (r < L && seg_row) ? seg_row[(size_t)b * L + r] : 0.f;
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

// The scores of the query tile in Qs against key tile k0: loads the key
// rows, their bias and segments, synchronises (so whatever else the caller
// loaded for this tile is visible too), and leaves this thread's 4x4
// scores in s. The caller synchronises before it, after the previous
// tile's reads.
template <typename T, int D>
__device__ __forceinline__ void key_tile_scores(
    const float* Qs, float* Ks, float* kbias, float* kseg, const float* qseg, const T* kbase,
    int ldk, const float* __restrict__ bias_row, const float* __restrict__ seg_row, int b,
    int k0, int L, float scale, float (&s)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool use_seg = seg_row != nullptr;
  load_tile<T, D>(Ks, kbase, ldk, k0, L);
  load_row_info(kbias, kseg, bias_row, seg_row, b, k0, L);
  __syncthreads();
  dot_tile<D>(Qs, Ks, tx, ty, s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      s[i][j] = score(s[i][j], scale, kbias[c], use_seg, qseg[4 * ty + i], kseg[c], k0 + c, L);
    }
}

// The row max m and the denominator l = sum exp(s - m) of this thread's four
// query rows over all keys, kept online in fp32. The forward's first pass,
// and the first pass of a backward that was handed no statistics: the same
// code, so both get the same bits.
template <typename T, int D>
__device__ __forceinline__ void row_stats(
    const float* Qs, float* Ks, float* kbias, float* kseg, const float* qseg, const T* kbase,
    int ldk, const float* __restrict__ bias_row, const float* __restrict__ seg_row, int b,
    int L, float scale, float (&m_run)[4], float (&l_run)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
  }
  for (int k0 = 0; k0 < L; k0 += AK) {
    float s[4][4];
    __syncthreads();  // the previous tile's reads are done
    key_tile_scores<T, D>(Qs, Ks, kbias, kseg, qseg, kbase, ldk, bias_row, seg_row, b, k0, L,
                          scale, s);
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
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * AQ * (D + 1) + AQ * 65 + 3 * AK;
}

// One block per (64-row query tile, head, batch item), two passes over
// the key tiles:
//   pass 1: the row max m and the denominator l (row_stats);
//   pass 2: p = exp(s - m) / l, dropped out, rounded to T as the TPU kernel
//           rounds its probabilities before p.v, and o += p . v.
// With stat_m/stat_l (the block's training forward) m and l are saved
// [B, H, L]; the flash forward saves nothing.
template <typename T, int D>
__global__ void __launch_bounds__(ATHREADS)
attention_fwd(Rows<const T> q, Rows<const T> k, Rows<const T> v,
              const float* __restrict__ bias_row, const float* __restrict__ seg_row,
              Rows<T> o, float* __restrict__ stat_m, float* __restrict__ stat_l,
              int L, float scale, Dropout drop) {
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
  const T* kbase = k.head(b, h, L, D);
  const T* vbase = v.head(b, h, L, D);

  load_tile<T, D>(Qs, q.head(b, h, L, D), q.ld, q0, L);
  load_row_info(nullptr, qseg, nullptr, seg_row, b, q0, L);

  float m_run[4], l_run[4], s[4][4];
  row_stats<T, D>(Qs, Ks, kbias, kseg, qseg, kbase, k.ld, bias_row, seg_row, b, L, scale,
                  m_run, l_run);

  // pass 2; l >= 1 (the row's max contributes exp(0)), so the division is safe
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < L; k0 += AK) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<T, D>(Vs, vbase, v.ld, k0, L);
    key_tile_scores<T, D>(Qs, Ks, kbias, kseg, qseg, kbase, k.ld, bias_row, seg_row, b, k0, L,
                          scale, s);
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
    pv_tile<D>(Ps, Vs, tx, ty, acc);
  }

  T* obase = o.head(b, h, L, D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * ty + i;
    if (qr >= L) continue;
    T* dst = obase + (size_t)qr * o.ld;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f<T>(acc[i][c]);
    if (stat_m && tx == 0) {
      const size_t at = ((size_t)b * H + h) * L + qr;
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
// forms ds and accumulates dq = ds . k. With RECOMPUTE (the flash backward,
// whose forward saved no statistics) a pass 0 first recomputes m and l as
// the forward made them and writes them to stat_m/stat_l for
// attention_bwd_dkdv; without it they are read from there.
template <typename T, int D, bool RECOMPUTE>
__global__ void __launch_bounds__(ATHREADS)
attention_bwd_dq(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dO,
                 float* __restrict__ stat_m, float* __restrict__ stat_l,
                 const float* __restrict__ bias_row, const float* __restrict__ seg_row,
                 float* __restrict__ delta_out, Rows<T> dq_out,
                 int L, float scale, Dropout drop) {
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
  const T* kbase = k.head(b, h, L, D);
  const T* vbase = v.head(b, h, L, D);

  load_tile<T, D>(Qs, q.head(b, h, L, D), q.ld, q0, L);
  load_tile<T, D>(dOs, dO.head(b, h, L, D), dO.ld, q0, L);
  load_row_info(nullptr, qseg, nullptr, seg_row, b, q0, L);
  float m[4], l[4];
  if (RECOMPUTE) {
    row_stats<T, D>(Qs, Ks, kbias, kseg, qseg, kbase, k.ld, bias_row, seg_row, b, L, scale,
                    m, l);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * ty + i;
    const size_t at = ((size_t)b * H + h) * L + qr;
    if (RECOMPUTE) {
      if (qr < L && tx == 0) {
        stat_m[at] = m[i];
        stat_l[at] = l[i];
      }
    } else {
      m[i] = qr < L ? stat_m[at] : 0.f;
      l[i] = qr < L ? stat_l[at] : 1.f;
    }
  }

  // p (the forward's probability), pd (dropped out, unrounded) and
  // dpd = do . v for this thread's 4x4 entries of key tile k0
  float p[4][4], pd[4][4], dpd[4][4];
  auto tile = [&](int k0) {
    __syncthreads();
    load_tile<T, D>(Vs, vbase, v.ld, k0, L);
    float s[4][4];
    key_tile_scores<T, D>(Qs, Ks, kbias, kseg, qseg, kbase, k.ld, bias_row, seg_row, b, k0, L,
                          scale, s);
    dot_tile<D>(dOs, Vs, tx, ty, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = q0 + 4 * ty + i;
        p[i][j] = qr < L ? expf(s[i][j] - m[i]) / l[i] : 0.f;
        pd[i][j] = drop.apply(p[i][j], stream, qr, k0 + tx + 16 * j);
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

  T* dqbase = dq_out.head(b, h, L, D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + 4 * ty + i;
    if (qr >= L) continue;
    T* dst = dqbase + (size_t)qr * dq_out.ld;
#pragma unroll
    for (int c = 0; c < DC; ++c) dst[tx + 16 * c] = from_f<T>(dq[i][c]);
    if (tx == 0) delta_out[((size_t)b * H + h) * L + qr] = delta[i];
  }
}

template <int D>
constexpr size_t bwd_dkdv_smem_floats() {
  return 4 * 64 * (D + 1) + 2 * 64 * 65 + 6 * 64;
}

// dk and dv for one (64-row key tile, head, batch item), looping over the
// query tiles; m, l and delta come from attention_bwd_dq. The tile is the
// transpose of the forward's: thread (ty, tx) owns key rows 4ty+i and query
// columns tx+16j, so sT[i][j] = k . q is the forward's score with the
// factors swapped (the same products in the same order, so the same bits).
// One program owns each key tile, so there are no float atomics and the
// sums are deterministic.
template <typename T, int D>
__global__ void __launch_bounds__(ATHREADS)
attention_bwd_dkdv(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dO,
                   const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                   const float* __restrict__ delta_in, const float* __restrict__ bias_row,
                   const float* __restrict__ seg_row, Rows<T> dk_out, Rows<T> dv_out,
                   int L, float scale, Dropout drop) {
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
  const T* qbase = q.head(b, h, L, D);
  const T* dO_base = dO.head(b, h, L, D);
  const bool use_seg = seg_row != nullptr;

  load_tile<T, D>(Ks, k.head(b, h, L, D), k.ld, k0, L);
  load_tile<T, D>(Vs, v.head(b, h, L, D), v.ld, k0, L);
  load_row_info(kbias, kseg, bias_row, seg_row, b, k0, L);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += AQ) {
    __syncthreads();  // the previous query tile's reads are done
    load_tile<T, D>(Qs, qbase, q.ld, q0, L);
    load_tile<T, D>(dOs, dO_base, dO.ld, q0, L);
    load_row_info(nullptr, qseg, nullptr, seg_row, b, q0, L);
    if (tid < 64) {
      const int qr = q0 + tid;
      const size_t at = ((size_t)b * H + h) * L + qr;
      const bool ok = qr < L;
      qm[tid] = ok ? stat_m[at] : 0.f;
      ql[tid] = ok ? stat_l[at] : 1.f;
      qdelta[tid] = ok ? delta_in[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dpd[4][4];
    dot_tile<D>(Ks, Qs, tx, ty, s);
    dot_tile<D>(Vs, dOs, tx, ty, dpd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 4 * ty + i, kk = k0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j, qr = q0 + qc;
        const float sc = score(s[i][j], scale, kbias[kr], use_seg, qseg[qc], kseg[kr], kk, L);
        const float p = qr < L ? expf(sc - qm[qc]) / ql[qc] : 0.f;
        const float pd = drop.apply(p, stream, qr, kk);
        PdT[kr * 65 + qc] = round_to<T>(pd);
        DsT[kr * 65 + qc] = round_to<T>((pd * dpd[i][j] - p * qdelta[qc]) * scale);
      }
    }
    __syncthreads();
    pv_tile<D>(PdT, dOs, tx, ty, dv);
    pv_tile<D>(DsT, Qs, tx, ty, dk);
  }

  T* dkbase = dk_out.head(b, h, L, D);
  T* dvbase = dv_out.head(b, h, L, D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + 4 * ty + i;
    if (kk >= L) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkbase[(size_t)kk * dk_out.ld + tx + 16 * c] = from_f<T>(dk[i][c]);
      dvbase[(size_t)kk * dv_out.ld + tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

// The launch of attention_bwd_dq then attention_bwd_dkdv over
// (ceil(L/64), H, B) blocks on `stream`.
template <typename T, int D, bool RECOMPUTE>
cudaError_t launch_attention_bwd(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                                 Rows<const T> dO, float* stat_m, float* stat_l, float* delta,
                                 const float* bias_row, const float* seg_row, Rows<T> dq,
                                 Rows<T> dk, Rows<T> dv, int B, int L, int H, Dropout drop,
                                 cudaStream_t stream) {
  const float scale = 1.f / sqrtf((float)D);
  const dim3 grid((L + 63) / 64, H, B);
  size_t smem = sizeof(float) * bwd_dq_smem_floats<D>();
  cudaError_t err = allow_smem(attention_bwd_dq<T, D, RECOMPUTE>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<T, D, RECOMPUTE><<<grid, ATHREADS, smem, stream>>>(
      q, k, v, dO, stat_m, stat_l, bias_row, seg_row, delta, dq, L, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = sizeof(float) * bwd_dkdv_smem_floats<D>();
  err = allow_smem(attention_bwd_dkdv<T, D>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv<T, D><<<grid, ATHREADS, smem, stream>>>(
      q, k, v, dO, stat_m, stat_l, delta, bias_row, seg_row, dk, dv, L, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_attention_fwd(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                                 const float* bias_row, const float* seg_row, Rows<T> o,
                                 float* stat_m, float* stat_l, int B, int L, int H,
                                 Dropout drop, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fwd_smem_floats<D>();
  cudaError_t err = allow_smem(attention_fwd<T, D>, smem);
  if (err != cudaSuccess) return err;
  attention_fwd<T, D><<<dim3((L + AQ - 1) / AQ, H, B), ATHREADS, smem, stream>>>(
      q, k, v, bias_row, seg_row, o, stat_m, stat_l, L, 1.f / sqrtf((float)D), drop);
  return cudaGetLastError();
}

}  // namespace

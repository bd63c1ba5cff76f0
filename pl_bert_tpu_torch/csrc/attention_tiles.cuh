// Softmax-attention kernels for Hopper shared by the attention block
// (attention_block.cu: K1-K4) and the per-head flash attention
// (flash_attention.cu: K7, K8): the Philox dropout, the score rule, and
//   attention_fwd_sm90       bf16 o = dropout(softmax(q k^T / sqrt(D) + bias
//                            [+ seg])) v on the tensor cores (wgmma, TMA) --
//                            the forward of K1, K3 and K7 in bf16
//   attention_bwd_dq_sm90    bf16 delta = sum_j dpd.pd and dq = ds . k, per
//                            query tile, on the tensor cores
//   attention_bwd_dkdv_sm90  bf16 dv = pd^T . do and dk = ds^T . q, per key
//                            tile, on the tensor cores
//                            (the flash backward K8 in bf16)
//   attention_fwd, attention_bwd_dq, attention_bwd_dkdv
//                            the same three on the CUDA cores: fp32 (where
//                            tensor cores would mean TF32), and the block
//                            backward K4 in bf16 too
// Each takes q, k, v (and do, and the outputs) as Rows: a base pointer and
// the distance between rows, so the same kernel reads the three sections of
// the block's qkv [B*L, 3P] buffer or three separate [B, L, H, D] tensors
// (contiguous, or views of one fused projection) without a transposed copy.
//
// Accumulation and the softmax are fp32; the normalised, dropped-out
// probabilities are rounded to the compute type T before p.v, and ds before
// ds.k and ds^T.q, where the TPU kernels round them
// (pl_bert_tpu/ops/attention_block.py:128-139, :372-373;
// pl_bert_tpu/ops/flash_attention.py:65-69, :110). Every kernel makes two
// passes over the key tiles (m and l, then the normalised p), recomputing
// q.k rather than storing an [L, L] tile; scores never leave the chip.
//
// What bounds the bf16 forward: at [8, 512, 12, 64] its q.k and p.v are
// 6.4 GFLOP (9.7 with q.k formed again in pass 2) against 25 MB of q, k, v
// and o, near the card's ridge of ~295 FLOP a byte; with dropout the
// Philox draws (ten rounds of two 32-bit multiplies per probability) are
// work of the same size on the integer units. The design: one warpgroup
// per (64-query tile, head, batch item) forms S = Q K^T with
// wgmma.m64n64k16 from shared memory, keeps the softmax statistics in
// registers (a row's 64 scores sit on the four threads of a quad), and in
// pass 2 turns S into the bf16 probabilities in registers, which are
// wgmma's A operand for O += P V (the RS form; V read MN-major). K and V
// tiles arrive by TMA through a 3-D map over [B, L, H*D] into a two-buffer
// ring, the next tile loading while this one is used; TMA zero-fills rows
// past L within each batch item. Its products are a small part of its
// time: the softmax arithmetic on the CUDA cores, the Philox draws and the
// K/V reloads from L2 (each K tile twice per query tile) set the rest.
//
// The bf16 flash backward (K8) needs five products, 10 L^2 D FLOP a
// (batch, head): q.k, do.v^T, pd^T.do, ds.k, ds^T.q, far above the ridge,
// so the tensor cores bound it. It forms ten (q.k four times, do.v^T
// twice more: the dq kernel's three passes over the keys and the dk/dv
// kernel each form their own). Every score it forms is the
// forward's own: the S tile (qk_tile), the score rule (score_tile) and the
// online row max and denominator (stats_tile) are the functions the
// forward calls, with queries the 64-row A operand in every kernel, so
// K8's recomputed m and l equal the block forward's (K3's) saved ones bit
// for bit and p = exp(s - m)/l is the forward's p. dq sums over the key
// tiles, dk and dv over the query tiles, each 64-deep step in a fresh
// accumulator promoted with round-to-nearest adds (sm90.cuh). pd^T and ds^T
// are written to shared memory in bf16 and read back by wgmma as MN-major
// A operands; q and do (or k and v) are read K-major for the products that
// sum over D and MN-major for those that sum over the queries, from the
// same TMA tile. The block backward (K4) keeps the CUDA-core kernels in
// bf16 as well (attention_block.cu says why): its scores are FMA chains
// over d, which match the plain version's cuBLAS fp32 scores, not the
// bf16 forward's tensor-core ones.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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
// order d = 0..D-1 with fmaf: the CUDA-core kernels below compute q.k this
// way, so the fp32 backward reproduces the fp32 forward's scores bitwise
// (K4's bf16 backward matches the bf16 forward's to fp32 rounding).
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
// query rows over all keys, kept online in fp32. The fp32 forward's first
// pass, and the first pass of a backward that was handed no statistics: the
// same code, so in fp32 both get the same bits.
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

// fp32 (K2, and K3/K7 in fp32) on the CUDA cores, where tensor cores would
// mean TF32 and about three decimal digits. One block per (64-row query
// tile, head, batch item), two passes over the key tiles:
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

// --- the tensor-core tiles the bf16 forward and backward share ----------------
//
// A warpgroup holds a 64 x 64 tile of scores in the wgmma accumulator
// layout: register r of thread (warp w, lane) is row 16w + lane/4 +
// 8*((r >> 1) & 1), column 8*(r >> 2) + 2*(lane % 4) + (r & 1). Every kernel
// that forms a score, forward or backward, goes through the three functions
// below in the same order, so they form the same bits.

// sc[64 x 64] = A . B^T over D for two K-major 64-row tiles of D columns
// (64-column boxes 8 KB apart): S = Q K^T, and in the backward also
// dP = dO V^T. The same wgmma shape and k16 order wherever S is formed.
template <int D>
__device__ __forceinline__ void qk_tile(float (&sc)[32], const uint8_t* A, const uint8_t* Bt) {
  pin(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss<0, 0>(sc, kmajor_desc(A, kk), kmajor_desc(Bt, kk), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  pin(sc);
}

// score's rule on a tile of raw q.k: kb/ks the 64 keys' bias and segment
// (key k0 + column), qseg this thread's two rows' segments. The scale and
// bias are one fmaf, written out rather than left to the compiler's
// contraction, so that every tensor-core kernel rounds them alike.
__device__ __forceinline__ void score_tile(float (&sc)[32], const float* kb, const float* ks,
                                           const float (&qseg)[2], bool use_seg, int k0, int L,
                                           float scale) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int c = 8 * (r >> 2) + 2 * t + (r & 1);
    float v = fmaf(sc[r], scale, kb[c]);
    if (use_seg && qseg[(r >> 1) & 1] != ks[c]) v = kNeg;
    if (k0 + c >= L) v = -CUDART_INF_F;
    sc[r] = v;
  }
}

// one key tile's step of the online row max and denominator of this
// thread's two rows (a row's 64 scores sit on the four threads of a quad)
__device__ __forceinline__ void stats_tile(const float (&sc)[32], float (&m_run)[2],
                                           float (&l_run)[2]) {
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * ih], sc[4 * c + 2 * ih + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // column 0 of the first tile is a real key, so m_new is finite
    const float m_new = fmaxf(m_run[ih], mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      sum += expf(sc[4 * c + 2 * ih] - m_new) + expf(sc[4 * c + 2 * ih + 1] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run[ih] = fmaf(l_run[ih], expf(m_run[ih] - m_new), sum);
    m_run[ih] = m_new;
  }
}

// the normalised probability, as the forward forms it before dropout
__device__ __forceinline__ float prob(float s, float m, float l) { return expf(s - m) / l; }

// --- the bf16 forward on the tensor cores ---------------------------------------

// Q, a two-buffer ring of K and of V tiles (64 rows x D, D/64 boxes of
// 8 KB each), the key tiles' bias and segments, three barriers
template <int D>
constexpr size_t fwd_sm90_smem() {
  return 1024 + 5 * (D / 64) * 8192 + 4 * AK * sizeof(float) + 3 * sizeof(uint64_t);
}

// attention_fwd's function for bf16, on the tensor cores; one warpgroup per
// (64-row query tile, head, batch item). Warp w holds query rows 16w..16w+15:
// thread (lane) rows r0 = 16w + lane/4 and r0 + 8, and of each key tile the
// columns 8c + 2(lane%4) + {0, 1}, c < 8 -- the wgmma accumulator layout.
// The loads are a sequence of 2n tiles (n = key tiles): pass 1's K tiles,
// then pass 2's K and V tiles, load i into buffer i % 2, issued by thread 0
// once every warp has finished with load i - 2.
template <int D>
__global__ void __launch_bounds__(128)
attention_fwd_sm90(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias_row,
                   const float* __restrict__ seg_row, Rows<__nv_bfloat16> o,
                   float* __restrict__ stat_m, float* __restrict__ stat_l, int L, float scale,
                   Dropout drop) {
  constexpr uint32_t TILE = (D / 64) * 8192;  // 64 rows of one head
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1k(smem_raw);
  uint8_t* Ks = Qs + TILE;      // [2][TILE]
  uint8_t* Vs = Ks + 2 * TILE;  // [2][TILE]
  float* kbias = reinterpret_cast<float*>(Vs + 2 * TILE);  // [2][64]
  float* kseg = kbias + 2 * AK;                             // [2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(kseg + 2 * AK);  // buffers 0, 1; Q

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const int n = (L + AK - 1) / AK;
  const bool use_seg = seg_row != nullptr;

  auto load = [&](int i) {  // thread 0
    const int s = i & 1, k0 = (i % n) * AK;
    const bool with_v = i >= n;
    mbar_expect_tx(&bar[s], (with_v ? 2u : 1u) * TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(Ks + s * TILE + c * 8192, &kmap, &bar[s], h * D + 64 * c, k0, b);
      if (with_v) tma_load_3d(Vs + s * TILE + c * 8192, &vmap, &bar[s], h * D + 64 * c, k0, b);
    }
  };
  auto load_keys = [&](int i) {  // the padding bias and segment of load i's keys
    if (tid < AK) {
      const int s = i & 1, k = (i % n) * AK + tid;
      kbias[s * AK + tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
      kseg[s * AK + tid] = (k < L && use_seg) ? seg_row[(size_t)b * L + k] : 0.f;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[2], TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      tma_load_3d(Qs + c * 8192, &qmap, &bar[2], h * D + 64 * c, q0, b);
    load(0);
    load(1);  // 2n >= 2
  }
  load_keys(0);
  load_keys(1);
  const int r0 = 16 * warp + lane / 4;
  float qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + r0 + 8 * i;
    qseg[i] = (use_seg && qr < L) ? seg_row[(size_t)b * L + qr] : 0.f;
  }
  __syncthreads();
  mbar_wait(&bar[2], 0);

  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_run[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
  for (int i = 0; i < 2 * n; ++i) {
    const int s = i & 1, k0 = (i % n) * AK;
    mbar_wait(&bar[s], (i >> 1) & 1);
    __syncwarp();
    float sc[32];
    qk_tile<D>(sc, Qs, Ks + s * TILE);
    score_tile(sc, kbias + s * AK, kseg + s * AK, qseg, use_seg, k0, L, scale);
    if (i < n) {  // pass 1: the row max and denominator, online
      stats_tile(sc, m_run, l_run);
    } else {  // pass 2: p normalised, dropped out, rounded; o += p . v
      uint32_t pa[16];
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int ih = (r >> 1) & 1, c = 8 * (r >> 2) + 2 * t, qr = q0 + r0 + 8 * ih;
        const float p0 = drop.apply(prob(sc[r], m_run[ih], l_run[ih]), stream, qr, k0 + c);
        const float p1 = drop.apply(prob(sc[r + 1], m_run[ih], l_run[ih]), stream, qr, k0 + c + 1);
        const __nv_bfloat162 pair = __floats2bfloat162_rn(p0, p1);
        pa[r / 2] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      float part[D / 2];  // this key tile's p.v, promoted into acc
      pin(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        if constexpr (D == 64)
          wgmma_m64n64k16_rs_tb(part, a, mnmajor_desc(Vs + s * TILE, kk), kk > 0);
        else
          wgmma_m64n128k16_rs_tb(part, a, mnmajor_desc(Vs + s * TILE, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(part);
      pin(pa);
      promote(acc, part);
    }
    __syncthreads();  // every warp is done with buffer s
    if (i + 2 < 2 * n) {
      if (tid == 0) load(i + 2);
      load_keys(i + 2);
    }
  }

  __nv_bfloat16* obase = o.head(b, h, L, D);
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qr = q0 + r0 + 8 * ih;
    if (qr >= L) continue;
    __nv_bfloat16* dst = obase + (size_t)qr * o.ld;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[4 * c + 2 * ih], acc[4 * c + 2 * ih + 1]);
    if (stat_m && t == 0) {
      const size_t at = ((size_t)b * H + h) * L + qr;
      stat_m[at] = m_run[ih];
      stat_l[at] = l_run[ih];
    }
  }
}

// A 3-D map over one of q, k, v: [B][L][cols] with rows r.ld apart, read
// in boxes of 64 columns x 64 rows of one batch item; rows past L read as
// zero. False if cuTensorMapEncodeTiled refuses it (r.ld or the base not a
// multiple of 16 bytes).
inline bool rows_map(CUtensorMap* map, Rows<const __nv_bfloat16> r, int B, int L, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)r.ld * 2, (cuuint64_t)L * r.ld * 2};
  const cuuint32_t box[3] = {64, AK, 1};
  return r.ld % 8 == 0 && bf16_map(map, r.ptr, 3, dims, strides, box);
}

// --- the bf16 backward on the tensor cores --------------------------------------

// The block's own pair of tiles (Q and dO, or K and V), a two-buffer ring of
// the other pair, with `transposed` the pd and ds tiles the dk/dv kernel
// writes for wgmma to read transposed, the key tiles' bias and segments,
// three barriers
template <int D>
constexpr size_t bwd_sm90_smem(bool transposed) {
  return 1024 + 6 * (D / 64) * 8192 + (transposed ? 2 * 8192 : 0) + 4 * AK * sizeof(float) +
         3 * sizeof(uint64_t);
}

// ds = (pd . dpd - p . delta) * scale with every product and difference
// rounded on its own, as the plain versions compute it; the dq and dk/dv
// kernels call this one function, so both get the same ds
__device__ __forceinline__ float ds_of(float pd, float dpd, float p, float delta, float scale) {
  return __fmul_rn(__fsub_rn(__fmul_rn(pd, dpd), __fmul_rn(p, delta)), scale);
}

// stores (v0, v1) rounded to bf16 at row `row`, columns 8c + 2t and +1, of a
// 64 x 64 bf16 tile in the layout TMA writes under the 128-byte swizzle
// (16-byte chunk c of a row sits at chunk c ^ (row % 8)); a warp's 32 stores
// fall in 32 different banks
__device__ __forceinline__ void st_pair_sw128(uint8_t* tile, int row, int c, int t, float v0,
                                              float v1) {
  *reinterpret_cast<__nv_bfloat162*>(tile + row * 128 + ((c ^ (row & 7)) << 4) + 4 * t) =
      __floats2bfloat162_rn(v0, v1);
}

// attention_bwd_dq's function for bf16 on the tensor cores, recomputing the
// statistics (K8, whose forward saved nothing): one warpgroup per (64-row
// query tile, head, batch item), in the forward's thread layout. Q and dO
// arrive once; the key side is a sequence of loads through a two-buffer
// ring, three passes over the n key tiles:
//   pass 0: m and l with the forward's code (K tiles only), written to
//     stat_m/stat_l for the dk/dv kernel;
//   pass 1: delta = sum_j dpd.pd from the unrounded pd, dpd = do.v^T on
//     wgmma;
//   pass 2: ds rounded to bf16 in registers is wgmma's A operand for
//     dq += ds . K (K read MN-major), each key tile's products promoted.
template <int D>
__global__ void __launch_bounds__(128)
attention_bwd_dq_sm90(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const float* __restrict__ bias_row, const float* __restrict__ seg_row,
                      float* __restrict__ stat_m, float* __restrict__ stat_l,
                      float* __restrict__ delta_out, Rows<__nv_bfloat16> dq_out, int L,
                      float scale, Dropout drop) {
  constexpr uint32_t TILE = (D / 64) * 8192;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1k(smem_raw);
  uint8_t* dOs = Qs + TILE;
  uint8_t* Ks = dOs + TILE;     // [2][TILE]
  uint8_t* Vs = Ks + 2 * TILE;  // [2][TILE]
  float* kbias = reinterpret_cast<float*>(Vs + 2 * TILE);  // [2][64]
  float* kseg = kbias + 2 * AK;                             // [2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(kseg + 2 * AK);  // buffers 0, 1; Q and dO

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int q0 = blockIdx.x * AQ, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const int n = (L + AK - 1) / AK, total = 3 * n;
  const bool use_seg = seg_row != nullptr;

  auto load = [&](int i) {  // thread 0: load i's K tile, and its V tile after pass 0
    const int s = i & 1, k0 = (i % n) * AK;
    const bool with_v = i >= n;
    mbar_expect_tx(&bar[s], (with_v ? 2u : 1u) * TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(Ks + s * TILE + c * 8192, &kmap, &bar[s], h * D + 64 * c, k0, b);
      if (with_v) tma_load_3d(Vs + s * TILE + c * 8192, &vmap, &bar[s], h * D + 64 * c, k0, b);
    }
  };
  auto load_keys = [&](int i) {  // the padding bias and segment of load i's keys
    if (tid < AK) {
      const int s = i & 1, k = (i % n) * AK + tid;
      kbias[s * AK + tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
      kseg[s * AK + tid] = (k < L && use_seg) ? seg_row[(size_t)b * L + k] : 0.f;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[2], 2 * TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(Qs + c * 8192, &qmap, &bar[2], h * D + 64 * c, q0, b);
      tma_load_3d(dOs + c * 8192, &dmap, &bar[2], h * D + 64 * c, q0, b);
    }
    load(0);
    load(1);  // total >= 3
  }
  load_keys(0);
  load_keys(1);
  const int r0 = 16 * warp + lane / 4;
  float qseg[2], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qr = q0 + r0 + 8 * ih;
    qseg[ih] = (use_seg && qr < L) ? seg_row[(size_t)b * L + qr] : 0.f;
  }
  __syncthreads();
  mbar_wait(&bar[2], 0);

  float delta[2] = {0.f, 0.f}, acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
  for (int i = 0; i < total; ++i) {
    const int s = i & 1, pass = i / n, k0 = (i % n) * AK;
    mbar_wait(&bar[s], (i >> 1) & 1);
    __syncwarp();
    float sc[32];
    qk_tile<D>(sc, Qs, Ks + s * TILE);
    score_tile(sc, kbias + s * AK, kseg + s * AK, qseg, use_seg, k0, L, scale);
    if (pass == 0) {
      stats_tile(sc, m, l);
      if (i == n - 1) {  // the statistics are complete: dk/dv reads them
#pragma unroll
        for (int ih = 0; ih < 2; ++ih) {
          const int qr = q0 + r0 + 8 * ih;
          if (qr < L && t == 0) {
            stat_m[((size_t)b * H + h) * L + qr] = m[ih];
            stat_l[((size_t)b * H + h) * L + qr] = l[ih];
          }
        }
      }
    } else {
      float dp[32];
      qk_tile<D>(dp, dOs, Vs + s * TILE);  // dpd = do . v^T
      uint32_t da[16];  // ds in bf16 pairs, dq's A operand
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int ih = (r >> 1) & 1, c = 8 * (r >> 2) + 2 * t, qr = q0 + r0 + 8 * ih;
        const float p0 = qr < L ? prob(sc[r], m[ih], l[ih]) : 0.f;
        const float p1 = qr < L ? prob(sc[r + 1], m[ih], l[ih]) : 0.f;
        const float pd0 = drop.apply(p0, stream, qr, k0 + c);
        const float pd1 = drop.apply(p1, stream, qr, k0 + c + 1);
        if (pass == 1) {
          delta[ih] = fmaf(dp[r], pd0, delta[ih]);
          delta[ih] = fmaf(dp[r + 1], pd1, delta[ih]);
        } else {
          const __nv_bfloat162 pair =
              __floats2bfloat162_rn(ds_of(pd0, dp[r], p0, delta[ih], scale),
                                    ds_of(pd1, dp[r + 1], p1, delta[ih], scale));
          da[r / 2] = *reinterpret_cast<const uint32_t*>(&pair);
        }
      }
      if (pass == 1 && i % n == n - 1) {  // delta's pass is done: sum over the quad
#pragma unroll
        for (int ih = 0; ih < 2; ++ih) {
          delta[ih] += __shfl_xor_sync(0xffffffffu, delta[ih], 1);
          delta[ih] += __shfl_xor_sync(0xffffffffu, delta[ih], 2);
        }
      }
      if (pass == 2) {  // dq += ds . K, this key tile summed on its own
        float part[D / 2];
        pin(part);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < AK / 16; ++kk) {
          const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
          if constexpr (D == 64)
            wgmma_m64n64k16_rs_tb(part, a, mnmajor_desc(Ks + s * TILE, kk), kk > 0);
          else
            wgmma_m64n128k16_rs_tb(part, a, mnmajor_desc(Ks + s * TILE, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        pin(part);
        pin(da);
        promote(acc, part);
      }
    }
    __syncthreads();  // every warp is done with buffer s
    if (i + 2 < total) {
      if (tid == 0) load(i + 2);
      load_keys(i + 2);
    }
  }

  __nv_bfloat16* dqbase = dq_out.head(b, h, L, D);
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int qr = q0 + r0 + 8 * ih;
    if (qr >= L) continue;
    __nv_bfloat16* dst = dqbase + (size_t)qr * dq_out.ld;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * c + 2 * t) =
          __floats2bfloat162_rn(acc[4 * c + 2 * ih], acc[4 * c + 2 * ih + 1]);
    if (t == 0) delta_out[((size_t)b * H + h) * L + qr] = delta[ih];
  }
}

// attention_bwd_dkdv's function for bf16 on the tensor cores: one
// warpgroup per (64-row key tile, head, batch item), K and V loaded once,
// looping over the query tiles (Q and dO through a two-buffer ring). Each
// query tile's S = Q K^T is the forward's own tile (queries the A operand),
// so p = exp(s - m)/l from the saved m and l is the forward's p bit for bit.
// pd (for dv) and ds (for dk) go to shared memory in bf16, in the swizzled
// layout, and wgmma reads them MN-major as A = pd^T and ds^T against do and
// q read MN-major: dv += pd^T . do, dk += ds^T . q, each query tile's
// products promoted. One program owns each key tile: no float atomics, the
// sums deterministic. DV and DK choose what a launch accumulates: both at
// D = 64; at D = 128 two launches, one each, to keep the accumulators in
// registers.
template <int D, bool DV, bool DK>
__global__ void __launch_bounds__(128)
attention_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const float* __restrict__ bias_row, const float* __restrict__ seg_row,
                        const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                        const float* __restrict__ delta_in, Rows<__nv_bfloat16> dk_out,
                        Rows<__nv_bfloat16> dv_out, int L, float scale, Dropout drop) {
  constexpr uint32_t TILE = (D / 64) * 8192;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1k(smem_raw);
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Vs + TILE;       // [2][TILE]
  uint8_t* dOs = Qs + 2 * TILE;  // [2][TILE]
  uint8_t* PDs = dOs + 2 * TILE;  // pd [query][key], bf16
  uint8_t* DSs = PDs + 8192;      // ds [query][key], bf16
  float* kbias = reinterpret_cast<float*>(DSs + 8192);  // [64]
  float* kseg = kbias + AK;                              // [64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(kseg + AK);  // buffers 0, 1; K and V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int k0 = blockIdx.x * AK, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const int n = (L + AQ - 1) / AQ;  // query tiles
  const bool use_seg = seg_row != nullptr;

  auto load = [&](int i) {  // thread 0: query tile i's Q and dO
    const int s = i & 1;
    mbar_expect_tx(&bar[s], 2 * TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(Qs + s * TILE + c * 8192, &qmap, &bar[s], h * D + 64 * c, i * AQ, b);
      tma_load_3d(dOs + s * TILE + c * 8192, &dmap, &bar[s], h * D + 64 * c, i * AQ, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[2], 2 * TILE);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load_3d(Ks + c * 8192, &kmap, &bar[2], h * D + 64 * c, k0, b);
      tma_load_3d(Vs + c * 8192, &vmap, &bar[2], h * D + 64 * c, k0, b);
    }
    load(0);
    if (n > 1) load(1);
  }
  if (tid < AK) {
    const int k = k0 + tid;
    kbias[tid] = (k < L && bias_row) ? bias_row[(size_t)b * L + k] : 0.f;
    kseg[tid] = (k < L && use_seg) ? seg_row[(size_t)b * L + k] : 0.f;
  }
  const int r0 = 16 * warp + lane / 4;
  __syncthreads();
  mbar_wait(&bar[2], 0);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dk[r] = dv[r] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i & 1, q0 = i * AQ;
    float qseg[2], m[2], l[2], dl[2];
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      const int qr = q0 + r0 + 8 * ih;
      const size_t at = ((size_t)b * H + h) * L + qr;
      const bool ok = qr < L;
      qseg[ih] = (use_seg && ok) ? seg_row[(size_t)b * L + qr] : 0.f;
      m[ih] = ok ? stat_m[at] : 0.f;
      l[ih] = ok ? stat_l[at] : 1.f;
      dl[ih] = (DK && ok) ? delta_in[at] : 0.f;
    }
    mbar_wait(&bar[s], (i >> 1) & 1);
    __syncwarp();
    float sc[32], dp[32];
    qk_tile<D>(sc, Qs + s * TILE, Ks);
    score_tile(sc, kbias, kseg, qseg, use_seg, k0, L, scale);
    if (DK) qk_tile<D>(dp, dOs + s * TILE, Vs);  // dpd = do . v^T
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int ih = (r >> 1) & 1, c = 8 * (r >> 2) + 2 * t, qr = q0 + r0 + 8 * ih;
      const float p0 = qr < L ? prob(sc[r], m[ih], l[ih]) : 0.f;
      const float p1 = qr < L ? prob(sc[r + 1], m[ih], l[ih]) : 0.f;
      const float pd0 = drop.apply(p0, stream, qr, k0 + c);
      const float pd1 = drop.apply(p1, stream, qr, k0 + c + 1);
      if (DV) st_pair_sw128(PDs, r0 + 8 * ih, r >> 2, t, pd0, pd1);
      if (DK)
        st_pair_sw128(DSs, r0 + 8 * ih, r >> 2, t, ds_of(pd0, dp[r], p0, dl[ih], scale),
                      ds_of(pd1, dp[r + 1], p1, dl[ih], scale));
    }
    fence_proxy_async();  // the stores above are wgmma's operands
    __syncthreads();
    float part[D / 2];  // this query tile's products, promoted
    if (DV) {
      pin(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AQ / 16; ++kk) {
        if constexpr (D == 64)
          wgmma_m64n64k16_ss<1, 1>(part, mnmajor_desc(PDs, kk), mnmajor_desc(dOs + s * TILE, kk),
                                   kk > 0);
        else
          wgmma_m64n128k16_ss<1, 1>(part, mnmajor_desc(PDs, kk),
                                    mnmajor_desc(dOs + s * TILE, kk), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(part);
      promote(dv, part);
    }
    if (DK) {
      pin(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < AQ / 16; ++kk) {
        if constexpr (D == 64)
          wgmma_m64n64k16_ss<1, 1>(part, mnmajor_desc(DSs, kk), mnmajor_desc(Qs + s * TILE, kk),
                                   kk > 0);
        else
          wgmma_m64n128k16_ss<1, 1>(part, mnmajor_desc(DSs, kk), mnmajor_desc(Qs + s * TILE, kk),
                                    kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(part);
      promote(dk, part);
    }
    __syncthreads();  // every warp is done with buffer s and the pd/ds tiles
    if (i + 2 < n && tid == 0) load(i + 2);
  }

#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int kr = k0 + r0 + 8 * ih;
    if (kr >= L) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      if (DK)
        *reinterpret_cast<__nv_bfloat162*>(dk_out.head(b, h, L, D) + (size_t)kr * dk_out.ld +
                                           8 * c + 2 * t) =
            __floats2bfloat162_rn(dk[4 * c + 2 * ih], dk[4 * c + 2 * ih + 1]);
      if (DV)
        *reinterpret_cast<__nv_bfloat162*>(dv_out.head(b, h, L, D) + (size_t)kr * dv_out.ld +
                                           8 * c + 2 * t) =
            __floats2bfloat162_rn(dv[4 * c + 2 * ih], dv[4 * c + 2 * ih + 1]);
    }
  }
}

// K8's bf16 backward on `stream`: attention_bwd_dq_sm90 over (ceil(L/64),
// H, B) blocks, recomputing m and l into stat_m/stat_l, then the dk/dv
// kernel over the key tiles (two launches at D = 128).
// cudaErrorInvalidValue before launching if TMA cannot map q, k, v or dO (a
// base or row distance not a multiple of 16 bytes).
template <int D>
cudaError_t launch_attention_bwd_sm90(Rows<const __nv_bfloat16> q, Rows<const __nv_bfloat16> k,
                                      Rows<const __nv_bfloat16> v, Rows<const __nv_bfloat16> dO,
                                      float* stat_m, float* stat_l, float* delta,
                                      const float* bias_row, const float* seg_row,
                                      Rows<__nv_bfloat16> dq, Rows<__nv_bfloat16> dk,
                                      Rows<__nv_bfloat16> dv, int B, int L, int H, Dropout drop,
                                      cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  if (!rows_map(&qm, q, B, L, H * D) || !rows_map(&km, k, B, L, H * D) ||
      !rows_map(&vm, v, B, L, H * D) || !rows_map(&dm, dO, B, L, H * D))
    return cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)D);
  const dim3 grid((L + 63) / 64, H, B);
  size_t smem = bwd_sm90_smem<D>(false);
  cudaError_t err = allow_smem(attention_bwd_dq_sm90<D>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_sm90<D><<<grid, 128, smem, stream>>>(
      qm, km, vm, dm, bias_row, seg_row, stat_m, stat_l, delta, dq, L, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = bwd_sm90_smem<D>(true);
  auto dkdv = [&](auto kernel) {
    cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, 128, smem, stream>>>(qm, km, vm, dm, bias_row, seg_row, stat_m, stat_l, delta,
                                        dk, dv, L, scale, drop);
    return cudaGetLastError();
  };
  if constexpr (D == 64) {
    return dkdv(attention_bwd_dkdv_sm90<D, true, true>);
  } else {
    err = dkdv(attention_bwd_dkdv_sm90<D, true, false>);
    if (err != cudaSuccess) return err;
    return dkdv(attention_bwd_dkdv_sm90<D, false, true>);
  }
}

template <int D>
constexpr size_t bwd_dq_smem_floats() {
  return 4 * 64 * (D + 1) + 64 * 65 + 3 * 64;
}

// On the CUDA cores (fp32, and K4 in bf16): dq, and delta = sum_j dpd.pd,
// for one (64-row query tile, head, batch item): pass 1 over the key tiles
// sums delta (it uses the unrounded pd, so it is not rowsum(do * o) once o
// is rounded or dropout applies); pass 2 forms ds and accumulates
// dq = ds . k. With RECOMPUTE (the fp32 flash backward, whose forward saved
// no statistics) a pass 0 first recomputes m and l as the forward made them
// and writes them to stat_m/stat_l for attention_bwd_dkdv; without it they
// are read from there.
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

// On the CUDA cores (fp32, and K4 in bf16): dk and dv for one (64-row key
// tile, head, batch item), looping over the query tiles; m, l and delta
// come from attention_bwd_dq. The tile is the transpose of the forward's:
// thread (ty, tx) owns key rows 4ty+i and query columns tx+16j, so
// sT[i][j] = k . q is the forward's score with the factors swapped (the
// same products in the same order, so the same bits).
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
// (ceil(L/64), H, B) blocks on `stream`, on the CUDA cores: the fp32
// backward of K4 and K8, and K4's bf16 backward.
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

// The forward over (ceil(L/64), H, B) blocks on `stream`: bf16 on the
// tensor cores, fp32 on the CUDA cores. With stat_m/stat_l (the block's
// training forward) m and l are saved [B, H, L].
template <typename T, int D>
cudaError_t launch_attention_fwd(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                                 const float* bias_row, const float* seg_row, Rows<T> o,
                                 float* stat_m, float* stat_l, int B, int L, int H,
                                 Dropout drop, cudaStream_t stream) {
  const dim3 grid((L + AQ - 1) / AQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    CUtensorMap qm, km, vm;
    if (!rows_map(&qm, q, B, L, H * D) || !rows_map(&km, k, B, L, H * D) ||
        !rows_map(&vm, v, B, L, H * D))
      return cudaErrorInvalidValue;
    const size_t smem = fwd_sm90_smem<D>();
    cudaError_t err = allow_smem(attention_fwd_sm90<D>, smem);
    if (err != cudaSuccess) return err;
    attention_fwd_sm90<D><<<grid, 128, smem, stream>>>(qm, km, vm, bias_row, seg_row, o, stat_m,
                                                      stat_l, L, scale, drop);
  } else {
    const size_t smem = sizeof(float) * fwd_smem_floats<D>();
    cudaError_t err = allow_smem(attention_fwd<T, D>, smem);
    if (err != cudaSuccess) return err;
    attention_fwd<T, D><<<grid, ATHREADS, smem, stream>>>(q, k, v, bias_row, seg_row, o, stat_m,
                                                           stat_l, L, scale, drop);
  }
  return cudaGetLastError();
}

}  // namespace

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
//   attention_fwd            the forward on the CUDA cores in fp32 (where
//                            tensor cores would mean TF32)
//   attention_bwd_delta, attention_bwd_dkdv, attention_bwd_dq
//                            the backward on the CUDA cores: fp32, and the
//                            block backward K4 in bf16 too (a delta pass,
//                            dk/dv writing ds to a scratch, dq = ds . k)
// Each takes q, k, v (and do, and the outputs) as Rows: a base pointer and
// the distance between rows, so the same kernel reads the three sections of
// the block's qkv [B*L, 3P] buffer or three separate [B, L, H, D] tensors
// (contiguous, or views of one fused projection) without a transposed copy.
//
// Accumulation and the softmax are fp32; the normalised, dropped-out
// probabilities are rounded to the compute type T before p.v, and ds before
// ds.k and ds^T.q, where the TPU kernels round them
// (pl_bert_tpu/ops/attention_block.py:128-139, :372-373;
// pl_bert_tpu/ops/flash_attention.py:65-69, :110). Every forward makes two
// passes over the key tiles (m and l, then the normalised p), recomputing
// q.k rather than storing an [L, L] tile; scores never leave the chip (the
// CUDA-core backward stores only the rounded ds, once).
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
// bf16 forward's tensor-core ones. Those kernels, and what bounds them,
// are described where they begin, below.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "philox.cuh"
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

// 64-row query and key tiles (the tensor-core kernels' too)
constexpr int AQ = 64, AK = 64;

// ---------------------------------------------------------------------------
// The CUDA-core (SIMT) kernels: fp32 (K2, and K3/K7/K8 in fp32, where tensor
// cores would mean TF32), and the block backward K4 in bf16 too.
//
// Every product they form, and the projection GEMM of attention_block.cu,
// runs in one register-blocked micro-tile, fma_tile: a thread owns 8 rows x
// TN columns of outputs and, for each k, reads its 8 rows' A values as two
// float4 and its columns' B values as float4 from fp32 tiles in shared
// memory, then issues 8*TN fmaf -- 32 or 64 FMAs for 3 or 4 shared loads,
// where the scalar 4x4 tiles before it issued 16 for 8. Each output stays
// one fmaf chain over k in ascending order, started from 0, so the bits are
// those of a sequential fp32 dot product (which is what the plain versions'
// cuBLAS fp32 sums give on the card) whatever thread owns it.
//
// Tiles are 64 x 64 for 128 threads: thread (ty = tid/16, tx = tid%16) owns
// rows 4ty..4ty+3 and 32+4ty..32+4ty+3 (trow) and, of a score tile, the
// columns tx + 16j, j < 4 (tcol): a row's 64 scores sit on the 16 lanes of
// one half-warp, which reduce row sums with shuffles; of a D-wide output, the
// columns 4tx..4tx+3 (and 64+4tx.. at D = 128). The operands live in fp32:
// tiles that sum over the head dimension are held transposed (k-major,
// [D][64]) on one side and row by row ([64][D+4]) on the other; tiles that
// sum over rows are k-major as they come. Fills read 16-byte chunks:
// cp.async straight into shared memory for fp32, or 8 bf16 values held in
// registers and converted once at the store (TileFill), so the next tile's
// reads are in flight while this one is multiplied.
constexpr int ST = 128;   // threads of a SIMT attention block
constexpr int PLD = 68;   // row distance of the [64][64] probability and ds tiles

template <typename T>
constexpr int kChunk = 16 / (int)sizeof(T);  // elements of T in 16 bytes

__device__ __forceinline__ int trow(int ty, int i) { return 4 * ty + (i & 3) + 32 * (i >> 2); }
__device__ __forceinline__ int tcol(int tx, int j) { return tx + 16 * j; }

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the 16 bytes of a chunk of T as its kChunk<T> fp32 values (exact)
__device__ __forceinline__ void unpack(const uint4& u, float* v, float) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// kChunk<T> values of src, n of them valid (the rest read as 0): one
// 16-byte load where all are and vec says src is 16-byte aligned
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* src, int n, bool vec) {
  constexpr int W = kChunk<T>;
  if (vec && n >= W) return __ldg(reinterpret_cast<const uint4*>(src));
  using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  union {
    uint4 u;
    Raw e[W];
  } c;
  c.u = make_uint4(0u, 0u, 0u, 0u);
  const Raw* s = reinterpret_cast<const Raw*>(src);
#pragma unroll
  for (int e = 0; e < W; ++e)
    if (e < n) c.e[e] = s[e];
  return c.u;
}

// 16 bytes of T at dst from kChunk<T> fp32 values already exact in T
__device__ __forceinline__ void store_chunk(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);
}
__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Fills a ROWS x COLS fp32 tile in shared memory from rows of T that are ld
// elements apart: straight (dst[r * ldd + c]) or TRANS (dst[c * ldd + r]);
// elements past `rows` rows or `cols` columns are 0. load() starts the
// reads -- cp.async into dst for a straight fp32 tile, else 16-byte loads
// into registers -- and store() writes what load() holds, converted once,
// then waits for the cp.async copies. vec: src and ld keep every chunk
// 16-byte aligned; else the elements are read one by one. Consecutive
// threads take consecutive chunks of a row (straight) or the same chunk of
// consecutive rows (TRANS), so the shared-memory stores meet no conflict.
template <typename T, int ROWS, int COLS, int THREADS, bool TRANS>
struct TileFill {
  static constexpr int W = kChunk<T>, CPR = COLS / W, N = ROWS * CPR / THREADS;
  static constexpr bool kAsync = !TRANS && std::is_same<T, float>::value;
  static_assert(COLS % W == 0 && ROWS * CPR % THREADS == 0, "a tile of whole chunks");
  uint4 u[kAsync ? 1 : N];

  __device__ __forceinline__ static void at(int t, int& r, int& c) {
    const int i = threadIdx.x + THREADS * t;
    if (TRANS) {
      r = i % ROWS;
      c = i / ROWS;
    } else {
      r = i / CPR;
      c = i % CPR;
    }
  }
  __device__ __forceinline__ void put(const uint4& v, float* dst, int ldd, int r, int c) const {
    float f[W];
    unpack(v, f, T());
    if (TRANS) {
#pragma unroll
      for (int e = 0; e < W; ++e) dst[(c * W + e) * ldd + r] = f[e];
    } else {
#pragma unroll
      for (int e = 0; e < W; e += 4) store_chunk(dst + r * ldd + c * W + e, f + e);
    }
  }
  __device__ __forceinline__ void load(const T* src, size_t ld, int rows, int cols, bool vec,
                                       float* dst, int ldd) {
#pragma unroll
    for (int t = 0; t < N; ++t) {
      int r, c;
      at(t, r, c);
      const int n = r < rows ? cols - c * W : 0;
      const T* p = src + (size_t)r * ld + c * W;
      if constexpr (kAsync) {
        if (vec)
          cp_async16(dst + r * ldd + c * W, n > 0 ? p : src, n >= W ? 16 : (n > 0 ? 4 * n : 0));
        else
          put(load_chunk<T>(p, n, false), dst, ldd, r, c);
      } else {
        u[t] = load_chunk<T>(p, n, vec);
      }
    }
    if constexpr (kAsync) cp_async_commit();
  }
  __device__ __forceinline__ void store(float* dst, int ldd) const {
    if constexpr (kAsync) {
      cp_async_wait_all();
    } else {
#pragma unroll
      for (int t = 0; t < N; ++t) {
        int r, c;
        at(t, r, c);
        put(u[t], dst, ldd, r, c);
      }
    }
  }
};

// whether the chunks of a Rows are 16-byte aligned (every head's columns
// start at a multiple of D, itself a multiple of 8)
template <typename T>
__host__ __device__ inline bool rows_vec(Rows<const T> r) {
  return r.ld % kChunk<T> == 0 && reinterpret_cast<uintptr_t>(r.ptr) % 16 == 0;
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The micro-tile: acc[i][j] += sum_k A(row i, k) * B(col j, k) over
// k = 0..KT-1 in ascending order, one fmaf a product. A is k-major
// (A[k * lda + row]); the thread's rows are ar..ar+3 and ar+ah..ar+ah+3,
// read as two float4 a k. B is k-major (B[k * ldb + col]) with columns
// bc..bc+3, and bc+bh..bc+bh+3 when TN is 8, read as float4; or, with
// BROWS, row by row (B[col * ldb + k]) with the TN = 4 columns bc + bh*j,
// each read as a float4 of four consecutive k.
template <int TN, bool BROWS, int KT>
__device__ __forceinline__ void fma_tile(float (&acc)[8][TN], const float* __restrict__ A,
                                         int lda, int ar, int ah, const float* __restrict__ B,
                                         int ldb, int bc, int bh) {
  static_assert(KT % 4 == 0 && (BROWS ? TN == 4 : (TN == 4 || TN == 8)), "micro-tile shape");
#pragma unroll 2
  for (int k0 = 0; k0 < KT; k0 += 4) {
    float4 bq[BROWS ? 4 : 1];
    if constexpr (BROWS) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bq[j] = *reinterpret_cast<const float4*>(B + (bc + bh * j) * ldb + k0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* ak = A + (k0 + kk) * lda;
      const float4 a0 = *reinterpret_cast<const float4*>(ak + ar);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + ar + ah);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
      if constexpr (BROWS) {
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = lane(bq[j], kk);
      } else {
        const float* bk = B + (k0 + kk) * ldb;
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 bv = *reinterpret_cast<const float4*>(bk + bc + bh * h);
          b[4 * h] = bv.x;
          b[4 * h + 1] = bv.y;
          b[4 * h + 2] = bv.z;
          b[4 * h + 3] = bv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// The thread's 8 x 4 raw scores of a 64 x 64 tile: rows of At (k-major
// [D][64]) against the columns of Bs (row by row, [64][D+4]), summed over d
// in order. The forward and every backward kernel form q.k here, so the fp32
// backward's scores are the fp32 forward's bit for bit (the product is
// q*k in one kernel and k*q in another, the same fmaf).
template <int D>
__device__ __forceinline__ void dot_block(float (&s)[8][4], const float* At, const float* Bs,
                                          int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  fma_tile<4, true, D>(s, At, 64, 4 * ty, 32, Bs, D + 4, tx, 16);
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

// The padding bias and segment id of rows r0..r0+63 of batch item b into
// bias/seg (either may be null); 0 past L and where the caller has none.
__device__ __forceinline__ void load_row_info(float* bias, float* seg,
                                              const float* __restrict__ bias_row,
                                              const float* __restrict__ seg_row, int b, int r0,
                                              int L) {
  if (threadIdx.x < 64) {
    const int r = r0 + threadIdx.x;
    if (bias) bias[threadIdx.x] = (r < L && bias_row) ? bias_row[(size_t)b * L + r] : 0.f;
    if (seg) seg[threadIdx.x] = (r < L && seg_row) ? seg_row[(size_t)b * L + r] : 0.f;
  }
}

// One key tile's step of the online row max m and denominator
// l = sum exp(s - m) of the thread's 8 query rows, in fp32: the fp32
// forward's first pass and the statistics pass of a backward that was
// handed none -- the same code, so in fp32 both get the same bits.
__device__ __forceinline__ void stats_step(const float (&s)[8][4], float (&m_run)[8],
                                           float (&l_run)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float mx = half_warp_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
    // column 0 of the first tile is always a real key, so m_new is finite
    // and exp(-inf - m_new) is 0, never exp(-inf + inf)
    const float m_new = fmaxf(m_run[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum += expf(s[i][j] - m_new);
    l_run[i] = l_run[i] * expf(m_run[i] - m_new) + half_warp_sum(sum);
    m_run[i] = m_new;
  }
}

// writes the thread's 8 x 4 block v (rows trow, columns tcol of a score
// tile) to dst[col * PLD + row], k-major for a product that sums over the
// columns: two float4 a column
__device__ __forceinline__ void put_transposed(float* dst, const float (&v)[8][4], int tx,
                                               int ty) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      *reinterpret_cast<float4*>(dst + tcol(tx, j) * PLD + 4 * ty + 32 * g) =
          make_float4(v[4 * g][j], v[4 * g + 1][j], v[4 * g + 2][j], v[4 * g + 3][j]);
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return D * 64 + 4 * 64 * (D + 4) + 64 * PLD + 5 * 64;
}

// fp32 (K2, and K3/K7 in fp32) on the CUDA cores. One block of 128 threads
// per (64-row query tile, head, batch item); Q^T is filled once, and the
// key side is a sequence of 2n tile loads through two buffers (load i into
// buffer i % 2, the next one in flight while this one is used):
//   pass 1 (K tiles): the row max m and the denominator l (stats_step);
//   pass 2 (K and V tiles): p = exp(s - m) / l, dropped out, rounded to T
//     as the TPU kernel rounds its probabilities before p.v, written to
//     shared memory k-major, and o += p . v in the micro-tile.
// With stat_m/stat_l (the block's training forward) m and l are saved
// [B, H, L]; the flash forward saves nothing.
template <typename T, int D>
__global__ void __launch_bounds__(ST)
attention_fwd(Rows<const T> q, Rows<const T> k, Rows<const T> v,
              const float* __restrict__ bias_row, const float* __restrict__ seg_row,
              Rows<T> o, float* __restrict__ stat_m, float* __restrict__ stat_l,
              int L, float scale, Dropout drop) {
  constexpr int RL = D + 4, TN = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][64]
  float* Ks = Qt + D * 64;          // [2][64][RL]
  float* Vs = Ks + 2 * 64 * RL;     // [2][64][RL]
  float* Pt = Vs + 2 * 64 * RL;     // [64 keys][PLD]
  float* kbias = Pt + 64 * PLD;     // [2][64]
  float* kseg = kbias + 2 * 64;     // [2][64]
  float* qseg = kseg + 2 * 64;      // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const int n = (L + 63) / 64;
  const bool use_seg = seg_row != nullptr;
  const T* kbase = k.head(b, h, L, D);
  const T* vbase = v.head(b, h, L, D);
  const bool veck = rows_vec(k), vecv = rows_vec(v);

  {
    TileFill<T, 64, D, ST, true> fq;
    fq.load(q.head(b, h, L, D) + (size_t)q0 * q.ld, q.ld, L - q0, D, rows_vec(q), Qt, 64);
    fq.store(Qt, 64);
  }
  load_row_info(nullptr, qseg, nullptr, seg_row, b, q0, L);
  TileFill<T, 64, D, ST, false> fk, fv;
  auto load = [&](int i) {
    const int s = i & 1, k0 = (i % n) * 64;
    fk.load(kbase + (size_t)k0 * k.ld, k.ld, L - k0, D, veck, Ks + s * 64 * RL, RL);
    if (i >= n) fv.load(vbase + (size_t)k0 * v.ld, v.ld, L - k0, D, vecv, Vs + s * 64 * RL, RL);
    load_row_info(kbias + 64 * s, kseg + 64 * s, bias_row, seg_row, b, k0, L);
  };
  auto store = [&](int i) {
    const int s = i & 1;
    fk.store(Ks + s * 64 * RL, RL);
    if (i >= n) fv.store(Vs + s * 64 * RL, RL);
  };
  load(0);
  store(0);
  __syncthreads();

  float m_run[8], l_run[8], acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  }
  for (int it = 0; it < 2 * n; ++it) {
    const int s = it & 1, k0 = (it % n) * 64;
    if (it + 1 < 2 * n) load(it + 1);
    float sc[8][4];
    dot_block<D>(sc, Qt, Ks + s * 64 * RL, tx, ty);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tcol(tx, j);
        sc[i][j] = score(sc[i][j], scale, kbias[64 * s + c], use_seg, qseg[trow(ty, i)],
                         kseg[64 * s + c], k0 + c, L);
      }
    if (it < n) {
      stats_step(sc, m_run, l_run);
    } else {
      // l >= 1 (the row's max contributes exp(0)), so the division is safe
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(sc[i][j] - m_run[i]) / l_run[i];
          sc[i][j] = round_to<T>(drop.apply(p, stream, q0 + trow(ty, i), k0 + tcol(tx, j)));
        }
      put_transposed(Pt, sc, tx, ty);
      __syncthreads();
      fma_tile<TN, false, 64>(acc, Pt, PLD, 4 * ty, 32, Vs + s * 64 * RL, RL, 4 * tx, 64);
    }
    if (it + 1 < 2 * n) store(it + 1);
    __syncthreads();  // buffer s, Pt and the key rows' info are free
  }

  T* obase = o.head(b, h, L, D);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + trow(ty, i);
    if (qr >= L) continue;
    T* dst = obase + (size_t)qr * o.ld;
#pragma unroll
    for (int c = 0; c < TN; ++c) dst[4 * tx + (c & 3) + 64 * (c >> 2)] = from_f<T>(acc[i][c]);
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

// --- the backward on the CUDA cores (fp32, and K4 in bf16) -----------------------
//
// The gradient needs five L^2 D products a (batch, head): s = q.k and
// dpd = do.v^T (over d), dv = pd^T.do and dk = ds^T.q (over the queries),
// dq = ds.k (over the keys). Three kernels form seven of them with one
// Philox draw a probability, where the pass-twice design before them
// formed nine with three draws:
//   attention_bwd_delta  per query tile: s, dpd and delta = sum_j dpd.pd
//                        (2 products, the one Philox draw, whose keep bits
//                        it writes out, 64 keys a word); with RECOMPUTE (the fp32
//                        flash backward, whose forward saved nothing) a
//                        first pass over the K tiles recomputes m and l with
//                        the forward's code and saves them;
//   attention_bwd_dkdv   per key tile, over the query tiles: s, dpd, then
//                        dv += pd^T.do and dk += ds^T.q (4 products; the
//                        dropout from the delta pass's keep bits),
//                        and ds, rounded to T, written out once to a
//                        [B, H, Lp, Lp] scratch (Lp = L rounded up to 64);
//   attention_bwd_dq     dq = ds.k, a batched GEMM over the keys reading that
//                        scratch (1 product).
// Scores are formed only where they are used, never stored; ds crosses
// memory once each way (at [96, 512, 768] bf16 604 MB, ~0.36 ms at the
// card's 3.35 TB/s), which is cheaper than the two products (and a Philox
// draw) that a second pass over the keys would form again.
//
// Every output is one fp32 fmaf chain from 0 in a fixed order -- s and dpd
// over d, dq over the keys, dk and dv over the queries, all ascending --
// and delta is summed in the same tree for every query row: the columns
// tx + 16j of each key tile in the thread's chain, then half_warp_sum. pd
// is rounded to T before dv, ds before dq and dk, and nothing else is
// rounded before the stores. That is the order of the plain version's
// cuBLAS fp32 sums, which the bf16 gates need matched bit for bit (one-ulp
// flips in dqkv fan out into dx through the 2304-deep projection; PERF.md).
// One program owns each output tile, so there are no float atomics and the
// sums are deterministic.

template <int D>
constexpr size_t bwd_delta_smem_floats() {
  return 2 * D * 64 + 4 * 64 * (D + 4) + 5 * 64;
}

// delta = sum_j dpd.pd for one (64-row query tile, head, batch item), from
// the unrounded pd (so it is not rowsum(do * o) once o is rounded or
// dropout applies). Q^T and dO^T are filled once; K and V tiles stream
// through two buffers. m and l are read from stat_m/stat_l, or with
// RECOMPUTE formed first over the K tiles (stats_step, as the forward forms
// them) and written there for attention_bwd_dkdv.
template <typename T, int D, bool RECOMPUTE>
__global__ void __launch_bounds__(ST)
attention_bwd_delta(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dO,
                    float* __restrict__ stat_m, float* __restrict__ stat_l,
                    const float* __restrict__ bias_row, const float* __restrict__ seg_row,
                    float* __restrict__ delta_out, uint64_t* __restrict__ keep_out, int Lp,
                    int L, float scale, Dropout drop) {
  constexpr int RL = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][64]
  float* dOt = Qt + D * 64;         // [D][64]
  float* Ks = dOt + D * 64;         // [2][64][RL]
  float* Vs = Ks + 2 * 64 * RL;     // [2][64][RL]
  float* kbias = Vs + 2 * 64 * RL;  // [2][64]
  float* kseg = kbias + 2 * 64;     // [2][64]
  float* qseg = kseg + 2 * 64;      // [64]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const uint32_t stream = (uint32_t)(b * H + h);
  const int n = (L + 63) / 64, n0 = RECOMPUTE ? n : 0, total = n0 + n;
  const bool use_seg = seg_row != nullptr;
  const T* kbase = k.head(b, h, L, D);
  const T* vbase = v.head(b, h, L, D);
  const bool veck = rows_vec(k), vecv = rows_vec(v);

  {
    TileFill<T, 64, D, ST, true> f;
    f.load(q.head(b, h, L, D) + (size_t)q0 * q.ld, q.ld, L - q0, D, rows_vec(q), Qt, 64);
    f.store(Qt, 64);
    f.load(dO.head(b, h, L, D) + (size_t)q0 * dO.ld, dO.ld, L - q0, D, rows_vec(dO), dOt, 64);
    f.store(dOt, 64);
  }
  load_row_info(nullptr, qseg, nullptr, seg_row, b, q0, L);
  TileFill<T, 64, D, ST, false> fk, fv;
  auto k0_of = [&](int i) { return (i < n0 ? i : i - n0) * 64; };
  auto load = [&](int i) {
    const int s = i & 1, k0 = k0_of(i);
    fk.load(kbase + (size_t)k0 * k.ld, k.ld, L - k0, D, veck, Ks + s * 64 * RL, RL);
    if (i >= n0) fv.load(vbase + (size_t)k0 * v.ld, v.ld, L - k0, D, vecv, Vs + s * 64 * RL, RL);
    load_row_info(kbias + 64 * s, kseg + 64 * s, bias_row, seg_row, b, k0, L);
  };
  auto store = [&](int i) {
    const int s = i & 1;
    fk.store(Ks + s * 64 * RL, RL);
    if (i >= n0) fv.store(Vs + s * 64 * RL, RL);
  };
  load(0);
  store(0);
  __syncthreads();

  float m[8], l[8], delta[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + trow(ty, i);
    const size_t at = ((size_t)b * H + h) * L + qr;
    if (RECOMPUTE) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
    } else {
      m[i] = qr < L ? stat_m[at] : 0.f;
      l[i] = qr < L ? stat_l[at] : 1.f;
    }
    delta[i] = 0.f;
  }
  for (int it = 0; it < total; ++it) {
    const int s = it & 1, k0 = k0_of(it);
    if (it + 1 < total) load(it + 1);
    float sc[8][4];
    dot_block<D>(sc, Qt, Ks + s * 64 * RL, tx, ty);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tcol(tx, j);
        sc[i][j] = score(sc[i][j], scale, kbias[64 * s + c], use_seg, qseg[trow(ty, i)],
                         kseg[64 * s + c], k0 + c, L);
      }
    if (it < n0) {
      stats_step(sc, m, l);
      if (it == n0 - 1 && tx == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int qr = q0 + trow(ty, i);
          if (qr < L) {
            stat_m[((size_t)b * H + h) * L + qr] = m[i];
            stat_l[((size_t)b * H + h) * L + qr] = l[i];
          }
        }
      }
    } else {
      // p (the forward's probability) dropped out, unrounded, in place; the
      // keep bits of each row's 64 keys gathered by ballot (lanes 0-15 hold
      // row trow(ty, i) of an even ty, 16-31 of the odd one) and written as
      // one word, bit c for key k0 + c
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qr = q0 + trow(ty, i);
        uint64_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = qr < L ? expf(sc[i][j] - m[i]) / l[i] : 0.f;
          if (drop.on) {
            const bool kept = drop.keep(stream, qr, k0 + tcol(tx, j));
            sc[i][j] = kept ? p * drop.inv_keep : 0.f;  // drop.apply's value
            const uint32_t bits = __ballot_sync(0xffffffffu, kept) >> (16 * (ty & 1));
            word |= (uint64_t)(bits & 0xffffu) << (16 * j);
          } else {
            sc[i][j] = p;
          }
        }
        if (drop.on && tx == 0)
          keep_out[((size_t)(b * H + h) * Lp + qr) * (Lp / 64) + k0 / 64] = word;
      }
      float dpd[8][4];
      dot_block<D>(dpd, dOt, Vs + s * 64 * RL, tx, ty);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) delta[i] = fmaf(dpd[i][j], sc[i][j], delta[i]);
    }
    if (it + 1 < total) store(it + 1);
    __syncthreads();  // buffer s and the key rows' info are free
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    delta[i] = half_warp_sum(delta[i]);
    const int qr = q0 + trow(ty, i);
    if (qr < L && tx == 0) delta_out[((size_t)b * H + h) * L + qr] = delta[i];
  }
}

template <int D, bool DK, bool DV>
constexpr size_t bwd_dkdv_smem_floats() {
  return (DK ? 2 : 1) * D * 64 + 2 * 64 * (D + 4) + ((DK ? 1 : 0) + (DV ? 1 : 0)) * 64 * PLD +
         8 * 64;
}

// dk (DK) and dv (DV) for one (64-row key tile, head, batch item), over the
// query tiles; m, l and delta come from attention_bwd_delta. The tile is
// the transpose of the forward's: thread (ty, tx) owns key rows trow and
// query columns tcol, so its raw score is k.q, the forward's product with
// the factors swapped (the same fmaf). K^T (and V^T for dpd) are filled
// once; Q and dO stream through one buffer each, the next tile's reads held
// in registers (bf16) over this one's products -- two buffers would take the
// shared memory of a second block a multiprocessor. The dropout mask is the
// delta pass's (keep_in), not drawn again. pd and ds, rounded to T, go to
// shared memory k-major for the products over the queries; with DK the ds
// tile is also written out to ds_out, rows of Lp, for attention_bwd_dq. At
// D = 64 one launch does both (DK = DV); at D = 128 the accumulators of both
// do not fit the registers, so dk and dv take a launch each (8 products
// there).
template <typename T, int D, bool DK, bool DV>
__global__ void __launch_bounds__(ST)
attention_bwd_dkdv(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dO,
                   const float* __restrict__ stat_m, const float* __restrict__ stat_l,
                   const float* __restrict__ delta_in, const float* __restrict__ bias_row,
                   const float* __restrict__ seg_row, const uint64_t* __restrict__ keep_in,
                   Rows<T> dk_out, Rows<T> dv_out, T* __restrict__ ds_out, int Lp, int L,
                   float scale, Dropout drop) {
  constexpr int RL = D + 4, TN = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                             // [D][64]
  float* Vt = Kt + D * 64;                      // [D][64], with DK
  float* Qs = Vt + (DK ? D * 64 : 0);           // [64][RL]
  float* dOs = Qs + 64 * RL;                    // [64][RL]
  float* PDs = dOs + 64 * RL;                   // [64 queries][PLD], with DV
  float* DSs = PDs + (DV ? 64 * PLD : 0);       // [64 queries][PLD], with DK
  float* qm = DSs + (DK ? 64 * PLD : 0);        // the query tile's m, l, delta, segment
  float* ql = qm + 64;
  float* qdelta = ql + 64;
  float* qseg = qdelta + 64;
  float* kbias = qseg + 64;
  float* kseg = kbias + 64;
  uint64_t* qkeep = reinterpret_cast<uint64_t*>(kseg + 64);  // the query rows' keep bits

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n = (L + 63) / 64;
  const bool use_seg = seg_row != nullptr;
  const T* qbase = q.head(b, h, L, D);
  const T* dObase = dO.head(b, h, L, D);
  const bool vecq = rows_vec(q), vecd = rows_vec(dO);

  {
    TileFill<T, 64, D, ST, true> f;
    f.load(k.head(b, h, L, D) + (size_t)k0 * k.ld, k.ld, L - k0, D, rows_vec(k), Kt, 64);
    f.store(Kt, 64);
    if (DK) {
      f.load(v.head(b, h, L, D) + (size_t)k0 * v.ld, v.ld, L - k0, D, rows_vec(v), Vt, 64);
      f.store(Vt, 64);
    }
  }
  load_row_info(kbias, kseg, bias_row, seg_row, b, k0, L);
  using Fill = TileFill<T, 64, D, ST, false>;
  Fill fq, fd;
  auto load = [&](int i) {
    const int q0 = i * 64;
    fq.load(qbase + (size_t)q0 * q.ld, q.ld, L - q0, D, vecq, Qs, RL);
    fd.load(dObase + (size_t)q0 * dO.ld, dO.ld, L - q0, D, vecd, dOs, RL);
  };
  auto store = [&](int i) {
    fq.store(Qs, RL);
    fd.store(dOs, RL);
    if (tid < 64) {
      const int qr = i * 64 + tid;
      const size_t at = ((size_t)b * H + h) * L + qr;
      const bool ok = qr < L;
      qm[tid] = ok ? stat_m[at] : 0.f;
      ql[tid] = ok ? stat_l[at] : 1.f;
      if (DK) qdelta[tid] = ok ? delta_in[at] : 0.f;
      qseg[tid] = (ok && use_seg) ? seg_row[(size_t)b * L + qr] : 0.f;
      if (drop.on) qkeep[tid] = keep_in[((size_t)(b * H + h) * Lp + qr) * (Lp / 64) + blockIdx.x];
    }
  };
  load(0);
  store(0);
  __syncthreads();

  float dk[8][TN], dv[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) dk[i][c] = dv[i][c] = 0.f;
  T* ds_tile = ds_out + (size_t)(b * H + h) * Lp * Lp + k0;
  for (int it = 0; it < n; ++it) {
    const int q0 = it * 64;
    float dpd[8][4], sc[8][4];
    if (DK) dot_block<D>(dpd, Vt, dOs, tx, ty);
    dot_block<D>(sc, Kt, Qs, tx, ty);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kr = trow(ty, i), kk = k0 + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tcol(tx, j), qr = q0 + qc;
        const float sv = score(sc[i][j], scale, kbias[kr], use_seg, qseg[qc], kseg[kr], kk, L);
        const float p = qr < L ? expf(sv - qm[qc]) / ql[qc] : 0.f;
        // drop.apply's value, from the delta pass's draw
        const float pd = !drop.on ? p : ((qkeep[qc] >> kr) & 1u) ? p * drop.inv_keep : 0.f;
        sc[i][j] = round_to<T>(pd);
        if (DK) dpd[i][j] = round_to<T>((pd * dpd[i][j] - p * qdelta[qc]) * scale);
      }
    }
    if (DV) put_transposed(PDs, sc, tx, ty);
    if (DK) put_transposed(DSs, dpd, tx, ty);
    // the next tile's reads into registers, in flight over the products
    // below (issued here, not earlier: the scores' registers are free)
    if (!Fill::kAsync && it + 1 < n) load(it + 1);
    __syncthreads();
    if (DV) fma_tile<TN, false, 64>(dv, PDs, PLD, 4 * ty, 32, dOs, RL, 4 * tx, 64);
    if (DK) {
      fma_tile<TN, false, 64>(dk, DSs, PLD, 4 * ty, 32, Qs, RL, 4 * tx, 64);
      // the ds tile out: row r is query q0 + r, keys k0..k0+63, in 16 bytes
      constexpr int W = kChunk<T>;
#pragma unroll
      for (int t = 0; t < 64 * 64 / W / ST; ++t) {
        const int i = tid + ST * t, r = i / (64 / W), c = i % (64 / W);
        store_chunk(ds_tile + (size_t)(q0 + r) * Lp + c * W, DSs + r * PLD + c * W);
      }
    }
    __syncthreads();  // Qs, dOs, PDs and DSs are free
    if (it + 1 < n) {
      if (Fill::kAsync) load(it + 1);
      store(it + 1);
      __syncthreads();
    }
  }

  T* dkbase = dk_out.head(b, h, L, D);
  T* dvbase = dv_out.head(b, h, L, D);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kk = k0 + trow(ty, i);
    if (kk >= L) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = 4 * tx + (c & 3) + 64 * (c >> 2);
      if (DK) dkbase[(size_t)kk * dk_out.ld + col] = from_f<T>(dk[i][c]);
      if (DV) dvbase[(size_t)kk * dv_out.ld + col] = from_f<T>(dv[i][c]);
    }
  }
}

template <int D>
constexpr size_t bwd_dq_smem_floats() {
  return 2 * 64 * 64 + 2 * 64 * (D + 4);
}

// dq = ds . k for one (64-row query tile, head, batch item): a GEMM over the
// keys in ascending order, ds tiles (the scratch attention_bwd_dkdv wrote,
// rows Lp apart) filled transposed and K tiles row by row, two buffers each.
template <typename T, int D>
__global__ void __launch_bounds__(ST)
attention_bwd_dq(const T* __restrict__ ds, int Lp, Rows<const T> k, Rows<T> dq_out, int L) {
  constexpr int RL = D + 4, TN = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* DSt = smem;                // [2][64 keys][64 queries]
  float* Ks = DSt + 2 * 64 * 64;    // [2][64][RL]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int n = (L + 63) / 64;
  const T* dsbase = ds + ((size_t)(b * H + h) * Lp + q0) * Lp;
  const T* kbase = k.head(b, h, L, D);
  const bool veck = rows_vec(k);
  TileFill<T, 64, 64, ST, true> fs;
  TileFill<T, 64, D, ST, false> fk;
  auto load = [&](int i) {
    const int s = i & 1, k0 = i * 64;
    fs.load(dsbase + k0, Lp, 64, 64, true, DSt + s * 64 * 64, 64);
    fk.load(kbase + (size_t)k0 * k.ld, k.ld, L - k0, D, veck, Ks + s * 64 * RL, RL);
  };
  auto store = [&](int i) {
    const int s = i & 1;
    fs.store(DSt + s * 64 * 64, 64);
    fk.store(Ks + s * 64 * RL, RL);
  };
  load(0);
  store(0);
  __syncthreads();
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    if (it + 1 < n) load(it + 1);
    fma_tile<TN, false, 64>(acc, DSt + s * 64 * 64, 64, 4 * ty, 32, Ks + s * 64 * RL, RL, 4 * tx,
                            64);
    if (it + 1 < n) store(it + 1);
    __syncthreads();
  }
  T* dqbase = dq_out.head(b, h, L, D);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qr = q0 + trow(ty, i);
    if (qr >= L) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c)
      dqbase[(size_t)qr * dq_out.ld + 4 * tx + (c & 3) + 64 * (c >> 2)] = from_f<T>(acc[i][c]);
  }
}

// Lp: the row distance of the ds scratch, L rounded up to the 64-row tile
inline int ds_rows(int L) { return (L + 63) / 64 * 64; }

// The launch of attention_bwd_delta, attention_bwd_dkdv (two launches at
// D = 128) and attention_bwd_dq over (ceil(L/64), H, B) blocks on `stream`,
// on the CUDA cores: the fp32 backward of K4 and K8, and K4's bf16
// backward. ds: scratch of B*H*Lp*Lp elements of T (ds_rows); keep_bits:
// with dropout, scratch of B*H*Lp*(Lp/64) words, the delta pass's keep mask
// for the dk/dv kernel.
template <typename T, int D, bool RECOMPUTE>
cudaError_t launch_attention_bwd(Rows<const T> q, Rows<const T> k, Rows<const T> v,
                                 Rows<const T> dO, float* stat_m, float* stat_l, float* delta,
                                 const float* bias_row, const float* seg_row, Rows<T> dq,
                                 Rows<T> dk, Rows<T> dv, T* ds, uint64_t* keep_bits, int B,
                                 int L, int H, Dropout drop, cudaStream_t stream) {
  if (ds == nullptr || (drop.on && keep_bits == nullptr)) return cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)D);
  const dim3 grid((L + 63) / 64, H, B);
  const int Lp = ds_rows(L);
  size_t smem = sizeof(float) * bwd_delta_smem_floats<D>();
  cudaError_t err = allow_smem(attention_bwd_delta<T, D, RECOMPUTE>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_delta<T, D, RECOMPUTE><<<grid, ST, smem, stream>>>(
      q, k, v, dO, stat_m, stat_l, bias_row, seg_row, delta, keep_bits, Lp, L, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv = [&](auto kernel, size_t floats) {
    const size_t bytes = sizeof(float) * floats;
    cudaError_t e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    kernel<<<grid, ST, bytes, stream>>>(q, k, v, dO, stat_m, stat_l, delta, bias_row, seg_row,
                                        keep_bits, dk, dv, ds, Lp, L, scale, drop);
    return cudaGetLastError();
  };
  if constexpr (D == 64) {
    err = dkdv(attention_bwd_dkdv<T, D, true, true>, bwd_dkdv_smem_floats<D, true, true>());
  } else {
    err = dkdv(attention_bwd_dkdv<T, D, true, false>, bwd_dkdv_smem_floats<D, true, false>());
    if (err == cudaSuccess)
      err = dkdv(attention_bwd_dkdv<T, D, false, true>, bwd_dkdv_smem_floats<D, false, true>());
  }
  if (err != cudaSuccess) return err;
  smem = sizeof(float) * bwd_dq_smem_floats<D>();
  err = allow_smem(attention_bwd_dq<T, D>, smem);
  if (err != cudaSuccess) return err;
  attention_bwd_dq<T, D><<<grid, ST, smem, stream>>>(ds, Lp, k, dq, L);
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
    attention_fwd<T, D><<<grid, ST, smem, stream>>>(q, k, v, bias_row, seg_row, o, stat_m,
                                                           stat_l, L, scale, drop);
  }
  return cudaGetLastError();
}

}  // namespace

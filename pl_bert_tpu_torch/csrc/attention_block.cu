// Attention block for Hopper: QKV projection, softmax attention and output
// projection, forward and backward, all in kernels written here.
//
// Replaces the Pallas kernels of pl_bert_tpu/ops/attention_block.py:
//   - the primal-only ("light") forward, _fwd_kernel_light_full (one grid
//     program per batch item, bf16) -- K1 -- and _fwd_kernel_light (per
//     128-lane head group, fp32) -- K2 -- via plbt_attention_block_fwd with
//     no stats;
//   - the saving training forward _fwd_kernel (K3), via the same entry
//     with stats: the same kernels, so both forwards return identical
//     values, as the JAX custom-VJP contract requires (:196-198);
//   - its backward _bwd_kernel (K4), via plbt_attention_block_bwd.
// Any sequence length, head_dim 64 or 128.
//
// Forward, three launches on the caller's stream (the wrapper allocates):
//   1. gemm:           qkv[M, 3P] = x[M, E] . [Wq|Wk|Wv][E, 3P] + [bq|bk|bv]
//   2. attention fwd:  ctx[M, P]  = dropout(softmax(q k^T / sqrt(D) + bias
//                                   [+ seg])) v, and for the training forward
//                                   the row max m and denominator l [B, H, L]
//   3. gemm:           out[M, E]  = ctx[M, P] . Wo[P, E] + bo
// M = B*L. out is the compute type T, or with out_f32 fp32 unrounded: a
// tensor-parallel shard's partial out-projection over its own heads, which
// the model ranks sum before the one rounding (pl_bert_tpu/parallel/tp.py:
// 101 asks its shard kernel for out_dtype=float32). In bf16 (what serving and training run) the three run on the
// tensor cores: gemm_bias_sm90 (gemm_sm90.cuh: wgmma fed by a TMA ring)
// and attention_fwd_sm90 (attention_tiles.cuh: wgmma for q.k and, from
// registers, p.v). In fp32 (K2, fp32 K3) they are gemm_bias and
// attention_fwd on the CUDA cores, since tensor cores would mean TF32.
// Accumulation, the bias adds and the softmax are fp32; q/k/v, the
// (dropped-out) probabilities and ctx are rounded to the compute type T at
// the points where the TPU kernel rounds them (attention_block.py:128-139,
// 159-168). The training forward saves qkv, ctx and (m, l): the TPU's
// q2/k2/v2/o2 and md [B,G,L,8].
//
// Backward, five launches (six at head_dim 128):
//   1. gemm (B^T):          do[M, P] = dout[M, E] . Wo[P, E]^T          (:331-334)
//   2. attention_bwd_delta: per query tile, delta = sum_j dpd.pd, with
//                           p = exp(s - m)/l recomputed from the saved m
//                           and l (:350-354); the dropout's keep bits,
//                           drawn once here, written out for launch 3
//   3. attention_bwd_dkdv:  per key tile, over the query tiles: dv = pd^T . do
//                           (pd rounded), dk = ds^T . q with
//                           ds = ((pd.dpd - p.delta) * scale) rounded
//                           (:372-373), ds also written to a scratch
//   4. attention_bwd_dq:    dq = ds . k from that scratch
//   5. gemm (B^T):          dx[M, E] = [dq|dk|dv][M, 3P] . [Wq|Wk|Wv]^T (:389-401)
// Launches 1-4 run on the CUDA cores in both types (gemm_bias and the SIMT
// attention kernels, all on attention_tiles.cuh's register-blocked
// fma_tile); launch 5 runs on the tensor cores in bf16 (gemm_bias_sm90
// reading Wqkv's transpose K-major). Moving 1-4 to the tensor cores (the
// flash backward's wgmma kernels, K8) missed the bf16 gates: the plain
// backward forms s, do and the 512-deep sums in cuBLAS fp32, which FMA
// chains in ascending order reproduce bit for bit and tensor-core sums do
// not; their one-ulp flips in do and dqkv fan out through the 512-deep and
// 2304-deep sums into dx, where one bf16 ulp is 0.125 (|dx| up to 39 on
// padded rows, measured on the card; PERF.md). The last GEMM's own flips
// stay single. So the CUDA-core kernels keep every sum's order: each output
// one fmaf chain from 0, ascending.
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
// What bounds it on the card: at [8, 512, 768] the forward is 25.8 GFLOP of
// products (19.3 in the two projections, 6.4 in q.k and p.v) against ~17 MB
// of x, weights and output, so the tensor-core rate bounds it (0.026 ms at
// 989 TFLOP/s); the backward does about 2.3x the work. The bf16 forward's
// design answers that bound: every product on wgmma, operands brought in by
// TMA and never converted in shared memory, q.k recomputed in the
// attention's second pass rather than an [L, L] tile stored. The bf16
// backward (K4) keeps its attention and do = dout . Wo^T on the CUDA cores
// (see above), so the fp32 rate (67 TFLOP/s) bounds it: it forms 7 L^2 D
// products of attention where the gradient needs 5, and ds makes one round
// trip through memory. The bf16 kernels take row strides and bases that are
// multiples of 16 bytes (E a multiple of 8); the wrapper refuses other
// shapes.

#include "attention_tiles.cuh"
#include "gemm_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// C[M, N] = A[M, K] . op(B) (+ bias[N]) on the CUDA cores: the backward's
// do = dout . Wo^T in both types (TB), and the fp32 projections. op(B) =
// B[K, N] row-major, or with TB the transpose of B[N, K] row-major. A
// 128 x 128 tile per block of 256 threads, 16 deep, in fma_tile
// (attention_tiles.cuh): thread (ty, tx) owns rows 4ty..4ty+3 and
// 64+4ty..64+4ty+3 and columns 4tx..4tx+3 and 64+4tx..64+4tx+3, reading
// each k's A and B values as float4 from k-major tiles (64 FMAs for 4
// shared loads). The tiles are filled in 16-byte chunks (A, and B with TB,
// transposed on the store; B without TB straight, by cp.async in fp32) into
// two buffers, the next k step's in flight while this one is multiplied.
// Each output is one fmaf chain over k = 0..K-1 in order, the bias added in
// fp32 after it and before the one rounding to T: the bits of cuBLAS's fp32
// GEMM on the card (PERF.md).
constexpr int GBM = 128, GBN = 128, GBK = 16, GTHREADS = 256, GLD = GBM + 4;

template <typename T, bool TB>
__global__ void __launch_bounds__(GTHREADS)
gemm_bias(const T* __restrict__ A, const T* __restrict__ B,
          const float* __restrict__ bias, T* __restrict__ C,
          int M, int N, int K) {
  __shared__ __align__(16) float As[2][GBK * GLD];  // [k][m]
  __shared__ __align__(16) float Bs[2][GBK * GLD];  // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  constexpr int W = kChunk<T>;
  const bool va = K % W == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const bool vb = (TB ? K : N) % W == 0 && reinterpret_cast<uintptr_t>(B) % 16 == 0;
  TileFill<T, GBM, GBK, GTHREADS, true> fa;
  TileFill<T, TB ? GBN : GBK, TB ? GBK : GBN, GTHREADS, TB> fb;
  auto load = [&](int k0, int s) {
    fa.load(A + (size_t)m0 * K + k0, K, M - m0, K - k0, va, As[s], GLD);
    if (TB)
      fb.load(B + (size_t)n0 * K + k0, K, N - n0, K - k0, vb, Bs[s], GLD);
    else
      fb.load(B + (size_t)k0 * N + n0, N, K - k0, N - n0, vb, Bs[s], GLD);
  };
  auto store = [&](int s) {
    fa.store(As[s], GLD);
    fb.store(Bs[s], GLD);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int nk = (K + GBK - 1) / GBK;
  load(0, 0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    if (t + 1 < nk) load((t + 1) * GBK, s ^ 1);
    fma_tile<8, false, GBK>(acc, As[s], GLD, 4 * ty, 64, Bs[s], GLD, 4 * tx, 64);
    if (t + 1 < nk) store(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + 4 * ty + (i & 3) + 64 * (i >> 2);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + 4 * tx + (j & 3) + 64 * (j >> 2);
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

// The forward's projections (C = A . B + bias) and the backward's dx (TB:
// C = A . B^T): bf16 on the tensor cores, fp32 on the CUDA cores
// (out_f32: C in fp32; the fp32 kernel writes fp32 anyway)
template <typename T, bool TB>
cudaError_t launch_proj(const void* A, const void* B, const void* bias, void* C, int M, int N,
                        int K, cudaStream_t stream, bool out_f32 = false) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_gemm_sm90<TB>(A, B, bias, C, M, N, K, stream, out_f32);
  else
    return launch_gemm<T, TB>(A, B, bias, C, M, N, K, stream);
}

template <typename T, int D>
cudaError_t run_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                    const void* bo, const void* bias_row, const void* seg_row, void* qkv,
                    void* ctx, void* out, void* stat_m, void* stat_l, int B, int L, int E,
                    int P, int H, Dropout drop, bool out_f32, cudaStream_t stream) {
  const int M = B * L;
  cudaError_t err = launch_proj<T, false>(x, wqkv, bqkv, qkv, M, 3 * P, E, stream);
  if (err != cudaSuccess) return err;
  // q, k and v are the three P-wide sections of a qkv row
  const T* sec = static_cast<const T*>(qkv);
  err = launch_attention_fwd<T, D>(
      Rows<const T>{sec, 3 * P}, Rows<const T>{sec + P, 3 * P}, Rows<const T>{sec + 2 * P, 3 * P},
      static_cast<const float*>(bias_row), static_cast<const float*>(seg_row),
      Rows<T>{static_cast<T*>(ctx), P}, static_cast<float*>(stat_m),
      static_cast<float*>(stat_l), B, L, H, drop, stream);
  if (err != cudaSuccess) return err;
  return launch_proj<T, false>(ctx, wo, bo, out, M, E, P, stream, out_f32);
}

template <typename T, int D>
cudaError_t run_bwd(const void* dout, const void* wqkv, const void* wo, const void* qkv,
                    const void* stat_m, const void* stat_l, const void* bias_row,
                    const void* seg_row, void* dO, void* delta, void* ds, void* keep_bits,
                    void* dqkv, void* dx, int B, int L, int E, int P, int H, Dropout drop,
                    cudaStream_t stream) {
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
      static_cast<T*>(ds), static_cast<uint64_t*>(keep_bits), B, L, H, drop, stream);
  if (err != cudaSuccess) return err;
  return launch_proj<T, true>(dqkv, wqkv, nullptr, dx, M, E, 3 * P, stream);
}

bool shape_ok(int B, int L, int E, int P, int H) {
  if (B < 1 || L < 1 || E < 1 || H < 1 || P % H) return false;
  const int D = P / H;
  return D == 64 || D == 128;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; x, the matrices, qkv and ctx are
// all of that type, and so is out unless out_f32 (then fp32). Each entry
// returns cudaGetLastError() after its launches (0 = success), or -1 for
// arguments it refuses.
// bias_row [B, L] fp32 is already clamped to _NEG, or NULL for none;
// seg_row [B, L] fp32, or NULL for no segments. qkv [B*L, 3P] and
// ctx [B*L, P] are written; stat_m and stat_l [B, H, L] fp32 are written
// when not NULL (the training forward), else the light forward runs.
// dropout != 0 drops attention probabilities with (seed, thresh, inv_keep).
extern "C" int plbt_attention_block_fwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wo, const void* bo,
    const void* bias_row, const void* seg_row, void* qkv, void* ctx, void* out,
    void* stat_m, void* stat_l, int B, int L, int E, int P, int H, int dtype, int out_f32,
    int dropout, unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!shape_ok(B, L, E, P, H) || (stat_m == nullptr) != (stat_l == nullptr)) return -1;
  const bool f32 = out_f32 != 0;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool d64 = P / H == 64;
  cudaError_t err;
  if (dtype == 0) {
    err = d64 ? run_fwd<float, 64>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx, out,
                                   stat_m, stat_l, B, L, E, P, H, drop, f32, st)
              : run_fwd<float, 128>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx, out,
                                    stat_m, stat_l, B, L, E, P, H, drop, f32, st);
  } else if (dtype == 1) {
    err = d64 ? run_fwd<__nv_bfloat16, 64>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv, ctx,
                                           out, stat_m, stat_l, B, L, E, P, H, drop, f32, st)
              : run_fwd<__nv_bfloat16, 128>(x, wqkv, bqkv, wo, bo, bias_row, seg_row, qkv,
                                            ctx, out, stat_m, stat_l, B, L, E, P, H, drop, f32,
                                            st);
  } else {
    return -1;
  }
  return static_cast<int>(err);
}

// The backward of the training forward. dout [B*L, E], wqkv [E, 3P],
// wo [P, E], qkv [B*L, 3P] (saved) in the compute type; stat_m/stat_l
// [B, H, L] fp32 (saved); bias_row/seg_row and the dropout as in the
// forward. Scratch: dO [B*L, P] and ds [B, H, Lp, Lp] (Lp = L rounded up
// to a multiple of 64) of the compute type, delta [B, H, L] fp32, and with
// dropout keep_bits [B, H, Lp, Lp/64] 64-bit words (else NULL). Writes
// dqkv [B*L, 3P] (= [dq|dk|dv], the compute type) and dx [B*L, E].
extern "C" int plbt_attention_block_bwd(
    const void* dout, const void* wqkv, const void* wo, const void* qkv, const void* stat_m,
    const void* stat_l, const void* bias_row, const void* seg_row, void* dO, void* delta,
    void* ds, void* keep_bits, void* dqkv, void* dx, int B, int L, int E, int P, int H,
    int dtype, int dropout, unsigned int seed, unsigned int thresh, float inv_keep,
    void* stream) {
  if (!shape_ok(B, L, E, P, H)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto bwd) {
    return static_cast<int>(bwd(dout, wqkv, wo, qkv, stat_m, stat_l, bias_row, seg_row, dO,
                                delta, ds, keep_bits, dqkv, dx, B, L, E, P, H, drop, st));
  };
  const bool d64 = P / H == 64;
  if (dtype == 0) return run(d64 ? run_bwd<float, 64> : run_bwd<float, 128>);
  if (dtype == 1)
    return run(d64 ? run_bwd<__nv_bfloat16, 64> : run_bwd<__nv_bfloat16, 128>);
  return -1;
}

// C[M, N] = A[M, K] . B[N, K]^T in bf16 on the tensor cores: the backward's
// dx projection (gemm_bias_sm90 reading B K-major) on its own, for checks.
extern "C" int plbt_gemm_bt(const void* A, const void* B, void* C, int M, int N, int K,
                            void* stream) {
  if (M < 1 || N < 1 || K < 1) return -1;
  return static_cast<int>(
      launch_gemm_sm90<true>(A, B, nullptr, C, M, N, K, static_cast<cudaStream_t>(stream)));
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
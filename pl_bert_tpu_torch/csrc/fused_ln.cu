// The fused dropout + residual add + LayerNorm backward (K6) and the copy
// anchor (K9) for Hopper. The forward (K5) stays in Triton
// (ops/_ln_triton.py): it runs at its bytes bound and draws the dropout mask
// with tl.rand, which K6 regenerates here bit for bit.
//
// K6 replaces the Pallas backward _bwd_kernel of pl_bert_tpu/ops/fused_ln.py
// (:88-115, via _fused_bwd :148-170). It keeps the TPU kernel's custom-VJP
// contract: nothing but x, the residual and gamma is saved, so the dropout
// mask and the row statistics are recomputed. Per row of [N, H]:
//   y = dropout(x) + res, xhat = (y - mean) * rstd,
//   dres = (g*gamma - mean(g*gamma) - xhat * mean(g*gamma*xhat)) * rstd,
//   dx = dres masked and scaled, dgamma += g*xhat, dbeta += g  (fp32).
// What bounds it on the card: it reads x, res and dy and writes dx and dres,
// 5 x N x H x itemsize bytes (377 MB at [49152, 768] bf16, 0.113 ms at
// 3.35 TB/s), for ~20 fp32 operations an element; with dropout, one
// Philox4x32-10 draw an element on the integer units (ten rounds of two
// 32-bit multiply-highs, two multiply-lows and two three-way XORs), work of
// the same order as the bytes. The design:
//   - a warp per row: lane l owns the 8-element column slices l*8 + 256*s,
//     s < NS = ceil(H / 256), so H = 768 is three 16-byte loads an operand
//     a lane in bf16 and no lane is padding (H a multiple of 8, <= 1024);
//   - the four row sums (mean, variance, and the two means of the gradient)
//     are warp shuffles: no shared memory and no barrier on the row path;
//   - while a warp works on one row, the next row's x, res and dy are on
//     their way into registers, so the loads hide behind the Philox draws
//     and the arithmetic;
//   - a lane always owns the same columns, so its dgamma/dbeta partials stay
//     in registers over every row its warp walks; one shared-memory pass a
//     block sums the warps' partials in a fixed order into one partial row a
//     block, and a second small kernel sums those rows in a fixed order. No
//     float atomics: two calls on the same inputs give the same bits.
// The mask is K5's: keep where tl.rand(seed, offset) >= rate, with offset =
// row * H + col as int32 -- Triton's Philox with key (seed_lo, seed_hi) and
// counter (offset, 0, 0, 0), first word, turned into a float as Triton's
// uint_to_uniform_float does (triton/language/random.py). The plain version
// of the same draw is ops/fused_ln.py::tl_rand.
//
// K9 replaces the copy anchor of tools/bench_fused_ln.py (_copy_kernel
// :110-113 via copy_op :115-127): out = fp32(x) + fp32(res) cast back, over
// the flat element range, which is K5's traffic (3 x N x H x itemsize) with
// none of its work -- the card's floor for that traffic. 16-byte vector
// loads and stores, four of each operand in flight a thread, a grid-stride
// loop over a few waves of blocks; a scalar loop takes a ragged tail, and the
// whole range when a base pointer is not 16-byte aligned.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;          // K6: warps a block, a row each at a time
constexpr int kMaxSlices = 4;      // K6: H <= 4 * 256
constexpr int kCopyThreads = 256;  // K9
constexpr int kCopyUnroll = 4;     // K9: 16-byte accesses an operand in flight a thread

// --- 8 elements of one row: 16 bytes of bf16 or 32 of fp32 ----------------

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  // round to nearest even, as torch's .to(torch.bfloat16)
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

template <typename T> struct Eight;

template <> struct Eight<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float f[8]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf16_lo(w[i]);
      f[2 * i + 1] = bf16_hi(w[i]);
    }
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, const float f[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]),
                                              bf16_pair(f[4], f[5]), bf16_pair(f[6], f[7]));
  }
};

template <> struct Eight<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float f[8]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ __forceinline__ static void put(float* p, const float f[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

// --- the dropout mask: Triton's tl.rand(seed, offset) >= rate -------------

struct LnDropout {
  uint32_t seed_lo, seed_hi;  // Triton's Philox key: the seed's two 32-bit words
  float rate;                 // keep where the uniform float >= rate (fp32, as Triton's arg)
  float scale;                // 1 / (1 - rate)
};

__device__ __forceinline__ bool tl_rand_keep(uint32_t offset, const LnDropout& d) {
  int32_t v = static_cast<int32_t>(philox_word0(offset, 0u, d.seed_lo, d.seed_hi));
  v = v < 0 ? ~v : v;  // Triton's x < 0 -> -x - 1, in int32
  return __fmul_rn(__int2float_rn(v), 4.6566127342e-10f) >= d.rate;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, m);
  return v;
}

struct LnBwdArgs {
  const void* x;
  const void* res;
  const float* gamma;
  const void* dy;
  void* dx;
  void* dres;
  float* part;  // [2, gridDim.x, H]: each block's dgamma row, then its dbeta row
  int n_rows, H;
  float eps;
  LnDropout drop;
};

template <typename T, int NS, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) ln_bwd(const LnBwdArgs a) {
  __shared__ float red[2][kWarps][NS * 256];
  const T* __restrict__ X = static_cast<const T*>(a.x);
  const T* __restrict__ R = static_cast<const T*>(a.res);
  const T* __restrict__ DY = static_cast<const T*>(a.dy);
  T* __restrict__ DX = static_cast<T*>(a.dx);
  T* __restrict__ DRES = static_cast<T*>(a.dres);
  const int H = a.H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  const float inv_h = 1.f / static_cast<float>(H);
  bool on[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) on[s] = s * 256 + lane * 8 < H;

  float dg[NS][8], db[NS][8];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) dg[s][j] = db[s][j] = 0.f;

  Eight<T> nx[NS], nr[NS], nd[NS];  // the next row, in flight
  auto fetch = [&](int row) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      const size_t off = static_cast<size_t>(row) * H + s * 256 + lane * 8;
      nx[s].load(X + off);
      nr[s].load(R + off);
      nd[s].load(DY + off);
    }
  };

  int row = blockIdx.x * kWarps + warp;
  if (row < a.n_rows) fetch(row);
#pragma unroll 1
  for (; row < a.n_rows; row += stride) {
    float y[NS][8], g[NS][8];
    float sum = 0.f;
    uint32_t kept = 0u;  // bit 8s + j: element j of slice s kept
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      float r[8];
      nx[s].get(y[s]);
      nr[s].get(r);
      nd[s].get(g[s]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = y[s][j];
        if (DROP) {
          const uint32_t offset = static_cast<uint32_t>(row * H + s * 256 + lane * 8 + j);
          const bool k = tl_rand_keep(offset, a.drop);
          kept |= static_cast<uint32_t>(k) << (8 * s + j);
          v = k ? v * a.drop.scale : 0.f;
        }
        v += r[j];
        y[s][j] = v;
        sum += v;
      }
    }
    // the next row's loads go out now and land behind this row's work
    if (row + stride < a.n_rows) fetch(row + stride);

    const float mean = warp_sum(sum) * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[s][j] -= mean;
        sq += y[s][j] * y[s][j];
      }
    }
    const float rstd = 1.f / sqrtf(warp_sum(sq) * inv_h + a.eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(a.gamma + s * 256 + lane * 8));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(a.gamma + s * 256 + lane * 8) + 1);
      const float gam[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xhat = y[s][j] * rstd;
        y[s][j] = xhat;
        dg[s][j] += g[s][j] * xhat;
        db[s][j] += g[s][j];
        const float gg = g[s][j] * gam[j];
        g[s][j] = gg;
        m1 += gg;
        m2 += gg * xhat;
      }
    }
    m1 = warp_sum(m1) * inv_h;
    m2 = warp_sum(m2) * inv_h;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      float d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d[j] = (g[s][j] - m1 - y[s][j] * m2) * rstd;
      const size_t off = static_cast<size_t>(row) * H + s * 256 + lane * 8;
      Eight<T>::put(DRES + off, d);
      if (DROP) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          d[j] = (kept >> (8 * s + j)) & 1u ? d[j] * a.drop.scale : 0.f;
      }
      Eight<T>::put(DX + off, d);
    }
  }

  // the block's dgamma/dbeta: the warps' partials summed in warp order
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!on[s]) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[0][warp][s * 256 + lane * 8 + j] = dg[s][j];
      red[1][warp][s * 256 + lane * 8 + j] = db[s][j];
    }
  }
  __syncthreads();
  float* dg_row = a.part + static_cast<size_t>(blockIdx.x) * H;
  float* db_row = a.part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sg += red[0][w][c];
      sb += red[1][w][c];
    }
    dg_row[c] = sg;
    db_row[c] = sb;
  }
}

// out[t, c] = sum over p of part[t, p, c] in p order (t = 0: dgamma, 1:
// dbeta): block (x, t) takes 32 columns; thread group w sums p = w, w + 8,
// ... and the eight group sums are added in group order.
__global__ void __launch_bounds__(256) ln_bwd_reduce(const float* part, int P, int H,
                                                     float* out) {
  __shared__ float acc[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* src = part + static_cast<size_t>(blockIdx.y) * P * H;
  float s = 0.f;
  if (c < H)
    for (int p = w; p < P; p += 8) s += src[static_cast<size_t>(p) * H + c];
  acc[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < H) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += acc[i][lane];
    out[blockIdx.y * H + c] = t;
  }
}

template <typename T, int NS, bool DROP>
int ln_bwd_blocks() {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_bwd<T, NS, DROP>, kWarps * 32, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// every instance, by dtype (0 fp32, 1 bf16), slices and dropout: f is a
// functor with a member template operator()<T, NS, DROP>()
template <typename F, typename T, int NS>
int with_drop(bool drop, const F& f) {
  return drop ? f.template operator()<T, NS, true>() : f.template operator()<T, NS, false>();
}

template <typename F, typename T>
int dispatch_ns(int ns, bool drop, const F& f) {
  switch (ns) {
    case 1: return with_drop<F, T, 1>(drop, f);
    case 2: return with_drop<F, T, 2>(drop, f);
    case 3: return with_drop<F, T, 3>(drop, f);
    default: return with_drop<F, T, 4>(drop, f);
  }
}

template <typename F>
int dispatch(int dtype, int H, bool drop, const F& f) {
  const int ns = (H + 255) / 256;
  if (H < 8 || H % 8 || ns > kMaxSlices || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? dispatch_ns<F, float>(ns, drop, f)
                    : dispatch_ns<F, __nv_bfloat16>(ns, drop, f);
}

struct BlocksFn {
  template <typename T, int NS, bool DROP> int operator()() const {
    return ln_bwd_blocks<T, NS, DROP>();
  }
};

struct LaunchFn {
  LnBwdArgs a;
  int blocks;
  cudaStream_t st;
  template <typename T, int NS, bool DROP> int operator()() const {
    ln_bwd<T, NS, DROP><<<blocks, kWarps * 32, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
__device__ __forceinline__ T add8(const T& a, const T& b);
template <>
__device__ __forceinline__ uint4 add8<uint4>(const uint4& a, const uint4& b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = bf16_pair(bf16_lo(x[i]) + bf16_lo(y[i]), bf16_hi(x[i]) + bf16_hi(y[i]));
  return make_uint4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ float4 add8<float4>(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float scalar_f(float v) { return v; }
__device__ __forceinline__ float scalar_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T scalar_t(float v);
template <> __device__ __forceinline__ float scalar_t<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 scalar_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// K9: V is the 16-byte vector (uint4 of 8 bf16, float4 of 4 fp32)
template <typename T, typename V>
__global__ void __launch_bounds__(kCopyThreads) add_copy(const T* __restrict__ x,
                                                         const T* __restrict__ r,
                                                         T* __restrict__ o, long long n,
                                                         int aligned) {
  constexpr int kPer = sizeof(V) / sizeof(T);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (aligned) {
    const V* xv = reinterpret_cast<const V*>(x);
    const V* rv = reinterpret_cast<const V*>(r);
    V* ov = reinterpret_cast<V*>(o);
    const long long nv = n / kPer;
    for (long long base = tid; base < nv; base += kCopyUnroll * threads) {
      V a[kCopyUnroll], b[kCopyUnroll];
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const long long i = base + u * threads;
        if (i < nv) {
          a[u] = __ldg(xv + i);
          b[u] = __ldg(rv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kCopyUnroll; ++u) {
        const long long i = base + u * threads;
        if (i < nv) ov[i] = add8<V>(a[u], b[u]);
      }
    }
    done = nv * kPer;
  }
  for (long long i = done + tid; i < n; i += threads)
    o[i] = scalar_t<T>(scalar_f(x[i]) + scalar_f(r[i]));
}

LnDropout make_drop(unsigned int seed_lo, unsigned int seed_hi, float rate) {
  LnDropout d;
  d.seed_lo = seed_lo;
  d.seed_hi = seed_hi;
  d.rate = rate;
  d.scale = rate > 0.f ? 1.f / (1.f - rate) : 1.f;
  return d;
}

}  // namespace

// K6's grid for [*, H] in dtype (0 fp32, 1 bf16), dropout on or off: blocks
// that fill every SM once; the caller sizes the partial rows [2, blocks, H]
// by it. Negative for a width the kernel does not take.
extern "C" int plbt_ln_bwd_blocks(int H, int dtype, int drop) {
  return dispatch(dtype, H, drop != 0, BlocksFn{});
}

// K6: dx, dres [n_rows, H] in dtype; part [2, blocks, H] fp32 scratch;
// dgdb [2, H] fp32 (dgamma, then dbeta). Dropout keeps where Triton's
// tl.rand(seed, row * H + col) >= rate.
extern "C" int plbt_ln_bwd(const void* x, const void* res, const void* gamma, const void* dy,
                           void* dx, void* dres, void* part, void* dgdb, int n_rows, int H,
                           int dtype, int blocks, unsigned int seed_lo, unsigned int seed_hi,
                           float rate, float eps, void* stream) {
  if (n_rows < 1 || blocks < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LnBwdArgs a;
  a.x = x;
  a.res = res;
  a.gamma = static_cast<const float*>(gamma);
  a.dy = dy;
  a.dx = dx;
  a.dres = dres;
  a.part = static_cast<float*>(part);
  a.n_rows = n_rows;
  a.H = H;
  a.eps = eps;
  a.drop = make_drop(seed_lo, seed_hi, rate);
  const int status = dispatch(dtype, H, rate > 0.f, LaunchFn{a, blocks, st});
  if (status != 0) return status;
  ln_bwd_reduce<<<dim3((H + 31) / 32, 2), 256, 0, st>>>(static_cast<const float*>(part), blocks,
                                                        H, static_cast<float*>(dgdb));
  return static_cast<int>(cudaGetLastError());
}

// K9: o = fp32(x) + fp32(r) cast back, over n elements of dtype (0 fp32,
// 1 bf16); 16-byte vectors where all three bases are 16-byte aligned.
extern "C" int plbt_add_copy(const void* x, const void* r, void* o, long long n, int dtype,
                             int blocks, void* stream) {
  if (n < 0 || blocks < 1 || (dtype != 0 && dtype != 1)) return -1;
  if (n == 0) return 0;
  const int aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
        reinterpret_cast<uintptr_t>(o)) & 15u) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    add_copy<float, float4><<<blocks, kCopyThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(r), static_cast<float*>(o), n,
        aligned);
  else
    add_copy<__nv_bfloat16, uint4><<<blocks, kCopyThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(r),
        static_cast<__nv_bfloat16*>(o), n, aligned);
  return static_cast<int>(cudaGetLastError());
}

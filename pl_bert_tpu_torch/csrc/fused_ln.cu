// The fused dropout + residual add + LayerNorm forward (K5) and backward
// (K6), and the copy anchor (K9), for Hopper.
//
// K5 replaces the Pallas forward _fwd_kernel of pl_bert_tpu/ops/fused_ln.py
// (:72-85, via _fused_fwd :132-145); per row of [N, H]:
//   y = dropout(x) + res, out = (y - mean) * rstd * gamma + beta,
// fp32 statistics (the variance the mean of the centred squares), out in
// x's dtype. What bounds it on the card: it reads x and the residual and
// writes the output, 3 x N x H x itemsize bytes (226 MB at [49152, 768]
// bf16, 0.068 ms at 3.35 TB/s); with dropout, one Philox4x32-10 draw an
// element on the integer units (20 IMAD and 20 LOP3 a draw in the SASS),
// which on an H100 take longer than the bytes: Triton's mask kernel, the
// same draws with one byte out an element, takes about 0.11 ms there
// (chip_smoke.py, phase 8). So with dropout K5 is bound by its draws, and
// the design keeps the integer pipes fed and the loads behind them.
//
// K6 replaces the Pallas backward _bwd_kernel of the same file (:88-115,
// via _fused_bwd :148-170). It keeps the TPU kernel's custom-VJP contract:
// nothing but x, the residual and gamma is saved, so the dropout mask and
// the row statistics are recomputed. Per row:
//   xhat = (y - mean) * rstd,
//   dres = (g*gamma - mean(g*gamma) - xhat * mean(g*gamma*xhat)) * rstd,
//   dx = dres masked and scaled, dgamma += g*xhat, dbeta += g  (fp32).
// It moves 5 x N x H x itemsize bytes (x, res, dy read; dx, dres written)
// for ~20 fp32 operations and, with dropout, one draw an element.
//
// The design, shared by both:
//   - a warp per row: lane l owns the 8-element column slices l*8 + 256*s,
//     s < NS = ceil(H / 256), so H = 768 is three 16-byte loads an operand
//     a lane in bf16 and no lane is padding (H a multiple of 8 up to 2048,
//     for both);
//   - one routine (row_stats) draws a row's mask and forms y, its mean and
//     rstd, so the backward recomputes the forward's statistics with the
//     same code in the same order. A lane's 8·NS draws of a row are
//     independent Philox chains, interleaved with the data, which gives
//     the integer pipes their parallelism; the next row's loads go out as
//     soon as this row's registers are read, and land behind the row sums
//     (warp shuffles: no shared memory and no barrier on the row path),
//     the output and the stores, and the next row's draws. K5 without
//     dropout is bound by its loads alone and keeps two rows in flight a
//     warp, which ran faster on an H100 at [49152, 768];
//   - a grid of blocks that fill every SM once, each warp walking rows at a
//     stride of the grid's warps. A lane always owns the same columns, so
//     K5 holds its gamma/beta in registers over every row at dropout 0
//     (with dropout those registers buy occupancy, and gamma/beta come
//     through L1), and K6 holds its dgamma/dbeta partials: one
//     shared-memory pass a block sums the warps' partials in a fixed order
//     into one partial row a block, and a second small kernel sums those
//     rows in a fixed order. No float atomics: two calls on the same inputs
//     give the same bits;
//   - rows wider than kRegSlices slices a lane (H > 1024) have no room in
//     registers for all of that: there K5 keeps one row in flight and reads
//     gamma/beta through L1, and K6 adds its partials to the warp's rows in
//     shared memory and loads each row when it takes it up.
// The mask: keep where tl.rand(seed, offset) >= rate, with offset = row *
// H + col as int32 -- Triton's Philox with key (seed_lo, seed_hi) and
// counter (offset, 0, 0, 0), first word, turned into a float as Triton's
// uint_to_uniform_float does (triton/language/random.py). The plain
// version of the same draw is ops/fused_ln.py::tl_rand; a Triton kernel
// that calls tl.rand itself (ops/_ln_triton.py) is the oracle on the card.
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

#include <type_traits>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;          // K5, K6: warps a block, a row each at a time
constexpr int kSlices = 8;         // K5, K6: H <= 8 * 256
constexpr int kRegSlices = 4;      // K5, K6: a row's state in registers up to 4 slices a lane
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

// Keep bits of a lane's row slice: bit 8s + j for element j of slice s
template <int NS>
using KeepBits = typename std::conditional<NS <= 4, uint32_t, uint64_t>::type;

// One row of the LayerNorm up to its normalisation, for K5 and K6 alike:
// the backward recomputes the forward's statistics with this code, in this
// order. xs, rs: the lane's slices of x and the residual, in flight. For
// each slice, its x and residual unpacked, then slice(s) (K6 unpacks its
// dy there), then for each element y = dropout(x) + res in fp32, the draw
// interleaved with the data so that the row's 8·NS independent Philox
// chains give the integer pipes their parallelism; then next() -- called
// once the slices are read -- sends the next row's loads out; then the
// mean and the variance (the mean of the centred squares) by warp
// shuffles. On return y holds y - mean, kept the keep bits, and the
// result is rstd.
template <typename T, int NS, bool DROP, typename Slice, typename Next>
__device__ __forceinline__ float row_stats(const Eight<T> (&xs)[NS], const Eight<T> (&rs)[NS],
                                           const bool (&on)[NS], int row, int H, int lane,
                                           float eps, const LnDropout& d, float (&y)[NS][8],
                                           KeepBits<NS>& kept, const Slice& slice,
                                           const Next& next) {
  const float inv_h = 1.f / static_cast<float>(H);
  float sum = 0.f;
  kept = 0u;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!on[s]) continue;
    float r[8];
    xs[s].get(y[s]);
    rs[s].get(r);
    slice(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = y[s][j];
      if (DROP) {
        const uint32_t offset = static_cast<uint32_t>(row * H + s * 256 + lane * 8 + j);
        const bool k = tl_rand_keep(offset, d);
        kept |= static_cast<KeepBits<NS>>(k) << (8 * s + j);
        v = k ? v * d.scale : 0.f;
      }
      v += r[j];
      y[s][j] = v;
      sum += v;
    }
  }
  next();
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
  return 1.f / sqrtf(warp_sum(sq) * inv_h + eps);
}

// K5's gamma and beta at the lane's columns: HELD, loaded once and held in
// registers over every row; else read per row through L1
template <int NS, bool HELD>
struct Affine {
  Eight<float> g[NS], b[NS];
  __device__ __forceinline__ Affine(const float* gamma, const float* beta, const bool (&on)[NS],
                                    int lane) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      g[s].load(gamma + s * 256 + lane * 8);
      b[s].load(beta + s * 256 + lane * 8);
    }
  }
  __device__ __forceinline__ void get(int s, float gs[8], float bs[8]) const {
    g[s].get(gs);
    b[s].get(bs);
  }
};

template <int NS>
struct Affine<NS, false> {
  const float* gamma;
  const float* beta;
  int lane;
  __device__ __forceinline__ Affine(const float* gamma_, const float* beta_, const bool (&)[NS],
                                    int lane_)
      : gamma(gamma_), beta(beta_), lane(lane_) {}
  __device__ __forceinline__ void get(int s, float gs[8], float bs[8]) const {
    Eight<float> e;
    e.load(gamma + s * 256 + lane * 8);
    e.get(gs);
    e.load(beta + s * 256 + lane * 8);
    e.get(bs);
  }
};

struct LnFwdArgs {
  const void* x;
  const void* res;
  const float* gamma;
  const float* beta;
  void* out;
  int n_rows, H;
  float eps;
  LnDropout drop;
};

template <typename T, int NS, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) ln_fwd(const LnFwdArgs a) {
  const T* __restrict__ X = static_cast<const T*>(a.x);
  const T* __restrict__ R = static_cast<const T*>(a.res);
  T* __restrict__ O = static_cast<T*>(a.out);
  const int H = a.H, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  bool on[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) on[s] = s * 256 + lane * 8 < H;
  // held in registers at dropout 0 where they fit; with dropout those
  // registers buy occupancy, which ran faster on an H100, and L1 serves
  // gamma and beta
  const Affine<NS, !DROP && NS <= kRegSlices> affine(a.gamma, a.beta, on, lane);

  auto fetch = [&](int row, Eight<T> (&fx)[NS], Eight<T> (&fr)[NS]) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      const size_t off = static_cast<size_t>(row) * H + s * 256 + lane * 8;
      fx[s].load(X + off);
      fr[s].load(R + off);
    }
  };
  // one row from the slices in flight (bx, br), which then take next_row's loads
  auto body = [&](int row, Eight<T> (&bx)[NS], Eight<T> (&br)[NS], int next_row) {
    float y[NS][8];
    KeepBits<NS> kept;
    const float rstd = row_stats<T, NS, DROP>(
        bx, br, on, row, H, lane, a.eps, a.drop, y, kept, [](int) {},
        [&] {
          if (next_row < a.n_rows) fetch(next_row, bx, br);
        });
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      float gs[8], bs[8];
      affine.get(s, gs, bs);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[s][j] = y[s][j] * rstd * gs[j] + bs[j];
      Eight<T>::put(O + static_cast<size_t>(row) * H + s * 256 + lane * 8, y[s]);
    }
  };

  int row = blockIdx.x * kWarps + warp;
  if (DROP || NS > kRegSlices) {
    // the draws bound the kernel (or a wide row fills the registers): one
    // row ahead keeps the loads behind them
    Eight<T> nx[NS], nr[NS];
    if (row < a.n_rows) fetch(row, nx, nr);
#pragma unroll 1
    for (; row < a.n_rows; row += stride) body(row, nx, nr, row + stride);
  } else {
    // the loads bound it: two rows in flight a warp
    Eight<T> ax[NS], ar[NS], bx[NS], br[NS];
    if (row < a.n_rows) fetch(row, ax, ar);
    if (row + stride < a.n_rows) fetch(row + stride, bx, br);
#pragma unroll 1
    for (; row < a.n_rows; row += 2 * stride) {
      body(row, ax, ar, row + 2 * stride);
      if (row + stride >= a.n_rows) break;
      body(row + stride, bx, br, row + 3 * stride);
    }
  }
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

// K6's dgamma/dbeta partial rows in shared memory, [2][kWarps][NS * 256]
// floats (dgamma, then dbeta; a row a warp): element j of a lane's slice s
// at s * 256 + (j / 4) * 128 + lane * 4 + j % 4, so that a warp's float4
// accesses are contiguous.
template <int NS>
constexpr int ln_bwd_smem() {
  return 2 * kWarps * NS * 256 * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ int partial_at(int s, int lane, int half) {
  return s * 256 + half * 128 + lane * 4;
}

// w[slice s of the lane] = v (ADD: += v)
template <bool ADD>
__device__ __forceinline__ void put_partial(float* w, int s, int lane, const float v[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float4* p = reinterpret_cast<float4*>(w + partial_at(s, lane, h));
    float4 o = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    if (ADD) {
      const float4 was = *p;
      o = make_float4(was.x + o.x, was.y + o.y, was.z + o.z, was.w + o.w);
    }
    *p = o;
  }
}

template <typename T, int NS, bool DROP>
__global__ void __launch_bounds__(kWarps * 32) ln_bwd(const LnBwdArgs a) {
  // HELD: the partials in registers and the next row in flight; else the
  // partials in shared memory and each row loaded when it is taken up
  constexpr bool HELD = NS <= kRegSlices;
  extern __shared__ float4 red_mem[];
  float* red = reinterpret_cast<float*>(red_mem);
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

  float* wg = red + warp * NS * 256;             // this warp's dgamma partials
  float* wb = red + (kWarps + warp) * NS * 256;  // and its dbeta partials
  float dg[HELD ? NS : 1][8], db[HELD ? NS : 1][8];  // HELD: the lane's partials
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if constexpr (HELD) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dg[s][j] = db[s][j] = 0.f;
    } else if (on[s]) {
      const float zero[8] = {};
      put_partial<false>(wg, s, lane, zero);
      put_partial<false>(wb, s, lane, zero);
    }
  }

  Eight<T> nx[NS], nr[NS], nd[NS];  // the row's loads, in flight
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
  if (HELD && row < a.n_rows) fetch(row);
#pragma unroll 1
  for (; row < a.n_rows; row += stride) {
    if (!HELD) fetch(row);
    float y[NS][8], g[NS][8];
    KeepBits<NS> kept;
    const float rstd = row_stats<T, NS, DROP>(
        nx, nr, on, row, H, lane, a.eps, a.drop, y, kept, [&](int s) { nd[s].get(g[s]); },
        [&] {
          if (HELD && row + stride < a.n_rows) fetch(row + stride);
        });
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      Eight<float> ge;
      ge.load(a.gamma + s * 256 + lane * 8);
      float gam[8], pg[8], pb[8];
      ge.get(gam);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xhat = y[s][j] * rstd;
        y[s][j] = xhat;
        if constexpr (HELD) {
          dg[s][j] += g[s][j] * xhat;
          db[s][j] += g[s][j];
        } else {
          pg[j] = g[s][j] * xhat;
          pb[j] = g[s][j];
        }
        const float gg = g[s][j] * gam[j];
        g[s][j] = gg;
        m1 += gg;
        m2 += gg * xhat;
      }
      if constexpr (!HELD) {
        put_partial<true>(wg, s, lane, pg);
        put_partial<true>(wb, s, lane, pb);
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
  if constexpr (HELD) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!on[s]) continue;
      put_partial<false>(wg, s, lane, dg[s]);
      put_partial<false>(wb, s, lane, db[s]);
    }
  }
  __syncthreads();
  float* dg_row = a.part + static_cast<size_t>(blockIdx.x) * H;
  float* db_row = a.part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const int j = c & 7;
    const int at = partial_at(c >> 8, (c & 255) >> 3, j >> 2) + (j & 3);
    float sg = 0.f, sb = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sg += red[w * NS * 256 + at];
      sb += red[(kWarps + w) * NS * 256 + at];
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

// every instance up to kMax slices, by dtype (0 fp32, 1 bf16), slices and
// dropout: f is a functor with a member template operator()<T, NS, DROP>()
template <int kMax, typename F, typename T, int NS = 1>
int dispatch_ns(int ns, bool drop, const F& f) {
  if (ns == NS)
    return drop ? f.template operator()<T, NS, true>() : f.template operator()<T, NS, false>();
  if constexpr (NS < kMax) return dispatch_ns<kMax, F, T, NS + 1>(ns, drop, f);
  return -1;
}

template <int kMax, typename F>
int dispatch(int dtype, int H, bool drop, const F& f) {
  const int ns = (H + 255) / 256;
  if (H < 8 || H % 8 || ns > kMax || (dtype != 0 && dtype != 1)) return -1;
  return dtype == 0 ? dispatch_ns<kMax, F, float>(ns, drop, f)
                    : dispatch_ns<kMax, F, __nv_bfloat16>(ns, drop, f);
}

// K6's shared memory a block; above the default 48 KB (NS > 6) the kernel
// has to be allowed it first
template <typename T, int NS, bool DROP>
int ln_bwd_allow() {
  if (ln_bwd_smem<NS>() <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      ln_bwd<T, NS, DROP>, cudaFuncAttributeMaxDynamicSharedMemorySize, ln_bwd_smem<NS>()));
}

// blocks that fill every SM once, at the occupancy the compiled kernel allows
template <bool BWD>
struct BlocksFn {
  template <typename T, int NS, bool DROP> int operator()() const {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if constexpr (BWD) {
      if (ln_bwd_allow<T, NS, DROP>() != 0) return -1;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_bwd<T, NS, DROP>, kWarps * 32,
                                                    ln_bwd_smem<NS>());
    } else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_fwd<T, NS, DROP>, kWarps * 32, 0);
    return sms * (per_sm > 0 ? per_sm : 1);
  }
};

struct FwdLaunch {
  LnFwdArgs a;
  int blocks;
  cudaStream_t st;
  template <typename T, int NS, bool DROP> int operator()() const {
    ln_fwd<T, NS, DROP><<<blocks, kWarps * 32, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

struct BwdLaunch {
  LnBwdArgs a;
  int blocks;
  cudaStream_t st;
  template <typename T, int NS, bool DROP> int operator()() const {
    const int allowed = ln_bwd_allow<T, NS, DROP>();
    if (allowed != 0) return allowed;
    ln_bwd<T, NS, DROP><<<blocks, kWarps * 32, ln_bwd_smem<NS>(), st>>>(a);
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

// K5's (backward 0) or K6's (backward 1) grid for [*, H] in dtype (0 fp32,
// 1 bf16), dropout on or off: blocks that fill every SM once; the caller
// sizes K6's partial rows [2, blocks, H] by it. Negative for a width the
// kernel does not take.
extern "C" int plbt_ln_blocks(int H, int dtype, int drop, int backward) {
  return backward ? dispatch<kSlices>(dtype, H, drop != 0, BlocksFn<true>{})
                  : dispatch<kSlices>(dtype, H, drop != 0, BlocksFn<false>{});
}

// K5: out [n_rows, H] in dtype from x, res [n_rows, H] in dtype and gamma,
// beta [H] fp32, on the caller's stream. Dropout keeps where Triton's
// tl.rand(seed, row * H + col) >= rate.
extern "C" int plbt_ln_fwd(const void* x, const void* res, const void* gamma, const void* beta,
                           void* out, int n_rows, int H, int dtype, int blocks,
                           unsigned int seed_lo, unsigned int seed_hi, float rate, float eps,
                           void* stream) {
  if (n_rows < 1 || blocks < 1) return -1;
  LnFwdArgs a;
  a.x = x;
  a.res = res;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.out = out;
  a.n_rows = n_rows;
  a.H = H;
  a.eps = eps;
  a.drop = make_drop(seed_lo, seed_hi, rate);
  return dispatch<kSlices>(dtype, H, rate > 0.f,
                              FwdLaunch{a, blocks, static_cast<cudaStream_t>(stream)});
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
  const int status = dispatch<kSlices>(dtype, H, rate > 0.f, BwdLaunch{a, blocks, st});
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

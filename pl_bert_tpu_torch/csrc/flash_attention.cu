// Per-head flash attention for Hopper, forward and backward.
//
// Replaces the Pallas kernels of pl_bert_tpu/ops/flash_attention.py, which
// the model runs where attention_impl is "pallas" (separate query/key/value
// projections outside the kernel, then this, then the output projection):
//   - K7, the forward _fwd_kernel (:47-70) via _flash_fwd (:157-170):
//     plbt_flash_attention_fwd, one launch;
//   - K8, the backward _bwd_kernel (:73-117) via _flash_bwd (:173-189):
//     plbt_flash_attention_bwd, two launches (dq over query tiles, dk/dv
//     over key tiles, so dk and dv need no atomics and are deterministic).
// The TPU ran one grid program per (batch, head) with the whole [L, L] score
// tile in VMEM. Here a block takes one 64-row query (or key) tile of one
// (batch, head) and walks the other side in 64-row tiles through shared
// memory: the kernels of attention_tiles.cuh, which the attention block
// shares.
//
// q, k, v, do and the outputs are [B, L, H, D] with D = 64; q, k, v and do
// may be views whose rows are further apart than H*D (the three sections of
// one fused projection), so the TPU wrapper's fold to [B*H, L, D]
// (:225-232) is never materialised.
//
// The custom-VJP contract of the TPU kernel (:157-189) is kept: the forward
// saves nothing but its inputs, and the backward recomputes the row max and
// the denominator (pass 0 of attention_bwd_dq, the forward's own code),
// then p, the dropout mask and ds. The rounding points are the TPU
// kernel's: p normalised in fp32, dropped out, then rounded to the compute
// type before p.v (:65-69) -- hence two passes over the keys, not an online
// softmax that rounds an unnormalised p; delta from the unrounded pd (:109),
// dv from the rounded one (:98-102); ds rounded before dq and dk (:110);
// dq, dk, dv rounded once, on store.
//
// Dropout is the port's Philox4x32-10 keyed by (seed, b*H + h) at (row,
// column), the stream of the attention block's kernels: with one seed both
// paths drop the same probabilities.
//
// What bounds it on the card: at [96, 512, 12, 64] bf16 the forward is
// 4*L*L*D*B*H = 77 GFLOP against 4 x 75.5 MB of q, k, v read and o written,
// so the bytes bound it (0.090 ms against 0.078 ms of tensor-core time);
// the backward is 10*L*L*D*B*H = 193 GFLOP against 7 x 75.5 MB, so the
// operations bound it. This version computes on the CUDA cores in fp32 and
// recomputes q.k (twice in the forward, four times in the backward), so it
// runs far above either bound: right first, tensor cores next.

#include "attention_tiles.cuh"

namespace {

bool flash_shape_ok(int B, int L, int H, int D, int ldq, int ldk, int ldv, int ldo) {
  const int P = H * D;
  return B >= 1 && L >= 1 && H >= 1 && D == 64 && ldq >= P && ldk >= P && ldv >= P &&
         ldo >= P;
}

template <typename T>
cudaError_t flash_fwd(const void* q, const void* k, const void* v, const void* bias_row,
                      const void* seg_row, void* out, int B, int L, int H, int ldq, int ldk,
                      int ldv, int ldo, Dropout drop, cudaStream_t stream) {
  return launch_attention_fwd<T, 64>(
      Rows<const T>{static_cast<const T*>(q), ldq}, Rows<const T>{static_cast<const T*>(k), ldk},
      Rows<const T>{static_cast<const T*>(v), ldv}, static_cast<const float*>(bias_row),
      static_cast<const float*>(seg_row), Rows<T>{static_cast<T*>(out), ldo}, nullptr, nullptr,
      B, L, H, drop, stream);
}

template <typename T>
cudaError_t flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* bias_row, const void* seg_row, void* stat_m, void* stat_l,
                      void* delta, void* dq, void* dk, void* dv, int B, int L, int H, int ldq,
                      int ldk, int ldv, int ldo, Dropout drop, cudaStream_t stream) {
  const int P = H * 64;  // dq, dk, dv are contiguous [B, L, H, D]
  return launch_attention_bwd<T, 64, true>(
      Rows<const T>{static_cast<const T*>(q), ldq}, Rows<const T>{static_cast<const T*>(k), ldk},
      Rows<const T>{static_cast<const T*>(v), ldv},
      Rows<const T>{static_cast<const T*>(dout), ldo}, static_cast<float*>(stat_m),
      static_cast<float*>(stat_l), static_cast<float*>(delta),
      static_cast<const float*>(bias_row), static_cast<const float*>(seg_row),
      Rows<T>{static_cast<T*>(dq), P}, Rows<T>{static_cast<T*>(dk), P},
      Rows<T>{static_cast<T*>(dv), P}, B, L, H, drop, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v and out are of that type.
// Element (b, row, h, d) of q sits at q[(b*L + row)*ldq + h*D + d], likewise
// k, v and out with ldk, ldv, ldo (>= H*D). bias_row [B, L] fp32 is already
// clamped to _NEG, or NULL; seg_row [B, L] fp32 (exact small integers, -1
// at padding), or NULL for no segments. dropout != 0 drops attention
// probabilities with (seed, thresh, inv_keep). Returns cudaGetLastError()
// after the launch (0 = success), or -1 for arguments it refuses (D != 64).
extern "C" int plbt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias_row, const void* seg_row,
    void* out, int B, int L, int H, int D, int ldq, int ldk, int ldv, int ldo, int dtype,
    int dropout, unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!flash_shape_ok(B, L, H, D, ldq, ldk, ldv, ldo)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(flash_fwd<float>(q, k, v, bias_row, seg_row, out, B, L, H, ldq,
                                             ldk, ldv, ldo, drop, st));
  if (dtype == 1)
    return static_cast<int>(flash_fwd<__nv_bfloat16>(q, k, v, bias_row, seg_row, out, B, L, H,
                                                     ldq, ldk, ldv, ldo, drop, st));
  return -1;
}

// The backward. q, k, v as in the forward (the saved inputs) and dout with
// row distance ldo; scratch stat_m, stat_l and delta [B, H, L] fp32; writes
// dq, dk and dv, contiguous [B, L, H, D] of the inputs' type.
extern "C" int plbt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* bias_row,
    const void* seg_row, void* stat_m, void* stat_l, void* delta, void* dq, void* dk, void* dv,
    int B, int L, int H, int D, int ldq, int ldk, int ldv, int ldo, int dtype, int dropout,
    unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!flash_shape_ok(B, L, H, D, ldq, ldk, ldv, ldo)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(flash_bwd<float>(q, k, v, dout, bias_row, seg_row, stat_m, stat_l,
                                             delta, dq, dk, dv, B, L, H, ldq, ldk, ldv, ldo,
                                             drop, st));
  if (dtype == 1)
    return static_cast<int>(flash_bwd<__nv_bfloat16>(q, k, v, dout, bias_row, seg_row, stat_m,
                                                     stat_l, delta, dq, dk, dv, B, L, H, ldq,
                                                     ldk, ldv, ldo, drop, st));
  return -1;
}

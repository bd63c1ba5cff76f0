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
// q, k, v, do and the outputs are [B, L, H, D] with D = 64 or 128; q, k, v and do
// may be views whose rows are further apart than H*D (the three sections of
// one fused projection), so the TPU wrapper's fold to [B*H, L, D]
// (:225-232) is never materialised.
//
// The custom-VJP contract of the TPU kernel (:157-189) is kept: the forward
// saves nothing but its inputs, and the backward recomputes the row max and
// the denominator (pass 0 of the dq kernel, with the forward's own code, so
// in bf16 they equal the block forward's saved m and l bit for bit; in
// fp32 the fp32 forward's), then p, the dropout mask and ds. The rounding points are the TPU
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
// Packed rows: with segments the three bf16 kernels walk only the (query
// tile, key tile) pairs of 64 rows where a query can see a key (tile_walk in
// attention_tiles.cuh). Each block reads its batch item's seg_row (and the
// bias) and finds each tile's range of segments >= 0 and whether it holds a
// padding or closed row; a pair is walked where the two ranges meet or the
// query tile holds such a row. The forward and the dq kernel loop over the
// key tiles walked, in ascending order, in every pass (the TMA ring loads
// only those; m and l are stored after the last one of pass 0, delta summed
// after the last one of pass 1), the dk/dv kernel over the query tiles that
// can see its key tile. Why it is exact: in a skipped pair every score of
// every query row < L is kNeg or -inf, and every such row that is neither
// padding nor closed has its own key, open and of its segment, in a walked
// tile, so its m is far above kNeg; a skipped tile would add exp(kNeg - m) =
// 0 to l and exact zeros to p.v, delta, ds, dq, dk and dv, and a leading
// all-kNeg tile's (kNeg, count) is rescaled to 0 by the first real one. A
// padding row sees only kNeg (its keys' bias is kNeg too), so every key
// counts in its l: its tile walks them all. So o, dq, dk, dv and the
// statistics keep their bits, for any seg_row. Without segments every tile
// is walked. The attention block's forward (K1, K3) runs attention_fwd_sm90
// too and skips alike on packed rows; K4 walks every tile from K3's m and
// l, which keep their bits.
//
// What bounds it on the card: at [96, 512, 12, 64] bf16 on rows without
// segments the forward is 4*L*L*D*B*H = 77 GFLOP against 4 x 75.5 MB of q, k,
// v read and o written, so the bytes bound it (0.090 ms against 0.078 ms of
// tensor-core time); the backward is 10*L*L*D*B*H = 193 GFLOP against 7 x
// 75.5 MB, so the operations bound it. On the packed training rows (about
// 4.2 segments a row, sum of segment^2 0.26 L^2) the kernels walk 47% of the
// tile pairs, where only 26% of the scores are of one segment, and the bound
// of the work within segments is the bytes for both. The bf16 forward runs
// on the tensor cores (attention_fwd_sm90: q.k and p.v on wgmma, K/V tiles by
// TMA from a 3-D map over the [B, L, H*D] rows, so q, k, v need
// 16-byte-aligned bases and row distances); with dropout its Philox draws
// are work of the same size on the integer units. The bf16 backward runs on
// the tensor cores too (attention_bwd_dq_sm90, attention_bwd_dkdv_sm90; q,
// k, v and do by TMA), forming q.k four times for each walked pair (three
// passes over the keys in the dq kernel, one in dk/dv) and drawing the
// dropout mask three times: what bounds it now, with each step's wgmma
// waited on before the softmax arithmetic and no warp specialisation. At
// D = 64 the dk/dv kernel is held to as few registers as let three blocks
// share an SM, as many as its shared memory allows.
// The fp32 kernels compute on the CUDA cores, the block backward's kernels
// (delta pass, dk/dv with ds written to a scratch, dq as a GEMM over it),
// and walk every tile.

#include "attention_tiles.cuh"

namespace {

bool flash_shape_ok(int B, int L, int H, int D, int ldq, int ldk, int ldv, int ldo) {
  const int P = H * D;
  return B >= 1 && L >= 1 && H >= 1 && (D == 64 || D == 128) && ldq >= P && ldk >= P &&
         ldv >= P && ldo >= P;
}

template <typename T, int D>
cudaError_t flash_fwd(const void* q, const void* k, const void* v, const void* bias_row,
                      const void* seg_row, void* out, int B, int L, int H, int ldq, int ldk,
                      int ldv, int ldo, Dropout drop, cudaStream_t stream) {
  return launch_attention_fwd<T, D>(
      Rows<const T>{static_cast<const T*>(q), ldq}, Rows<const T>{static_cast<const T*>(k), ldk},
      Rows<const T>{static_cast<const T*>(v), ldv}, static_cast<const float*>(bias_row),
      static_cast<const float*>(seg_row), Rows<T>{static_cast<T*>(out), ldo}, nullptr, nullptr,
      B, L, H, drop, stream);
}

// bf16 on the tensor cores, fp32 on the CUDA cores; both recompute m and l
template <typename T, int D>
cudaError_t flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                      const void* bias_row, const void* seg_row, void* stat_m, void* stat_l,
                      void* delta, void* ds, void* keep_bits, void* dq, void* dk, void* dv, int B,
                      int L, int H, int ldq, int ldk, int ldv, int ldo, Dropout drop,
                      cudaStream_t stream) {
  const int P = H * D;  // dq, dk, dv are contiguous [B, L, H, D]
  const Rows<const T> qr{static_cast<const T*>(q), ldq}, kr{static_cast<const T*>(k), ldk},
      vr{static_cast<const T*>(v), ldv}, dor{static_cast<const T*>(dout), ldo};
  const Rows<T> dqr{static_cast<T*>(dq), P}, dkr{static_cast<T*>(dk), P},
      dvr{static_cast<T*>(dv), P};
  float* m = static_cast<float*>(stat_m);
  float* l = static_cast<float*>(stat_l);
  float* dl = static_cast<float*>(delta);
  const float* br = static_cast<const float*>(bias_row);
  const float* sr = static_cast<const float*>(seg_row);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_attention_bwd_sm90<D>(qr, kr, vr, dor, m, l, dl, br, sr, dqr, dkr, dvr, B, L,
                                        H, drop, stream);
  else
    return launch_attention_bwd<T, D, true>(qr, kr, vr, dor, m, l, dl, br, sr, dqr, dkr, dvr,
                                            static_cast<T*>(ds), static_cast<uint64_t*>(keep_bits),
                                            B, L, H, drop, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16; q, k, v and out are of that type.
// Element (b, row, h, d) of q sits at q[(b*L + row)*ldq + h*D + d], likewise
// k, v and out with ldk, ldv, ldo (>= H*D). bias_row [B, L] fp32 is already
// clamped to _NEG, or NULL; seg_row [B, L] fp32 (exact small integers, -1
// at padding), or NULL for no segments. dropout != 0 drops attention
// probabilities with (seed, thresh, inv_keep). Returns cudaGetLastError()
// after the launch (0 = success), or -1 for arguments it refuses (D not 64
// or 128).
extern "C" int plbt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias_row, const void* seg_row,
    void* out, int B, int L, int H, int D, int ldq, int ldk, int ldv, int ldo, int dtype,
    int dropout, unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!flash_shape_ok(B, L, H, D, ldq, ldk, ldv, ldo)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return static_cast<int>(
        launch(q, k, v, bias_row, seg_row, out, B, L, H, ldq, ldk, ldv, ldo, drop, st));
  };
  if (dtype == 0) return run(D == 64 ? flash_fwd<float, 64> : flash_fwd<float, 128>);
  if (dtype == 1)
    return run(D == 64 ? flash_fwd<__nv_bfloat16, 64> : flash_fwd<__nv_bfloat16, 128>);
  return -1;
}

// The backward. q, k, v as in the forward (the saved inputs) and dout with
// row distance ldo; scratch stat_m, stat_l and delta [B, H, L] fp32, and in
// fp32 ds [B, H, Lp, Lp] (Lp = L rounded up to a multiple of 64) and, with
// dropout, keep_bits [B, H, Lp, Lp/64] 64-bit words (both NULL in bf16,
// whose kernels keep ds and the mask on the chip); writes
// dq, dk and dv, contiguous [B, L, H, D] of the inputs' type.
extern "C" int plbt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* bias_row,
    const void* seg_row, void* stat_m, void* stat_l, void* delta, void* ds, void* keep_bits,
    void* dq, void* dk, void* dv,
    int B, int L, int H, int D, int ldq, int ldk, int ldv, int ldo, int dtype, int dropout,
    unsigned int seed, unsigned int thresh, float inv_keep, void* stream) {
  if (!flash_shape_ok(B, L, H, D, ldq, ldk, ldv, ldo)) return -1;
  const Dropout drop = make_dropout(dropout, seed, thresh, inv_keep);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return static_cast<int>(launch(q, k, v, dout, bias_row, seg_row, stat_m, stat_l, delta, ds,
                                   keep_bits, dq, dk, dv, B, L, H, ldq, ldk, ldv, ldo, drop, st));
  };
  if (dtype == 0) return run(D == 64 ? flash_bwd<float, 64> : flash_bwd<float, 128>);
  if (dtype == 1)
    return run(D == 64 ? flash_bwd<__nv_bfloat16, 64> : flash_bwd<__nv_bfloat16, 128>);
  return -1;
}

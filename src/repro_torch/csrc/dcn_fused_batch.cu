// Batch-fused BLI(+)conv for Hopper (paper §IV-D fusion).
//
// Replaces src/repro/kernels/dcn_fused.py `_batch_kernel`
// (`dcn_fused_batch`): the concatenated Algorithm-1 schedules of a whole
// batch in one launch. Grid row g is one scheduled output tile of one
// image; its idx are plane-global packed addresses (tile * tp + offset),
// and a neighbour contributes iff its tile is one of the row's dep_cnt[g]
// deps dep_glb[g, :] (ADDR_BATCH in dcn_fused_common.cuh, which holds the
// kernel body and its design). Rows with dep_cnt = 0 (ragged padding)
// write b.
//
// Bound: operations. At the full-width VGG19-3 segment (tp = P = 64,
// KK = 9, C = O = 512, 4 images) the call does ~4.8 GFLOP on ~14 MB, about
// 340 FLOP per byte against an FP32 ridge of ~20 FLOP per byte (67 TFLOP/s
// over 3.35 TB/s), so the FP32 units bound it.
//
// Design: the channel-chunked patch in shared memory plus the 4x4
// register-tile contraction of dcn_fused_common.cuh. Membership of a
// neighbour's tile in the row's dep list is resolved once per block
// through a shared-memory bitmask, which replaces the per-slot
// localisation of the TPU kernel with one gather per neighbour.

#include "dcn_fused_common.cuh"

extern "C" int dcn_fused_batch_launch(const void* x, const void* row_id,
                                      const void* dep_glb,
                                      const void* dep_cnt, const void* idx,
                                      const void* coeff, const void* w,
                                      const void* b, void* out, int G,
                                      int k_pad, int t_in, int tp, int P,
                                      int KK, int C, int O, void* stream) {
  return dcn_fused_launch<ADDR_BATCH>(x, row_id, dep_glb, dep_cnt, idx,
                                      coeff, w, b, out, G, k_pad, t_in, tp,
                                      P, KK, C, O, stream);
}

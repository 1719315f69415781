// Per-image fused BLI(+)conv for Hopper: one schedule or one halo tile.
//
// Replaces two TPU kernels of src/repro/kernels/dcn_fused.py:
//
// * `_sched_kernel` (`dcn_fused_schedule`, the per-image "batched"
//   dispatch and the serving engine's degraded step): one image's whole
//   Algorithm-1 schedule in one launch. Row t's idx are slot-local
//   addresses k * tp + offset into the concatenation of its deps
//   dep_tbl[t, :dep_cnt[t]]; the TPU walks the dep slots as a sequential
//   grid dimension, DMAs tile dep_tbl[t, k] and skips slots
//   k >= dep_cnt[t]. Here each neighbour is gathered straight from
//   x_tiles[dep_tbl[t, a / tp], a % tp]; an address whose slot is
//   >= dep_cnt[t] (or whose dep id is not a tile of x) contributes zero
//   instead of reading a padding slot's tile. A row with dep_cnt = 0
//   writes the bias only. (ADDR_SCHED.)
// * `_fused_kernel` (`dcn_fused_tile`, "per_tile" dispatch and the
//   whole-plane `deformable_conv2d_pallas`): one output tile per image
//   with its packed (S, C) halo resident, idx in [0, S). The TPU builds a
//   4-hot row against iota(S), so an index outside [0, S) contributes
//   zero; the gather masks it the same way. JAX's vmap over images is
//   the grid's row dimension: one launch for a batch. (ADDR_TILE.)
//
// Bound: operations, like dcn_fused_batch.cu. At the full-width VGG19-3
// DCN layers (14x14x512, tile 8: T = 4, tp = 64, KK = 9, C = O = 512) a
// schedule is ~1.2 GFLOP on ~10.6 MB (9.4 MB of it the weights), and the
// whole-plane tile call (S = 196, P = 196 -> 256) ~0.9 GFLOP on ~10.4 MB
// per image: ~100 FLOP per byte, above the FP32 ridge of ~20.
//
// Design: the body of dcn_fused_common.cuh. The TPU keeps the whole (S, C)
// halo (512 KB at S = 256, C = 512) or the (bp*KK, C) patch in VMEM, over
// a block's 227 KB; the shared body instead resolves each neighbour to an
// x row once per block and streams channel chunks of the patch through
// shared memory, so the deformed intermediate never reaches device memory.
// At T = 4 rows a schedule is only 4 x 8 = 32 blocks, a quarter of the
// card: this is the degraded path, and it is kept simple.

#include "dcn_fused_common.cuh"

extern "C" int dcn_fused_schedule_launch(const void* x, const void* dep_tbl,
                                         const void* dep_cnt,
                                         const void* idx, const void* coeff,
                                         const void* w, const void* b,
                                         void* out, int T, int k_pad,
                                         int t_in, int tp, int P, int KK,
                                         int C, int O, void* stream) {
  return dcn_fused_launch<ADDR_SCHED>(x, nullptr, dep_tbl, dep_cnt, idx,
                                      coeff, w, b, out, T, k_pad, t_in, tp,
                                      P, KK, C, O, stream);
}

extern "C" int dcn_fused_tile_launch(const void* x, const void* idx,
                                     const void* coeff, const void* w,
                                     const void* b, void* out, int N, int S,
                                     int P, int KK, int C, int O,
                                     void* stream) {
  return dcn_fused_launch<ADDR_TILE>(x, nullptr, nullptr, nullptr, idx,
                                     coeff, w, b, out, N, 1, 1, S, P, KK, C,
                                     O, stream);
}

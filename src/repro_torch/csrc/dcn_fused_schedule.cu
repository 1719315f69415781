// Per-image fused BLI(+)conv for Hopper: one schedule or one halo tile.
//
// Replaces two TPU kernels of src/repro/kernels/dcn_fused.py:
//
// * `_sched_kernel` (`dcn_fused_schedule`, the per-image "batched"
//   dispatch, `dcn_pipeline` and the serving engine's degraded step): one
//   image's whole Algorithm-1 schedule in one call. Row t's idx are
//   slot-local addresses k * tp + offset into the concatenation of its deps
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
//   the grid's row dimension: one call for a batch. (ADDR_TILE.)
//
// Bound: at the full-width VGG19-3 DCN layers (14x14x512, tile 8: T = 4,
// tp = 64, KK = 9, C = O = 512) a schedule is ~1.2 GFLOP on ~10.6 MB (9.4
// MB of it the weights), a per_tile call ~0.3 GFLOP on ~10 MB and the
// whole-plane call (S = 196, P = 196 -> 256) ~0.9 GFLOP on ~10.4 MB. With
// the contraction in 3xTF32 on the tensor cores (165 TFLOP/s effective)
// the weight bytes bound a one-row call and the operations a schedule.
// With bf16 operands (`dtype` 1: x, w, b and out bf16; the coefficients,
// patch and sums float32) both entries halve the bytes and run the
// contraction in three bf16 products (989 / 3 = 330 TFLOP/s), in the
// Hopper body of dcn_fused_bf16.cuh.
//
// Design: in float32 and float16 the split-C body of dcn_fused_split.cuh
// (in bf16 its Hopper counterpart, dcn_fused_bf16.cuh, the same plan). The
// TPU keeps the whole (S, C) halo (512 KB at S = 256, C = 512) or the
// (bp*KK, C) patch in VMEM, over a block's 227 KB; the body resolves each neighbour to an x
// row once per block and streams (tap, 16-channel) stages of the patch
// through shared memory, so the deformed intermediate never reaches device
// memory. At these shapes a row has only 4-16 (pixel, output-channel)
// blocks, so the C reduction is split over 16-32 blocks per tile and a
// second pass adds the slices (the bf16 body adds them on chip, in the
// thread block cluster of a tile's slices, in the same launch).

#include "dcn_fused_bf16.cuh"
#include "dcn_fused_split.cuh"

// `ws` and `tickets` as for dcn_fused_batch_launch.
extern "C" int dcn_fused_schedule_launch(
    const void* x, const void* dep_tbl, const void* dep_cnt, const void* idx,
    const void* coeff, const void* w, const void* b, void* ws, void* tickets,
    void* out, int T, int k_pad, int t_in, int tp, int P, int KK, int C,
    int O, int n_split, int c_split, int dtype, void* stream) {
  if (dtype == 1)
    return b16::bf16_launch<b16::ADDR_SCHED>(
        x, nullptr, dep_tbl, dep_cnt, idx, coeff, w, b, ws, tickets, out, T,
        k_pad, t_in, t_in, tp, P, KK, C, O, n_split, stream);
  const auto run = dtype == 2
                       ? split::split_launch_t<__half, split::ADDR_SCHED>
                       : split::split_launch_t<float, split::ADDR_SCHED>;
  return run(x, nullptr, dep_tbl, dep_cnt, idx, coeff, w, b, ws, out, T,
             k_pad, t_in, t_in, tp, P, KK, C, O, n_split, c_split, stream);
}

extern "C" int dcn_fused_tile_launch(const void* x, const void* idx,
                                     const void* coeff, const void* w,
                                     const void* b, void* ws, void* tickets,
                                     void* out, int N, int S, int P, int KK,
                                     int C, int O, int n_split, int c_split,
                                     int dtype, void* stream) {
  if (dtype == 1)
    return b16::bf16_launch<b16::ADDR_TILE>(
        x, nullptr, nullptr, nullptr, idx, coeff, w, b, ws, tickets, out, N,
        1, 1, 1, S, P, KK, C, O, n_split, stream);
  const auto run = dtype == 2
                       ? split::split_launch_t<__half, split::ADDR_TILE>
                       : split::split_launch_t<float, split::ADDR_TILE>;
  return run(x, nullptr, nullptr, nullptr, idx, coeff, w, b, ws, out, N, 1,
             1, 1, S, P, KK, C, O, n_split, c_split, stream);
}

// Batch-fused BLI(+)conv for Hopper (paper §IV-D fusion).
//
// Replaces src/repro/kernels/dcn_fused.py `_batch_kernel`
// (`dcn_fused_batch`): the concatenated Algorithm-1 schedules of a whole
// batch in one launch. Grid row g is one scheduled output tile of one
// image; its idx and coeff are row row_id[g] of the image-order operands,
// plane-global packed addresses (tile * tp + offset); a neighbour
// contributes iff its tile is one of the row's dep_cnt[g] deps dep_glb[g,
// :] (ADDR_BATCH in dcn_fused_split.cuh, which holds the kernel body and
// its design). Rows with dep_cnt = 0 (ragged padding) write b.
//
// Bound: operations. At the full-width VGG19-3 segment (tp = P = 64,
// KK = 9, C = O = 512, 4 images, G = 16 rows) the call does ~4.8 GFLOP of
// contraction on ~14 MB; in 3xTF32 on the tensor cores (165 TFLOP/s) that
// is ~0.029 ms against ~0.004 ms of bytes. With bf16 operands (`dtype` 1:
// x, w, b and out bf16) the bytes halve, and the card does the contraction
// to FP32 accuracy in three bf16 products (the float32 patch split into
// three bf16 pieces, each product by a bf16 weight exact: 989 / 3 = 330
// TFLOP/s), ~0.015 ms.
//
// Design: float32 and float16 calls run the split-C body of #4 and #5
// (dcn_fused_split.cuh), bf16 calls its Hopper counterpart
// (dcn_fused_bf16.cuh). The TPU walks the row's dep slots as a sequential
// grid dimension, DMAs tile dep_glb[g, k] and localises the addresses
// against it; here each neighbour's tile is matched to its dep slot once
// per block, the row's live dep tiles are kept resident one chunk of
// channels at a time, and the C reduction is split so that 16 rows of 64
// pixels fill the card.

#include "dcn_fused_bf16.cuh"
#include "dcn_fused_split.cuh"

// `dtype`: 0 float32, 1 bf16, 2 float16 x, w, b and out. `ws`: the split-C
// body's float32 workspace, or the bf16 body's clusters' sums past one
// cluster a tile; `tickets`: the bf16 body's counts (zero
// between calls).
extern "C" int dcn_fused_batch_launch(
    const void* x, const void* row_id, const void* dep_glb,
    const void* dep_cnt, const void* idx, const void* coeff, const void* w,
    const void* b, void* ws, void* tickets, void* out, int G, int k_pad,
    int n_x, int t_in, int tp, int P, int KK, int C, int O, int n_split,
    int c_split, int dtype, void* stream) {
  if (dtype == 1)
    return b16::bf16_launch<b16::ADDR_BATCH>(
        x, row_id, dep_glb, dep_cnt, idx, coeff, w, b, ws, tickets, out, G,
        k_pad, n_x, t_in, tp, P, KK, C, O, n_split, stream);
  const auto run = dtype == 2
                       ? split::split_launch_t<__half, split::ADDR_BATCH>
                       : split::split_launch_t<float, split::ADDR_BATCH>;
  return run(x, row_id, dep_glb, dep_cnt, idx, coeff, w, b, ws, out, G,
             k_pad, n_x, t_in, tp, P, KK, C, O, n_split, c_split, stream);
}

// Clusters of `cluster` blocks of the bf16 body the current device runs
// at once, into *count (the wrappers' split rule reads it).
extern "C" int dcn_fused_bf16_max_clusters(int cluster, void* count) {
  return b16::bf16_max_clusters(cluster, static_cast<int*>(count));
}

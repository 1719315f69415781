// Flash attention (causal, GQA, sliding window, tanh soft-cap) for Hopper.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel`
// (`flash_attention`): for q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), all
// float32 (`flash_kernel`) or all bf16 or all float16 (`flash_kernel_bf16`,
// below), q head h reading kv head h / (Hq / Hkv),
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   qi  = i + (Skv - Sq),  masked unless ki < Skv, [qi >= ki], [qi - ki < w]
//   out = acc / max(l, 1e-30)   (online softmax; masked logits are -1e30
//                                and their p is forced to 0)
//
// Bound: operations. 4 * D FLOP per live (query, key) pair against
// 4 * D * 4 bytes per row of q, k, v and out: at the Qwen3-1.7B prefill
// (S = 2048-4096, D = 128, causal) the work is ~500-1000x the bytes. Both
// products run on the tensor cores in 3xTF32 (x = hi + lo, hi * hi + hi *
// lo + lo * hi, FP32 accumulation; dense TF32 495 / 3 = 165 TFLOP/s), which
// keeps the 1e-4 bound that plain TF32 would break.
//
// Design:
// * One block per (batch * q head, BQ-row query tile), one warpgroup per
//   64 query rows: BQ = 128 (two warpgroups sharing each K/V tile) where
//   the shared memory holds it, else 64 (the wrapper's `tile_config`).
//   The TPU's sequential KV grid axis is a loop over 32-key tiles.
// * Loads: one thread asks the TMA unit for the next tile's K and V rows
//   (a 4-d tensor map each; zeros past Skv and D; rows padded to DP + 4
//   floats) as soon as the current tile has left the landing buffers, so
//   the copy flies under the current tile's products (per-thread cp.async
//   copies, tried first, cost more issue time than the products).
// * A split pass moves the landed tile into the K-major unswizzled
//   canonical layouts wgmma reads (8-row x 16-byte core matrices; D zero-
//   padded to DP, a multiple of 16), as TF32 high part and residual: K
//   [32 keys][DP], V transposed to V^T [DP][32 keys] (TF32 wgmma takes no
//   transposed operand), both free of bank conflicts. q * scale is split
//   once per block; the high part of its first QR 8-dim steps also stays
//   in registers as the A fragment of Q K^T.
// * S = Q K^T: wgmma m64n32k8, 3 x DP / 8 instructions a tile, from zero.
//   Softmax in registers, scores in base 2 (log2 e folded into q's scale,
//   or into the soft-cap; exp2 on the SFU), masks only on edge tiles;
//   tiles the causal or window mask removes for all of a warpgroup's rows
//   are skipped (exact: their p is 0).
// * O += P V: wgmma m64nDPk8 with A (P hi / lo) from the registers that
//   hold S. The accumulator gives a thread columns {2t, 2t + 1} of each
//   8-key group and the A fragment wants {t, t + 4}; the keys of each
//   group are stored permuted in V^T (key 2j + h at position 4h + j) so
//   that the registers are the fragment as they stand (the order of a
//   sum's terms is free). Each tile's P V starts from zero and is added
//   to the FP32 total with round-to-nearest: the tensor cores' own
//   accumulation truncates, and carried over long caches it drifts past
//   the 1e-4 bound.
// * Query tiles launch heaviest first (causal rows near the end see the
//   most keys).

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "tma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace tc;

constexpr int BK = 32;        // keys per tile (wgmma N of Q K^T)
constexpr int WG = 128;       // threads of a warpgroup, 64 query rows
constexpr int MAX_DP = 144;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// S (64 rows x 32 keys) = A (64 x 8) * B (8 x 32) + (scale_d ? S : 0),
// both operands in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A from registers.
__device__ __forceinline__ void wgmma_qk(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, "
      "1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC8(i) ACC4(i), ACC4(i + 4)
#define PV_IN \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)

// O (64 rows x DP) = A (64 x 8 keys, registers) * B (8 x DP, V^T in shared
// memory) + (scale_d ? O : 0).
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(DP % 16 == 0 && DP >= 16 && DP <= MAX_DP, "head dim");
  if constexpr (DP == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : ACC8(0)
        : PV_IN);
  } else if constexpr (DP == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8)
        : PV_IN);
  } else if constexpr (DP == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16)
        : PV_IN);
  } else if constexpr (DP == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
        : PV_IN);
  } else if constexpr (DP == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32)
        : PV_IN);
  } else if constexpr (DP == 96) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32),
          ACC8(40)
        : PV_IN);
  } else if constexpr (DP == 112) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32),
          ACC8(40), ACC8(48)
        : PV_IN);
  } else if constexpr (DP == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32),
          ACC8(40), ACC8(48), ACC8(56)
        : PV_IN);
  } else if constexpr (DP == 144) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32),
          ACC8(40), ACC8(48), ACC8(56), ACC8(64)
        : PV_IN);
  }
}

#undef PV_IN
#undef ACC8
#undef ACC4

// Warpgroups a block for head dim DP: two (128 query rows) where their
// shared memory fits a block's 232,448 bytes, else one. The wrapper's
// `tile_config` applies the same rule.
__host__ __device__ constexpr int smem_bytes(int dp, int nwg) {
  return 4 * (2 * 64 * nwg * dp + 4 * BK * dp + 2 * BK * (dp + 4)) + 8;
}
__host__ __device__ constexpr int warpgroups(int dp) {
  return smem_bytes(dp, 2) <= 232448 ? 2 : 1;
}

// 2^x on the SFU (ex2.approx.ftz: ~2 ulp; a result below 2^-126 is 0,
// which beside the row's largest p = 1 changes no float32 sum).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// TMA copy of one box of a 4-d tensor map at (c0, c1, c2, c3) into dst;
// completes on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, int c2, int c3,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// The box of the 4-d tensor map (dims d, kv head, key, batch) at (0, hk,
// k0, b): BK rows of DP + 4 floats, zeros where d >= D or key >= Skv.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int hk, int k0, int b,
                                         uint64_t* bar) {
  tma_box(dst, map, 0, hk, k0, b, bar);
}

template <int DP>
__global__ void __launch_bounds__(2 * WG, 1)
flash_kernel(const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const float* __restrict__ q, float* __restrict__ out, int Sq,
             int Skv, int Hq, int Hkv, int D, int causal, int window,
             float scale, float softcap) {
  constexpr int TILE = BK * DP;   // floats of one K or V^T tile
  constexpr int LD = DP + 4;      // row stride of the landed tiles
  constexpr int NT = WG * warpgroups(DP), NW = NT / 32, BQ = 64 * NT / WG;
  extern __shared__ __align__(128) float smem[];
  float* Qh = smem;             // [BQ][DP] q * scale, TF32 high part
  float* Ql = Qh + BQ * DP;     // its residual
  float* Kh = Ql + BQ * DP;     // [BK][DP] K tile, high part
  float* Kl = Kh + TILE;        //          and residual
  float* Vh = Kl + TILE;        // [DP][BK] V^T tile, high part
  float* Vl = Vh + TILE;        //          and residual
  float* Ks = Vl + TILE;        // [BK][LD] next K tile as landed
  float* Vs = Ks + BK * LD;     // [BK][LD] next V tile as landed
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + BK * LD);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = tid / WG;
  const int wi = warp & 3, gq = lane >> 2, tq = lane & 3;
  // One block a (batch x head row, query tile), the row's tiles adjacent
  // in the flat grid: the rows live in grid.x, which holds 2^31 - 1.
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * BQ;  // heaviest first
  const long long qstride = (long long)Hq * D;
  const float* qb = q + ((long long)b * Sq * Hq + h) * D;
  float* ob = out + ((long long)b * Sq * Hq + h) * D;

  // Keys any real row of the block can see, and of this warpgroup.
  const long long off = (long long)Skv - Sq;
  const int q_rows = min(BQ, Sq - q0);
  long long k_hi = Skv;
  if (causal) k_hi = min(k_hi, q0 + q_rows - 1 + off + 1);
  const long long k_lo = max(0LL, q0 + off - (long long)window + 1);
  const int w0 = q0 + 64 * wg, w_rows = min(64, q_rows - 64 * wg);
  long long wk_hi = w_rows > 0 ? Skv : 0;
  if (causal && w_rows > 0) wk_hi = min(wk_hi, w0 + w_rows - 1 + off + 1);
  const long long wk_lo = max(0LL, w0 + off - (long long)window + 1);
  const int kt0 = (int)(k_lo / BK) * BK;
  const int n_tiles = k_lo < k_hi ? (int)((k_hi - kt0 + BK - 1) / BK) : 0;

  // One thread asks the TMA unit for tile t's K and V rows; `full` counts
  // their bytes.
  auto fetch = [&](int k0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(full)),
        "r"(2 * BK * LD * 4)
        : "memory");
    tma_rows(Ks, &k_map, hk, k0, b, full);
    tma_rows(Vs, &v_map, hk, k0, b, full);
  };
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(full)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n_tiles > 0) fetch(kt0);
  }

  // q * scale (times log2 e without a soft-cap: scores in base 2), split,
  // in the canonical layout while the first tile flies.
  const float qscale = softcap > 0.f ? scale : scale * LOG2E;
#pragma unroll 4
  for (int e = tid; e < BQ * DP / 4; e += NT) {
    const int r8 = e & 7, c = (e >> 3) % (DP / 4);
    const int r = 8 * ((e >> 3) / (DP / 4)) + r8;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < q_rows && 4 * c < D)
      x = __ldg(reinterpret_cast<const float4*>(
          qb + (long long)(q0 + r) * qstride + 4 * c));
    uint4 hi, lo;
    split_tf32(x.x * qscale, hi.x, lo.x);
    split_tf32(x.y * qscale, hi.y, lo.y);
    split_tf32(x.z * qscale, hi.z, lo.z);
    split_tf32(x.w * qscale, hi.w, lo.w);
    const int at = ((r >> 3) * (DP / 4) + c) * 32 + r8 * 4;
    *reinterpret_cast<uint4*>(Qh + at) = hi;
    *reinterpret_cast<uint4*>(Ql + at) = lo;
  }
  __syncthreads();  // the barrier's init, before anyone waits on it

  // Warpgroup wg owns query rows w0 .. w0 + 63; lane (gq, tq) of warp wi
  // holds rows 16 wi + gq (+ 8) of S (keys 8j + 2tq (+ 1)) and of O
  // (dims 8j + 2tq (+ 1)).
  float acc[DP / 2], o[DP / 2], s[16];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // The high part of q's first QR k-steps stays in registers as the A
  // fragment of Q K^T (lane (gq, tq) of warp wi: rows 16 wi + gq (+ 8),
  // dims tq (+ 4) of each 8-dim step), so the tensor cores read it from
  // shared memory once per block instead of twice per tile; as many steps
  // as the registers hold beside the accumulators.
  constexpr int QR = DP <= 128 ? (DP / 8 < 8 ? DP / 8 : 8) : 4;
  uint32_t qa[QR][4];
  {
    const float* qw = Qh + wg * 64 * DP + (2 * wi * (DP / 4)) * 32 + gq * 4;
#pragma unroll
    for (int ks = 0; ks < QR; ++ks)
#pragma unroll
      for (int u = 0; u < 4; ++u)  // (row + 8 (u & 1), dim tq + 4 (u >> 1))
        qa[ks][u] = __float_as_uint(
            qw[(u & 1) * (DP / 4) * 32 + (2 * ks + (u >> 1)) * 32 + tq]);
  }
  const uint64_t dq_h = smem_desc(Qh + wg * 64 * DP, 128, DP * 32);
  const uint64_t dq_l = smem_desc(Ql + wg * 64 * DP, 128, DP * 32);
  const uint64_t dk_l = smem_desc(Kl, 128, DP * 32);
  const uint64_t dv_l = smem_desc(Vl, 128, BK * 32);
  const float cap2 = softcap * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kt0 + t * BK;
    mbar_wait(full, t & 1);
    __syncthreads();  // tile t landed; every thread is done with t - 1
    // Split the landed tile into TF32 high and low parts, in the canonical
    // layouts. K: thread (r % 8, c % 4) of a warp item (r / 8, c / 4) moves
    // dims 4c .. 4c + 3 of key r to core matrix (r / 8, c), row r % 8. V^T:
    // lane d % 32 of a warp item (d / 32, 8-key group, h) moves dim d of
    // keys 2j + h, j < 4, of the group to core matrix (d / 8, 2 group + h),
    // row d % 8 (positions 4h + j hold key 2j + h). Reads and writes are
    // free of bank conflicts (rows LD = DP + 4 floats apart).
#pragma unroll
    for (int it = warp; it < BK / 8 * DP / 16; it += NW) {
      const int r = 8 * (it % (BK / 8)) + (lane & 7);
      const int c = 4 * (it / (BK / 8)) + (lane >> 3);
      const float4 x = *reinterpret_cast<const float4*>(Ks + r * LD + 4 * c);
      uint4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const int at = ((r >> 3) * (DP / 4) + c) * 32 + (r & 7) * 4;
      *reinterpret_cast<uint4*>(Kh + at) = hi;
      *reinterpret_cast<uint4*>(Kl + at) = lo;
    }
#pragma unroll
    for (int it = warp; it < (DP + 31) / 32 * BK / 4; it += NW) {
      const int d = 32 * (it / (BK / 4)) + lane, g2 = it % (BK / 4);
      if (DP % 32 == 0 || d < DP) {
        const float* src = Vs + (8 * (g2 >> 1) + (g2 & 1)) * LD + d;
        uint4 hi, lo;
        split_tf32(src[0], hi.x, lo.x);
        split_tf32(src[2 * LD], hi.y, lo.y);
        split_tf32(src[4 * LD], hi.z, lo.z);
        split_tf32(src[6 * LD], hi.w, lo.w);
        const int at = ((d >> 3) * (BK / 4) + g2) * 32 + (d & 7) * 4;
        *reinterpret_cast<uint4*>(Vh + at) = hi;
        *reinterpret_cast<uint4*>(Vl + at) = lo;
      }
    }
    fence_async_smem();  // the split tile: to wgmma
    __syncthreads();     // and the landing buffers are free
    if (tid == 0 && t + 1 < n_tiles) {
      fence_async_smem();  // their reads above before the TMA's writes
      fetch(k0 + BK);
    }

    if (k0 < wk_hi && k0 + BK > wk_lo) {
      // S = Q K^T in 3xTF32, small terms first, from zero.
      const uint64_t dk_h = smem_desc(Kh, 128, DP * 32);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {  // 8 dims = 256 bytes = 16 units
        wgmma_qk(s, dq_l + 16 * ks, dk_h + 16 * ks, ks);
        if (ks < QR) {
          wgmma_qk(s, qa[ks < QR ? ks : 0], dk_l + 16 * ks, 1);
          wgmma_qk(s, qa[ks < QR ? ks : 0], dk_h + 16 * ks, 1);
        } else {
          wgmma_qk(s, dq_h + 16 * ks, dk_l + 16 * ks, 1);
          wgmma_qk(s, dq_h + 16 * ks, dk_h + 16 * ks, 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
#pragma unroll
      for (int ks = 0; ks < QR; ++ks) fence_regs(qa[ks]);

      // Online softmax over the tile, in base 2. Masks only where some
      // (row, key) of the warpgroup's real rows is masked.
      const bool edge =
          !(k0 + BK <= Skv && (!causal || k0 + BK - 1 <= w0 + off) &&
            w0 + w_rows - 1 + off - k0 < window);
      float alpha[2];
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long qi = w0 + 16 * wi + gq + 8 * hh + off;
        bool ok[BK / 4];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float x = s[4 * j + 2 * hh + u];
            if (softcap > 0.f) x = tanhf(x / softcap) * cap2;
            const long long ki = k0 + 8 * j + 2 * tq + u;
            ok[2 * j + u] = !edge || (ki < Skv && (!causal || qi >= ki) &&
                                      qi - ki < window);
            x = ok[2 * j + u] ? x : NEG_INF;
            s[4 * j + 2 * hh + u] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        alpha[hh] = exp2_fast(m[hh] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float x = s[4 * j + 2 * hh + u] - m_new;
            const float p = ok[2 * j + u] ? exp2_fast(x) : 0.f;
            ps += p;
            // A fragment: (row, key 2tq + u) is column tq + 4u of the
            // permuted group, register 2u + hh.
            split_tf32(p, ph[j][2 * u + hh], pl[j][2 * u + hh]);
          }
        l[hh] = l[hh] * alpha[hh] + ps;  // this thread's share of the row
        m[hh] = m_new;
      }

      // O += P V in 3xTF32: this tile's products from zero, then added.
      const uint64_t dv_h = smem_desc(Vh, 128, BK * 32);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {  // 8 keys = 256 bytes = 16 units
        wgmma_pv<DP>(o, pl[j], dv_h + 16 * j, j);
        wgmma_pv<DP>(o, ph[j], dv_l + 16 * j, 1);
        wgmma_pv<DP>(o, ph[j], dv_h + 16 * j, 1);
      }
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      wgmma_wait();
      // The asynchronous wgmmas read ph, pl and write o until the wait.
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        fence_regs(ph[j]);
        fence_regs(pl[j]);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] += o[i];
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = 16 * wi + gq + 8 * hh;
    if (r < w_rows) {
      const float den = fmaxf(li, 1e-30f);
      float* orow = ob + (long long)(w0 + r) * qstride;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        if (c < D)
          *reinterpret_cast<float2*>(orow + c) = make_float2(
              acc[4 * j + 2 * hh] / den, acc[4 * j + 2 * hh + 1] / den);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit operands (`flash_kernel_bf16<T>`, T bf16 or float16): the same
// function with q, k, v and the output in T, as the TPU kernel runs it on
// bf16 or float16 inputs (its products read the 16-bit values exactly;
// scores, softmax state and the accumulator stay float32; the output is
// rounded once). The two types differ only in the wgmma operand type
// (.bf16 / .f16), the TMA element type and the rounding of P and the
// output (`Mma16<T>`); both are 2-byte types, so the swizzles, rings and
// tiles are one.
//
// Bound: operations, at the dense bf16 / float16 tensor-core rate (989
// TFLOP/s), twice TF32's, with half the bytes. Both products are single
// wgmma m64nNk16 instructions with float32 accumulation (no split: the
// operands are exact in their own type).
//
// Design (two consumer warpgroups and a producer warp, 288 threads):
// * One block per (batch * q head, 128-row query tile), heaviest tile
//   first; consumer warpgroup c owns query rows 64c .. 64c + 63. One
//   thread of the producer warp starts every copy by TMA: q once, then
//   every 64-key K and V tile the block's rows see. (Nine warps are
//   given registers as twelve: 168 a thread, and ptxas did not lift the
//   consumers above that through setmaxnreg. 64-key tiles fit: S 32, O
//   DP / 2 and P 16 registers; 128-key ones spill at D 128. Without the
//   producer warp, 256 threads may hold 255 registers and 128-key tiles:
//   thread 0 starting every copy stalled its warpgroup (1.6x slower); the
//   warpgroup releasing a stage second refilling it was 1-8 % faster at
//   D <= 128 but 20 % slower at D 144, nine copies a tile from a
//   consumer thread.)
// * The tiles land straight in the swizzled layouts wgmma reads: rows of
//   W = 64, 32 or 16 values (128, 64 or 32 B swizzle, the widest that
//   divides DP), so a tile is DP / W panels [rows][W], one TMA box each
//   (zeros past Skv, Sq and D). q and K are K-major operands of S = Q K^T;
//   V, [keys][D] as landed, is the MN-major B of P V (the wgmma transpose
//   flag). There is no move pass and no block barrier in the key loop.
// * K and V have rings of their own (4 tiles at every head dim), each
//   stage with a full and an empty mbarrier: a K stage is free once both
//   warpgroups' S has read it, a V stage once their P V has, and the
//   producer refills it at once.
// * Each warpgroup starts S(t) = Q K(t)^T, rescales O by alpha(t - 1),
//   starts O += P(t - 1) V(t - 1), waits for S(t) alone (wgmma.wait_group
//   1) and runs tile t's softmax in place while P(t - 1) V(t - 1) is
//   still on the tensor cores; then it waits for that product and packs
//   P(t). Each product is a wgmma group of its own behind its own fence,
//   and every register it reads is pinned before the fence: ptxas
//   serializes all the products of a kernel where another instruction
//   writes a wgmma operand inside a group's span.
// * The soft-cap and the masks are passes of their own under uniform
//   branches (per score, the compiler evaluated them for every score: a
//   2x slower softmax); the scale rides the exponent's FFMA.
// * Scores in base 2 (log2 e folded into the scale or the soft-cap, exp2
//   on the SFU); masks only on edge tiles; a masked score is -1e30 and a
//   row with no visible key yet subtracts 0, so its p is exactly 0.
// * P is rounded to T for O += P V: the accumulator of S hands a thread
//   keys {2t, 2t + 1} and {2t + 8, 2t + 9} of each 16-key step, which is
//   the A fragment of a 16-bit wgmma as it stands (no permutation). The
//   row sums l add the rounded p, so that the weights of a row sum to
//   one. (In float16 a p below 2^-24 rounds to 0: a share of the row's sum
//   under 2^-24 of its largest weight, 1.)
// * O is accumulated in place by the tensor cores after the rescale by
//   alpha: a 16-bit output does not see their truncating accumulation.
// ---------------------------------------------------------------------------

constexpr int BQ16 = 128;     // query rows a block of the bf16 kernel
constexpr int BK16 = 64;      // keys a K / V tile

// Values a swizzled shared-memory row holds for head dim dp: the widest of
// the 128, 64 and 32 B swizzles whose row divides dp.
__host__ __device__ constexpr int panel_bf16(int dp) {
  return dp % 64 == 0 ? 64 : dp % 32 == 0 ? 32 : 16;
}
constexpr int ST16 = 4;       // tiles a K or V ring holds
// q, the K and V rings, their mbarriers and q's, and 1 KB to align the
// base: 185,480 bytes at DP 144.
__host__ __device__ constexpr int smem_bytes_bf16(int dp) {
  return 1024 + 2 * BQ16 * dp + 4 * ST16 * BK16 * dp + 8 * (4 * ST16 + 1);
}
static_assert(smem_bytes_bf16(MAX_DP) <= 232448, "bf16 rings");

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// One probe of an mbarrier's phase of `parity` (try_wait may suspend the
// thread for a while before it answers).
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <typename T, int DP>
__global__ void __launch_bounds__(2 * WG + 32, 1)
flash_kernel_bf16(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  T* __restrict__ out, int Sq, int Skv, int Hq, int Hkv,
                  int D, int causal, int window, float scale,
                  float softcap) {
  using M = Mma16<T>;
  constexpr int BQ = BQ16, BK = BK16, ST = ST16;
  constexpr int W = panel_bf16(DP), SWZ = 2 * W;  // values / bytes a row
  constexpr int QP = BQ * SWZ, KP = BK * SWZ;     // bytes of a q / K panel
  constexpr int TILE = BK * DP * 2;               // bytes of a K / V tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const Qs =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Ks = Qs + BQ * DP * 2;  // [ST][DP / W][BK][W]
  uint8_t* const Vs = Ks + ST * TILE;    // [ST][DP / W][BK][W]
  uint64_t* const full_k = reinterpret_cast<uint64_t*>(Vs + ST * TILE);
  uint64_t* const full_v = full_k + ST;
  uint64_t* const empty_k = full_v + ST;
  uint64_t* const empty_v = empty_k + ST;
  uint64_t* const q_full = empty_v + ST;

  const int tid = threadIdx.x;
  // One block a (batch x head row, query tile), the row's tiles adjacent
  // in the flat grid: the rows live in grid.x, which holds 2^31 - 1.
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (n_qt - 1 - (int)(blockIdx.x % n_qt)) * BQ;  // heaviest first
  const long long off = (long long)Skv - Sq;
  const int q_rows = min(BQ, Sq - q0);
  long long k_hi = Skv;
  if (causal) k_hi = min(k_hi, q0 + q_rows - 1 + off + 1);
  const long long k_lo = max(0LL, q0 + off - (long long)window + 1);
  const int kt0 = (int)(k_lo / BK) * BK;
  const int n_tiles = k_lo < k_hi ? (int)((k_hi - kt0 + BK - 1) / BK) : 0;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(full_k + i)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_u32(full_v + i)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" ::"r"(
          smem_u32(empty_k + i)));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" ::"r"(
          smem_u32(empty_v + i)));
    }
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        smem_u32(q_full)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers' init, before anyone waits on them

  // A wait that outlasts ~2^34 cycles (seconds) traps: a barrier that
  // never completes surfaces as a launch failure, not as a hung card.
  auto wait = [](uint64_t* bar, int parity) {
    const long long t0 = clock64();
    while (!mbar_try(bar, parity))
      if (clock64() - t0 > (1ll << 34)) __trap();
  };
  // Warpgroup 0, 1: the consumers; 2: the producer warp. Lane 0's,
  // shuffled: warp-uniform as the compiler sees it, which the wgmma
  // products need (a branch it cannot prove uniform serializes them).
  const int c = __shfl_sync(0xffffffffu, tid / WG, 0);
  if (c == 2) {
    // The producer: q once, then the K and V tiles in order, each into its
    // ring stage once both consumers have released the stage's last tile.
    if (tid == 2 * WG) {
      mbar_expect(q_full, BQ * DP * 2);
#pragma unroll
      for (int p = 0; p < DP / W; ++p)
        tma_box(Qs + p * QP, &q_map, p * W, h, q0, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % ST, u = t / ST, k0 = kt0 + t * BK;
        if (u > 0) wait(empty_k + st, (u - 1) & 1);
        mbar_expect(full_k + st, TILE);
#pragma unroll
        for (int p = 0; p < DP / W; ++p)
          tma_box(Ks + st * TILE + p * KP, &k_map, p * W, hk, k0, b,
                  full_k + st);
        if (u > 0) wait(empty_v + st, (u - 1) & 1);
        mbar_expect(full_v + st, TILE);
#pragma unroll
        for (int p = 0; p < DP / W; ++p)
          tma_box(Vs + st * TILE + p * KP, &v_map, p * W, hk, k0, b,
                  full_v + st);
      }
    }
    return;
  }

  // Consumer warpgroup c owns query rows w0 .. w0 + 63; lane (gq, tq) of
  // warp wi holds rows 16 wi + gq (+ 8) of S (keys 8j + 2tq (+ 1)) and of
  // O (dims 8j + 2tq (+ 1)). It computes tiles [ta, tb) of the block's
  // n_tiles, those its rows see, and releases the others unread.
  const int ct = tid % WG;
  const int lane = ct & 31, wi = ct >> 5, gq = lane >> 2, tq = lane & 3;
  const int w0 = q0 + 64 * c, w_rows = min(64, q_rows - 64 * c);
  long long wk_hi = w_rows > 0 ? Skv : 0;
  if (causal && w_rows > 0) wk_hi = min(wk_hi, w0 + w_rows - 1 + off + 1);
  const long long wk_lo = max(0LL, w0 + off - (long long)window + 1);
  const bool any = wk_lo < wk_hi;
  const int ta = any ? (int)((wk_lo - kt0) / BK) : 0;
  const int tb = any ? (int)((wk_hi - kt0 + BK - 1) / BK) : 0;
  const bool leader = ct == 0;  // releases the warpgroup's stages

  auto release = [&](uint64_t* bar) {
    if (leader) mbar_arrive(bar);
  };
  auto skip = [&](int t) {  // a tile these rows do not see
    if (leader) {
      wait(full_k + t % ST, (t / ST) & 1);
      mbar_arrive(empty_k + t % ST);
      wait(full_v + t % ST, (t / ST) & 1);
      mbar_arrive(empty_v + t % ST);
    }
  };
  for (int t = 0; t < ta; ++t) skip(t);

  float o[DP / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  uint32_t pa[BK / 16][4];  // P of the last tile, bf16 A fragments
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  // K-major q and K: 8-row atoms 8 * SWZ bytes apart. MN-major V: 8-key
  // atoms 8 * SWZ apart along K, W-dim panels KP apart along N.
  const uint64_t dq = smem_desc_sw(Qs + c * 64 * SWZ, 16, 8 * SWZ, SWZ);
  const uint64_t dk = smem_desc_sw(Ks, 16, 8 * SWZ, SWZ);
  const uint64_t dv = smem_desc_sw(Vs, KP, 8 * SWZ, SWZ);
  // Scores in base 2: log2 e folded into the scale, or into the soft-cap
  // (whose pass then leaves a scale of 1 for the exponent's FFMA).
  const float qscale = softcap > 0.f ? scale : scale * LOG2E;
  const float escale = softcap > 0.f ? 1.f : qscale;
  const float cap2 = softcap * LOG2E;

  // S = Q K(t)^T, one wgmma group: 16 dims of panel 16ks / W a step.
  auto qk = [&](int t) {
    const uint64_t dkt = dk + (((t % ST) * TILE) >> 4);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int at = (16 * ks / W) * QP + (16 * ks % W) * 2;
      const int bt = (16 * ks / W) * KP + (16 * ks % W) * 2;
      M::n64(s, dq + (at >> 4), dkt + (bt >> 4), ks);
    }
    wgmma_commit();
  };
  // O = alpha O + P V(t), one wgmma group, P from pa: 16 keys (2 atoms) a
  // step. Multiplying by 1 is exact, so a thread whose rows kept their
  // maximum skips the rescale.
  auto pv = [&](int t) {
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    wait(full_v + t % ST, (t / ST) & 1);
    const uint64_t dvt = dv + (((t % ST) * TILE) >> 4);
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      M::template rs<DP>(o, pa[kk], dvt + ((kk * 16 * SWZ) >> 4), 1);
    wgmma_commit();
  };
  auto pv_done = [&](int t) {  // after the wait for P V(t)
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    release(empty_v + t % ST);
  };
  // Tile t's softmax, in place: S becomes p, the rescale of O alpha. The
  // soft-cap and the masks are whole passes under uniform branches: per
  // score, the compiler would evaluate them unconditionally.
  auto softmax = [&](int t) {
    const long long k0 = kt0 + (long long)t * BK;
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        s[i] = tanhf(s[i] * qscale / softcap) * cap2;
    }
    if (!(k0 + BK <= Skv && (!causal || k0 + BK - 1 <= w0 + off) &&
          w0 + w_rows - 1 + off - k0 < window)) {  // an edge tile
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const long long qi = w0 + 16 * wi + gq + 8 * ((i >> 1) & 1) + off;
        const long long ki = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        if (!(ki < Skv && (!causal || qi >= ki) && qi - ki < window))
          s[i] = NEG_INF;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // The row's maximum in base-2 units (escale > 0 keeps the order); a
      // row that has seen no visible key yet subtracts 0: its -1e30
      // scores then give p = 0 exactly (and its alpha 0 scales zeros).
      const float m_new = fmaxf(m[hh], mx == NEG_INF ? NEG_INF : mx * escale);
      const float m_use = m_new == NEG_INF ? 0.f : m_new;
      alpha[hh] = exp2_fast(m[hh] - m_use);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float& p0 = s[4 * j + 2 * hh];
        float& p1 = s[4 * j + 2 * hh + 1];
        p0 = exp2_fast(fmaf(p0, escale, -m_use));
        p1 = exp2_fast(fmaf(p1, escale, -m_use));
        const uint32_t w = M::pack(p0, p1);  // as P V will read them
        ps += M::lo(w) + M::hi(w);
      }
      l[hh] = l[hh] * alpha[hh] + ps;  // this thread's share of the row
      m[hh] = m_new;
    }
  };
  // P (in s) rounded to bf16 as the A fragments of P V: keys 8j + 2tq
  // (+ 1) of row hh are register 2 (j & 1) + hh of 16-key step j / 2.
  auto pack_p = [&] {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        pa[j >> 1][2 * (j & 1) + hh] =
            M::pack(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
  };

  wait(q_full, 0);  // even with no tile: no copy outlives the block
  if (ta < tb) {
    wait(full_k + ta % ST, (ta / ST) & 1);
    qk(ta);
    wgmma_wait_n<0>();
    fence_regs(s);
    release(empty_k + ta % ST);
    softmax(ta);
    pack_p();
  }
  for (int t = ta + 1; t < tb; ++t) {
    // S(t) and P(t - 1) V(t - 1) in flight together; tile t's softmax
    // runs under the second.
    wait(full_k + t % ST, (t / ST) & 1);
    qk(t);
    pv(t - 1);
    wgmma_wait_n<1>();  // S(t)
    fence_regs(s);
    release(empty_k + t % ST);
    softmax(t);
    wgmma_wait_n<0>();  // P(t - 1) V(t - 1)
    pv_done(t - 1);
    pack_p();
  }
  if (ta < tb) {
    pv(tb - 1);
    wgmma_wait_n<0>();
    pv_done(tb - 1);
  }
  for (int t = tb; t < n_tiles; ++t) skip(t);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = 16 * wi + gq + 8 * hh;
    if (r < w_rows) {
      const float den = fmaxf(li, 1e-30f);
      T* orow = out + (((long long)b * Sq + w0 + r) * Hq + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int cc = 8 * j + 2 * tq;
        if (cc < D)
          *reinterpret_cast<uint32_t*>(orow + cc) = M::pack(
              o[4 * j + 2 * hh] / den, o[4 * j + 2 * hh + 1] / den);
      }
    }
  }
}

// The 4-d tensor map (d, kv head, key, batch) of float32 k or v (B, Skv,
// Hkv, D) whose box is the tile the kernel lands: (DP + 4) x 1 x BK x 1.
cudaError_t rows_map(CUtensorMap* map, const void* x, int B, int Skv,
                     int Hkv, int D, int dp) {
  cudaError_t err;
  const PFN_cuTensorMapEncodeTiled_v12000 encode =
      hop::tensor_map_encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {4ull * D, 4ull * D * Hkv,
                                 4ull * D * Hkv * Skv};
  const cuuint32_t box[4] = {(cuuint32_t)dp + 4, 1, (cuuint32_t)BK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 4-d tensor map (d, head, row, batch) of 16-bit q, k or v (B, S, H,
// D) of element type `type` whose box is one swizzled panel of the 16-bit
// kernel: w values (the panel's row, w * 2 bytes = the swizzle) x 1 x rows
// x 1; zeros past D and S.
cudaError_t panel_map(CUtensorMap* map, const void* x, int B, int S, int H,
                      int D, int w, int rows, CUtensorMapDataType type) {
  cudaError_t err;
  const PFN_cuTensorMapEncodeTiled_v12000 encode =
      hop::tensor_map_encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * H, 2ull * D * H * S};
  const cuuint32_t box[4] = {(cuuint32_t)w, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      w == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(
      map, type, 4, const_cast<void*>(x), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
           int block_q, float scale, float softcap, cudaStream_t stream) {
  if (block_q != 64 * warpgroups(DP)) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(DP, warpgroups(DP));
  CUtensorMap k_map, v_map;
  cudaError_t err = rows_map(&k_map, k, B, Skv, Hkv, D, DP);
  if (err == cudaSuccess) err = rows_map(&v_map, v, B, Skv, Hkv, D, DP);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + block_q - 1) / block_q) * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  flash_kernel<DP><<<grid, WG * warpgroups(DP), smem, stream>>>(
      k_map, v_map, q, out, Sq, Skv, Hq, Hkv, D, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                int window, int block_q, float scale, float softcap,
                cudaStream_t stream) {
  if (block_q != BQ16) return (int)cudaErrorInvalidValue;
  constexpr int W = panel_bf16(DP);
  constexpr CUtensorMapDataType type =
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int smem = smem_bytes_bf16(DP);
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = panel_map(&q_map, q, B, Sq, Hq, D, W, BQ16, type);
  if (err == cudaSuccess)
    err = panel_map(&k_map, k, B, Skv, Hkv, D, W, BK16, type);
  if (err == cudaSuccess)
    err = panel_map(&v_map, v, B, Skv, Hkv, D, W, BK16, type);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_kernel_bf16<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Sq + BQ16 - 1) / BQ16) * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  flash_kernel_bf16<T, DP><<<grid, 2 * WG + 32, smem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), Sq, Skv, Hq, Hkv, D, causal,
      window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// block_q: the query rows of a block (64 a warpgroup) that the wrapper's
// `tile_config` gives for D, checked against the kernel's own rule.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int Hq, int Hkv, int D,
                                      int causal, int window, int block_q,
                                      float scale, float softcap,
                                      void* stream) {
  if (D % 4 || D < 4 || D > MAX_DP || Hkv < 1 || Hq % Hkv ||
      (block_q != 64 && block_q != 128))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(n)                                                      \
  case n:                                                                  \
    return launch<16 * n>(qf, kf, vf, of, B, Sq, Skv, Hq, Hkv, D, causal,  \
                          window, block_q, scale, softcap, st);
  switch ((D + 15) / 16) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4) FLASH_CASE(5)
    FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8) FLASH_CASE(9)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

namespace {

// The 16-bit kernel of element type T for D's padded width.
template <typename T>
int launch_16(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
              int block_q, float scale, float softcap, cudaStream_t st) {
#define FLASH_CASE(n)                                                      \
  case n:                                                                  \
    return launch_bf16<T, 16 * n>(q, k, v, out, B, Sq, Skv, Hq, Hkv, D,   \
                                  causal, window, block_q, scale, softcap, \
                                  st);
  switch ((D + 15) / 16) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4) FLASH_CASE(5)
    FLASH_CASE(6) FLASH_CASE(7) FLASH_CASE(8) FLASH_CASE(9)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The same for 16-bit q, k, v and out, `dtype` 1 bf16 or 2 float16; D a
// multiple of 8 (16-byte rows for the TMA), block_q 128 (`BQ16`).
extern "C" int flash_attention_16_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Skv, int Hq, int Hkv,
                                         int D, int causal, int window,
                                         int block_q, float scale,
                                         float softcap, int dtype,
                                         void* stream) {
  if (D % 8 || D < 8 || D > MAX_DP || Hkv < 1 || Hq % Hkv ||
      (dtype != 1 && dtype != 2))
    return (int)cudaErrorInvalidValue;
  const auto run = dtype == 2 ? launch_16<__half> : launch_16<__nv_bfloat16>;
  return run(q, k, v, out, B, Sq, Skv, Hq, Hkv, D, causal, window, block_q,
             scale, softcap, static_cast<cudaStream_t>(stream));
}

// Split-C fused BLI(+)conv body for Hopper (paper §IV-D fusion), the body
// of #1 dcn_fused_batch (dcn_fused_batch.cu), #4 dcn_fused_schedule and #5
// dcn_fused_tile (dcn_fused_schedule.cu).
//
// For grid row g (one output tile) and output pixel p:
//
//   out[g, p, :] = b + sum_{kk, c} patch[p, kk, c] * w[kk, c, :]
//   patch[p, kk, c] = sum_j coeff_j * x[src(idx_j), c]
//
// over the 4 BLI neighbours j. Three addressing modes, fixed at compile
// time (the TPU kernels' rules, unchanged):
//
//   ADDR_BATCH  (#1) plane-global a = tile * tp + offset, idx and coeff
//               rows read through row_id[g]; a neighbour counts iff a
//               slot k < dep_cnt[g] holds a tile of x with dep[g, k] %
//               t_in == a / tp (a row's deps are distinct tiles of one
//               image, so one slot at most); x row = dep[g, k] * tp +
//               a % tp. A dep_cnt = 0 row writes b.
//   ADDR_SCHED  (#4) slot-local a = k * tp + offset; a neighbour counts
//               iff k < dep_cnt[g] and dep[g, k] is a tile of x; x row =
//               dep[g, k] * tp + offset. A dep_cnt = 0 row writes b.
//   ADDR_TILE   (#5) halo-local a in [0, S) of image g's (S, C) halo
//               buffer, S = tp; x row = g * S + a.
//
// BATCH and SCHED share the resident-halo path: each neighbour is
// resolved to its dep slot k once, when the block's tables are built, so
// the stages interpolate from the chunk of slot k's tile in shared memory
// whichever mode put it there.
//
// Bound. At the shapes of the VGG19-3 DCN layers (C = O = 512, KK = 9,
// 64-256 output pixels per row) a call is 0.3-4.8 GFLOP against 9.4 MB of
// weights. With the contraction on the tensor cores in 3xTF32 (three TF32
// products per FP32 product, 495 / 3 = 165 TFLOP/s) the least time is set
// by the weight bytes (~2.8 us at 3.35 TB/s) for one row and by the
// operations for four or more. What held the FP32 body that came before
// it to ~0.77 ms was neither: 8-128 blocks on 132 SMs, each serialising
// gather, weight staging and FMA behind barriers, and every O-block
// re-gathering the same deformed patch. What holds this body is the
// serial per-stage work of one block (copy issue, interpolation from
// shared memory, one barrier), not the tensor cores, which idle most of a
// stage.
//
// Design:
// * Fill the card. The C reduction is cut into n_split slices of whole
//   BC-channel chunks (the wrapper's `fused_splits` policy); block
//   (g, pixel block, split * O-blocks + O-block) writes its partial
//   (BP, BO) sums to a float32 workspace (n_split, rows, P, O), and a
//   second kernel, launched as a programmatic dependent of the first, adds
//   the slices in split order and b once. No atomics: two runs are
//   bitwise equal. With n_split = 1 the first kernel writes out + b.
// * Keep the halo resident, as the TPU kernels keep it in VMEM, one
//   16-channel chunk at a time: the chunk of the tile's halo (TILE: its S
//   rows) or of the row's live dep tiles (BATCH, SCHED: up to k_pad * tp
//   rows) is copied once into shared memory, double-buffered by chunk, and
//   each of the KK taps interpolates its 4 neighbours from there. A halo
//   too large for two chunks in a block's shared memory takes the gather
//   path: each thread copies its pixel's 4 neighbours of each stage from
//   device memory into a ring and interpolates what it copied.
// * Overlap loads with math. The K loop runs over stages (one tap kk, one
//   chunk). A stage's w slice [BC][BO] is copied with 16-byte cp.async
//   into a 3-deep ring two stages ahead; stage s's wgmmas run
//   asynchronously while stage s + 1's patch is interpolated into the
//   other half of a 2-deep patch ring. One barrier a stage (two at a
//   chunk's first). The deformed patch never leaves the SM.
// * One block covers BO = 128 output channels (was 64), so the BLI is
//   repeated O / 128 times instead of O / 64.
// * The contraction runs on the tensor cores: wgmma m64n64k8 TF32 with
//   FP32 accumulators, A (w transposed, 64 output channels x 8) from
//   registers, B (the patch, 8 x 64 pixels) from shared memory in the
//   K-major canonical layout. 3xTF32: each operand is split into a TF32
//   high part and a TF32 residual and hi*hi + hi*lo + lo*hi is summed,
//   which keeps FP32 accuracy (plain TF32 would not meet 1e-4). Each
//   stage's products start from zero and are added to the FP32 total with
//   round-to-nearest: the tensor cores' own accumulation rounds toward
//   zero, and carried over all KK * C = 4608 products it drifts past the
//   1e-5 * max|out| that the split count may move the result.
//
// Element type T of x, w, b and out: float or __half. A float16 value
// widens to float32 exactly and its 11-bit significand is exact in TF32,
// so on float16 operands the 3xTF32 products keep float32 accuracy and
// the output is rounded once to float16. Calls whose x, w and b are all
// bf16 run the Hopper body of dcn_fused_bf16.cuh, which splits the float32
// patch into three bf16 pieces: exact only in bf16's exponent range (float16
// pieces would underflow below 2^-24 and overflow above 65504), so float16
// calls do not take it.

#pragma once

#include <cuda_fp16.h>

#include "wgmma_tf32.cuh"

namespace {
namespace split {

using namespace tc;

constexpr int BP = 64;        // output pixels per block (wgmma N)
constexpr int BO = 128;       // output channels per block (2 x wgmma M)
constexpr int BC = 16;        // input channels per chunk (one stage's K / KK)
constexpr int NT = 256;       // 2 warpgroups, one per 64 output channels
constexpr int WS = BO + 8;    // w row stride: conflict-free A fragments
constexpr int RING = 3;       // stages in flight: two ahead of the math
constexpr int PATCH = BP * BC;  // floats of one stage's patch (hi or lo)
constexpr int COMBINE_NT = 128;

// Per element type T of x and w: values of one 16-byte copy, and the halo
// row stride (values): a chunk row of BC channels plus one copy's padding,
// 80 bytes, each row on a 16-byte boundary.
template <typename T>
struct Elem {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int HS = BC + VEC;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// float -> T, rounded to nearest.
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

// Four consecutive values as float4 (float16: widened, exactly; 8-byte
// aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// One value into shared memory, zero where !ok: a 4-byte cp.async for a
// float; a float16 (cp.async copies no fewer than 4 bytes) by a load and a
// store, which land before the barrier or the wait that precedes its use,
// as the copy would.
__device__ __forceinline__ void copy1(float* dst, const float* src,
                                      const float* any, bool ok) {
  cp_async4(dst, ok ? src : any, ok ? 4 : 0);
}
__device__ __forceinline__ void copy1(__half* dst, const __half* src,
                                      const __half*, bool ok) {
  *dst = ok ? *src : __float2half_rn(0.f);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// Four consecutive values by one cp.async (16 bytes of float, 8 of
// float16), zero-filled where !ok.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* any, bool ok) {
  cp_async16(dst, ok ? src : any, ok ? 16 : 0);
}
__device__ __forceinline__ void copy4(__half* dst, const __half* src,
                                      const __half* any, bool ok) {
  cp_async8(dst, ok ? src : any, ok ? 8 : 0);
}
static_assert(NT == 4 * BP && BC == 16 && BO == 2 * 64 && BP == 64 &&
                  BC * BO % (4 * NT) == 0,
              "the thread maps below assume this tile");

enum Addr { ADDR_SCHED = 1, ADDR_TILE = 2, ADDR_BATCH = 3 };

// Shared-memory matrix descriptor of one k-step of a stage's patch: the
// K-major, unswizzled canonical layout of 8-pixel x 16-byte core matrices,
// LBO = 128 bytes to the next 4 channels, SBO = 512 bytes to the next 8
// pixels (a stage's 16 channels are 4 core matrices along K).
__device__ __forceinline__ uint64_t patch_desc(const float* p) {
  return smem_desc(p, 128, 512);
}

// D (64 output channels x 64 pixels) = A (64 x 8, registers) * B (8 x 64,
// the patch in shared memory) + (scale_d ? D : 0), TF32 in, FP32 out.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}

template <typename T, int MODE, bool HALO>
__global__ void __launch_bounds__(NT, 2)
split_kernel(const T* __restrict__ x, const int* __restrict__ row_id,
             const int* __restrict__ dep, const int* __restrict__ dep_cnt,
             const int* __restrict__ idx, const float* __restrict__ coeff,
             const T* __restrict__ w, const T* __restrict__ b,
             float* __restrict__ ws, T* __restrict__ out, int rows,
             int k_pad, int n_x, int t_in, int tp, int P, int KK, int C,
             int O, int c_split) {
  constexpr int VEC = Elem<T>::VEC, HS = Elem<T>::HS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bh = (float*)smem;                  // [2][PATCH] patch, TF32 high
  float* Bl = Bh + 2 * PATCH;                // [2][PATCH] patch, residual
  T* Wr = (T*)(Bl + 2 * PATCH);              // [RING][BC][WS] w slices
  // HALO: [2][S_h][HS], a chunk of the row's halo (TILE) or of its dep
  // tiles (BATCH, SCHED), double-buffered by chunk; else
  // [RING][4][4][BP][4], the neighbours of each stage gathered from device
  // memory. Both in T, as stored.
  const int S_h = MODE == ADDR_TILE ? tp : k_pad * tp;
  T* Xr = Wr + RING * BC * WS;
  int* src = (int*)(Xr + (HALO ? 2 * S_h * HS : RING * 16 * BP * 4));
  float* cf = (float*)(src + BP * KK * 4);   // [BP][KK][4]
  int* deps = (int*)(cf + BP * KK * 4);      // [k_pad] (BATCH, SCHED)

  const int g = blockIdx.x, p0 = blockIdx.y * BP;
  const int n_ob = (O + BO - 1) / BO;
  const int n_split = gridDim.z / n_ob;
  const int sp = blockIdx.z / n_ob, o0 = (blockIdx.z - sp * n_ob) * BO;
  const int c_lo = sp * c_split;
  const int c_hi = min(C, c_lo + c_split);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = MODE == ADDR_TILE ? 1 : dep_cnt[g];
  // The combine pass may be scheduled now; it waits for this grid's end.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (cnt == 0) {  // bias only; when split, the combine pass writes it
    if (n_split == 1)
      for (int e = tid; e < BP * BO; e += NT) {
        const int p = p0 + e / BO, o = o0 + e % BO;
        if (p < P && o < O) out[((size_t)g * P + p) * O + o] = b[o];
      }
    return;
  }

  // Stages: s -> (kk = s % KK, chunk = s / KK), kk fastest.
  const int n_stages =
      c_hi > c_lo ? (c_hi - c_lo + BC - 1) / BC * KK : 0;
  auto advance = [&](int& kk, int& c0) {
    if (++kk == KK) {
      kk = 0;
      c0 += BC;
    }
  };
  // Copy stage (kk, c0)'s [BC][BO] slice of w into ring slot `slot`, in
  // 16-byte pieces where O allows, else value by value; rows past c_hi and
  // columns past O are zero-filled.
  const bool vec_w = O % VEC == 0 && ((uintptr_t)w & 15) == 0;
  auto copy_w = [&](int slot, int kk, int c0) {
    T* dst = Wr + slot * BC * WS;
    if (vec_w) {
#pragma unroll
      for (int i = 0; i < BC * BO / VEC / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / (BO / VEC), o = (e % (BO / VEC)) * VEC;
        const bool ok = c0 + r < c_hi && o0 + o < O;
        cp_async16(dst + r * WS + o,
                   ok ? w + ((size_t)kk * C + c0 + r) * O + o0 + o : w,
                   ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BC * BO / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / BO, o = e % BO;
        const bool ok = c0 + r < c_hi && o0 + o < O;
        copy1(dst + r * WS + o, w + ((size_t)kk * C + c0 + r) * O + o0 + o,
              w, ok);
      }
    }
  };

  // The block's idx and coeff rows are contiguous in device memory: copy
  // them (and the row's deps) into shared memory in one go, while the w
  // slices of the first RING - 1 stages fly, then resolve in place where
  // each (pixel, kk, neighbour) lives: its row in the halo (HALO) or in x,
  // or -1.
  const size_t t0 =
      ((size_t)(MODE == ADDR_BATCH ? row_id[g] : g) * P + p0) * KK * 4;
  const int n_tab = min(BP, P - p0) * KK * 4;
  for (int e = tid; e < BP * KK * 4; e += NT) {
    const bool ok = e < n_tab;
    cp_async4(src + e, ok ? (const void*)(idx + t0 + e) : idx, ok ? 4 : 0);
    cp_async4(cf + e, ok ? coeff + t0 + e : coeff, ok ? 4 : 0);
  }
  if (MODE != ADDR_TILE)
    for (int k = tid; k < k_pad; k += NT)
      cp_async4(deps + k, dep + (size_t)g * k_pad + k, 4);
  cp_async_commit();
  int kk_w = 0, c_w = c_lo;  // next stage to copy
  for (int i = 0; i < RING - 1 && i < n_stages; ++i) {
    copy_w(i, kk_w, c_w);
    advance(kk_w, c_w);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  const int live = cnt < k_pad ? cnt : k_pad;
  for (int e = tid; e < BP * KK * 4; e += NT) {
    const int a = src[e];
    int s = -1;
    if (e < n_tab) {
      if (MODE == ADDR_BATCH) {
        // The slot of the row's dep tile that holds the neighbour.
        if (a >= 0) {
          const int tile = a / tp;
          for (int k = 0; k < live; ++k) {
            const int d = deps[k];
            if (d >= 0 && d < n_x && d % t_in == tile) {
              s = HALO ? k * tp + (a - tile * tp) : d * tp + (a - tile * tp);
              break;
            }
          }
        }
      } else if (MODE == ADDR_SCHED) {
        const int k = a / tp;
        if (a >= 0 && k < live) {
          const int d = deps[k];
          if (d >= 0 && d < n_x) s = HALO ? a : d * tp + (a - k * tp);
        }
      } else {
        if (a >= 0 && a < tp) s = HALO ? a : g * tp + a;
      }
    }
    src[e] = s;
    if (s < 0) cf[e] = 0.f;
  }
  __syncthreads();

  // Gather: thread (pixel pl = 8 * warp + lane % 8, channel quad q = lane
  // / 8) interpolates its pixel's channels c0 + 4q .. + 3 of a stage from
  // the 4 neighbours' rows. HALO: the rows come from the chunk of the halo
  // in shared memory, copied once a chunk, contiguous rows of 16 channels;
  // zero-filled where c >= c_hi or a dep is not a tile of x. Else the
  // thread copies its 4 neighbours' channels of each stage from device
  // memory into its own part of the ring (zero-filled where a neighbour
  // does not count or c >= c_hi): it reads only what it copied, so those
  // copies need its own wait, not a barrier.
  const int q = lane >> 3, pl = 8 * warp + (lane & 7);
  // Halo rows move in 16-byte copies of VEC channels, a gathered
  // neighbour's 4 channels in one copy of 4 values, where C and x's
  // alignment allow; else value by value.
  const bool vec_x = C % VEC == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_g =
      (C & 3) == 0 && ((uintptr_t)x & (4 * sizeof(T) - 1)) == 0;
  // Copy x rows [r0, r0 + n) of channels [c0, c0 + BC) to halo rows
  // dst .. (zeros where ok is false or c >= c_hi).
  auto copy_rows = [&](T* dst, size_t r0, int n, int c0, bool ok) {
    constexpr int PIECES = BC / VEC;  // 16-byte copies a row
    if (vec_x) {
      // Unsigned, so that / and % by PIECES are a shift and a mask: the
      // signed forms cost registers here, inside the stage loop where
      // the accumulators peak, and make the float body spill them.
      for (unsigned e = tid; e < n * PIECES; e += NT) {
        const int r = e / PIECES, c = c0 + VEC * (e % PIECES);
        const bool v = ok && c < c_hi;
        cp_async16(dst + r * HS + VEC * (e % PIECES),
                   v ? x + (r0 + r) * C + c : x, v ? 16 : 0);
      }
    } else {
      for (int e = tid; e < n * BC; e += NT) {
        const int r = e / BC, c = c0 + e % BC;
        copy1(dst + r * HS + e % BC, x + (r0 + r) * C + c, x,
              ok && c < c_hi);
      }
    }
  };
  auto copy_x = [&](int slot, int kk, int c0) {
    if (HALO) {
      if (kk != 0) return;  // one copy a chunk, into buffer chunk % 2
      T* dst = Xr + (((c0 - c_lo) / BC) & 1) * S_h * HS;
      if (MODE == ADDR_TILE) {
        copy_rows(dst, (size_t)g * tp, tp, c0, true);
      } else {
        for (int k = 0; k < live; ++k) {
          const int d = deps[k];
          copy_rows(dst + k * tp * HS, (size_t)max(d, 0) * tp, tp, c0,
                    d >= 0 && d < n_x);
        }
      }
      return;
    }
    const int c = c0 + 4 * q;
    const int* sj = src + (pl * KK + kk) * 4;
    T* dst = Xr + ((slot * 16 + q) * BP + pl) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = sj[j];
      const T* xp = x + (size_t)max(s, 0) * C + c;
      if (vec_g) {
        copy4(dst + j * 4 * BP * 4, xp, x, s >= 0 && c < c_hi);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          copy1(dst + j * 4 * BP * 4 + e, xp + e, x, s >= 0 && c + e < c_hi);
      }
    }
  };
  // Write the patch row (pl, 4q .. 4q + 3) as TF32 high and residual
  // parts, each at its place in the canonical layout: core matrix
  // (pl / 8, q), row pl % 8. A fence hands the writes to the tensor cores'
  // (async) proxy.
  auto interpolate = [&](int slot, int kk, int chunk, int buf) {
    const int4 s4 = *(const int4*)(src + (pl * KK + kk) * 4);
    const float4 c4 = *(const float4*)(cf + (pl * KK + kk) * 4);
    const int sj[4] = {s4.x, s4.y, s4.z, s4.w};
    const float cj[4] = {c4.x, c4.y, c4.z, c4.w};
    const T* h = Xr + (chunk & 1) * S_h * HS + 4 * q;
    const T* xs = Xr + ((slot * 16 + q) * BP + pl) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float k = cj[j];
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!HALO)
        xv = load4(xs + j * 4 * BP * 4);
      else if (sj[j] >= 0)
        xv = load4(h + sj[j] * HS);
      v[0] += k * xv.x;
      v[1] += k * xv.y;
      v[2] += k * xv.z;
      v[3] += k * xv.w;
    }
    uint4 hi, lo;
    split_tf32(v[0], hi.x, lo.x);
    split_tf32(v[1], hi.y, lo.y);
    split_tf32(v[2], hi.z, lo.z);
    split_tf32(v[3], hi.w, lo.w);
    const int at = buf * PATCH + ((warp * 4 + q) * 8 + (lane & 7)) * 4;
    *(uint4*)(Bh + at) = hi;
    *(uint4*)(Bl + at) = lo;
    fence_async_smem();
  };
  int kk_x = 0, c_x = c_lo;  // next stage to gather
  for (int i = 0; i < RING - 1; ++i) {
    if (i < n_stages) {
      copy_x(i, kk_x, c_x);
      advance(kk_x, c_x);
    }
    cp_async_commit();
  }

  // Contraction on the tensor cores: warpgroup wg owns output channels
  // o0 + 64 wg .. + 63 (wgmma M) of all 64 pixels (N). Its A fragment (w,
  // transposed) comes from registers: lane (gq, tq) of warp wi holds rows
  // 16 wi + gq (+ 8), columns (channels) tq (+ 4) of each 8-deep k-step.
  const int wg = warp >> 2, wi = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int a_off = tq * WS + 64 * wg + 16 * wi + gq;
  float acc[32], d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = d[i] = 0.f;

  // Commit groups so far: the tables, the prologue's w slices, then one
  // per prologue stage's neighbours; then one an iteration. Waiting until
  // at most RING - 2 are pending leaves the next stage's w slice and
  // neighbours landed (this thread's copies; a barrier then makes them
  // everyone's).
  //
  // Iteration s: issue stage s's wgmmas (async, on patch buffer s % 2),
  // issue the copies of stage s + RING - 1, interpolate stage s + 1 into
  // the other patch buffer while the tensor cores run, then wait for them
  // and add the stage's sum. One barrier an iteration (two at a chunk's
  // first stage, whose halo all threads copied).
  int slot = 0, next = RING - 1, kk_n = 0, chunk_n = 0;  // stage s + 1's
  auto step = [&]() {
    slot = slot == RING - 1 ? 0 : slot + 1;
    if (++kk_n == KK) {
      kk_n = 0;
      ++chunk_n;
    }
  };
  if (n_stages > 0) {
    cp_async_wait<RING - 2>();
    if (HALO) __syncthreads();
    interpolate(0, 0, 0, 0);
  }
  __syncthreads();
  for (int s = 0; s < n_stages; ++s) {
    uint32_t ah[2][4], al[2][4];
    const T* A = Wr + slot * BC * WS + a_off;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const T* a = A + ks * 8 * WS;
      const float av[4] = {widen(a[0]), widen(a[8]), widen(a[4 * WS]),
                           widen(a[4 * WS + 8])};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[ks][i], al[ks][i]);
    }
    // 3xTF32: lo*hi + hi*lo + hi*hi. Each k-step's 32 bytes of patch rows
    // are two core matrices along K. The stage's sum starts from zero and is added to the FP32
    // total with round-to-nearest.
    const float* bh = Bh + (s & 1) * PATCH;
    const float* bl = Bl + (s & 1) * PATCH;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      wgmma_tf32(d, al[ks], patch_desc(bh + ks * 64), ks);
      wgmma_tf32(d, ah[ks], patch_desc(bl + ks * 64), 1);
      wgmma_tf32(d, ah[ks], patch_desc(bh + ks * 64), 1);
    }
    wgmma_commit();

    if (s + RING - 1 < n_stages) {
      copy_w(next, kk_w, c_w);
      advance(kk_w, c_w);
      copy_x(next, kk_x, c_x);
      advance(kk_x, c_x);
    }
    cp_async_commit();
    next = next == RING - 1 ? 0 : next + 1;
    step();
    if (s + 1 < n_stages) {
      cp_async_wait<RING - 2>();
      if (HALO && kk_n == 0) __syncthreads();
      interpolate(slot, kk_n, chunk_n, (s + 1) & 1);
    }

    wgmma_wait();
    // The asynchronous wgmmas read ah, al and write d until the wait: keep
    // the compiler from reusing or reading those registers before it.
    fence_regs(d);
    fence_regs(ah[0]);
    fence_regs(ah[1]);
    fence_regs(al[0]);
    fence_regs(al[1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += d[i];
    __syncthreads();  // patch and w of stage s + 1 visible; stage s done
  }

  // Epilogue: acc[4j + v] is output channel o0 + 64 wg + 16 wi + gq
  // (+ 8 for v >= 2) of pixel p0 + 8j + 2tq (+ 1 for odd v). Unsplit, the
  // sum plus b is rounded once to T; else the float32 partial is kept.
  float* part = ws + (size_t)sp * rows * P * O;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int p = p0 + 8 * j + 2 * tq + (v & 1);
      const int o = o0 + 64 * wg + 16 * wi + gq + 8 * (v >> 1);
      const size_t e = ((size_t)g * P + p) * O + o;
      if (p < P && o < O) {
        if (n_split == 1)
          out[e] = narrow<T>(acc[4 * j + v] + widen(b[o]));
        else
          part[e] = acc[4 * j + v];
      }
    }
}

// out[g, p, o] = (ws[0, g, p, o] + ... + ws[n_split - 1, g, p, o]) + b[o],
// in split order, in float32 and rounded once to T; a dep_cnt = 0 row is
// b.
template <typename T>
__global__ void __launch_bounds__(COMBINE_NT)
split_combine(const float* __restrict__ ws, const int* __restrict__ dep_cnt,
              const T* __restrict__ b, T* __restrict__ out, int rows,
              int P, int O, int n_split) {
  // Launched early (programmatic dependent launch): wait until the split
  // pass has finished and its workspace writes are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int o = blockIdx.y * COMBINE_NT + threadIdx.x;
  if (o >= O) return;
  const size_t e = (size_t)blockIdx.x * O + o;  // blockIdx.x = g * P + p
  float v = widen(b[o]);
  if (dep_cnt == nullptr || dep_cnt[blockIdx.x / P] != 0) {
    const size_t stride = (size_t)rows * P * O;
    float s = ws[e];
#pragma unroll 8
    for (int i = 1; i < n_split; ++i) s += ws[e + i * stride];
    v = s + v;
  }
  out[e] = narrow<T>(v);
}

template <typename T, int MODE, bool HALO>
cudaError_t launch_main(int smem, dim3 grid, cudaStream_t stream,
                        const void* x, const void* row_id, const void* dep,
                        const void* dep_cnt, const void* idx,
                        const void* coeff, const void* w, const void* b,
                        void* ws, void* out, int rows, int k_pad, int n_x,
                        int t_in, int tp, int P, int KK, int C, int O,
                        int c_split) {
  const cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, MODE, HALO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  split_kernel<T, MODE, HALO><<<grid, NT, smem, stream>>>(
      (const T*)x, (const int*)row_id, (const int*)dep, (const int*)dep_cnt,
      (const int*)idx, (const float*)coeff, (const T*)w, (const T*)b,
      (float*)ws, (T*)out, rows, k_pad, n_x, t_in, tp, P, KK, C, O, c_split);
  return cudaGetLastError();
}

// Launch both passes over `rows` grid rows on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess. x, w, b and out hold T;
// `ws` holds (n_split, rows, P, O) floats when n_split > 1; `c_split`
// channels per slice; `n_x` tiles of tp rows in x (BATCH, SCHED); `row_id`
// only for BATCH. The halo path runs when two chunks of the halo (TILE: S
// rows; BATCH, SCHED: k_pad * tp), in T, fit a block's shared memory, else
// the gather path.
template <typename T, int MODE>
int split_launch_t(const void* x, const void* row_id, const void* dep,
                   const void* dep_cnt, const void* idx, const void* coeff,
                   const void* w, const void* b, void* ws, void* out,
                   int rows, int k_pad, int n_x, int t_in, int tp, int P,
                   int KK, int C, int O, int n_split, int c_split,
                   void* stream) {
  constexpr long long E = sizeof(T);
  const long long s_h = MODE == ADDR_TILE ? tp : (long long)k_pad * tp;
  const long long fixed = 4 * 4 * PATCH + E * RING * BC * WS +
                          KK * BP * 4 * 8 +
                          (MODE != ADDR_TILE ? 4 * k_pad : 0);
  const long long halo = fixed + E * 2 * s_h * Elem<T>::HS;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_ob = (O + BO - 1) / BO;
  const dim3 grid(rows, (P + BP - 1) / BP, n_ob * n_split);
  const cudaStream_t st = (cudaStream_t)stream;
  err = halo <= limit
            ? launch_main<T, MODE, true>((int)halo, grid, st, x, row_id, dep,
                                         dep_cnt, idx, coeff, w, b, ws, out,
                                         rows, k_pad, n_x, t_in, tp, P, KK,
                                         C, O, c_split)
            : launch_main<T, MODE, false>(
                  (int)(fixed + E * RING * 16 * BP * 4), grid, st, x, row_id,
                  dep, dep_cnt, idx, coeff, w, b, ws, out, rows, k_pad, n_x,
                  t_in, tp, P, KK, C, O, c_split);
  if (err != cudaSuccess || n_split == 1) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * P, (O + COMBINE_NT - 1) / COMBINE_NT);
  cfg.blockDim = dim3(COMBINE_NT);
  cfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, split_combine<T>, (const float*)ws,
      MODE != ADDR_TILE ? (const int*)dep_cnt : nullptr, (const T*)b,
      (T*)out, rows, P, O, n_split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace split
}  // namespace

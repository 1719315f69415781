// Fused BLI(+)conv on bf16 x, w and b for Hopper (paper §IV-D fusion): the
// body of #1 dcn_fused_batch (dcn_fused_batch.cu), #4 dcn_fused_schedule
// and #5 dcn_fused_tile (dcn_fused_schedule.cu) when x, w and b are all
// bf16. It replaces the TPU kernels `_batch_kernel`, `_sched_kernel` and
// `_fused_kernel` of src/repro/kernels/dcn_fused.py on bf16 operands, under
// the three addressing rules of dcn_fused_split.cuh (ADDR_BATCH,
// ADDR_SCHED, ADDR_TILE), which keeps the float32 body:
//
//   out[g, p, :] = bf16(b + sum_{kk, c} patch[p, kk, c] * w[kk, c, :])
//   patch[p, kk, c] = sum_j coeff_j * x[src(idx_j), c]     (float32)
//
// The coefficients and the patch stay float32 (the patch is never rounded
// to bf16); the contraction is FP32-accurate; b is added once to the
// float32 sum and the result rounded once. A dep_cnt = 0 row is b.
//
// Bound: operations. At the VGG19-3 DCN layers (C = O = 512, KK = 9) a
// call is 0.3-4.8 GFLOP on 5-7 MB. The card's fastest FP32-accurate form
// of a float32 patch times a bf16 weight is three bf16 products: the patch
// value v split into three bf16 pieces whose sum is v exactly (here each
// piece the truncation of what the earlier ones left: 8 + 8 + 8
// significant bits, each subtraction exact), each product with a bf16 w
// exact in float32; 989 / 3 = 330 TFLOP/s. The split body that ran these
// calls before (2xTF32, 247.5 TFLOP/s) spent a stage's time not on the
// tensor cores but in every thread starting the stage's copies (26 % of a
// block's path at #1's shape) and interpolating into shared memory behind
// a proxy fence (32 %), tools/dcn_phases.py on an H100. Here the
// interpolation of each patch value, once per 128 output channels, is what
// is left between the tensor cores and their rate.
//
// Design (288 threads: two consumer warpgroups and one producer warp; one
// block an SM):
// * A block owns 128 output channels and two units, each one row's block
//   of 64 output pixels: consumer warpgroup u computes D (64 pixels x 128
//   channels) = patch x w for unit u with wgmma m64n128k16 bf16, so every
//   w byte brought from L2 serves 128 pixels. Units pair in order: two
//   rows (#1, #4), or two pixel blocks of one row that share a halo (#5 on
//   the whole plane); an odd last unit leaves a warpgroup idle. (Two
//   warpgroups of 256 channels each would halve the interpolation, but
//   their 128 accumulators do not fit the 168 registers a thread of a
//   nine-warp block gets; without the producer warp, a consumer thread
//   that started the copies stalled its warpgroup: 1.4x slower on an H100.)
// * The patch is the A operand, from registers: the thread that
//   interpolates a value holds it in the A fragment's place (rows g, g + 8;
//   columns 2t, 2t + 1, 2t + 8, 2t + 9), as three bf16 pieces, and each
//   piece goes into the same float32 accumulator. No patch goes through
//   shared memory, no proxy fence, no block barrier in the stage loop. A
//   stage (one tap, 32 channels: two 16-channel steps, six products) is
//   one wgmma group from one of two register buffers (24 + 24), while the
//   next stage is interpolated into the other; a thread loads a pixel's
//   four neighbours' words for both steps together. The group is retired
//   before the next stage, so none is in flight across the loop's back
//   edge (one that was made ptxas serialize every product).
// * w is the B operand as stored ([KK][C][O], O contiguous: MN-major, the
//   transpose flag set): a stage lands as two 128-B swizzled panels [32]
//   [64] in a ring of up to 8 stages. The producer warp fills the ring
//   with TMA boxes of a 3-d tensor map (zeros past C and O) against full /
//   empty mbarriers, and the halo chunk of each unit's rows with 2-d boxes
//   of x viewed as (rows, C), one a dep tile (TILE: the S halo rows),
//   double-buffered by chunk. A halo row is 40 channels, 80 bytes: the
//   rows of 8 neighbours fall on distinct banks with no swizzle to undo.
//   Where TMA cannot take an operand (a row of C or O values not a
//   multiple of 16 bytes, or a base off 16 bytes; 16-byte cp.async copies
//   could not take those either) the producer warp copies it value by
//   value into the same places. Where two chunks of the halo do not fit,
//   the consumers read the neighbours from device memory (the gather
//   path).
// * The split of the contraction: its stages (taps x 32-channel chunks)
//   are cut into n_split even slices, one a block. The slices of a (pair,
//   O-block) run as a thread block cluster of at most 8 blocks (rank =
//   slice) and are merged on chip: each block stashes its float32 sums in
//   its own shared memory; after a cluster barrier rank r reads its 1/n
//   share of the tile from every rank in split order (distributed shared
//   memory), adds b, rounds and stores; a second cluster barrier keeps
//   every block alive until the reads are done. Past 8 slices, ceil(n / 8)
//   clusters a tile each merge theirs into a float32 workspace, and the
//   last to count itself in (a ticket a share, zero again after) adds the
//   clusters' sums in cluster order. No second launch, no atomics on the
//   values: two runs are bitwise equal, and a row's result depends on
//   n_split alone.
// * The tensor cores accumulate over the block's whole K (their float32
//   sum truncates; at KK * C = 4608 three-piece steps it moves the result
//   by well under the bf16 output's half ulp).
// * `// PROF <phase>` lines mark where tools/dcn_phases.py puts its timers.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace {
namespace b16 {

using namespace tc;
using namespace hop;
using bf16 = __nv_bfloat16;

enum Addr { ADDR_SCHED = 1, ADDR_TILE = 2, ADDR_BATCH = 3 };

constexpr int BP = 64;            // output pixels of a unit (wgmma M)
constexpr int BO = 128;           // output channels of a block (wgmma N)
constexpr int BK = 32;            // input channels of a stage and a chunk
constexpr int WG = 128;           // threads of a warpgroup
constexpr int NT = 2 * WG + 32;   // two consumer warpgroups, the producer
constexpr int MAX_RING = 8, MIN_RING = 4;
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int WPANEL = BK * 128;  // bytes of a w panel [BK][64 channels]
constexpr int WSTAGE = (BO / 64) * WPANEL;
// A halo row: the chunk's 32 channels and 8 more, as one TMA box row
// lands them: 80 bytes, 20 banks apart, so the rows of 8 neighbours fall
// on distinct banks with no swizzle to undo.
constexpr int HCH = BK + 8;       // channels of a halo row
constexpr int HROW = 2 * HCH;     // its bytes
constexpr int SROW = BO + 4;      // floats of a stash row
constexpr int STASH = 2 * BP * SROW * 4;
constexpr unsigned FULL = 0xffffffffu;

// Kernel arguments. The halo: `hrows` rows a unit (TILE: the S halo rows;
// BATCH, SCHED: k_pad dep tiles of `ts` rows, each tile's tp rows copied
// as `nbox` boxes of `br` <= 256 rows), then one zero row, in a slot of
// `hslot` bytes; two slots (units) a chunk buffer, two buffers.
struct Args {
  const bf16* x;
  const int* row_id;
  const int* dep;
  const int* dep_cnt;
  const int* idx;
  const float* coeff;
  const bf16* w;
  const bf16* b;
  bf16* out;
  float* ws;     // the clusters' sums [groups][pairs][O-blocks][2][BP][BO]
  int* tickets;  // a count per (pair, O-block, rank), zero between calls
  int rows, k_pad, n_x, t_in, tp, P, KK, C, O;
  int n_split;   // slices of the stages: block x takes slice x
  int groups;    // clusters a tile (more than MAX_CLUSTER slices)
  float rtp;  // 1 / tp
  int ring, halo, tma_w, tma_x;
  int ts, br, nbox, hrows, hslot;
};

// Offsets (bytes) from the block's 1024-byte aligned base: the w ring,
// the halo (both reused for the stash of the float32 sums after the
// loop), the tables of resolved neighbours and coefficients [2 units][BP]
// [KK][4] each, each consumer warp's copy of its row's deps and the
// producer's of both rows [8 + 2][k_pad], the mbarriers; `total` counts
// 1024 bytes to align the base.
struct Layout {
  int halo, tab, deps, bars, total;
};

__host__ __device__ __forceinline__ Layout layout(int ring, int hslot,
                                                  int KK, int k_pad) {
  Layout L;
  L.halo = ring * WSTAGE;
  const int region = L.halo + 4 * hslot;
  L.tab = region > STASH ? region : STASH;
  L.deps = L.tab + 2 * BP * KK * 4 * 8;
  L.bars = L.deps + (10 * k_pad * 4 + 15) / 16 * 16;
  L.total = 1024 + L.bars + 8 * (2 * ring + 4);
  return L;
}

// The bf16 truncation of x and of y in one register (x in the low half),
// and the exact remainders x - trunc(x), y - trunc(y).
__device__ __forceinline__ uint32_t cut(float& x, float& y) {
  const uint32_t u = __float_as_uint(x), v = __float_as_uint(y);
  x -= __uint_as_float(u & 0xffff0000u);
  y -= __uint_as_float(v & 0xffff0000u);
  return __byte_perm(u, v, 0x7632);
}

// x and y as three bf16 pairs whose sums are x and y exactly: each piece
// the truncation of what the earlier ones left (8 + 8 + 8 significant
// bits; each subtraction exact), `x` in the low halves.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = cut(x, y);
  mid = cut(x, y);
  lo = cut(x, y);
}

// fence_regs over a k-step's three pieces of A fragments.
__device__ __forceinline__ void fence3(uint32_t (&fr)[3][4]) {
  fence_regs(fr[0]);
  fence_regs(fr[1]);
  fence_regs(fr[2]);
}

// Both consumer warpgroups (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Four floats of the block of cluster rank `rank` at this block's shared
// address `p`.
__device__ __forceinline__ float4 ld_peer4(const float* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Channels c, c + 1 of x row `s` (zeros where s < 0 or past C), widened.
__device__ __forceinline__ float2 gather2(const bf16* __restrict__ x, int s,
                                         int c, int C) {
  float2 v = make_float2(0.f, 0.f);
  if (s >= 0) {
    const bf16* r = x + (size_t)s * C;
    if (c < C) v.x = __bfloat162float(r[c]);
    if (c + 1 < C) v.y = __bfloat162float(r[c + 1]);
  }
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(NT, 1)
bf16_kernel(const __grid_constant__ CUtensorMap w_map,
            const __grid_constant__ CUtensorMap x_map,
            const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // PROF start
  const Layout L = layout(a.ring, a.halo ? a.hslot : 0, a.KK, a.k_pad);
  uint8_t* const ring = smem;
  uint8_t* const halo = smem + L.halo;
  int* const tsrc = reinterpret_cast<int*>(smem + L.tab);
  float* const tcf =
      reinterpret_cast<float*>(smem + L.tab + 2 * BP * a.KK * 16);
  int* const tdep = reinterpret_cast<int*>(smem + L.deps);
  uint64_t* const full_w = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* const empty_w = full_w + a.ring;
  uint64_t* const full_h = empty_w + a.ring;
  uint64_t* const empty_h = full_h + 2;
  float* const stash = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, lane = tid & 31;
  // The warpgroup (0, 1: consumers; 2: the producer warp) and the warp,
  // lane 0's, shuffled: warp-uniform as the compiler sees them, which the
  // wgmma products need (a branch it cannot prove uniform serializes
  // them).
  const int warp = __shfl_sync(FULL, tid >> 5, 0);
  const int wg = warp >> 2, wi = warp & 3;
  // The split of the contraction: block x takes slice x of the stages
  // (tap, 32-channel chunk), tap fastest; its cluster is group x / n_rank
  // and its rank there x % n_rank.
  const int n_rank = gridDim.x / a.groups;
  const int rank = blockIdx.x % n_rank, grp = blockIdx.x / n_rank;
  const int o0 = blockIdx.y * BO;
  const int npb = (a.P + BP - 1) / BP, n_units = a.rows * npb;
  const int u0 = 2 * blockIdx.z, u1 = u0 + 1;
  const bool has0 = u0 < n_units, has1 = u1 < n_units;
  const int row0 = has0 ? u0 / npb : 0, row1 = has1 ? u1 / npb : 0;
  const int pb0 = u0 - row0 * npb, pb1 = u1 - row1 * npb;
  const int per_px = a.KK * 4;
  const int cnt0 = MODE == ADDR_TILE ? 1 : has0 ? a.dep_cnt[row0] : 0;
  const int cnt1 = MODE == ADDR_TILE ? 1 : has1 ? a.dep_cnt[row1] : 0;
  // Start at once the reads that need nothing else, so that their
  // latencies overlap: each consumer warp's raw tables of its unit's 16
  // pixels and its row's deps; the producer's copy of both rows' deps
  // [2][k_pad] (masked once dep_cnt is known).
  int* const pd = tdep + 8 * a.k_pad;
  if (wg < 2 && (wg ? has1 : has0)) {
    const int row = wg ? row1 : row0, pb = wg ? pb1 : pb0;
    const int trow = MODE == ADDR_BATCH ? a.row_id[row] : row;
    int* const sw = tsrc + (wg * BP + 16 * wi) * per_px;
    float* const cw = tcf + (wg * BP + 16 * wi) * per_px;
    const int p0 = pb * BP + 16 * wi;
    const int n_ok = max(0, min(16, a.P - p0)) * per_px;
    const size_t g0 = ((size_t)trow * a.P + p0) * per_px;
    for (int e = lane; e < 16 * per_px; e += 32) {
      const bool ok = e < n_ok;
      cp_async4(sw + e, ok ? (const void*)(a.idx + g0 + e) : a.idx,
                ok ? 4 : 0);
      cp_async4(cw + e, ok ? (const void*)(a.coeff + g0 + e) : a.coeff,
                ok ? 4 : 0);
    }
    if (MODE != ADDR_TILE)
      for (int k = lane; k < a.k_pad; k += 32)
        cp_async4(tdep + warp * a.k_pad + k,
                  a.dep + (size_t)row * a.k_pad + k, 4);
  } else if (wg == 2 && MODE != ADDR_TILE) {
    for (int k = lane; k < a.k_pad; k += 32) {
      cp_async4(pd + k, a.dep + (size_t)row0 * a.k_pad + k, has0 ? 4 : 0);
      cp_async4(pd + a.k_pad + k, a.dep + (size_t)row1 * a.k_pad + k,
                has1 ? 4 : 0);
    }
  }
  const bool act0 = __shfl_sync(FULL, has0 && cnt0 > 0, 0);
  const bool act1 = __shfl_sync(FULL, has1 && cnt1 > 0, 0);
  const int consumers = (int)act0 + (int)act1;
  const bool share = act0 && act1 && row0 == row1;  // one halo for both
  const int n_stages = a.KK * ((a.C + BK - 1) / BK);
  const int st0 = (int)min((long long)n_stages,
                           (long long)blockIdx.x * n_stages / a.n_split);
  const int st1 = (int)min((long long)n_stages, (long long)(blockIdx.x + 1) *
                                                    n_stages / a.n_split);
  const int n_st = st1 - st0;  // this block's stages
  const int ch0 = st0 / a.KK, kk0 = st0 - ch0 * a.KK;  // its first

  if (tid == 0) {
    const int arrivals = max(1, 4 * consumers);  // a warp each
    for (int i = 0; i < a.ring; ++i) {
      mbar_init(full_w + i, 1);
      mbar_init(empty_w + i, arrivals);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_h + i, 1);
      mbar_init(empty_h + i, arrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // PROF bars

  if (wg == 2) {
    // The producer warp: the halo's chunk ch into buffer ch % 2 at the
    // first stage of the chunk, once the buffer's last chunk is released;
    // stage s (tap s % KK, chunk s / KK) of w into ring slot s % ring, once
    // the slot's last stage is released. TMA boxes from lane 0, or
    // value-by-value copies from every lane. The rows of a slot's chunk:
    // for each of its tiles (TILE: the halo; else the row's live dep tiles
    // that are tiles of x) the x row of its first row and its place in
    // the slot.
    const bool load1 = act1 && !share;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (MODE != ADDR_TILE) {
      for (int k = lane; k < a.k_pad; k += 32) {
        if (!(act0 && k < cnt0)) pd[k] = -1;
        if (!(load1 && k < cnt1)) pd[a.k_pad + k] = -1;
      }
      __syncwarp();
    }
    auto tiles = [&](int sl, auto&& fn) {
      if (sl == 0 ? !act0 : !load1) return;
      if (MODE == ADDR_TILE) {
        fn((sl == 0 ? row0 : row1) * a.tp, 0);
        return;
      }
      for (int k = 0; k < a.k_pad; ++k) {
        const int d = pd[sl * a.k_pad + k];
        if (d >= 0 && d < a.n_x) fn(d * a.tp, k * a.ts);
      }
    };
    // The block's chunk lc (chunk ch0 + lc) of the halo into buffer lc % 2,
    // once that buffer's last chunk is released.
    auto load_halo = [&](int lc) {
      const int hb = lc & 1, c0 = (ch0 + lc) * BK;
      if (lc >= 2) mbar_wait(empty_h + hb, ((lc >> 1) - 1) & 1);
      uint8_t* const buf = halo + 2 * hb * a.hslot;
      if (a.tma_x) {
        if (lane == 0) {
          int bytes = 0;
          for (int sl = 0; sl < 2; ++sl)
            tiles(sl, [&](int, int) { bytes += a.nbox * a.br * HROW; });
          mbar_expect(full_h + hb, bytes);
          for (int sl = 0; sl < 2; ++sl)
            tiles(sl, [&](int xr, int hr) {
              for (int bx = 0; bx < a.nbox; ++bx)
                tma_2d(buf + sl * a.hslot + (hr + bx * a.br) * HROW, &x_map,
                       c0, xr + bx * a.br, full_h + hb);
            });
        }
      } else {
        // Value by value, the chunk's 32 channels of each row.
        for (int sl = 0; sl < 2; ++sl)
          tiles(sl, [&](int xr, int hr) {
            uint8_t* const dst = buf + sl * a.hslot + hr * HROW;
            for (int e = lane; e < a.tp * BK; e += 32) {
              const int r = e / BK, c = e % BK;
              const bf16 v = c0 + c < a.C
                                 ? a.x[(size_t)(xr + r) * a.C + c0 + c]
                                 : __float2bfloat16_rn(0.f);
              *reinterpret_cast<bf16*>(dst + r * HROW + 2 * c) = v;
            }
          });
        __syncwarp();
        if (lane == 0) mbar_arrive(full_h + hb);
      }
    };
    // The block's stage i (stage st0 + i) of w into ring slot i % ring,
    // once the slot's last stage is released.
    auto load_w = [&](int i) {
      const int s = st0 + i, slot = i % a.ring;
      const int ch = s / a.KK, kk = s - ch * a.KK, c0 = ch * BK;
      if (i >= a.ring) mbar_wait(empty_w + slot, (i / a.ring - 1) & 1);
      uint8_t* const dst = ring + slot * WSTAGE;
      if (a.tma_w) {
        if (lane == 0) {
          mbar_expect(full_w + slot, WSTAGE);
          for (int p = 0; p < BO / 64; ++p)
            tma_3d(dst + p * WPANEL, &w_map, o0 + 64 * p, c0, kk,
                   full_w + slot);
        }
      } else {
        // Value by value, 128-B swizzle: 16-byte word j of panel row r at
        // word j ^ (r % 8); zeros past C and O.
        for (int e = lane; e < BK * BO; e += 32) {
          const int r = e / BO, col = e % BO, c = c0 + r, o = o0 + col;
          const bf16 v = c < a.C && o < a.O
                             ? a.w[((size_t)kk * a.C + c) * a.O + o]
                             : __float2bfloat16_rn(0.f);
          const int cc = col & 63;
          *reinterpret_cast<bf16*>(dst + (col >> 6) * WPANEL + r * 128 +
                                   ((((cc >> 3) ^ r) & 7) << 4) +
                                   2 * (cc & 7)) = v;
        }
        // The tensor cores read the ring through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(full_w + slot);
      }
    };
    if (consumers > 0 && n_st > 0) {
      if (lane == 0) {
        if (a.tma_w) prefetch_map(&w_map);
        if (a.tma_x) prefetch_map(&x_map);
        if (a.halo)  // the zero row of each (buffer, slot)
          for (int i = 0; i < 4; ++i) {
            uint4* z = reinterpret_cast<uint4*>(halo + i * a.hslot +
                                                a.hrows * HROW);
            for (int k = 0; k < HROW / 16; ++k) z[k] = make_uint4(0, 0, 0, 0);
          }
      }
      __syncwarp();
      for (int i = 0, kk = kk0, lc = 0; i < n_st; ++i) {
        if (a.halo && (kk == 0 || i == 0)) load_halo(lc);
        load_w(i);
        if (++kk == a.KK) {
          kk = 0;
          ++lc;
        }
      }
    }
    __syncwarp();
  } else if (wg == 0 ? act0 : act1) {
    // Warpgroup wg: unit (row, pixel block pb). Lane (g, t) of warp wi
    // holds the A fragment rows 16 wi + g (+ 8) (pixels), columns 2t,
    // 2t + 1 (+ 8) of each 16-channel step, and the accumulator rows 16 wi
    // + g (+ 8), columns 8j + 2t (+ 1) (output channels).
    const int row = wg ? row1 : row0, pb = wg ? pb1 : pb0;
    const int hs = wg == 1 && !share;  // the unit's halo slot
    const int g = lane >> 2, t = lane & 3;
    int* const src = tsrc + wg * BP * per_px;
    float* const cf = tcf + wg * BP * per_px;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // PROF tabw

    // The warp's 16 pixels: each (pixel, tap, neighbour) resolved once to
    // its place in the halo (the byte offset of its row there) or, on the
    // gather path, its row of x; where it does not count, to the zero row
    // (-1) with a zero coefficient.
    {
      const int live =
          MODE == ADDR_TILE ? 1 : min(wg ? cnt1 : cnt0, a.k_pad);
      int* const dw = tdep + warp * a.k_pad;
      int* const sw = src + 16 * wi * per_px;
      float* const cw = cf + 16 * wi * per_px;
      const int p0 = pb * BP + 16 * wi, n_e = 16 * per_px;
      const int n_ok = max(0, min(16, a.P - p0)) * per_px;
      // A dep slot that holds no tile of x (or is past the row's count)
      // becomes -1; on the halo path #1's slot holds its tile's place in
      // the image (dep % t_in), the key its neighbours match.
      if (MODE != ADDR_TILE) {
        for (int k = lane; k < a.k_pad; k += 32) {
          const int d = dw[k];
          dw[k] = k < live && d >= 0 && d < a.n_x
                      ? (MODE == ADDR_BATCH && a.halo ? d % a.t_in : d)
                      : -1;
        }
        __syncwarp();
      }
      // v / tp for 0 <= v < 2^24: the float quotient, corrected by one.
      auto div_tp = [&](int v) {
        int q = __float2int_rz(__int2float_rn(v) * a.rtp);
        if (q * a.tp > v) --q;
        else if ((q + 1) * a.tp <= v) ++q;
        return q;
      };
      // The first 8 slots' keys in registers (#1 matches against them).
      int dk[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dk[k] = MODE == ADDR_BATCH && k < a.k_pad ? dw[k] : -1;
      // On the gather path a slot's key is the dep itself, matched by its
      // place in the image (the slow path: rows too many for the halo).
      auto match = [&](int m, int tile) {
        return m >= 0 && m % a.t_in == tile;
      };
#pragma unroll 2
      for (int e = lane; e < n_e; e += 32) {
        const int v = sw[e];
        int s = -1;
        if (e < n_ok) {
          if (MODE == ADDR_BATCH) {
            if (v >= 0) {
              const int tile = div_tp(v), off = v - tile * a.tp;
              int kf = -1;
              if (a.halo) {
#pragma unroll
                for (int k = 7; k >= 0; --k)
                  if (dk[k] == tile) kf = k;
                for (int k = 8; kf < 0 && k < live; ++k)
                  if (dw[k] == tile) kf = k;
              } else {
                for (int k = 0; kf < 0 && k < live; ++k)
                  if (match(dw[k], tile)) kf = k;
              }
              if (kf >= 0) s = a.halo ? kf * a.ts + off : dw[kf] * a.tp + off;
            }
          } else if (MODE == ADDR_SCHED) {
            const int k = v >= 0 ? div_tp(v) : a.k_pad;
            if (k < live) {
              const int d = dw[k];
              if (d >= 0)
                s = a.halo ? k * a.ts + (v - k * a.tp)
                           : d * a.tp + (v - k * a.tp);
            }
          } else if (v >= 0 && v < a.tp) {
            s = a.halo ? v : row * a.tp + v;
          }
        }
        if (s < 0) cw[e] = 0.f;
        if (a.halo) {
          const int R = s < 0 ? a.hrows : s;
          s = R * HROW;
        }
        sw[e] = s;
      }
      __syncwarp();
    }
    // PROF tab

    // Stage (tap kk, chunk ch) as A fragments, [step ks][piece][4]:
    // register i + 2h of step ks holds pixel 16 wi + g + 8i, channels 16 ks
    // + 2t + 8h, + 1. A pixel's four neighbours serve both steps: their
    // 16 words (or, on the gather path, 32 values) are loaded together.
    auto interp = [&](int kk, int ch, int lc, uint32_t(&F)[2][3][4]) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = ((16 * wi + g + 8 * i) * a.KK + kk) * 4;
        const int4 s4 = *reinterpret_cast<const int4*>(src + at);
        const float4 f4 = *reinterpret_cast<const float4*>(cf + at);
        const int sj[4] = {s4.x, s4.y, s4.z, s4.w};
        const float fj[4] = {f4.x, f4.y, f4.z, f4.w};
        float v[2][2][2];  // [step ks][half h][channel]
        // One uniform branch around each path, so that its loads are
        // straight-line code the compiler can issue together.
        if (a.halo) {
          const uint8_t* const H =
              halo + (2 * (lc & 1) + hs) * a.hslot + 4 * t;
          uint32_t word[4][4];  // [16-byte word q = 2 ks + h][neighbour]
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              word[q][j] =
                  *reinterpret_cast<const uint32_t*>(H + sj[j] + 16 * q);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v0 = fmaf(fj[j], bf16_lo(word[q][j]), v0);
              v1 = fmaf(fj[j], bf16_hi(word[q][j]), v1);
            }
            v[q >> 1][q & 1][0] = v0;
            v[q >> 1][q & 1][1] = v1;
          }
        } else {
          const int c = ch * BK + 2 * t;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float v0 = 0.f, v1 = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 xv = gather2(a.x, sj[j], c + 8 * q, a.C);
              v0 = fmaf(fj[j], xv.x, v0);
              v1 = fmaf(fj[j], xv.y, v1);
            }
            v[q >> 1][q & 1][0] = v0;
            v[q >> 1][q & 1][1] = v1;
          }
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split3(v[ks][h][0], v[ks][h][1], F[ks][0][i + 2 * h],
                   F[ks][1][i + 2 * h], F[ks][2][i + 2 * h]);
      }
    };
    // D += A (both steps of a stage, three pieces each) * w (the stage's
    // slot), one wgmma group, the smallest piece first. Every register a
    // product reads or writes is pinned around it: ptxas serializes all
    // the products where another instruction writes one inside a group's
    // span.
    float acc[BO / 2];
#pragma unroll
    for (int i = 0; i < BO / 2; ++i) acc[i] = 0.f;
    const uint64_t dw0 = smem_desc_sw(ring, WPANEL, 8 * 128, 128);
    auto pin = [&]() { fence_regs(acc); };
    auto fence6 = [&](uint32_t(&F)[2][3][4]) {
      fence3(F[0]);
      fence3(F[1]);
    };
    auto issue = [&](int slot, uint32_t(&F)[2][3][4]) {
      const uint64_t d = dw0 + ((slot * WSTAGE) >> 4);
      pin();
      fence6(F);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int pc = 2; pc >= 0; --pc)
          wgmma_bf16_rs<BO>(acc, F[ks][pc], d + ((ks * 16 * 128) >> 4), 1);
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Stage s goes to the tensor cores from one buffer while stage s + 1
    // is interpolated into the other; the stage's products are retired
    // before the next, so none is in flight across the loop's back edge.
    uint32_t Fa[2][3][4], Fb[2][3][4];
    // Stage s's tap, chunk, and chunk of the block (its halo buffer).
    int kk = kk0, ch = ch0, lc = 0, slot = 0, phase = 0;
    auto stage = [&](int s, uint32_t(&Fc)[2][3][4],
                     uint32_t(&Fn)[2][3][4]) {
      // PROF t
      mbar_wait(full_w + slot, phase);
      // PROF wfull
      issue(slot, Fc);
      // PROF issue
      if (a.halo && kk == a.KK - 1) release(empty_h + (lc & 1));
      if (++kk == a.KK) {
        kk = 0;
        ++ch;
        ++lc;
        if (a.halo && s + 1 < n_st)
          mbar_wait(full_h + (lc & 1), (lc >> 1) & 1);
      }
      // PROF hwait
      if (s + 1 < n_st) interp(kk, ch, lc, Fn);
      // PROF interp
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin();
      fence6(Fc);
      release(empty_w + slot);
      if (++slot == a.ring) {
        slot = 0;
        phase ^= 1;
      }
      // PROF wwait
    };
    if (n_st > 0) {
      if (a.halo) mbar_wait(full_h, 0);
      interp(kk0, ch0, 0, Fa);
    }
    // PROF loop
    for (int s = 0; s < n_st; s += 2) {
      stage(s, Fa, Fb);
      if (s + 1 < n_st) stage(s + 1, Fb, Fa);
    }
    // PROF epi0
    consumers_sync();  // both warpgroups done with the ring and the halo
    // The block's float32 sums into the stash [unit][pixel][SROW].
    float* const st = stash + (wg * BP + 16 * wi + g) * SROW + 2 * t;
#pragma unroll
    for (int j = 0; j < BO / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(st + 8 * hh * SROW + 8 * j) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  } else {
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // started above
    consumers_sync();
  }
  __syncwarp();
  cluster_sync();  // every rank's sums stashed
  // PROF epi1

  // Rank r's share of the tile (float4s [e0, e1) of [2][BP][BO / 4]), each
  // thread on four fixed output channels: the ranks' sums in split order,
  // then b, rounded once; a unit of a dep_cnt = 0 row writes b. Past one
  // cluster a tile, each cluster's sums go to the workspace instead, and
  // the last of the tile's clusters to count itself in adds them in group
  // order (a ticket a share; the order of the sum is fixed, not the
  // arrival's).
  const int n4 = 2 * BP * BO / 4;
  const bool two_level = a.groups > 1;
  float4* const wsp = reinterpret_cast<float4*>(a.ws) +
                      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * n4;
  const size_t g_stride = (size_t)gridDim.z * gridDim.y * n4;
  const int e0 = rank * n4 / n_rank, e1 = (rank + 1) * n4 / n_rank;
  const int o = o0 + 4 * ((e0 + tid) % (BO / 4));
  const bool vec_out = a.O % 4 == 0 && ((uintptr_t)a.out & 7) == 0;
  float bo[4];
  for (int k = 0; k < 4; ++k)
    bo[k] = o + k < a.O ? __bfloat162float(a.b[o + k]) : 0.f;
  // b as bf16 pairs: the bits of a dep_cnt = 0 row (exact).
  const uint32_t b01 = pack_bf16(bo[0], bo[1]), b23 = pack_bf16(bo[2], bo[3]);
  for (int e = e0 + tid; e < e1 && wg < 2; e += 2 * WG) {
    const int u = e / (BP * BO / 4), px = e / (BO / 4) % BP;
    const int row = u ? row1 : row0, p = (u ? pb1 : pb0) * BP + px;
    if (!(u ? has1 : has0) || p >= a.P || o >= a.O) continue;
    uint32_t y01 = b01, y23 = b23;
    if (u ? act1 : act0) {
      const float* const sp = stash + (u * BP + px) * SROW + (o - o0);
      // Every rank's four sums read at once, then added in split order.
      float4 d[MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q)
        if (q < n_rank) d[q] = ld_peer4(sp, q);
      float4 v = d[0];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q)
        if (q < n_rank) {
          v.x += d[q].x;
          v.y += d[q].y;
          v.z += d[q].z;
          v.w += d[q].w;
        }
      if (two_level) {
        wsp[grp * g_stride + e] = v;
        continue;
      }
      y01 = pack_bf16(v.x + bo[0], v.y + bo[1]);
      y23 = pack_bf16(v.z + bo[2], v.w + bo[3]);
    }
    if (two_level) continue;  // the last cluster writes b
    bf16* const dst = a.out + ((size_t)row * a.P + p) * a.O + o;
    if (vec_out) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(y01, y23);
    } else {
      for (int k = 0; k < 4 && o + k < a.O; ++k)
        dst[k] = __ushort_as_bfloat16(
            (unsigned short)((k < 2 ? y01 : y23) >> (16 * (k & 1))));
    }
  }
  if (two_level && wg < 2) {
    int* const flag = tsrc;  // the tables' place, free by now
    __threadfence();
    consumers_sync();
    if (tid == 0) {
      int* const tk =
          a.tickets + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * n_rank +
          rank;
      const int seen = atomicAdd(tk, 1);
      *flag = seen == a.groups - 1;
      if (seen == a.groups - 1) *tk = 0;  // zero again for the next call
    }
    consumers_sync();
    if (*flag) {
      __threadfence();
      for (int e = e0 + tid; e < e1; e += 2 * WG) {
        const int u = e / (BP * BO / 4), px = e / (BO / 4) % BP;
        const int row = u ? row1 : row0, p = (u ? pb1 : pb0) * BP + px;
        if (!(u ? has1 : has0) || p >= a.P || o >= a.O) continue;
        uint32_t y01 = b01, y23 = b23;
        if (u ? act1 : act0) {
          float4 v = __ldcg(wsp + e);
          for (int q = 1; q < a.groups; ++q) {
            const float4 d = __ldcg(wsp + q * g_stride + e);
            v.x += d.x;
            v.y += d.y;
            v.z += d.z;
            v.w += d.w;
          }
          y01 = pack_bf16(v.x + bo[0], v.y + bo[1]);
          y23 = pack_bf16(v.z + bo[2], v.w + bo[3]);
        }
        bf16* const dst = a.out + ((size_t)row * a.P + p) * a.O + o;
        if (vec_out) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(y01, y23);
        } else {
          for (int k = 0; k < 4 && o + k < a.O; ++k)
            dst[k] = __ushort_as_bfloat16(
                (unsigned short)((k < 2 ? y01 : y23) >> (16 * (k & 1))));
        }
      }
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while a peer reads its stash
  // PROF end
}

// The 3-d tensor map (O, C, KK) of w whose box is one 128-B swizzled panel
// of a stage: 64 output channels x 32 input channels x 1 tap; zeros past O
// and C.
inline cudaError_t w_map_of(CUtensorMap* map, const void* w, int KK, int C,
                            int O) {
  cudaError_t err;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)O, (cuuint64_t)C, (cuuint64_t)KK};
  const cuuint64_t strides[2] = {2ull * O, 2ull * O * C};
  const cuuint32_t box[3] = {64, BK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 2-d tensor map (C, rows) of x whose box is `br` halo rows of a
// chunk, HCH channels each, unswizzled; zeros past C and the last row.
inline cudaError_t x_map_of(CUtensorMap* map, const void* x, long long rows,
                            int C, int br) {
  cudaError_t err;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * C};
  const cuuint32_t box[2] = {HCH, (cuuint32_t)br};
  const cuuint32_t step[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Clusters a tile for n_split slices, ceil(n_split / MAX_CLUSTER), and
// blocks a cluster, the fewest that hold them (the wrapper's
// `fused_cluster` is the same rule in Python). A last cluster may have
// blocks past the last slice: they add zeros.
__host__ __forceinline__ int groups_of(int n_split) {
  return (n_split + MAX_CLUSTER - 1) / MAX_CLUSTER;
}
__host__ __forceinline__ int cluster_of(int n_split) {
  const int g = groups_of(n_split);
  return (n_split + g - 1) / g;
}

// Launch over `rows` grid rows on `stream`: grid (cluster, O / BO,
// ceil(rows * P / BP / 2)) in clusters of (cluster, 1, 1). `n_x` tiles of
// tp rows in x (BATCH, SCHED; TILE: rows halos of tp = S rows); `row_id`
// only for BATCH; the stages (KK taps x ceil(C / BK) chunks) cut into
// n_split slices as even as whole stages allow.
// The halo path runs where two chunks of every unit's halo and a ring of
// MIN_RING stages fit a block's shared memory, else the gather path.
// Returns the first CUDA error (a failed tensor-map encode included).
template <int MODE>
int bf16_launch(const void* x, const void* row_id, const void* dep,
                const void* dep_cnt, const void* idx, const void* coeff,
                const void* w, const void* b, void* ws, void* tickets,
                void* out, int rows, int k_pad, int n_x, int t_in, int tp,
                int P, int KK, int C, int O, int n_split,
                void* stream) {
  if (rows < 1 || P < 1 || O < 1 || C < 1 || KK < 1 || tp < 1 ||
      n_split < 1 || n_split > KK * ((C + BK - 1) / BK))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.row_id = static_cast<const int*>(row_id);
  a.dep = static_cast<const int*>(dep);
  a.dep_cnt = static_cast<const int*>(dep_cnt);
  a.idx = static_cast<const int*>(idx);
  a.coeff = static_cast<const float*>(coeff);
  a.w = static_cast<const bf16*>(w);
  a.b = static_cast<const bf16*>(b);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.rows = rows;
  a.k_pad = k_pad;
  a.n_x = n_x;
  a.t_in = t_in;
  a.tp = tp;
  a.rtp = 1.f / tp;
  a.P = P;
  a.KK = KK;
  a.C = C;
  a.O = O;
  const int cluster = cluster_of(n_split);
  a.groups = groups_of(n_split);
  a.n_split = n_split;
  a.br = min(256, tp);
  a.nbox = (tp + a.br - 1) / a.br;
  a.ts = (a.nbox * a.br + 15) / 16 * 16;  // tiles on 1024-byte boundaries
  a.hrows = (MODE == ADDR_TILE ? 1 : k_pad) * a.ts;
  a.hslot = ((a.hrows + 1) * HROW + 1023) / 1024 * 1024;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  a.halo = layout(MIN_RING, a.hslot, KK, k_pad).total <= limit;
  a.ring = MAX_RING;
  while (a.ring > MIN_RING &&
         layout(a.ring, a.halo ? a.hslot : 0, KK, k_pad).total > limit)
    --a.ring;
  const int smem = layout(a.ring, a.halo ? a.hslot : 0, KK, k_pad).total;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  a.tma_w = O % 8 == 0 && ((uintptr_t)w & 15) == 0;
  a.tma_x = a.halo && C % 8 == 0 && ((uintptr_t)x & 15) == 0;
  CUtensorMap w_map = {}, x_map = {};
  if (a.tma_w) err = w_map_of(&w_map, w, KK, C, O);
  if (err == cudaSuccess && a.tma_x)
    err = x_map_of(&x_map, x,
                   (long long)(MODE == ADDR_TILE ? rows : n_x) * tp, C, a.br);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bf16_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)rows * ((P + BP - 1) / BP);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * a.groups, (O + BO - 1) / BO,
                     (unsigned)((units + 1) / 2));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bf16_kernel<MODE>, w_map, x_map, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of `cluster` blocks the card runs at once (one block an SM, the
// shared memory of a full ring): cudaOccupancyMaxActiveClusters.
inline int bf16_max_clusters(int cluster, int* count) {
  const int smem = layout(MAX_RING, 0, 9, 16).total;
  cudaError_t err = cudaFuncSetAttribute(
      bf16_kernel<ADDR_BATCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(count, bf16_kernel<ADDR_BATCH>,
                                             &cfg);
}

}  // namespace b16
}  // namespace

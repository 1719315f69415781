// Split-KV single-query decode attention over a bf16 cache, for Hopper.
//
// Replaces src/repro/kernels/flash_decode.py `_decode_kernel`
// (`flash_decode`) where the k and v caches are bf16 (q float32 or bf16);
// flash_decode.cu keeps the float32 caches. For q (B, Hq, D) and caches
// k, v (B, S, Hkv, D), q head h reading kv head h / g (g = Hq / Hkv), with
// valid prefix len = lengths[b],
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   keys ki < len (and ki > len - 1 - w with a window w) are visible
//   out = acc / max(l, 1e-30)   (a sequence with no visible key gives 0)
//
// in float32 on the widened cache, the output in q's type, rounded once.
//
// Bound: bytes. Each visible key row of K and V (2 D bytes each) is read
// once and used for 2 g D multiply-adds: ~g / 2 FLOP a byte. At the
// serving shapes the bytes take about a microsecond, so what bounds the
// kernel there is its chain of latencies: launch, `lengths`, the first
// bytes, the math of a block's keys and the merge of its splits.
//
// Design (tools/decode_phases.py times its phases).
// * One cluster of C blocks (C <= 8, the portable limit; the wrapper's
//   `cluster_size` picks it from shapes) per (sequence, kv head): grid
//   (C, B * Hkv). Shared memory is sized for three blocks an SM, at which
//   an H100 runs 45 clusters of 8 at once (30 at two an SM), so a small
//   batch fills the SMs in one wave. Cluster rows take the sequences
//   heaviest first (most visible keys, ties by index): the longest blocks
//   start first and the short ones fill in behind them, which balances a
//   ragged long batch.
// * Each block reads `lengths` once (one coalesced load), ranks the
//   sequences and cuts its own sequence's visible keys: nt stages of TK
//   keys; n splits (nt, or min(num_splits, visible / 64) when the caller
//   forces a count), run by nb = min(C, n) blocks, block j taking the
//   consecutive splits [j n / nb, (j + 1) n / nb) as one range of whole
//   stages (`range_of`; the wrapper's `cluster_ranges` is the same rule
//   in Python). Its first copies are one device-memory read from launch.
// * A producer warp fills a ring of stages, each with a full and an empty
//   mbarrier: K's and V's TK rows as d16(D) / W panels of W values a row,
//   in the TMA's 128, 64 or 32-byte swizzle. Where a block may stream
//   TMA_KEYS keys or more, one TMA box a panel (tensor maps encoded at
//   launch); below, 16-byte cp.async copies from every lane into the same
//   places, whose first bytes land sooner (cp.async.mbarrier.arrive.noinc
//   on the full barrier). One bulk copy a row, with no tensor map,
//   moved 1.17 TB/s at the 32k cache: too many small requests.
// * NC consumer warps take the stages in turn (stage i to warp i % NC) and
//   run both products on the tensor cores with mma.sync m16n8k16 bf16,
//   float32 accumulators: S = Q K^T (rows: the g <= 8 query heads; K by
//   ldmatrix) and O^T = V^T P^T (V by ldmatrix.trans; the S accumulator
//   of a head is, as it stands, the B fragment of P^T). q * scale and p
//   are float32, so each is split into three bf16 pieces whose sum is the
//   value (8 + 8 + 8 bits): three products a step, each exact in float32,
//   give the float32 product, and the function is unchanged (a bf16 P,
//   one piece, would change it). The same math on the CUDA cores was the
//   largest phase of a block's path at llama-3.2-vision's cross cache
//   (43 %, tools/decode_phases.py on an H100; 26 % on the tensor cores).
//   Scores in base 2, the running max over the quad of lanes that holds a
//   head.
// * The warps' states merge in warp order in shared memory, four columns
//   a thread, into the block's (m, l, acc). Each block of the cluster
//   with keys then sends its state into rank 0's shared memory
//   (st.async, counted in bytes on rank 0's merge barrier); rank 0 merges
//   them after its own in split order and writes the output. One cluster
//   barrier, arrived at the start and waited on before the first send,
//   keeps any send from reaching rank 0 before its barrier is set up.
//   Nothing goes through global scratch, there is no ticket, and a launch
//   holds no host state. Two runs are bitwise equal; only the float32
//   summation order depends on the split count.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int TK = 16;            // keys a stage (one consumer warp's unit)
constexpr int NC = 4;             // consumer warps a block
constexpr int NT = 32 * (NC + 1); // and the producer warp
constexpr int MAX_CLUSTER = 8;    // portable cluster size
constexpr int MAX_RING = 8;
constexpr int SPLIT_KEYS = 64;    // fewest keys of a forced split
constexpr int TMA_KEYS = 1024;    // a block's keys from which TMA copies
// Shared memory a block may take so that three fit an SM (228 KB, 1 KB
// of it reserved per block), at which an H100 runs 45 clusters of 8 at
// once (cudaOccupancyMaxActiveClusters; 30 at two blocks an SM). Three
// blocks' consumer warps also hide more latency: at the 32k cache two
// blocks an SM with rings twice as deep ran 1.3x slower (math on the CUDA
// cores).
constexpr int SMEM_BUDGET3 = 75 * 1024;
constexpr int SMEM_BUDGET2 = 113 * 1024;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ long long visible(int len, int S, int window) {
  const long long hi = min((long long)len, (long long)S);
  const long long lo = max(0LL, (long long)len - (long long)window);
  return max(0LL, hi - lo);
}

// D rounded up to whole 16-value steps of the products (the columns past
// D are zeros in q and in the ring).
__host__ __device__ __forceinline__ int d16(int D) {
  return (D + 15) / 16 * 16;
}

// Values a row of a stage's panel holds: the widest of the 128, 64 and
// 32-byte swizzles (64, 32, 16 values) that divides d16(D), or 8 values,
// unswizzled, where D is an odd multiple of 8. A stage is K's d16(D) / W
// panels [TK][W], then V's, each one TMA box.
__host__ __device__ __forceinline__ int panel_w(int D) {
  const int d = d16(D);
  return D % 16 ? 8 : d % 64 == 0 ? 64 : d % 32 == 0 ? 32 : 16;
}

// 32-bit words of a row of q's bf16 pieces: d16(D) / 2 and 4 more, so the
// eight heads' rows start on distinct banks.
__host__ __device__ __forceinline__ int q_words(int D) {
  return d16(D) / 2 + 4;
}

// Offsets (bytes) of a block's shared memory from its 1024-byte aligned
// base: the ring of stages (64 d16(D) bytes each, a multiple of 1024, so
// every panel sits on its swizzle's atom), the full and empty mbarriers
// of the ring and the merge's, the three bf16 pieces of q * scale
// [3][G + 1][q_words] (row G zeros: the products' rows past G read it),
// and the states the cluster's other blocks send (acc [C - 1][G][D], m
// and l [C - 1][G]); `total` counts 1024 bytes to align the base. The
// warps' states are merged in the ring's place.
struct Layout {
  int bars, qp, ra, rm, total;
};

__host__ __device__ __forceinline__ Layout layout(int G, int D, int ring,
                                                  int C) {
  Layout o;
  o.bars = ring * 2 * TK * 2 * d16(D);
  o.qp = o.bars + 16 * ring + 16;
  o.ra = o.qp + 4 * 3 * (G + 1) * q_words(D);
  o.rm = o.ra + 4 * (C - 1) * G * D;
  o.total = 1024 + o.rm + 16 * ((8 * (C - 1) * G + 15) / 16);
  return o;
}

// Stages of the ring: the most, up to MAX_RING and at least NC, that fit
// three blocks an SM (two where not even NC fit); with TMA copies whole
// multiples of NC. Stage i goes to slot i % ring and to warp i % NC. The
// cp.async copies land in issue order, so a slot's phases complete in
// order; the TMA boxes of different stages land in any order, and a warp
// that waited on the parity of a slot's next phase while its last one was
// still open would pass at once: with ring a multiple of NC each slot is
// read by one warp, in order.
__host__ __forceinline__ int ring_of(int G, int D, int C, bool tma) {
  const int step = tma ? NC : 1;
  for (const int budget : {SMEM_BUDGET3, SMEM_BUDGET2})
    for (int ring = MAX_RING; ring >= NC; ring -= step)
      if (layout(G, D, ring, C).total <= budget) return ring;
  return NC;
}

// The sequence of rank r when the batch is ordered by visible keys, most
// first (ties by index), and its length; every lane of the warp returns
// them.
__device__ __forceinline__ int2 ranked(const int* __restrict__ lengths,
                                       int B, int S, int window, int r,
                                       int lane) {
  for (int i0 = 0; i0 < B; i0 += 32) {
    const int i = i0 + lane;
    const int li = i < B ? lengths[i] : 0;
    const long long vi = i < B ? visible(li, S, window) : -1;
    int rank = 0;
    for (int j0 = 0; j0 < B; j0 += 32) {
      const long long vj =
          j0 + lane < B ? visible(lengths[j0 + lane], S, window) : -1;
      const int m = min(32, B - j0);
      for (int t = 0; t < m; ++t) {
        const long long vt = __shfl_sync(0xffffffffu, vj, t);
        rank += vt > vi || (vt == vi && j0 + t < i);
      }
    }
    const unsigned hit = __ballot_sync(0xffffffffu, i < B && rank == r);
    if (hit) {
      const int src = __ffs(hit) - 1;
      return make_int2(i0 + src, __shfl_sync(0xffffffffu, li, src));
    }
  }
  return make_int2(0, 0);  // r >= B: not reached
}

// Block j's keys [a, e) of a sequence of length len, and nb, the blocks
// of its cluster that have keys.
struct Range {
  long long a, e;
  int nb;
};

__device__ __forceinline__ Range range_of(int len, int S, int window, int C,
                                          int num_splits, int j) {
  const long long lo = max(0LL, (long long)len - (long long)window);
  const long long nv = visible(len, S, window);
  if (nv == 0) return {lo, lo, 0};
  const long long nt = (nv + TK - 1) / TK;
  const long long n =
      num_splits > 0
          ? max(1LL, min((long long)num_splits, nv / SPLIT_KEYS))
          : nt;
  const int nb = (int)min((long long)C, n);
  if (j >= nb) return {lo, lo, nb};
  const long long s0 = j * n / nb * nt / n;
  const long long s1 = (j + 1) * n / nb * nt / n;
  return {lo + TK * s0, min(lo + nv, lo + TK * s1), nb};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One probe of an mbarrier's phase of `parity`.
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

// A wait that outlasts ~2^34 cycles (seconds) traps: a barrier that never
// completes surfaces as a launch failure, not as a hung card.
__device__ __forceinline__ void wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// 16 bytes from global `src` to shared `dst` through L2 only, or 16 zero
// bytes where `bytes` is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// An arrival on `bar` once this thread's cp.async copies so far have
// landed (counted in the barrier's init count): in issue order.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// TMA copy of one box of a 4-d tensor map at (c0, c1, c2, c3) into
// `dst`; completes on `bar`.
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

// Four 8x8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), as mma fragments; `trans`: transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b for a 16x16 bf16 A (row-major fragments a0..a3), a 16x8 bf16
// B (b0, b1) and float32 d.
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y as three bf16 pairs whose sums are x and y (8 + 8 + 8
// significant bits): each product with a bf16 value is then exact in
// float32, so three bf16 products give the float32 product.
__device__ __forceinline__ void split3(float x, float y, uint32_t (&w)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x -= __low2float(h);
  y -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x, y);
  x -= __low2float(m);
  y -= __high2float(m);
  w[0] = bits(h);
  w[1] = bits(m);
  w[2] = bits(__floats2bfloat162_rn(x, y));
}

// This block's shared address `p` in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Stores into a peer block's shared memory (`addr` from `peer`), counted
// in bytes on the peer's mbarrier `bar`.
__device__ __forceinline__ void st_async(uint32_t addr, float4 x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float x,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0], %1, [%2];\n" ::"r"(addr),
      "f"(x), "r"(bar)
      : "memory");
}

// The wait for the peers' states on this block's merge barrier: the
// acquire is at cluster scope, where they were written.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// The cluster barrier, in two halves: every block's merge barrier is
// initialised before any block sends to it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The consumer warps' own barrier (the producer does not take part).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC * 32) : "memory");
}

__device__ __forceinline__ void fma4(float4& a, float p, float4 v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// G: query heads a block merges (g <= G; the products take 8 heads, those
// past g zero). DT: 16-value steps of D a thread's O^T registers hold
// (d16(D) / 16 <= DT). q and out are bf16 where `q_bf16`, else float32.
// num_splits > 0 forces the split count rule of the caller's `num_splits`.
template <int G, int DT>
__global__ void __launch_bounds__(NT, 3)
decode_bf16_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const void* __restrict__ q,
                   const int* __restrict__ lengths, void* __restrict__ out,
                   const bf16* __restrict__ k, const bf16* __restrict__ v,
                   int B, int S, int Hq, int Hkv, int D, int ring, int tma,
                   int num_splits, int window, int q_bf16, float scale,
                   float softcap) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const int C = gridDim.x, j = blockIdx.x;  // the block's cluster rank
  const int rk = blockIdx.y / Hkv, hk = blockIdx.y - rk * Hkv;
  const int g = Hq / Hkv, d4 = D / 4, D16 = d16(D), W = panel_w(D);
  const int pb = TK * 2 * W;             // bytes of a panel
  const int half = TK * 2 * D16;         // K's panels, then V's
  const int stage = 2 * half;
  const Layout L = layout(G, D, ring, C);
  uint8_t* const rings = smem;
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* const empty = full + ring;
  uint64_t* const merged = empty + ring;  // the peers' states landed
  uint32_t* const Qp = reinterpret_cast<uint32_t*>(smem + L.qp);
  float* const Ra = reinterpret_cast<float*>(smem + L.ra);
  float* const Rm = reinterpret_cast<float*>(smem + L.rm);
  float* const Rl = Rm + (C - 1) * G;

  // The tensor maps' descriptors fetched while `lengths` is read.
  if (tma && tid == NC * 32) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&k_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&v_map))
                 : "memory");
  }
  // Every warp ranks the batch itself (one read of `lengths`, no block
  // barrier on the way to the first copy).
  const int2 seq = ranked(lengths, B, S, window, rk, lane);
  const int b = seq.x;
  const Range r = range_of(seq.y, S, window, C, num_splits, j);
  const int ns = (int)((r.e - r.a + TK - 1) / TK);  // this block's stages
  const long long bh0 = (long long)b * Hq + (long long)hk * g;
  if (tid == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(full + i, tma ? 1 : 32);  // TMA's arrival, or the lanes'
      mbar_init(empty + i, 1);
    }
    mbar_init(merged, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Rank 0 expects the state of every other block with keys.
    if (j == 0 && r.nb > 1) mbar_expect(merged, (r.nb - 1) * 4 * g * (D + 2));
  }
  __syncthreads();  // the barriers' init and the range, before any wait
  cluster_arrive();

  // Panel rows of W values, swizzled as the TMA lands them: 16-byte
  // word c of row t of a panel sits at word c ^ (bits 7.. of t * 2 W).
  const int swz = 2 * W / 16 - 1;
  if (wi == NC) {
    // The producer: stage i's K and V panels into slot i % ring once the
    // slot's last stage is read (zeros past D and S; keys past the
    // block's range are masked by the consumers). Long ranges: one TMA
    // box a panel from lane 0. Short ones: 16-byte cp.async copies from
    // every lane into the same swizzled places (zeros past the range),
    // each lane's arrival falling due when its copies have landed.
    if (tma) {
      if (lane == 0)
        for (int i = 0; i < ns; ++i) {
          const int slot = i % ring, t0 = (int)(r.a + (long long)i * TK);
          if (i >= ring) wait(empty + slot, (i / ring - 1) & 1);
          mbar_expect(full + slot, stage);
          uint8_t* const dst = rings + slot * stage;
          for (int p = 0; p < D16 / W; ++p) {
            tma_box(dst + p * pb, &k_map, p * W, hk, t0, b, full + slot);
            tma_box(dst + half + p * pb, &v_map, p * W, hk, t0, b,
                    full + slot);
          }
        }
    } else {
      const long long kstride = (long long)Hkv * D;
      const bf16* const kb = k + ((long long)b * S * Hkv + hk) * D;
      const bf16* const vb = v + ((long long)b * S * Hkv + hk) * D;
      // Lane: word cc of rows rr, rr + rpi, ... (in its panel p, word
      // c), so a warp's copies read whole rows.
      const int wpr = D16 / 8, rpi = 32 / wpr;  // words a row, rows a pass
      const int cc = lane % wpr, rr = lane / wpr;
      const int p = cc / (W / 8), c = cc - p * (W / 8);
      for (int i = 0; i < ns; ++i) {
        const int slot = i % ring;
        const long long t0 = r.a + (long long)i * TK;
        const int nk = (int)min((long long)TK, r.e - t0);
        if (i >= ring) wait(empty + slot, (i / ring - 1) & 1);
        uint8_t* const dst = rings + slot * stage + p * pb;
        if (rr < rpi)
          for (int t = rr; t < TK; t += rpi) {
            const int o = t * 2 * W + 16 * c;
            const int at = o ^ (((o >> 7) & swz) << 4);
            const bool ok = t < nk && 8 * cc < D;
            const long long row = ok ? (t0 + t) * kstride + 8 * cc : 0;
            cp_async16(dst + at, kb + row, ok ? 16 : 0);
            cp_async16(dst + half + at, vb + row, ok ? 16 : 0);
          }
        cp_async_arrive(full + slot);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }  // producer
    __syncwarp();
    cluster_wait();
    return;
  }

  // q * scale of the g heads (zeros past g and past D) as three bf16
  // pieces, [piece][head][q_words] over G + 1 heads: in base 2 (times
  // log2 e) for exp2f, or in base e under a soft-cap, whose tanh is taken
  // first.
  const float qscale = softcap > 0.f ? scale : scale * LOG2E;
  const int qw = q_words(D);
  for (int e = tid; e < (G + 1) * D16 / 2; e += NC * 32) {
    const int h = e / (D16 / 2), d = 2 * (e - h * (D16 / 2));
    float x = 0.f, y = 0.f;
    if (h < g && d < D && ns > 0) {
      const long long at = (bh0 + h) * D + d;
      if (q_bf16) {
        x = __bfloat162float(static_cast<const bf16*>(q)[at]);
        y = __bfloat162float(static_cast<const bf16*>(q)[at + 1]);
      } else {
        x = static_cast<const float*>(q)[at];
        y = static_cast<const float*>(q)[at + 1];
      }
    }
    uint32_t w[3];
    split3(x * qscale, y * qscale, w);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
      Qp[(pc * (G + 1) + h) * qw + d / 2] = w[pc];
  }
  consumer_sync();  // Qp

  // Fragments of the m16n8k16 products (gq = lane / 4, tq = lane % 4).
  // S = Q K^T: rows are heads (gq; rows 8-15 zero), columns the stage's
  // keys 2 tq, 2 tq + 1 (+ 8). O^T = V^T P^T: rows are columns of D
  // (16 mt + gq, + 8), columns the heads 2 tq, 2 tq + 1. The S
  // accumulator of head gq is, as it stands, the B fragment of P^T.
  const int gq = lane >> 2, tq = lane & 3, qrow = min(gq, G);
  // ldmatrix rows: key (lane % 8) + 8 (lane / 16) of the stage, 8 values
  // from column 16 ks + 8 ((lane / 8) % 2): in panel col / W, 16-byte
  // word (col % W) / 8 of the key's row, which the swizzle XORs with bits
  // 7.. of the row's offset (a lane's own constant: a row is 2 W <= 128
  // bytes, so the word stays within bits 4-6).
  const int lkey = (lane & 7) + ((lane >> 4) << 3);
  const int lcol = 8 * ((lane >> 3) & 1);
  const int wlog = 31 - __clz(W);
  const int lrow = lkey * 2 * W, lx = ((lrow >> 7) & swz) << 4;
  auto lds_off = [&](int ks) {
    const int col = 16 * ks + lcol;
    return (uint32_t)((col >> wlog) * pb + lrow +
                      ((2 * (col & (W - 1))) ^ lx));
  };
  float m = NEG_INF, l = 0.f;  // head gq's running max and this lane's sum
  float o[DT][4];              // O^T, steps past d16(D) / 16 unused
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  for (int i = wi; i < ns; i += NC) {
    const int slot = i % ring;
    wait(full + slot, (i / ring) & 1);
    const uint32_t Ks = smem_u32(rings + slot * stage);
    const uint32_t Vs = Ks + half;
    const int nk = (int)min((long long)TK, r.e - r.a - (long long)i * TK);
    if (tma && nk < TK) {
      // The keys past the range: V's rows zeroed (they may be any
      // values, and P V multiplies them by 0); the scores are masked.
      for (int e = lane; e < (TK - nk) * (D16 / 8); e += 32) {
        const int t = nk + e / (D16 / 8), w = e % (D16 / 8);
        const int p = w / (W / 8);
        *reinterpret_cast<uint4*>(rings + slot * stage + half + p * pb +
                                  t * 2 * W + 16 * (w - p * (W / 8))) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
    }

    // S = Q K^T in three products a step (q's pieces), each summed apart.
    float sc[3][2][4];
#pragma unroll
    for (int pc = 0; pc < 3; ++pc)
#pragma unroll
      for (int u = 0; u < 8; ++u) sc[pc][u / 4][u % 4] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DT; ++ks) {
      if (ks >= D16 / 16) break;
      uint32_t kf[4];
      ldsm4(kf, Ks + lds_off(ks));
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
        const uint32_t* const qr = Qp + (pc * (G + 1) + qrow) * qw +
                                   8 * ks + tq;
        const uint32_t a0 = qr[0], a2 = qr[4];
        mma(sc[pc][0], a0, 0u, a2, 0u, kf[0], kf[1]);
        mma(sc[pc][1], a0, 0u, a2, 0u, kf[2], kf[3]);
      }
    }
    // Head gq's scores of keys 2 tq, 2 tq + 1, 8 + 2 tq, 9 + 2 tq.
    float x[4];
    bool valid[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int nt = u / 2, c = u % 2;
      float y = (sc[2][nt][c] + sc[1][nt][c]) + sc[0][nt][c];
      if (softcap > 0.f) y = tanhf(y / softcap) * (softcap * LOG2E);
      valid[u] = 8 * nt + 2 * tq + c < nk;
      x[u] = valid[u] ? y : NEG_INF;
    }
    float mt = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mn = fmaxf(m, mt);
    float p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      p[u] = valid[u] ? exp2f(x[u] - mn) : 0.f;
    const float alpha = exp2f(m - mn);
    l = l * alpha + ((p[0] + p[1]) + (p[2] + p[3]));
    m = mn;
    // O^T's columns are heads 2 tq and 2 tq + 1: their rescales.
    const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * tq);
    const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * tq + 4);
    uint32_t pb0[3], pb1[3];
    split3(p[0], p[1], pb0);
    split3(p[2], p[3], pb1);
#pragma unroll
    for (int mt16 = 0; mt16 < DT; ++mt16) {
      if (mt16 >= D16 / 16) break;
      o[mt16][0] *= al0;
      o[mt16][1] *= al1;
      o[mt16][2] *= al0;
      o[mt16][3] *= al1;
      uint32_t vf[4];
      ldsm4_trans(vf, Vs + lds_off(mt16));
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        mma(o[mt16], vf[0], vf[1], vf[2], vf[3], pb0[pc], pb1[pc]);
    }
    __syncwarp();  // the stage read
    if (lane == 0) mbar_arrive(empty + slot);
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  consumer_sync();  // every warp done with the ring

  // The warps' states where the ring was, merged in warp order into the
  // block's (m, l, acc): four columns a thread.
  float* const Wa = reinterpret_cast<float*>(rings);  // [NC][G][D]
  float* const Wm = Wa + NC * G * D;                  // [NC][G]
  float* const Wl = Wm + NC * G;                      // [NC][G]
  if (tq == 0 && gq < G) {
    Wm[wi * G + gq] = m;
    Wl[wi * G + gq] = l;
  }
#pragma unroll
  for (int mt16 = 0; mt16 < DT; ++mt16)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = 16 * mt16 + gq + 8 * (u / 2), h = 2 * tq + u % 2;
      if (h < G && d < D) Wa[(wi * G + h) * D + d] = o[mt16][u];
    }
  consumer_sync();
  // The cluster's blocks with keys send their states to rank 0, which
  // merges them after its own in split order (one pass, the running max
  // rescaling the sums) and writes the output (zeros where no key is
  // visible).
  cluster_wait();
  const uint32_t bar0 = peer(merged, 0);
  for (int e = tid; e < g * d4 && j < max(r.nb, 1); e += NC * 32) {
    const int h = e / d4, c = e - h * d4;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NC; ++w) mx = fmaxf(mx, Wm[w * G + h]);
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NC; ++w) {
      const float f = exp2f(Wm[w * G + h] - mx);
      den += Wl[w * G + h] * f;
      fma4(num, f, *reinterpret_cast<const float4*>(
                       Wa + (w * G + h) * D + 4 * c));
    }
    if (j > 0) {
      st_async(peer(Ra + ((j - 1) * G * D + 4 * e), 0), num, bar0);
      if (c == 0) {
        st_async(peer(Rm + (j - 1) * G + h, 0), mx, bar0);
        st_async(peer(Rl + (j - 1) * G + h, 0), den, bar0);
      }
      continue;
    }
    if (r.nb > 1) wait_cluster(merged, 0);
    for (int i = 0; i < r.nb - 1; ++i) {
      const float mi = Rm[i * G + h], li = Rl[i * G + h];
      const float4 ai =
          *reinterpret_cast<const float4*>(Ra + i * G * D + 4 * e);
      const float mn = fmaxf(mx, mi);
      const float fo = exp2f(mx - mn), fi = exp2f(mi - mn);
      den = den * fo + li * fi;
      num = make_float4(num.x * fo + ai.x * fi, num.y * fo + ai.y * fi,
                        num.z * fo + ai.z * fi, num.w * fo + ai.w * fi);
      mx = mn;
    }
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const float o[4] = {num.x * inv, num.y * inv, num.z * inv, num.w * inv};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q_bf16)
        static_cast<bf16*>(out)[bh0 * D + 4 * e + u] =
            __float2bfloat16_rn(o[u]);
      else
        static_cast<float*>(out)[bh0 * D + 4 * e + u] = o[u];
    }
  }
}

// The 4-d tensor map (d, kv head, key, batch) of a bf16 cache (B, S, Hkv,
// D) whose box is one panel of a stage: W values x 1 x TK keys x 1, in
// the panel's swizzle; zeros past D and S.
cudaError_t panel_map(CUtensorMap* map, const void* x, int B, int S,
                      int Hkv, int D) {
  cudaError_t err;
  const PFN_cuTensorMapEncodeTiled_v12000 encode =
      hop::tensor_map_encoder(&err);
  if (encode == nullptr) return err;
  const int W = panel_w(D);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * Hkv,
                                 2ull * D * Hkv * S};
  const cuuint32_t box[4] = {(cuuint32_t)W, 1, (cuuint32_t)TK, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      W == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
      : W == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch: grid (C, B * Hkv) in clusters of (C, 1, 1).
template <int G, int DT>
cudaError_t launch(int C, cudaStream_t st, const void* q, const void* k,
                   const void* v, const void* lengths, void* out, int B,
                   int S, int Hq, int Hkv, int D, int num_splits, int window,
                   int q_bf16, float scale, float softcap) {
  // TMA copies where a block may stream TMA_KEYS keys or more (a 32k
  // cache), cp.async ones below (their first bytes land sooner).
  const long long longest = (min((long long)S, (long long)window) + C - 1) / C;
  const bool tma = longest >= TMA_KEYS;
  const int ring = ring_of(G, D, C, tma);
  const int smem = layout(G, D, ring, C).total;
  CUtensorMap k_map = {}, v_map = {};
  cudaError_t err = cudaSuccess;
  if (tma) {
    err = panel_map(&k_map, k, B, S, Hkv, D);
    if (err == cudaSuccess) err = panel_map(&v_map, v, B, S, Hkv, D);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_bf16_kernel<G, DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B * Hkv);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_bf16_kernel<G, DT>, k_map, v_map, q,
                           static_cast<const int*>(lengths), out,
                           static_cast<const bf16*>(k),
                           static_cast<const bf16*>(v), B, S, Hq, Hkv, D,
                           ring, (int)tma, num_splits, window, q_bf16, scale,
                           softcap);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// k, v bf16 (D a multiple of 8, at most 256), q and out bf16 where
// `q_bf16`, else float32; `cluster` the blocks a (sequence, kv head), 1
// to 8; `num_splits` > 0 forces min(num_splits, visible / 64) splits a
// sequence (at least one), 0 takes one a stage.
extern "C" int flash_decode_bf16_launch(const void* q, const void* k,
                                        const void* v, const void* lengths,
                                        void* out, int B, int S, int Hq,
                                        int Hkv, int D, int cluster,
                                        int num_splits, int window,
                                        int q_bf16, float scale,
                                        float softcap, void* stream) {
  if (D % 8 || D < 8 || D > 256 || Hkv < 1 || Hq % Hkv || Hq / Hkv > 8 ||
      cluster < 1 || cluster > MAX_CLUSTER || num_splits < 0 || B < 1 ||
      (long long)B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // O^T registers for 8, 9 or 16 steps of 16 values (D <= 128, D <= 144,
  // D <= 256).
  const int g = Hq / Hkv, dt = (D + 15) / 16;
  const auto pick = [dt](auto l8, auto l9, auto l16) {
    return dt <= 8 ? l8 : dt <= 9 ? l9 : l16;
  };
  const auto run = g == 1   ? pick(launch<1, 8>, launch<1, 9>, launch<1, 16>)
                   : g == 2 ? pick(launch<2, 8>, launch<2, 9>, launch<2, 16>)
                   : g <= 4 ? pick(launch<4, 8>, launch<4, 9>, launch<4, 16>)
                            : pick(launch<8, 8>, launch<8, 9>, launch<8, 16>);
  return (int)run(cluster, st, q, k, v, lengths, out, B, S, Hq, Hkv, D,
                  num_splits, window, q_bf16, scale, softcap);
}

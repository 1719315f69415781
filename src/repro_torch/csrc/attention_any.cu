// General bodies of flash attention (#7) and split-KV decode (#8) for
// Hopper: every head dim, group, alignment and row count the TPU kernels
// take, with both products on the tensor cores.
//
// Replaces, for the shapes the fast bodies refuse, the same two TPU kernels
// as flash_attention.cu and flash_decode.cu / flash_decode_bf16.cu:
// src/repro/kernels/flash_attention.py `_flash_kernel` and
// src/repro/kernels/flash_decode.py `_decode_kernel`. Those take any head
// dim D, any number of query heads over a kv head, any batch and any
// operand address; the fast bodies take D up to 144 (#7) or 256 (#8) in
// whole 16-byte words, at most 8 query heads a kv head (#8), 16-byte
// aligned operands and, over a bf16 cache, B * Hkv <= 65535. The wrappers'
// `attention_body` / `decode_body` send every other shape here, chosen from
// shapes, types and pointer alignment before any launch; the launch plan
// (rows, column warps, key tile, ring stages, copy widths, splits) is the
// wrappers' `general_plan`, and `layout` below is its shared-memory rule.
// A head dim whose smallest tiles pass the shared memory (from 1185 over
// float32 caches, 1409 in 16 bits) takes attention_wide.cu instead.
//
// Both are one function over "rows" that share a kv head: a row is a query
// with its own key range [lo, hi), and
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   out = sum_k p v / max(sum_k p, 1e-30),  p = exp(s - max s) over the
//         row's keys, 0 elsewhere (a row with no key gives 0)
//
// #7 (mode 0): row r of a block is query i0 + r of head h, the absolute key
//   time qi = i + Skv - Sq, keys [max(0, qi - w + 1), causal ? qi + 1 :
//   Skv) within [0, Skv); q, k, v and out of one type.
// #8 (mode 1): row r is query head r of the block's chunk of the kv head's
//   group, keys [max(0, len - w), min(len, S)), cut into splits; q and out
//   of one type, the caches of theirs, each K and V value rounded to bf16 or
//   float16 where it is read when `rk` says so (a wider cache under a
//   narrower model, as the JAX decode path casts the cache to x's type).
//
// Bound: #7 operations (4 D flops a visible (query, key) pair: 990 TFLOP/s
// in bf16 / fp16, 3xTF32 at 495 / 3 = 165 in float32); #8 bytes (each
// visible K and V row read once, at 3.35 TB/s).
//
// Design (tools/any_phases.py times its phases).
// * Tensor cores for both products, mma.sync with float32 accumulators.
//   q, k, v all bf16 or all float16 (the "16-bit" body): m16n8k16, operands
//   by ldmatrix, P rounded to the operands' type for P V, as the fast 16-bit
//   body does. Every other mix (the "TF32" body): m16n8k8 .tf32, q * scale
//   float32 in shared memory split into a TF32 high and low part; a float32
//   K or V value splits the same way (3xTF32: hi hi + hi lo + lo hi); a
//   bf16 or float16 value, or one rounded to either (`rk`), is exact in
//   TF32, so only q and P split (two products). Scores in base 2 (log2 e in
//   q's scale, or in the soft-cap).
// * Scores once per (row, key). A block holds `rf` row fragments of 16 rows
//   (a warp's MMA rows) and `cw` column warps a fragment: D is zero-padded
//   to a multiple of 16 and O's columns are cut into `cw` slices of at most
//   256 (a warp's 16 rows x 256 columns are 128 float32 registers a
//   thread). Per key tile the fragment's `cs` S warps each score a disjoint
//   run of the tile's keys over all of D; the row maxima meet in shared
//   memory (a named barrier a fragment), P lands once in shared memory and
//   every column warp multiplies it into its own slice of V.
// * Copies that match the operand. K and V tiles of `bk` keys (64; fewer
//   where a wide D would pass the shared memory) go through a ring of 2 to 4
//   stages, so the next tiles' copies run during this tile's products; each
//   tile lands as panels of 128 bytes a row in the 128-byte swizzle (the
//   16-byte chunk c of row r at c ^ (r % 8): ldmatrix and the TF32 loads
//   read it without bank conflicts). Per tensor, the plan's widest copy its
//   base pointer and row pitch allow: a TMA box a panel, issued by one
//   thread and counted on the stage's mbarrier (16-byte rows: a cp.async
//   copy of each 16 bytes stalled the block's warps on the load / store
//   pipe, which also holds their ldmatrix, by ~4K cycles a 64 KB tile),
//   else 4-byte cp.async, else element loads (a 16-bit view at an odd
//   offset), all into the same swizzled panels. q lands once by cp.async.
// * #7: a block takes 16 rf query rows of one (batch, head); blocks run the
//   longest query tiles first. Key tiles outside every row's range are never
//   visited (the loop runs over the rows' union) and only edge tiles are
//   masked. The grid's x dimension carries the (tile, batch, head) blocks,
//   up to 2^31 - 1.
// * #8: the group's query heads are the MMA rows (16 a fragment, up to two
//   fragments a block: Falcon's 71 heads over one kv head are three blocks
//   of up to 32), so a K / V tile is read once a chunk of 32 heads. Each
//   sequence's visible keys are cut as flash_decode.cu cuts them
//   (`split_of`, kv_split.cuh; the wrapper's `split_ranges`):
//   one block a (sequence, kv head, group chunk, split) on the grid's x
//   dimension; a sequence with one split writes out, else each split writes
//   its (m, l, acc) to a float32 scratch and the last block to finish (an
//   atomic ticket it resets to 0) merges them in split order.
// * The output (or a split's state) goes through shared memory (the rings'
//   and q's place) and out in whole rows, one type switch a block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_split.cuh"
#include "tma.cuh"

namespace {

constexpr int MAX_WARPS = 8;   // warps a block
constexpr int MAX_NB = 32;     // n8 blocks of O a column warp holds (256)
constexpr int MAX_SB = 8;      // n8 blocks of S an S warp scores (64 keys)
constexpr int MAX_STAGES = 4;  // K / V tiles of the ring
constexpr int SMEM_LIMIT = 232448;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// The block's shared memory for head dim D, `rf` row fragments, `cw`
// column warps, `bk`-key tiles and `stages` ring stages; `half` the 16-bit
// body, `ksz` the bytes of a K / V value. From a 1024-byte aligned base:
// the K ring [stages][panels][bk][128 B] and the V ring (panels of `wk`
// values, dpw = the panels' columns), Q [16 rf][ldq] (the 16-bit body: q
// as given; TF32: q * scale in float32), P [rf][16][ldp] (the 16-bit body
// in the operands' type, TF32 in float32), the row maxima and sums
// [2][rf][cw][16] float32, the ring's mbarriers and the merge flag. After
// the key loop the output stage [16 rf][lds] float32 takes the rings' and
// Q's place; `bytes` counts 1024 to align the base. Row pitches keep the
// fragment loads free of bank conflicts and every row on 16 bytes.
struct Layout {
  int dp, colw, cs, kw, wk, dpw;
  int ldq, ldp, lds;
  int v_off, q_off, p_off, x_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int D, int rf, int cw, int bk,
                                         int stages, bool half, int ksz) {
  Layout o;
  o.dp = (D + 15) / 16 * 16;
  o.colw = ((o.dp + cw - 1) / cw + 15) / 16 * 16;
  const int steps = bk / (half ? 16 : 8);
  o.cs = 1;
  while (2 * o.cs <= cw && 2 * o.cs <= steps) o.cs *= 2;
  o.kw = bk / o.cs;
  o.wk = 128 / ksz;
  o.dpw = (o.dp + o.wk - 1) / o.wk * o.wk;
  const int qsz = half ? 2 : 4;
  o.ldq = half ? o.dp + 8 : o.dp + 4;
  o.ldp = half ? bk + 8 : bk + 4;
  o.lds = o.dp + 4;
  o.v_off = stages * bk * o.dpw * ksz;
  o.q_off = 2 * o.v_off;
  const int q_end = o.q_off + 16 * rf * o.ldq * qsz;
  const int stage = 16 * rf * o.lds * 4;
  o.p_off = q_end > stage ? q_end : stage;
  o.x_off = o.p_off + rf * 16 * o.ldp * qsz;
  o.bar_off = o.x_off + 2 * rf * cw * 16 * 4;
  o.bytes = o.bar_off + 8 * MAX_STAGES + 16 + 1024;
  return o;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;  // mode 1
  float* part_ml;      // mode 1, splits > 1: [2][B * Hq][splits]
  float* part_acc;     //   [B * Hq][splits][D], on 16 bytes
  int* ticket;         //   [B * Hkv][row_tiles], 0 on entry and exit
  void* out;
  int mode;            // 0: #7, 1: #8
  int B, Sq, Skv, Hq, Hkv, D;
  int causal, window, q_type, splits, target;
  int rf, cw, bk, stages, cq, ck, cv;  // ck, cv 16: TMA boxes
  float scale, softcap;
  long long row_tiles;  // mode 0: query tiles a (batch, head); 1: chunks
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

// x rounded to bf16 (RK 1) or float16 (RK 2), widened back; RK 0 leaves it.
template <int RK>
__device__ __forceinline__ float rounded(float x) {
  if constexpr (RK == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if constexpr (RK == 2) return __half2float(__float2half_rn(x));
  return x;
}

__device__ __forceinline__ float load(const void* p, long long i, int type) {
  if (type == 1)
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
  if (type == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// Rows [0, n) of a row-major float tile of pitch `ld`, `cols` values each,
// to p[first + r * stride + c] as T (a warp a row, lanes along it).
template <typename T>
__device__ __noinline__ void store_rows(void* p, long long first,
                                           long long stride, const float* x,
                                           int ld, int n, int cols, int warp,
                                           int nw, int lane) {
  T* o = static_cast<T*>(p) + first;
  for (int r = warp; r < n; r += nw)
    for (int c = lane; c < cols; c += 32) {
      const float y = x[r * ld + c];
      if constexpr (std::is_same<T, bf16>::value)
        o[r * stride + c] = __float2bfloat16_rn(y);
      else if constexpr (std::is_same<T, __half>::value)
        o[r * stride + c] = __float2half_rn(y);
      else
        o[r * stride + c] = y;
    }
}

// The same in the output's type (0 float32, 1 bf16, 2 float16).
__device__ __forceinline__ void store_out(int type, void* p, long long first,
                                          long long stride, const float* x,
                                          int ld, int n, int cols, int warp,
                                          int nw, int lane) {
  if (type == 1)
    store_rows<bf16>(p, first, stride, x, ld, n, cols, warp, nw, lane);
  else if (type == 2)
    store_rows<__half>(p, first, stride, x, ld, n, cols, warp, nw, lane);
  else
    store_rows<float>(p, first, stride, x, ld, n, cols, warp, nw, lane);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA copy of one box of a 4-d tensor map at (c0, c1, c2, c3) into dst;
// completes on `bar`.
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b, m16n8k16, 16-bit operands of T, float32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, bf16>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, m16n8k8 TF32, float32 accumulators.
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// 2^x (ex2.approx: 2^-22 relative; what falls below float32's normal range
// flushes to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) as 1 - 2 / (e^(2x) + 1): a few instructions, absolute error
// ~1e-7 (a soft-cap c scales it to ~1e-7 c in a score).
__device__ __forceinline__ float tanh_short(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// x = hi + lo, both TF32 (the low part of the residual is below float32's
// 24 bits of the product's accuracy).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Byte offset of value (row r, column c) in a ring tile of `bk` rows:
// panels of 128 bytes a row (`wk` values of `sz` bytes), the 16-byte chunk
// j of row r at j ^ (r % 8) (the TMA's 128-byte swizzle).
__device__ __forceinline__ int swz(int r, int c, int bk, int wk, int sz) {
  const int p = c / wk, b = (c - p * wk) * sz;
  return p * bk * 128 + r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// Rows [0, nrows) of a row-major tile of pitch `ld` (values of T): row r <
// nvalid gets the D values at src[first + r * stride ..], the rest zeros.
// `width` is the copy: 16 or 4 bytes (cp.async; the caller commits), else
// one value a load.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          long long first, long long stride,
                                          int nrows, int nvalid, int D,
                                          int width, int tid, int nt) {
  if (width == 16 || width == 4) {
    const int E = width / (int)sizeof(T);  // values a copy
    const int W = D / E;                   // copies a row
    for (int e = tid; e < nrows * W; e += nt) {
      const int r = e / W, col = (e - r * W) * E;
      const bool ok = r < nvalid;
      const T* s = ok ? src + first + r * stride + col : src;
      if (width == 16)
        cp_async16(dst + r * ld + col, s, ok ? 16 : 0);
      else
        cp_async4(dst + r * ld + col, s, ok ? 4 : 0);
    }
  } else {
    using U = typename std::conditional<sizeof(T) == 2, uint16_t,
                                        uint32_t>::type;
    const U* s = reinterpret_cast<const U*>(src);
    U* d = reinterpret_cast<U*>(dst);
    for (int e = tid; e < nrows * D; e += nt) {
      const int r = e / D, col = e - r * D;
      d[r * ld + col] = r < nvalid ? s[first + r * stride + col] : U(0);
    }
  }
}

// The same into a ring tile's swizzled panels (4-byte cp.async or element
// loads; the 16-byte rows take TMA boxes). Columns past D are left as
// they are (zeros from the kernel's start).
template <typename T>
__device__ __noinline__ void copy_panels(unsigned char* dst,
                                            const T* src, long long first,
                                            long long stride, int bk,
                                            int nvalid, int D, int wk,
                                            int width, int tid, int nt) {
  constexpr int sz = sizeof(T);
  if (width == 4) {
    const int E = 4 / sz, W = D / E;
    for (int e = tid; e < bk * W; e += nt) {
      const int r = e / W, col = (e - r * W) * E;
      const bool ok = r < nvalid;
      cp_async4(dst + swz(r, col, bk, wk, sz),
                ok ? src + first + r * stride + col : src, ok ? 4 : 0);
    }
  } else {
    using U = typename std::conditional<sz == 2, uint16_t, uint32_t>::type;
    const U* s = reinterpret_cast<const U*>(src);
    for (int e = tid; e < bk * D; e += nt) {
      const int r = e / D, col = e - r * D;
      *reinterpret_cast<U*>(dst + swz(r, col, bk, wk, sz)) =
          r < nvalid ? s[first + r * stride + col] : U(0);
    }
  }
}

// Thread 0: the TMA boxes of a ring stage's K and / or V panels (null map:
// that tensor takes cp.async), counted on the stage's mbarrier `bar`.
__device__ __noinline__ void issue_boxes(const CUtensorMap* km,
                                         const CUtensorMap* vm,
                                         unsigned char* kdst,
                                         unsigned char* vdst, uint64_t* bar,
                                         int tx_bytes, int panels, int bk,
                                         int wk, int hk, int t0, int b) {
  fence_async_smem();  // the stage's earlier reads before the writes
  hop::mbar_expect(bar, tx_bytes);
  for (int p = 0; p < panels; ++p) {
    if (km) tma_4d(kdst + p * bk * 128, km, p * wk, hk, t0, b, bar);
    if (vm) tma_4d(vdst + p * bk * 128, vm, p * wk, hk, t0, b, bar);
  }
}

// Zeros in rows [from, bk) of a ring tile's panels.
__device__ __noinline__ void zero_tail(unsigned char* tile, int panels,
                                       int bk, int from, int tid, int nt) {
  const int zr = (bk - from) * 8;  // 16-byte chunks a panel
  for (int e = tid; e < panels * zr; e += nt) {
    const int p = e / zr;
    reinterpret_cast<uint4*>(tile + p * bk * 128 + from * 128)[e - p * zr] =
        make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
}

// KT: the caches' type (k, v), RK: K and V rounded to bf16 (1) or float16
// (2) where read; HALF: the 16-bit body (q of KT, RK 0), else TF32 (q of
// any type, `a.q_type`); NB: n8 blocks of O a column warp holds (16: 128
// columns; 32: 256). `k_map`, `v_map`: the caches' tensor maps where they
// take TMA boxes. The key loop's code is kept short (rare paths out of
// line): a longer loop ran out of the instruction cache.
template <typename KT, int RK, bool HALF, int NB>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
attention_any_kernel(const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const Args a) {
  using QT = typename std::conditional<HALF, KT, float>::type;
  constexpr bool KEXACT = !std::is_same<KT, float>::value || RK != 0;
  constexpr int KSZ = sizeof(KT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Layout L = layout(a.D, a.rf, a.cw, a.bk, a.stages, HALF, KSZ);
  unsigned char* Kr = smem;
  unsigned char* Vr = smem + L.v_off;
  QT* Qs = reinterpret_cast<QT*>(smem + L.q_off);
  QT* Ps = reinterpret_cast<QT*>(smem + L.p_off);
  float* Xm = reinterpret_cast<float*>(smem + L.x_off);  // [rf][cw][16]
  float* Xl = Xm + a.rf * a.cw * 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  int* flag = reinterpret_cast<int*>(full + MAX_STAGES);

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, f = warp / a.cw, c = warp - f * a.cw;
  const int g = lane >> 2, t = lane & 3;
  const int rows = 16 * a.rf, group = a.Hq / a.Hkv, dp = L.dp, bk = a.bk;
  const int tile_bytes = bk * L.dpw * KSZ;  // a ring stage of K (or V)
  const int bx = blockIdx.x;

  // The block's (batch b, kv head hk), its rows (row r at q / out element
  // q_first + r * q_stride, r < q_valid), the union [k_lo, k_hi) of their
  // key ranges and [max_lo, min_hi) the keys every row sees; this thread's
  // rows 16 f + g and 16 f + g + 8 see [rlo, rhi).
  int b, hk, q_valid, sp = 0, ne = 1, k_lo, k_hi, max_lo, min_hi, rlo[2],
      rhi[2];
  long long q_first, q_stride, pair = 0, chunk = 0, bh0 = 0;
  if (a.mode == 0) {
    // Every factor of the grid's x dimension (< 2^31) fits 32 bits.
    const int bhs = a.B * a.Hq, tq = bx / bhs, bh = bx - tq * bhs;
    const long long tile = a.row_tiles - 1 - tq;  // the longest first
    b = bh / a.Hq;
    const int h = bh - b * a.Hq;
    hk = h / group;
    const long long i0 = tile * rows;
    q_valid = (int)min((long long)rows, (long long)a.Sq - i0);
    q_stride = (long long)a.Hq * a.D;
    q_first = ((long long)b * a.Sq + i0) * q_stride + (long long)h * a.D;
    const long long off = (long long)a.Skv - a.Sq;
    auto lo_of = [&](long long i) {
      return (int)max(0LL, i + off - (long long)a.window + 1);
    };
    auto hi_of = [&](long long i) {
      return (int)(a.causal ? max(0LL, min((long long)a.Skv, i + off + 1))
                            : (long long)a.Skv);
    };
    k_lo = lo_of(i0);
    k_hi = hi_of(i0 + q_valid - 1);
    max_lo = lo_of(i0 + q_valid - 1);
    min_hi = hi_of(i0);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * f + g + 8 * j;
      rlo[j] = r < q_valid ? lo_of(i0 + r) : 0;
      rhi[j] = r < q_valid ? hi_of(i0 + r) : 0;
    }
  } else {
    const int per = (int)a.row_tiles * a.splits, pr = bx / per;
    const int rem = bx - pr * per, ch = rem / a.splits;
    pair = pr;
    chunk = ch;
    sp = rem - ch * a.splits;
    b = pr / a.Hkv;
    hk = pr - b * a.Hkv;
    q_valid = (int)min((long long)rows, (long long)group - chunk * rows);
    q_stride = a.D;
    bh0 = (long long)b * a.Hq + (long long)hk * group + chunk * rows;
    q_first = bh0 * a.D;
    // One split needs no key count (each warp sums the batch's).
    const long long keys =
        a.splits > 1 ? kv_split::keys_a_split(a.lengths, a.B, a.Skv,
                                              a.window, a.Hkv, a.target, lane)
                     : kv_split::MIN_KEYS;
    const kv_split::Split s = kv_split::split_of(a.lengths[b], a.Skv,
                                                 a.window, a.splits, keys, sp);
    ne = max(s.n, 1);
    if (sp >= ne) return;
    k_lo = max_lo = (int)s.a;
    k_hi = min_hi = (int)s.e;
    rlo[0] = rlo[1] = k_lo;
    rhi[0] = rhi[1] = k_hi;
  }
  // Scores in base 2: log2 e folded into q's scale, or into the soft-cap.
  const float qscale = a.softcap > 0.f ? a.scale : a.scale * LOG2E;
  const float cap2 = a.softcap * LOG2E;
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  const long long kv_stride = (long long)a.Hkv * a.D;
  const long long kv_first = ((long long)b * a.Skv * a.Hkv + hk) * a.D;
  const bool tma_k = a.ck == 16, tma_v = a.cv == 16;
  const int panels = L.dpw / L.wk;
  const int tx_bytes = (tma_k + tma_v) * tile_bytes;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) hop::mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The cp.async routes leave a tile's columns past D as they find them:
  // zeros, once, before any copy.
  if (!tma_k || !tma_v) {
    for (int e = tid; e < 2 * L.v_off / 16; e += nt)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0, 0, 0, 0);
    fence_async_smem();
  }
  __syncthreads();
  if constexpr (HALF) {
    if (a.D < dp) {
      const int w = dp - a.D;
      for (int e = tid; e < rows * w; e += nt) {
        const int r = e / w;
        reinterpret_cast<uint16_t*>(Qs)[r * L.ldq + a.D + e - r * w] = 0;
      }
    }
    copy_rows<KT>(Qs, L.ldq, static_cast<const KT*>(a.q), q_first, q_stride,
                  rows, q_valid, a.D, a.cq, tid, nt);
  } else {
    for (int e = tid; e < rows * dp; e += nt) {
      const int r = e / dp, col = e - r * dp;
      Qs[r * L.ldq + col] =
          r < q_valid && col < a.D
              ? load(a.q, q_first + r * q_stride + col, a.q_type) * qscale
              : 0.f;
    }
  }
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + bk - 1) / bk : 0;
  // Tile i of the block's keys into ring stage i % stages (copies past
  // k_hi: zeros, or past the cache for a TMA box); always one copy group.
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int t0 = k_lo + i * bk, nv = min(bk, k_hi - t0);
      const int st = i % a.stages;
      if ((tma_k || tma_v) && tid == 0)
        issue_boxes(tma_k ? &k_map : nullptr, tma_v ? &v_map : nullptr,
                    Kr + st * tile_bytes, Vr + st * tile_bytes, full + st,
                    tx_bytes, panels, bk, L.wk, hk, t0, b);
      const long long first = kv_first + (long long)t0 * kv_stride;
      if (!tma_k)
        copy_panels<KT>(Kr + st * tile_bytes, static_cast<const KT*>(a.k),
                        first, kv_stride, bk, nv, a.D, L.wk, a.ck, tid, nt);
      if (!tma_v)
        copy_panels<KT>(Vr + st * tile_bytes, static_cast<const KT*>(a.v),
                        first, kv_stride, bk, nv, a.D, L.wk, a.cv, tid, nt);
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int i = 0; i < a.stages - 1; ++i) issue(i);

  // This warp: O's columns [col0, col0 + 8 nob); as an S warp (c < cs) the
  // tile's keys [kb, kb + 8 nsb). m: the rows' running max (base 2), equal
  // in the fragment's warps; l: this thread's share of the running sums.
  const int col0 = c * L.colw;
  const int nob = max(0, min(L.colw, dp - col0)) / 8;
  const bool s_warp = c < L.cs;
  const int kb = c * L.kw, nsb = L.kw / 8;
  const int bar_id = 1 + f, bar_n = 32 * a.cw;
  float o[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % a.stages;
    cp_async_wait(a.stages - 2);  // tile i (and q), this thread's copies
    if (tma_k || tma_v) hop::mbar_wait(full + st, (i / a.stages) & 1);
    __syncthreads();  // every thread's copies; tile i - 1 read by all
    const int t0 = k_lo + i * bk, nv = min(bk, k_hi - t0);
    if (tma_v && nv < bk && a.mode == 1) {
      // A TMA box reads the cache past the split's end: rows past the
      // sequence's length may hold anything, and 0 x NaN is NaN in P V.
      zero_tail(Vr + st * tile_bytes, panels, bk, nv, tid, nt);
      __syncthreads();
    }
    issue(i + a.stages - 1);  // into the stage tile i - 1 left
    const bool masked = !(t0 >= max_lo && t0 + bk <= min_hi);
    const unsigned char* Ks = Kr + st * tile_bytes;
    const unsigned char* Vs = Vr + st * tile_bytes;

    // S for keys [kb, kb + 8 nsb) of the tile over all of D.
    float s[MAX_SB][4];
#pragma unroll
    for (int j = 0; j < MAX_SB; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    float mt[2] = {NEG_INF, NEG_INF};
    if (s_warp) {
      if constexpr (HALF) {
        const uint32_t qa0 = smem_u32(Qs + (16 * f + (lane & 15)) * L.ldq +
                                      (lane >> 4) * 8);
        // Lane's K row kb + 16 jp + (lane & 7) + 8 (lane >> 4): its row's
        // swizzle is lane & 7.
        const uint32_t kb0 =
            smem_u32(Ks) + (kb + (lane & 7) + (lane >> 4) * 8) * 128;
        for (int k0 = 0; k0 < dp; k0 += 16) {
          // The step's fragments first, then its products.
          const int p = k0 / 64;
          const int ch =
              ((((k0 - 64 * p) >> 3) + ((lane >> 3) & 1)) ^ lane) & 7;
          const uint32_t kp = kb0 + p * bk * 128 + ch * 16;
          uint32_t qa[4], kf[MAX_SB / 2][4];
          ldsm4(qa, qa0 + 2 * k0);
#pragma unroll
          for (int jp = 0; jp < MAX_SB / 2; ++jp)
            if (2 * jp < nsb && kb + 16 * jp < nv)
              ldsm4(kf[jp], kp + 16 * jp * 128);
#pragma unroll
          for (int jp = 0; jp < MAX_SB / 2; ++jp) {
            if (2 * jp < nsb && kb + 16 * jp < nv) {
              mma16<KT>(s[2 * jp], qa, kf[jp][0], kf[jp][1]);
              mma16<KT>(s[2 * jp + 1], qa, kf[jp][2], kf[jp][3]);
            }
          }
        }
      } else {
        const float* q0 = Qs + (16 * f + g) * L.ldq + t;
        for (int k0 = 0; k0 < dp; k0 += 8) {
          uint32_t ah[4], al[4];
          split(q0[k0], ah[0], al[0]);
          split(q0[k0 + 8 * L.ldq], ah[1], al[1]);
          split(q0[k0 + 4], ah[2], al[2]);
          split(q0[k0 + 8 * L.ldq + 4], ah[3], al[3]);
          // Lane's K rows kb + 8 j + g: their swizzle is g.
          const unsigned char* k0r = Ks + swz(kb + g, k0 + t, bk, L.wk, KSZ);
          const unsigned char* k1r =
              Ks + swz(kb + g, k0 + t + 4, bk, L.wk, KSZ);
#pragma unroll
          for (int j = 0; j < MAX_SB; ++j) {
            if (j < nsb && kb + 8 * j < nv) {
              const float x0 = rounded<RK>(
                  widen(*reinterpret_cast<const KT*>(k0r + 8 * j * 128)));
              const float x1 = rounded<RK>(
                  widen(*reinterpret_cast<const KT*>(k1r + 8 * j * 128)));
              if constexpr (KEXACT) {
                const uint32_t b0 = __float_as_uint(x0);
                const uint32_t b1 = __float_as_uint(x1);
                mma8(s[j], al, b0, b1);
                mma8(s[j], ah, b0, b1);
              } else {
                uint32_t bh0, bl0, bh1, bl1;
                split(x0, bh0, bl0);
                split(x1, bh1, bl1);
                mma8(s[j], al, bh0, bh1);
                mma8(s[j], ah, bl0, bl1);
                mma8(s[j], ah, bh0, bh1);
              }
            }
          }
        }
      }
      // Scale, soft-cap, mask, each a pass of its own taken only where it
      // applies (a short loop body); the rows' maxima over the warp's keys.
      if constexpr (HALF) {
#pragma unroll
        for (int j = 0; j < MAX_SB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= qscale;
      }
      if (a.softcap > 0.f) {
#pragma unroll
        for (int j = 0; j < MAX_SB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = tanh_short(s[j][e] * inv_cap) * cap2;
      }
      if (masked) {  // keys [lo, hi) of the tile, row by row
        int lo[2], hi[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          lo[rr] = min(max(rlo[rr] - t0, 0), bk);
          hi[rr] = min(max(rhi[rr] - t0, 0), nv);
        }
#pragma unroll
        for (int j = 0; j < MAX_SB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1, kk = kb + 8 * j + 2 * t + (e & 1);
            s[j][e] = kk >= lo[rr] && kk < hi[rr] ? s[j][e] : NEG_INF;
          }
      }
#pragma unroll
      for (int j = 0; j < MAX_SB; ++j) {
        if (j < nsb) {
          mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
          mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 1));
        mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], 2));
      }
    }
    if (a.cw > 1) {  // the fragment's S warps' maxima meet
      if (s_warp && t == 0) {
        Xm[(f * a.cw + c) * 16 + g] = mt[0];
        Xm[(f * a.cw + c) * 16 + g + 8] = mt[1];
      }
      bar_sync(bar_id, bar_n);
      for (int cc = 0; cc < L.cs; ++cc) {
        mt[0] = fmaxf(mt[0], Xm[(f * a.cw + cc) * 16 + g]);
        mt[1] = fmaxf(mt[1], Xm[(f * a.cw + cc) * 16 + g + 8]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float mn = fmaxf(m[rr], mt[rr]);
      alpha[rr] = exp2_approx(m[rr] - mn);
      m[rr] = mn;
      l[rr] *= alpha[rr];
    }
    if (s_warp) {  // P = exp2(s - m), to shared memory
#pragma unroll
      for (int j = 0; j < MAX_SB; ++j) {
        if (j < nsb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const float p =
                s[j][e] <= NEG_INF ? 0.f : exp2_approx(s[j][e] - m[rr]);
            s[j][e] = p;
            l[rr] += p;
          }
          QT* pr = Ps + (16 * f + g) * L.ldp + kb + 8 * j + 2 * t;
          if constexpr (HALF) {
            if constexpr (std::is_same<KT, bf16>::value) {
              *reinterpret_cast<__nv_bfloat162*>(pr) =
                  __floats2bfloat162_rn(s[j][0], s[j][1]);
              *reinterpret_cast<__nv_bfloat162*>(pr + 8 * L.ldp) =
                  __floats2bfloat162_rn(s[j][2], s[j][3]);
            } else {
              *reinterpret_cast<__half2*>(pr) =
                  __floats2half2_rn(s[j][0], s[j][1]);
              *reinterpret_cast<__half2*>(pr + 8 * L.ldp) =
                  __floats2half2_rn(s[j][2], s[j][3]);
            }
          } else {
            *reinterpret_cast<float2*>(pr) = make_float2(s[j][0], s[j][1]);
            *reinterpret_cast<float2*>(pr + 8 * L.ldp) =
                make_float2(s[j][2], s[j][3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {  // columns past nob stay 0
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    if (a.cw > 1)
      bar_sync(bar_id, bar_n);  // the fragment's P written
    else
      __syncwarp();

    // O[:, col0 ..] += P V over the tile's keys.
    if constexpr (HALF) {
      const uint32_t pa0 = smem_u32(Ps + (16 * f + (lane & 15)) * L.ldp +
                                    (lane >> 4) * 8);
      // Lane's V row 16 ks + (lane & 7) + 8 ((lane >> 3) & 1): its swizzle
      // is lane & 7; its columns col0 + 16 jp + 8 (lane >> 4).
      const uint32_t vb0 =
          smem_u32(Vs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * 128;
#pragma unroll 1
      for (int ks = 0; ks < MAX_SB / 2; ++ks) {
        if (16 * ks < bk && 16 * ks < nv) {
          uint32_t pa[4];
          ldsm4(pa, pa0 + 2 * 16 * ks);
          // Four V fragments (64 columns) ahead of their products.
#pragma unroll
          for (int jq = 0; jq < NB / 8; ++jq) {
            uint32_t vf[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int col = col0 + 16 * (4 * jq + u) + (lane >> 4) * 8;
              const int p = col / 64;
              if (2 * (4 * jq + u) < nob)
                ldsm4t(vf[u], vb0 + p * bk * 128 + 16 * ks * 128 +
                                  ((((col - 64 * p) >> 3) ^ lane) & 7) * 16);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int jp = 4 * jq + u;
              if (2 * jp < nob) {
                mma16<KT>(o[2 * jp], pa, vf[u][0], vf[u][1]);
                mma16<KT>(o[2 * jp + 1], pa, vf[u][2], vf[u][3]);
              }
            }
          }
        }
      }
    } else {
#pragma unroll 1
      for (int ks = 0; ks < MAX_SB; ++ks) {
        if (8 * ks < bk && 8 * ks < nv) {
          const float* pr = Ps + (16 * f + g) * L.ldp + 8 * ks + t;
          uint32_t ah[4], al[4];
          split(pr[0], ah[0], al[0]);
          split(pr[8 * L.ldp], ah[1], al[1]);
          split(pr[4], ah[2], al[2]);
          split(pr[8 * L.ldp + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (j < nob) {
              const int col = col0 + 8 * j + g;
              const float x0 = rounded<RK>(widen(*reinterpret_cast<const KT*>(
                  Vs + swz(8 * ks + t, col, bk, L.wk, KSZ))));
              const float x1 = rounded<RK>(widen(*reinterpret_cast<const KT*>(
                  Vs + swz(8 * ks + t + 4, col, bk, L.wk, KSZ))));
              if constexpr (KEXACT) {
                const uint32_t b0 = __float_as_uint(x0);
                const uint32_t b1 = __float_as_uint(x1);
                mma8(o[j], al, b0, b1);
                mma8(o[j], ah, b0, b1);
              } else {
                uint32_t bh0, bl0, bh1, bl1;
                split(x0, bh0, bl0);
                split(x1, bh1, bl1);
                mma8(o[j], al, bh0, bh1);
                mma8(o[j], ah, bl0, bl1);
                mma8(o[j], ah, bh0, bh1);
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait(0);

  // The rows' sums: over the quad, then over the fragment's warps.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  if (a.cw > 1) {
    if (t == 0) {
      Xl[(f * a.cw + c) * 16 + g] = l[0];
      Xl[(f * a.cw + c) * 16 + g + 8] = l[1];
    }
    bar_sync(bar_id, bar_n);
    l[0] = l[1] = 0.f;
    for (int cc = 0; cc < a.cw; ++cc) {
      l[0] += Xl[(f * a.cw + cc) * 16 + g];
      l[1] += Xl[(f * a.cw + cc) * 16 + g + 8];
    }
  }

  // The block's rows to the stage (the rings' and q's place): O / l, or a
  // split's raw (m, l, acc).
  const bool direct = a.mode == 0 || ne == 1;
  __syncthreads();  // every warp done with the rings and q
  float* stage = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 16 * f + g + 8 * rr;
    const float inv = direct ? 1.f / fmaxf(l[rr], 1e-30f) : 1.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < nob)
        *reinterpret_cast<float2*>(stage + r * L.lds + col0 + 8 * j + 2 * t) =
            make_float2(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
    if (c == 0 && t == 0) {
      Xm[r] = m[rr];
      Xl[r] = l[rr];
    }
  }
  __syncthreads();
  const int nw = nt / 32;
  if (direct) {
    store_out(a.q_type, a.out, q_first, q_stride, stage, L.lds, q_valid,
              a.D, warp, nw, lane);
    return;
  }
  const long long n_rows = (long long)a.B * a.Hq;
  store_rows<float>(a.part_acc, (bh0 * a.splits + sp) * a.D,
                    (long long)a.splits * a.D, stage, L.lds, q_valid, a.D,
                    warp, nw, lane);
  for (int r = tid; r < q_valid; r += nt) {
    a.part_ml[(bh0 + r) * a.splits + sp] = Xm[r];
    a.part_ml[(n_rows + bh0 + r) * a.splits + sp] = Xl[r];
  }

  // The last of the sequence's ne blocks (this chunk) merges the splits.
  __threadfence();
  __syncthreads();
  int* ticket = a.ticket + pair * a.row_tiles + chunk;
  if (tid == 0) *flag = atomicAdd(ticket, 1) == ne - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // Two passes, each with many loads in flight (one dependent round trip
  // to L2 per eight splits): a thread a row finds the row's max M over the
  // splits and its sum den = sum_i l_i 2^(m_i - M) (Xm, Xl); then each
  // thread sums acc_i 2^(m_i - M) in split order for IT values (or four
  // values' float4s) at once into the stage, which goes out in whole rows.
  for (int r = tid; r < q_valid; r += nt) {
    const float* pm = a.part_ml + (bh0 + r) * a.splits;
    const float* pl = a.part_ml + (n_rows + bh0 + r) * a.splits;
    float mx = NEG_INF, den = 0.f;
    for (int i0 = 0; i0 < ne; i0 += 8) {
      // Splits past ne re-read the last one and weigh nothing.
      float mi[8], li[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = min(i0 + u, ne - 1);
        mi[u] = __ldcg(pm + i);
        li[u] = i0 + u < ne ? __ldcg(pl + i) : 0.f;
      }
      float mb = mx;
#pragma unroll
      for (int u = 0; u < 8; ++u) mb = fmaxf(mb, mi[u]);
      den *= exp2_approx(mx - mb);
#pragma unroll
      for (int u = 0; u < 8; ++u) den += li[u] * exp2_approx(mi[u] - mb);
      mx = mb;
    }
    Xm[r] = mx;
    Xl[r] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int per = a.D % 4 == 0 ? 4 : 1;  // values a thread's load
  const int groups = a.D / per, items = q_valid * groups;
  constexpr int IT = 4;  // items a thread carries through the splits
  for (int e0 = tid; e0 < items; e0 += IT * nt) {
    const float* pm[IT];
    const float* pa[IT];
    float mx[IT];
    float4 num[IT];
#pragma unroll
    for (int h = 0; h < IT; ++h) {
      const int e = min(e0 + h * nt, items - 1);
      const int r = e / groups, d = (e - r * groups) * per;
      pm[h] = a.part_ml + (bh0 + r) * a.splits;
      pa[h] = a.part_acc + (bh0 + r) * a.splits * a.D + d;
      mx[h] = Xm[r];
      num[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i0 = 0; i0 < ne; i0 += 8) {
      float mi[IT][8];
      float4 ai[IT][8];
#pragma unroll
      for (int h = 0; h < IT; ++h)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = min(i0 + u, ne - 1);
          const float* src = pa[h] + (long long)i * a.D;
          mi[h][u] = i0 + u < ne ? __ldcg(pm[h] + i) : NEG_INF;
          ai[h][u] = per == 4 ? __ldcg(reinterpret_cast<const float4*>(src))
                              : make_float4(__ldcg(src), 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int h = 0; h < IT; ++h)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float w = exp2_approx(mi[h][u] - mx[h]);
          num[h].x += ai[h][u].x * w;
          num[h].y += ai[h][u].y * w;
          num[h].z += ai[h][u].z * w;
          num[h].w += ai[h][u].w * w;
        }
    }
#pragma unroll
    for (int h = 0; h < IT; ++h) {
      const int e = e0 + h * nt;
      if (e < items) {
        const int r = e / groups, d = (e - r * groups) * per;
        const float inv = 1.f / Xl[r];
        float* x = stage + r * L.lds + d;
        x[0] = num[h].x * inv;
        if (per == 4) {
          x[1] = num[h].y * inv;
          x[2] = num[h].z * inv;
          x[3] = num[h].w * inv;
        }
      }
    }
  }
  __syncthreads();
  store_out(a.q_type, a.out, q_first, q_stride, stage, L.lds, q_valid, a.D,
            warp, nw, lane);
  if (tid == 0) *ticket = 0;
}

template <typename KT, int RK, bool HALF, int NB>
cudaError_t run_nb(const CUtensorMap& km, const CUtensorMap& vm,
                   const Args& a, unsigned blocks, int threads, int smem,
                   cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      attention_any_kernel<KT, RK, HALF, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_any_kernel<KT, RK, HALF, NB>
      <<<blocks, threads, smem, st>>>(km, vm, a);
  return cudaGetLastError();
}

// The instance whose registers hold `colw` columns of O.
template <typename KT, int RK, bool HALF>
cudaError_t run(const CUtensorMap& km, const CUtensorMap& vm, const Args& a,
                int colw, unsigned blocks, int threads, int smem,
                cudaStream_t st) {
  return colw <= 128
             ? run_nb<KT, RK, HALF, 16>(km, vm, a, blocks, threads, smem, st)
             : run_nb<KT, RK, HALF, 32>(km, vm, a, blocks, threads, smem, st);
}

int type_size(int type) { return type == 0 ? 4 : 2; }

// A copy of `width` bytes takes every row of D values of `size` bytes
// from base p: 16 or 4 bytes (or one value) dividing both.
bool copy_ok(const void* p, int width, int D, int size) {
  if (width != 16 && width != 4 && width != size) return false;
  return (uintptr_t)p % width == 0 && ((long long)D * size) % width == 0;
}

bool half_body(int q_type, int kv_type, int rk) {
  return q_type == kv_type && kv_type != 0 && rk == 0;
}

// The 4-d tensor map (d, kv head, key, batch) of a cache (B, S, Hkv, D) of
// `type` whose box is one ring panel: 128 bytes of a row x bk keys, in the
// 128-byte swizzle; zeros past D and S.
cudaError_t panel_map(CUtensorMap* map, const void* x, int B, int S,
                      int Hkv, int D, int bk, int type) {
  cudaError_t err;
  const PFN_cuTensorMapEncodeTiled_v12000 encode =
      hop::tensor_map_encoder(&err);
  if (encode == nullptr) return err;
  const cuuint64_t sz = type_size(type);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {sz * D, sz * D * Hkv, sz * D * Hkv * S};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / sz), 1, (cuuint32_t)bk, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapDataType dt =
      type == 1   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
      : type == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult res = encode(
      map, dt, 4, const_cast<void*>(x), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Shared memory of a launch of the plan (rf, cw, bk, stages) at head dim D
// (the wrappers' `general_plan` computes the same).
extern "C" int attention_any_smem_bytes(int D, int rf, int cw, int bk,
                                        int stages, int q_type, int kv_type,
                                        int rk) {
  if (rk == kv_type) rk = 0;
  return layout(D, rf, cw, bk, stages, half_body(q_type, kv_type, rk),
                type_size(kv_type))
      .bytes;
}

// mode 0 (#7): q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), out like q;
// `lengths`, `part`, `ticket` unused. mode 1 (#8): q / out (B, Hq, D),
// caches (B, Skv, Hkv, D), `lengths` (B,) int32, `causal` unused; with
// `splits` > 1, `part` (16-byte aligned) holds (2 + D) * B * Hq * splits
// + 4 floats and `ticket` B * Hkv * (group chunks) ints that are 0 on
// entry and again on exit; `target` the blocks of equal work the split
// rule aims at (INT32_MAX: 64 keys a split). `window` INT32_MAX for none,
// `softcap` 0 for none; type codes 0 float32, 1 bf16, 2 float16; `rk`
// rounds K and V to bf16 (1) or float16 (2) where read. The plan: `rf` row
// fragments of 16 rows and `cw` column warps a block, `bk`-key tiles in a
// ring of `stages`, copy widths `cq`, `ck`, `cv` (16, 4 or the value's
// size; 16 for k or v: TMA boxes) for q, k, v.
extern "C" int attention_any_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* part, void* ticket, void* out, int mode, int B, int Sq, int Skv,
    int Hq, int Hkv, int D, int causal, int window, int q_type, int kv_type,
    int rk, int rf, int cw, int bk, int stages, int cq, int ck, int cv,
    int splits, int target, float scale, float softcap, void* stream) {
  if (rk == kv_type) rk = 0;
  const bool half = half_body(q_type, kv_type, rk);
  if (B < 0 || Sq < 0 || Skv < 0 || Hkv < 1 || Hq < 1 || Hq % Hkv ||
      D < 1 || window < 1 || q_type < 0 || q_type > 2 || kv_type < 0 ||
      kv_type > 2 || rk < 0 || rk > 2 || (mode != 0 && mode != 1) ||
      rf < 1 || cw < 1 || rf * cw > MAX_WARPS ||
      (bk != 64 && bk != 32 && bk != 16 && (bk != 8 || half)) ||
      stages < 2 || stages > MAX_STAGES || splits < 1 || target < 1 ||
      (mode == 0 && splits != 1) || (mode == 1 && !lengths) ||
      (mode == 1 && splits > 1 && (!part || !ticket)) ||
      !copy_ok(q, cq, D, type_size(q_type)) ||
      !copy_ok(k, ck, D, type_size(kv_type)) ||
      !copy_ok(v, cv, D, type_size(kv_type)))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(D, rf, cw, bk, stages, half, type_size(kv_type));
  if (L.colw > 8 * MAX_NB || cw * L.colw < L.dp || L.bytes > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const long long g = Hq / Hkv, rows = 16LL * rf;
  const long long row_tiles =
      mode == 0 ? ((long long)Sq + rows - 1) / rows : (g + rows - 1) / rows;
  const long long pairs =
      mode == 0 ? (long long)B * Hq : (long long)B * Hkv;
  const long long blocks = pairs * row_tiles * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  CUtensorMap km{}, vm{};
  cudaError_t err = cudaSuccess;
  if (ck == 16) err = panel_map(&km, k, B, Skv, Hkv, D, bk, kv_type);
  if (err == cudaSuccess && cv == 16)
    err = panel_map(&vm, v, B, Skv, Hkv, D, bk, kv_type);
  if (err != cudaSuccess) return (int)err;
  float* ml = static_cast<float*>(part);
  Args a{q,
         k,
         v,
         static_cast<const int*>(lengths),
         ml,
         ml ? ml + ((size_t)2 * B * Hq * splits + 3) / 4 * 4 : nullptr,
         static_cast<int*>(ticket),
         out,
         mode,
         B,
         Sq,
         Skv,
         Hq,
         Hkv,
         D,
         causal,
         window,
         q_type,
         splits,
         target,
         rf,
         cw,
         bk,
         stages,
         cq,
         ck,
         cv,
         scale,
         softcap,
         row_tiles};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n = (unsigned)blocks;
  const int threads = 32 * rf * cw, sm = L.bytes, cl = L.colw;
  if (half)
    err = kv_type == 1
              ? run<bf16, 0, true>(km, vm, a, cl, n, threads, sm, st)
              : run<__half, 0, true>(km, vm, a, cl, n, threads, sm, st);
  else if (kv_type == 0)
    err = rk == 1   ? run<float, 1, false>(km, vm, a, cl, n, threads, sm, st)
          : rk == 2 ? run<float, 2, false>(km, vm, a, cl, n, threads, sm, st)
                    : run<float, 0, false>(km, vm, a, cl, n, threads, sm, st);
  else if (kv_type == 1)
    err = rk == 2 ? run<bf16, 2, false>(km, vm, a, cl, n, threads, sm, st)
                  : run<bf16, 0, false>(km, vm, a, cl, n, threads, sm, st);
  else
    err = rk == 1 ? run<__half, 1, false>(km, vm, a, cl, n, threads, sm, st)
                  : run<__half, 0, false>(km, vm, a, cl, n, threads, sm, st);
  return (int)err;
}

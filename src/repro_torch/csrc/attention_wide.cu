// The wide-head-dim path of the general bodies of flash attention (#7) and
// split-KV decode (#8): the head dims whose whole-D tiles do not fit the
// tensor-core general body's shared memory (attention_any.cu).
//
// Replaces, for those shapes, the same two TPU kernels as attention_any.cu:
// src/repro/kernels/flash_attention.py `_flash_kernel` and
// src/repro/kernels/flash_decode.py `_decode_kernel`, which take any head
// dim D. The tensor-core body holds q, its K / V ring and an output stage
// of all of D in one block's shared memory, which from D 1185 over
// float32 caches, 1409 with q and the caches 16-bit and 1793 for another q
// over 16-bit caches does not fit. The wrappers' `general_plan` gives
// those shapes the plan "wide" and `general_launch` sends them here; every
// other general shape takes attention_any.cu.
//
// Both are one function over "rows" that share a kv head: a row is a query
// with its own key range [lo, hi), and
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   out = sum_k p v / max(sum_k p, 1e-30),  p = exp(s - max s) over the
//         row's keys, 0 elsewhere (a row with no key gives 0)
//
// #7 (mode 0): row r of a block is query i = 32 * tile + r of head h, the
//   absolute key time qi = i + Skv - Sq, keys [max(0, qi - w + 1),
//   causal ? qi + 1 : Skv) within [0, Skv); q, k, v and out of one type.
// #8 (mode 1): row r is query head 8 * chunk + r of the kv head's group
//   (groups of any size, in chunks of 8), keys [max(0, len - w), min(len,
//   S)), not split; q and out of one type, the caches of theirs, each K
//   and V value rounded to bf16 or float16 where it is read when `rk` says
//   so.
//
// Types: q / out and k / v each float32, bf16 or float16 (a type code a
// pair: 0, 1, 2), widened exactly to float32; every sum is float32 and the
// output is rounded once to q's type.
//
// Bound: the same work as attention_any.cu's (operations for #7, bytes for
// #8); this path does not approach it. Its shared memory is at most 25 KB
// whatever D is, which is what it is for: it is the simple form, on CUDA
// cores, right at every head dim.
//
// Design. Block (row tile, output-column slice): 128 threads, 4 R rows (R
// a warp: 8 for #7, whose rows share every key tile, 2 for #8), DV = 128
// output columns (lane l owns columns l + 32 j of the slice), so any D is
// ceil(D / 128) blocks side by side, each recomputing the scores. Keys go
// in tiles of 32, lane = key. A tile's scores are summed over D in chunks
// of 32 dimensions: the chunk of K (32 keys x 32 dims) and of the rows' q
// land in shared memory by element loads (any alignment, zeros past D and
// past the keys), each lane sums its key's products for its warp's R rows.
// Then the online softmax in base 2 on warp shuffles, the tile's V slice
// (32 keys x 128 columns) in shared memory, and P V in registers. The
// grid's x dimension carries the rows' tiles (up to 2^31 - 1 blocks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128, NW = NT / 32, BK = 32, DC = 32, DV = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float load(const void* p, long long i, int type) {
  if (type == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (type == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float x,
                                      int type) {
  if (type == 1)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else if (type == 2)
    static_cast<__half*>(p)[i] = __float2half_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

// x rounded to bf16 (rk 1) or float16 (rk 2), widened back; rk 0 leaves it.
__device__ __forceinline__ float rounded(float x, int rk) {
  if (rk == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (rk == 2) return __half2float(__float2half_rn(x));
  return x;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;  // mode 1
  void* out;
  int mode;            // 0: #7, 1: #8
  int B, Sq, Skv, Hq, Hkv, D;
  int causal, window;
  int q_type, kv_type, rk;
  float scale, softcap;
  long long row_tiles;  // tiles of 4 R rows a (batch, head) pair
};

// R: rows a warp (4 R a block).
template <int R>
__global__ void __launch_bounds__(NT)
attention_wide_kernel(const Args a) {
  constexpr int ROWS = NW * R;
  __shared__ float Ks[BK][DC + 1];
  __shared__ float Qs[ROWS][DC];
  __shared__ float Vs[BK][DV];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bx = blockIdx.x;
  const int g = a.Hq / a.Hkv;
  const int dv0 = blockIdx.y * DV;

  // The block's pair (batch b, kv head hk) and its rows: row r's q / out
  // element offset, key range [lo, hi) (empty past the rows), and whether
  // it is a row (bit r of `rows`; a row with no key writes 0).
  int b, hk;
  long long q_off[ROWS], lo[ROWS], hi[ROWS];
  unsigned rows = 0;
  if (a.mode == 0) {
    const long long bh = bx / a.row_tiles, tile = bx - bh * a.row_tiles;
    b = (int)(bh / a.Hq);
    const int h = (int)(bh - (long long)b * a.Hq);
    hk = h / g;
    const long long off = (long long)a.Skv - a.Sq;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long i = tile * ROWS + r;
      const long long qi = i + off;
      q_off[r] = ((b * (long long)a.Sq + i) * a.Hq + h) * a.D;
      hi[r] = a.causal ? min((long long)a.Skv, qi + 1) : (long long)a.Skv;
      lo[r] = max(0LL, qi - (long long)a.window + 1);
      if (i < a.Sq)
        rows |= 1u << r;
      else
        lo[r] = hi[r] = 0;
    }
  } else {
    const long long pair = bx / a.row_tiles, chunk = bx - pair * a.row_tiles;
    b = (int)(pair / a.Hkv);
    hk = (int)(pair - (long long)b * a.Hkv);
    const int len = a.lengths[b];
    const long long l_hi = min((long long)len, (long long)a.Skv);
    const long long l_lo = max(0LL, (long long)len - (long long)a.window);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long j = chunk * ROWS + r;  // head of the group
      q_off[r] = ((long long)b * a.Hq + (long long)hk * g + j) * a.D;
      lo[r] = l_lo;
      hi[r] = j < g ? l_hi : l_lo;
      if (j < g) rows |= 1u << r;
    }
  }
  long long k_lo = 0x7fffffffffffffffLL, k_hi = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    if (lo[r] < hi[r]) {
      k_lo = min(k_lo, lo[r]);
      k_hi = max(k_hi, hi[r]);
    }
  const long long kv_row = (long long)a.Hkv * a.D;  // elements a key
  const long long kv_base = ((long long)b * a.Skv * a.Hkv + hk) * a.D;
  // Scores in base 2: log2 e folded into q's scale, or into the soft-cap.
  const float qscale = a.softcap > 0.f ? a.scale : a.scale * LOG2E;
  const float cap2 = a.softcap * LOG2E;

  float m[R], l[R], acc[R][DV / 32];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 32; ++j) acc[i][j] = 0.f;
  }
  for (long long t0 = k_lo; t0 < k_hi; t0 += BK) {
    // Scores of key t0 + lane for the warp's rows R warp .. R warp + R - 1.
    float s[R];
#pragma unroll
    for (int i = 0; i < R; ++i) s[i] = 0.f;
    for (int c0 = 0; c0 < a.D; c0 += DC) {
      __syncthreads();  // the last chunk (and the last tile's V) read
      for (int e = tid; e < BK * DC; e += NT) {
        const int kk = e / DC, d = e - kk * DC;
        const long long key = t0 + kk;
        float x = 0.f;
        if (key < k_hi && c0 + d < a.D)
          x = rounded(load(a.k, kv_base + key * kv_row + c0 + d, a.kv_type),
                      a.rk);
        Ks[kk][d] = x;
      }
      for (int e = tid; e < ROWS * DC; e += NT) {
        const int r = e / DC, d = e - r * DC;
        Qs[r][d] = lo[r] < hi[r] && c0 + d < a.D
                       ? load(a.q, q_off[r] + c0 + d, a.q_type) * qscale
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < DC; ++d) {
        const float kv = Ks[lane][d];
#pragma unroll
        for (int i = 0; i < R; ++i)
          s[i] = fmaf(Qs[R * warp + i][d], kv, s[i]);
      }
    }
    // The tile's online softmax, row by row of the warp's.
    const long long key = t0 + lane;
    float p[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = R * warp + i;
      const bool vis = key >= lo[r] && key < hi[r];
      float x = s[i];
      if (a.softcap > 0.f) x = tanhf(x / a.softcap) * cap2;
      x = vis ? x : NEG_INF;
      float mt = x;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float mn = fmaxf(m[i], mt);
      p[i] = vis ? exp2f(x - mn) : 0.f;
      float ps = p[i];
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float alpha = exp2f(m[i] - mn);
      l[i] = l[i] * alpha + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DV / 32; ++j) acc[i][j] *= alpha;
    }
    // P V over the block's column slice.
    __syncthreads();  // every warp done with the chunk buffers
    for (int e = tid; e < BK * DV; e += NT) {
      const int kk = e / DV, d = e - kk * DV;
      const long long kt = t0 + kk;
      float x = 0.f;
      if (kt < k_hi && dv0 + d < a.D)
        x = rounded(load(a.v, kv_base + kt * kv_row + dv0 + d, a.kv_type),
                    a.rk);
      Vs[kk][d] = x;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < BK; ++t) {
      float v[DV / 32];
#pragma unroll
      for (int j = 0; j < DV / 32; ++j) v[j] = Vs[t][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pt = __shfl_sync(0xffffffffu, p[i], t);
#pragma unroll
        for (int j = 0; j < DV / 32; ++j)
          acc[i][j] = fmaf(pt, v[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * warp + i;
    const bool live = (rows >> r) & 1u;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DV / 32; ++j) {
      const int c = dv0 + lane + 32 * j;
      if (live && c < a.D)
        store(a.out, q_off[r] + c, acc[i][j] / den, a.q_type);
    }
  }
}

}  // namespace

// mode 0 (#7): q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), out like q;
// `lengths` unused. mode 1 (#8): q / out (B, Hq, D), caches (B, Skv, Hkv,
// D), `lengths` (B,) int32, `causal` unused. `window` INT32_MAX for none,
// `softcap` 0 for none; type codes 0 float32, 1 bf16, 2 float16; `rk`
// rounds K and V to bf16 (1) or float16 (2) where read.
extern "C" int attention_wide_launch(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int mode, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int D,
                                    int causal, int window, int q_type,
                                    int kv_type, int rk, float scale,
                                    float softcap, void* stream) {
  if (B < 0 || Sq < 0 || Skv < 0 || Hkv < 1 || Hq < 1 || Hq % Hkv ||
      D < 1 || window < 1 || q_type < 0 || q_type > 2 || kv_type < 0 ||
      kv_type > 2 || rk < 0 || rk > 2 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q,  k,      v,      static_cast<const int*>(lengths),
         out, mode,  B,      Sq,
         Skv, Hq,    Hkv,    D,
         causal, window, q_type, kv_type,
         rk, scale, softcap, 0};
  // #7: 32 rows a block (8 a warp); #8: 8 (2 a warp).
  const int rows = mode == 0 ? 4 * 8 : 4 * 2;
  long long pairs;
  if (mode == 0) {
    a.row_tiles = ((long long)Sq + rows - 1) / rows;
    pairs = (long long)B * Hq;
  } else {
    a.row_tiles = ((long long)(Hq / Hkv) + rows - 1) / rows;
    pairs = (long long)B * Hkv;
  }
  const long long blocks = pairs * a.row_tiles;
  const long long slices = ((long long)D + DV - 1) / DV;
  if (blocks > 0x7fffffffLL || slices > 65535)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)blocks, (unsigned)slices);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    attention_wide_kernel<8><<<grid, NT, 0, st>>>(a);
  else
    attention_wide_kernel<2><<<grid, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

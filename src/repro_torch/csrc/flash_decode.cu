// Split-KV single-query decode attention for Hopper.
//
// Replaces src/repro/kernels/flash_decode.py `_decode_kernel`
// (`flash_decode`) over float32 and float16 caches (bf16 caches:
// flash_decode_bf16.cu): for q (B, Hq, D) and caches k, v (B, S, Hkv, D),
// q float32, bf16 or float16, q head h reading kv head h / g (g = Hq /
// Hkv), with valid prefix len = lengths[b],
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   keys ki < len (and ki > len - 1 - w with a window w) are visible
//   out = acc / max(l, 1e-30)   (a sequence with no visible key gives 0)
//
// in float32, the output in q's type, rounded once. With `round_kv` (a
// float32 cache under a bf16 or float16 model, which the wrapper's caller
// asks for) each K and V value is rounded to the model's type where it is
// read, as the model's JAX decode path casts the cache to x's type before
// the attention; the cache is read as stored and nothing is copied. The
// rounding is a template parameter, so the instantiations without it are
// the TPU kernel's function (it widens without rounding) with no branch
// added to their loops. A float16 cache is read as stored, 2 bytes a value,
// and widened exactly: the same body with half the bytes. (The bf16 body's
// split of q and p into three bf16 pieces needs float32's exponent range,
// which float16 pieces lack, so a float16 cache does not take it.)
//
// Bound: bytes. Each visible key row of K and V is read once and used for
// 2 * g * D multiply-adds: ~g / 4 FLOP per byte, far below the FP32 ridge
// (~20). At the Qwen3-1.7B decode (8 kv heads, D = 128, g = 2) the call
// moves the visible keys of both caches; q and out are noise. The card's
// 3.35 TB/s needs ~25 GB/s from each SM, i.e. tens of KB in flight per SM
// at all times.
//
// Design.
// * Split the visible keys, not the capacity. Each (sequence, kv head)
//   cuts its own visible range [max(0, len - w), min(len, S)) into
//   n = clamp(visible / keys, 1, splits) near-equal runs of whole TK-key
//   tiles, where keys = max(64, Hkv * (visible keys of the batch) /
//   target), rounded up to whole tiles: about `target` blocks of equal
//   work for the whole call, none with fewer than `keys` keys unless it is
//   its sequence's only one (`split_of` in kv_split.cuh, shared with the
//   general body; the wrapper's `split_ranges` is the same rule in
//   Python). The grid is (B * Hkv, splits), `splits` an upper limit from
//   shapes; blocks past their sequence's n return at once, after the busy
//   ones. Every block reads `lengths` on the device:
//   the host never waits.
// * One block per (kv head, split) serves all g query heads, so every
//   K/V byte is read from device memory once.
// * Overlap loads with math, with no block barrier per tile. Each of the
//   NW warps owns the block's tiles w, w + NW, ... and streams them
//   through its own RING-deep shared-memory ring with 16-byte
//   cp.async.cg, RING - 1 tiles ahead of the one it scores: ~128 KB in
//   flight per SM. A tile costs the warp two __syncwarp()s. Lane (key k =
//   lane % 8, part p = lane / 8) scores key k over the float4 columns p,
//   p + 4, ... of every head (rows padded so the 8 keys of a phase hit
//   distinct banks), scores are kept in base 2 for exp2f, the running max
//   moves on three shuffles a head, each lane keeps its own key's share of
//   the running sum until the end, and P.V accumulates in registers, lane
//   l owning columns l and l + 32.
// * One launch. The warps' states are merged in warp order; with n = 1
//   the block writes out. Else it writes its (m, l, acc) to scratch, and
//   the last block of the (sequence, kv head) to finish — an atomic
//   ticket, which that block resets to 0 — merges the n splits in split
//   order. Two runs are bitwise equal, and nothing is left for the host to
//   clear; only the float32 summation order depends on the split count.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_split.cuh"

namespace {

// Keys of one warp stage (the key tile): the split rule's whole runs.
constexpr int TK = kv_split::TK;
constexpr int RING = 3;        // stages of each warp's ring
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

// out[i] = x in q's type (`q_type` 0 float32, 1 bf16, 2 float16; a 16-bit
// type rounded to nearest).
__device__ __forceinline__ void put(void* out, long long i, float x,
                                    int q_type) {
  if (q_type == 1)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(x);
  else if (q_type == 2)
    static_cast<__half*>(out)[i] = __float2half_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row stride of a ring tile (elements of T): one or two 16-byte words past
// the row, whichever makes it an odd number of words, so the 8 rows read
// by a phase of lanes fall in distinct banks (float: D + 4 or D + 8).
template <typename T>
__host__ __device__ __forceinline__ int row_stride(int D) {
  constexpr int E = 16 / sizeof(T);  // values a 16-byte word
  const int w = D / E;
  return E * (w + (w % 2 ? 2 : 1));
}

// v with each value rounded (to nearest even) to bf16 (RK 1) or float16
// (RK 2) and widened back; RK 0 leaves it.
template <int RK>
__device__ __forceinline__ float4 rounded(float4 v) {
  if constexpr (RK == 1)
    return make_float4(__bfloat162float(__float2bfloat16_rn(v.x)),
                       __bfloat162float(__float2bfloat16_rn(v.y)),
                       __bfloat162float(__float2bfloat16_rn(v.z)),
                       __bfloat162float(__float2bfloat16_rn(v.w)));
  else if constexpr (RK == 2)
    return make_float4(__half2float(__float2half_rn(v.x)),
                       __half2float(__float2half_rn(v.y)),
                       __half2float(__float2half_rn(v.z)),
                       __half2float(__float2half_rn(v.w)));
  else
    return v;
}

// Four consecutive values as float4 (bf16, float16: widened, exactly).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&w.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// T: the caches' type (float or __half). G: query heads a block holds in
// registers (g <= G; heads g.. are zero). NW: warps a block. q and out are
// of `q_type` (0 float32, 1 bf16, 2 float16). RK: K and V rounded to bf16
// (1) or float16 (2) where they are read (a float32 cache under a 16-bit
// model); the instantiations without it (0) are the TPU kernel's function.
template <typename T, int RK, int G, int NW>
__global__ void __launch_bounds__(32 * NW)
decode_kernel(const void* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ part_ml, float* __restrict__ part_acc,
              int* __restrict__ ticket, void* __restrict__ out, int B,
              int S, int Hq, int Hkv, int D, int splits, int target,
              int window, int q_type, float scale, float softcap) {
  constexpr int NT = 32 * NW;
  const int pair = blockIdx.x, sp = blockIdx.y;
  const int b = pair / Hkv, hk = pair - b * Hkv, g = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh0 = (long long)b * Hq + (long long)hk * g;
  // q's g * D / 4 float4s, loaded while the split is worked out.
  constexpr int QV = (G * 64 + NT - 1) / NT;
  float4 qv[QV];
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int e = tid + j * NT;
    qv[j] = e >= g * D / 4 ? make_float4(0.f, 0.f, 0.f, 0.f)
            : q_type == 1
                ? load4(static_cast<const bf16*>(q) + bh0 * D + 4 * e)
            : q_type == 2
                ? load4(static_cast<const __half*>(q) + bh0 * D + 4 * e)
                : load4(static_cast<const float*>(q) + bh0 * D + 4 * e);
  }
  // The keys a split aims at (every warp sums the batch's), hence this
  // block's keys.
  const long long keys =
      kv_split::keys_a_split(lengths, B, S, window, Hkv, target, lane);
  const kv_split::Split r =
      kv_split::split_of(lengths[b], S, window, splits, keys, sp);
  const int ne = max(r.n, 1);
  if (sp >= ne) return;

  extern __shared__ float4 smem4[];
  __shared__ int last;
  const int ld = row_stride<T>(D), d4 = D / 4;
  constexpr int E = 16 / sizeof(T);  // values a 16-byte copy
  float* Qs = reinterpret_cast<float*>(smem4);  // [G][D], q * scale
  T* rings = reinterpret_cast<T*>(Qs + G * D);  // [NW][RING][2][TK][ld]
  T* ring = rings + warp * RING * 2 * TK * ld;

  const long long kstride = (long long)Hkv * D;
  const long long base = ((long long)b * S * Hkv + hk) * D;
  // Scores are kept in base 2 (times log2(e)) for exp2f: Qs holds
  // q * scale * log2(e), or q * scale under a soft-cap, whose tanh is
  // taken in base e.
  const float qscale = softcap > 0.f ? scale : scale * LOG2E;
#pragma unroll
  for (int j = 0; j < QV; ++j) {
    const int e = tid + j * NT;
    if (e < G * D / 4)
      reinterpret_cast<float4*>(Qs)[e] =
          make_float4(qv[j].x * qscale, qv[j].y * qscale, qv[j].z * qscale,
                      qv[j].w * qscale);
  }

  // This warp's tiles: t = warp + NW * i of the split's nt tiles.
  const int nt = (int)((max(0LL, r.e - r.a) + TK - 1) / TK);
  const int mine = nt > warp ? (nt - warp + NW - 1) / NW : 0;
  // Copy the K and V rows of tile i into ring slot i % RING, lane l the
  // 16-byte words l and l + 32 of each row (zeros for keys past the
  // split's end); always one commit group.
  auto issue = [&](int i) {
    if (i < mine) {
      const long long t0 = r.a + (long long)(warp + NW * i) * TK;
      const int nk = (int)min((long long)TK, r.e - t0);
      T* dst = ring + (i % RING) * 2 * TK * ld;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = E * (lane + 32 * j);
        if (c < D) {
          const T* ks = k + base + t0 * kstride + c;
          const T* vs = v + base + t0 * kstride + c;
#pragma unroll
          for (int t = 0; t < TK; ++t) {
            const bool ok = t < nk;
            cp_async16(dst + t * ld + c, ok ? ks + t * kstride : k,
                       ok ? 16 : 0);
            cp_async16(dst + (TK + t) * ld + c, ok ? vs + t * kstride : k,
                       ok ? 16 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < RING - 1; ++i) issue(i);
  __syncthreads();  // Qs

  const int kq = lane & 7, pq = lane >> 3;
  // m: running max (all lanes); l: this lane's key's share of the running
  // sum, summed over the 8 keys at the end; acc: columns lane, lane + 32.
  float m[G], l[G];
  float4 acc[G][2];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
    acc[h][0] = acc[h][1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = 0; i < mine; ++i) {
    issue(i + RING - 1);
    cp_async_wait<RING - 1>();  // this lane's copies of tile i landed
    __syncwarp();               // ... and every lane's
    const T* Ks = ring + (i % RING) * 2 * TK * ld;
    const T* Vs = Ks + TK * ld;

    // Scores of key kq: partial dots over columns pq, pq + 4, ... (two
    // sums, even and odd float4s, to halve the chain), then summed over
    // the 4 parts.
    float s[G], s2[G];
#pragma unroll
    for (int h = 0; h < G; ++h) s[h] = s2[h] = 0.f;
    const T* kr = Ks + kq * ld;
#pragma unroll 2
    for (int c = pq; c < d4; c += 8) {
      float4 x = load4(kr + 4 * c);
      x = rounded<RK>(x);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4 y =
            *reinterpret_cast<const float4*>(Qs + h * D + 4 * c);
        s[h] = fmaf(x.x, y.x, s[h]);
        s[h] = fmaf(x.y, y.y, s[h]);
        s[h] = fmaf(x.z, y.z, s[h]);
        s[h] = fmaf(x.w, y.w, s[h]);
      }
      if (c + 4 < d4) {
        float4 z = load4(kr + 4 * c + 16);
        z = rounded<RK>(z);
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const float4 y =
              *reinterpret_cast<const float4*>(Qs + h * D + 4 * c + 16);
          s2[h] = fmaf(z.x, y.x, s2[h]);
          s2[h] = fmaf(z.y, y.y, s2[h]);
          s2[h] = fmaf(z.z, y.z, s2[h]);
          s2[h] = fmaf(z.w, y.w, s2[h]);
        }
      }
    }
    const bool valid = r.a + (long long)(warp + NW * i) * TK + kq < r.e;
    float p[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float x = s[h] + s2[h];
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (softcap > 0.f) x = tanhf(x / softcap) * (softcap * LOG2E);
      x = valid ? x : NEG_INF;
      float mt = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float mn = fmaxf(m[h], mt);
      p[h] = valid ? exp2f(x - mn) : 0.f;
      const float alpha = exp2f(m[h] - mn);
      l[h] = l[h] * alpha + p[h];
      m[h] = mn;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[h][j].x *= alpha;
        acc[h][j].y *= alpha;
        acc[h][j].z *= alpha;
        acc[h][j].w *= alpha;
      }
    }
    // P.V: key t's probabilities come from lane t.
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      float pt[G];
#pragma unroll
      for (int h = 0; h < G; ++h) pt[h] = __shfl_sync(0xffffffffu, p[h], t);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        if (c < d4) {
          float4 y = load4(Vs + t * ld + 4 * c);
          y = rounded<RK>(y);
#pragma unroll
          for (int h = 0; h < G; ++h) {
            acc[h][j].x = fmaf(pt[h], y.x, acc[h][j].x);
            acc[h][j].y = fmaf(pt[h], y.y, acc[h][j].y);
            acc[h][j].z = fmaf(pt[h], y.z, acc[h][j].z);
            acc[h][j].w = fmaf(pt[h], y.w, acc[h][j].w);
          }
        }
      }
    }
    __syncwarp();  // tile i read: its slot may be refilled
  }
#pragma unroll
  for (int h = 0; h < G; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 4);
  }
  cp_async_wait<0>();
  __syncthreads();  // every ring drained and read

  // Merge the warps in warp order: their states go to shared memory.
  float* Wa = Qs + G * D;         // [NW][G][D], over the rings
  float* Wm = Wa + NW * G * D;    // [NW][G]
  float* Wl = Wm + NW * G;        // [NW][G]
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane == 0) {
      Wm[warp * G + h] = m[h];
      Wl[warp * G + h] = l[h];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 32 * j;
      if (c < d4)
        *reinterpret_cast<float4*>(Wa + (warp * G + h) * D + 4 * c) =
            acc[h][j];
    }
  }
  __syncthreads();
  const long long n_rows = (long long)B * Hq;
  for (int e = tid; e < g * D; e += NT) {
    const int h = e / D, d = e - h * D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, Wm[w * G + h]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = exp2f(Wm[w * G + h] - mx);
      den += Wl[w * G + h] * f;
      num += Wa[(w * G + h) * D + d] * f;
    }
    if (ne == 1) {
      put(out, (bh0 + h) * D + d, num / fmaxf(den, 1e-30f), q_type);
    } else {
      part_acc[((bh0 + h) * splits + sp) * D + d] = num;
      if (d == 0) {
        part_ml[(bh0 + h) * splits + sp] = mx;
        part_ml[(n_rows + bh0 + h) * splits + sp] = den;
      }
    }
  }
  if (ne == 1) return;

  // The last of the sequence's n blocks to get here merges the splits.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket + pair, 1) == ne - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < g * D; e += NT) {
    const int h = e / D, d = e - h * D;
    const float* pm = part_ml + (bh0 + h) * splits;
    const float* pl = part_ml + (n_rows + bh0 + h) * splits;
    const float* pa = part_acc + (bh0 + h) * splits * D + d;
    // One pass in split order, the running max rescaling the sums.
    float mx = NEG_INF, den = 0.f, num = 0.f;
#pragma unroll 4
    for (int i = 0; i < ne; ++i) {
      const float mi = __ldcg(pm + i), li = __ldcg(pl + i);
      const float ai = __ldcg(pa + (long long)i * D);
      const float mn = fmaxf(mx, mi);
      const float fo = exp2f(mx - mn), fi = exp2f(mi - mn);
      den = den * fo + li * fi;
      num = num * fo + ai * fi;
      mx = mn;
    }
    put(out, (bh0 + h) * D + d, num / fmaxf(den, 1e-30f), q_type);
  }
  if (tid == 0) ticket[pair] = 0;
}

template <typename T, int RK, int G, int NW>
cudaError_t launch(size_t smem, dim3 grid, cudaStream_t stream,
                   const void* q, const void* k, const void* v,
                   const void* lengths, void* part, void* ticket, void* out,
                   int B, int S, int Hq, int Hkv, int D, int splits,
                   int target, int window, int q_type, float scale,
                   float softcap) {
  const cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, RK, G, NW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float* ml = static_cast<float*>(part);
  float* acc = ml + (size_t)2 * B * Hq * splits;
  decode_kernel<T, RK, G, NW><<<grid, 32 * NW, smem, stream>>>(
      q, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), ml, acc, static_cast<int*>(ticket),
      out, B, S, Hq, Hkv, D, splits, target, window, q_type, scale, softcap);
  return cudaGetLastError();
}

// Eight warps a block where their rings fit an SM's shared memory
// (D <= 128), else four.
template <typename T, int RK, int G>
cudaError_t launch_g(dim3 grid, cudaStream_t st, const void* q,
                     const void* k, const void* v, const void* lengths,
                     void* part, void* ticket, void* out, int B, int S,
                     int Hq, int Hkv, int D, int splits, int target,
                     int window, int q_type, float scale, float softcap) {
  const size_t ring = sizeof(T) * RING * 2 * TK * row_stride<T>(D);
  const size_t qs = sizeof(float) * G * D;
  if (D <= 128)
    return launch<T, RK, G, 8>(qs + 8 * ring, grid, st, q, k, v, lengths,
                               part, ticket, out, B, S, Hq, Hkv, D, splits,
                               target, window, q_type, scale, softcap);
  return launch<T, RK, G, 4>(qs + 4 * ring, grid, st, q, k, v, lengths, part,
                             ticket, out, B, S, Hq, Hkv, D, splits, target,
                             window, q_type, scale, softcap);
}

template <typename T, int RK>
cudaError_t launch_t(dim3 grid, cudaStream_t st, const void* q,
                     const void* k, const void* v, const void* lengths,
                     void* part, void* ticket, void* out, int B, int S,
                     int Hq, int Hkv, int D, int splits, int target,
                     int window, int q_type, float scale, float softcap) {
  const int g = Hq / Hkv;
  if (g == 1)
    return launch_g<T, RK, 1>(grid, st, q, k, v, lengths, part, ticket, out,
                              B, S, Hq, Hkv, D, splits, target, window,
                              q_type, scale, softcap);
  if (g == 2)
    return launch_g<T, RK, 2>(grid, st, q, k, v, lengths, part, ticket, out,
                              B, S, Hq, Hkv, D, splits, target, window,
                              q_type, scale, softcap);
  if (g <= 4)
    return launch_g<T, RK, 4>(grid, st, q, k, v, lengths, part, ticket, out,
                              B, S, Hq, Hkv, D, splits, target, window,
                              q_type, scale, softcap);
  return launch_g<T, RK, 8>(grid, st, q, k, v, lengths, part, ticket, out, B,
                            S, Hq, Hkv, D, splits, target, window, q_type,
                            scale, softcap);
}

}  // namespace

// `part` holds (2 + D) * B * Hq * splits floats of per-split state;
// `ticket` B * Hkv ints that are 0 on entry and are 0 again on exit;
// `target` the blocks of equal work the split rule aims at (INT32_MAX: a
// split of 64 keys, each sequence taking up to `splits` of them). q and
// out are of `q_type` (0 float32, 1 bf16, 2 float16); the caches of
// `kv_type` (0 float32, 2 float16; D a multiple of 8 for float16);
// `round_kv` rounds each K and V value of a float32 cache to bf16 (1) or
// float16 (2) where it is read.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* part, void* ticket, void* out,
                                   int B, int S, int Hq, int Hkv, int D,
                                   int splits, int target, int window,
                                   int q_type, int kv_type, int round_kv,
                                   float scale, float softcap,
                                   void* stream) {
  if (D % 4 || D < 4 || D > 256 || Hkv < 1 || Hq % Hkv || Hq / Hkv > 8 ||
      splits < 1 || splits > 65535 || target < 1 || q_type < 0 ||
      q_type > 2 || round_kv < 0 || round_kv > 2 ||
      (kv_type == 2 && (D % 8 || round_kv)) || (kv_type != 0 && kv_type != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * Hkv, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = kv_type == 2   ? launch_t<__half, 0>
                   : round_kv == 1 ? launch_t<float, 1>
                   : round_kv == 2 ? launch_t<float, 2>
                                   : launch_t<float, 0>;
  const cudaError_t err =
      run(grid, st, q, k, v, lengths, part, ticket, out, B, S, Hq, Hkv, D,
          splits, target, window, q_type, scale, softcap);
  return (int)err;
}

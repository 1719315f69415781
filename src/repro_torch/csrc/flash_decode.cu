// Split-KV single-query decode attention for Hopper.
//
// Replaces src/repro/kernels/flash_decode.py `_decode_kernel`
// (`flash_decode`): for q (B, Hq, D) and caches k, v (B, S, Hkv, D),
// float32, q head h reading kv head h / g (g = Hq / Hkv), with valid
// prefix len = lengths[b],
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   keys ki < len (and ki > len - 1 - w with a window w) are visible
//   out = acc / max(l, 1e-30)   (a sequence with no visible key gives 0)
//
// Bound: bytes. Each visible key row of K and V is read once and used for
// 2 * g * D multiply-adds: ~g / 4 FLOP per byte, far below the FP32 ridge
// (~20). At the Qwen3-1.7B decode (8 kv heads, D = 128, g = 2) the call
// moves the valid prefixes of both caches; q and out are noise.
//
// Design. The TPU carried (m, l, acc) through a sequential grid over KV
// blocks; here the KV axis of each (sequence, kv head) is cut into
// `splits` equal chunks, one block each, so B * Hkv * splits blocks fill
// the 132 SMs even at batch 4. A block serves all g query heads of its kv
// head, so every K/V byte is read from device memory once, not g times.
// It streams 64-key K/V tiles through shared memory (rows padded to D + 4
// floats), takes the g x 64 scores one thread per (head, key), runs the
// online softmax per head with one warp per head, and accumulates P.V one
// thread per (head, column). A chunk that holds no visible key returns at
// once. The partial (m, l, acc) of each split go to scratch that the
// wrapper allocates; a second kernel combines them per (sequence, q head)
// against the global max, in split order, skipping the empty splits
// (a reduction across blocks needs a second pass). Only the float32
// summation order depends on the split count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int TK = 64;
constexpr float NEG_INF = -1e30f;

// Visible keys of split `sp` of a sequence of length `len`: [a, e).
struct Range {
  long long a, e;
};

__device__ __forceinline__ Range split_range(int len, int S, int chunk,
                                             int sp, int window) {
  const long long hi = min((long long)len, (long long)S);
  const long long lo = max(0LL, (long long)len - (long long)window);
  const long long start = (long long)sp * chunk;
  const long long end = min((long long)S, start + chunk);
  return {max(start, lo), min(end, hi)};
}

__global__ void __launch_bounds__(NT)
decode_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int B, int S, int Hq, int Hkv, int D, int splits,
                    int chunk, int window, float scale, float softcap) {
  const int sp = blockIdx.x, bk = blockIdx.y;
  const int b = bk / Hkv, hk = bk % Hkv, g = Hq / Hkv;
  const Range r = split_range(lengths[b], S, chunk, sp, window);
  if (r.a >= r.e) return;  // nothing visible in this chunk

  extern __shared__ float4 smem4[];
  const int ld = D + 4, d4 = D / 4;
  float* Ks = reinterpret_cast<float*>(smem4);  // TK x ld
  float* Vs = Ks + TK * ld;                      // TK x ld
  float* Qs = Vs + TK * ld;                      // g x D, scaled
  float* Acc = Qs + g * D;                       // g x D
  float* Ps = Acc + g * D;                       // g x TK
  float* Ms = Ps + g * TK;                       // g: running max
  float* Ls = Ms + g;                            // g: running sum
  float* As = Ls + g;                            // g: this tile's rescale

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long kstride = (long long)Hkv * D;
  const float* qb = q + ((long long)b * Hq + (long long)hk * g) * D;
  const float* kb = k + ((long long)b * S * Hkv + hk) * D;
  const float* vb = v + ((long long)b * S * Hkv + hk) * D;

  for (int e = tid; e < g * D; e += NT) {
    Qs[e] = qb[e] * scale;
    Acc[e] = 0.f;
  }
  for (int h = tid; h < g; h += NT) {
    Ms[h] = NEG_INF;
    Ls[h] = 0.f;
  }

  for (long long t0 = r.a; t0 < r.e; t0 += TK) {
    const int n = (int)min((long long)TK, r.e - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < n * d4; e += NT) {
      const int t = e / d4, c = e % d4;
      const long long row = (t0 + t) * kstride;
      *reinterpret_cast<float4*>(Ks + t * ld + 4 * c) =
          __ldg(reinterpret_cast<const float4*>(kb + row) + c);
      *reinterpret_cast<float4*>(Vs + t * ld + 4 * c) =
          __ldg(reinterpret_cast<const float4*>(vb + row) + c);
    }
    __syncthreads();

    for (int e = tid; e < g * TK; e += NT) {
      const int h = e / TK, t = e % TK;
      float s = NEG_INF;
      if (t < n) {
        const float4* qr = reinterpret_cast<const float4*>(Qs + h * D);
        const float4* kr = reinterpret_cast<const float4*>(Ks + t * ld);
        float acc = 0.f;
        for (int c = 0; c < d4; ++c) {
          const float4 x = qr[c], y = kr[c];
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
          acc = fmaf(x.z, y.z, acc);
          acc = fmaf(x.w, y.w, acc);
        }
        s = softcap > 0.f ? tanhf(acc / softcap) * softcap : acc;
      }
      Ps[h * TK + t] = s;
    }
    __syncthreads();

    for (int h = warp; h < g; h += NW) {
      float mx = NEG_INF;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, Ps[h * TK + t]);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[h], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TK; t += 32) {
        const float p = t < n ? expf(Ps[h * TK + t] - m_new) : 0.f;
        Ps[h * TK + t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[h] = alpha;
        Ls[h] = Ls[h] * alpha + sum;
        Ms[h] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < g * D; e += NT) {
      const int h = e / D, d = e % D;
      const float* pr = Ps + h * TK;
      float acc = Acc[e] * As[h];
      for (int t = 0; t < n; ++t) acc = fmaf(pr[t], Vs[t * ld + d], acc);
      Acc[e] = acc;
    }
  }
  __syncthreads();

  // Partial state of q heads hk * g .. hk * g + g - 1 for this split.
  const long long bh0 = (long long)b * Hq + (long long)hk * g;
  const long long n_rows = (long long)B * Hq;
  for (int h = tid; h < g; h += NT) {
    part_ml[(bh0 + h) * splits + sp] = Ms[h];
    part_ml[(n_rows + bh0 + h) * splits + sp] = Ls[h];
  }
  for (int e = tid; e < g * D; e += NT) {
    const int h = e / D, d = e % D;
    part_acc[((bh0 + h) * splits + sp) * D + d] = Acc[e];
  }
}

__global__ void __launch_bounds__(NT)
decode_combine_kernel(const int* __restrict__ lengths,
                      const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      float* __restrict__ out, int B, int S, int Hq, int D,
                      int splits, int chunk, int window) {
  const long long bh = blockIdx.x, n_rows = (long long)B * Hq;
  const int len = lengths[bh / Hq];
  const float* m = part_ml + bh * splits;
  const float* l = part_ml + (n_rows + bh) * splits;
  float mx = NEG_INF;
  for (int sp = 0; sp < splits; ++sp) {
    const Range r = split_range(len, S, chunk, sp, window);
    if (r.a < r.e) mx = fmaxf(mx, m[sp]);
  }
  float den = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const Range r = split_range(len, S, chunk, sp, window);
    if (r.a < r.e) den += l[sp] * expf(m[sp] - mx);
  }
  den = fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < D; d += NT) {
    float acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const Range r = split_range(len, S, chunk, sp, window);
      if (r.a < r.e)
        acc += part_acc[(bh * splits + sp) * D + d] * expf(m[sp] - mx);
    }
    out[bh * D + d] = acc / den;
  }
}

int chunk_of(int S, int splits) { return (S + splits - 1) / splits; }

}  // namespace

extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* part_ml, void* part_acc, int B,
                                   int S, int Hq, int Hkv, int D, int splits,
                                   int window, float scale, float softcap,
                                   void* stream) {
  if (D % 4 || D < 4 || D > 256 || Hkv < 1 || Hq % Hkv || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int g = Hq / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)2 * TK * (D + 4) + 2 * g * D + g * TK + 3 * g);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, B * Hkv);
  decode_split_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), B, S, Hq,
      Hkv, D, splits, chunk_of(S, splits), window, scale, softcap);
  return (int)cudaGetLastError();
}

extern "C" int flash_decode_combine_launch(const void* lengths,
                                           const void* part_ml,
                                           const void* part_acc, void* out,
                                           int B, int S, int Hq, int D,
                                           int splits, int window,
                                           void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  decode_combine_kernel<<<B * Hq, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(part_ml),
      static_cast<const float*>(part_acc), static_cast<float*>(out), B, S, Hq,
      D, splits, chunk_of(S, splits), window);
  return (int)cudaGetLastError();
}

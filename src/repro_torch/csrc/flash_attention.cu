// Flash attention (causal, GQA, sliding window, tanh soft-cap) for Hopper.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel`
// (`flash_attention`): for q (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), float32,
// q head h reading kv head h / (Hq / Hkv),
//
//   s   = (q * scale) . k^T,  tanh(s / c) * c with a soft-cap c > 0
//   qi  = i + (Skv - Sq),  masked unless ki < Skv, [qi >= ki], [qi - ki < w]
//   out = acc / max(l, 1e-30)   (online softmax; masked logits are -1e30
//                                and their p is forced to 0)
//
// Bound: operations. 4 * D FLOP per live (query, key) pair against
// 4 * D * 4 bytes per row of q, k, v and out: at the Qwen3-1.7B prefill
// (S = 2048-4096, D = 128, causal) the work is ~500-1000x the bytes, far
// above the FP32 ridge of ~20 FLOP per byte. No tensor cores: TF32 would
// break the 1e-4 bound the port holds the kernel to (wgmma is later work).
//
// Design. One block of 256 threads per (batch * q head, 64-row query
// tile); the TPU's sequential KV grid axis becomes a loop inside the block
// over 64-row K/V tiles staged in shared memory (rows padded to D + 4
// floats so the 16-byte loads of a quarter warp hit distinct banks). Each
// thread owns 4 query rows (ty + 16 i) by 4 keys (tx + 16 j) of the score
// tile, and the same 4 rows by ceil(D / 16) output columns of the
// accumulator, so the online-softmax state (m, l, acc) stays in registers
// and a row's max and sum are shuffles over its 16 lanes. P goes through
// shared memory (over the spent K tile) into the P.V product. KV tiles the
// causal or window mask removes entirely are never visited: exact, as
// their p is 0. Query tiles launch heaviest first (causal rows near the end
// see the most keys). Nothing assumes a power of two: the kernel is
// instantiated for ceil(D / 16) in {1, 2, 4, 8, 9}, the head dims of the
// configs (16 and 20 at smoke size, 64, 128, 144 at full width); any other
// D returns cudaErrorInvalidValue, and another instantiation serves it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int PLD = BK + 1;  // P row stride (floats): rows ty, ty+1 differ
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "load_tile copies BQ rows for every tile");

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Copy BQ rows (row r at src + r * stride) of D floats into smem rows
// of stride ld, zero-filling rows at or past `valid`, times `mul`.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int valid,
                                          int D, int ld, float mul) {
  const int d4 = D / 4;
  for (int e = threadIdx.x; e < BQ * d4; e += NT) {
    const int r = e / d4, c = e % d4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      x = __ldg(reinterpret_cast<const float4*>(src + r * stride) + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = x;
  }
}

template <int NC>  // output columns per thread: ceil(D / 16)
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int Sq,
             int Skv, int Hq, int Hkv, int D, int causal, int window,
             float scale, float softcap) {
  extern __shared__ float4 smem4[];
  const int ld = D + 4;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * ld;
  float* Ps = Ks;  // P overwrites the K tile once the scores are taken
  const int ks_len = BK * ld > BQ * PLD ? BK * ld : BQ * PLD;
  float* Vs = Ks + ks_len;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tile first
  const long long qstride = (long long)Hq * D, kstride = (long long)Hkv * D;
  const float* qb = q + ((long long)b * Sq * Hq + h) * D;
  const float* kb = k + ((long long)b * Skv * Hkv + hk) * D;
  const float* vb = v + ((long long)b * Skv * Hkv + hk) * D;
  float* ob = out + ((long long)b * Sq * Hq + h) * D;

  // Keys any real row of this tile can see.
  const long long off = (long long)Skv - Sq;
  const int q_rows = min(BQ, Sq - q0);
  long long k_hi = Skv;
  if (causal) k_hi = min(k_hi, q0 + q_rows - 1 + off + 1);
  const long long k_lo = max(0LL, q0 + off - (long long)window + 1);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  if (k_lo < k_hi) {
    load_tile(Qs, qb + q0 * qstride, qstride, q_rows, D, ld, scale);
    for (int k0 = (int)(k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
      load_tile(Ks, kb + k0 * kstride, kstride, Skv - k0, D, ld, 1.f);
      load_tile(Vs, vb + k0 * kstride, kstride, Skv - k0, D, ld, 1.f);
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; d += 4) {
        float4 qa[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(qa[i], kv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long qi = q0 + ty + 16 * i + off;
        bool ok[4];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long ki = k0 + tx + 16 * j;
          ok[j] = ki < Skv && (!causal || qi >= ki) && qi - ki < window;
          float x = s[i][j];
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          s[i][j] = ok[j] ? x : NEG_INF;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int o = 8; o >= 1; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
          ps += s[i][j];
        }
        l[i] = l[i] * alpha + ps;  // this thread's share of the row sum
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
        m[i] = m_new;
      }
      __syncthreads();  // every thread is done with the K tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * PLD + tx + 16 * j] = s[i][j];
      __syncthreads();

      for (int kk = 0; kk < BK; ++kk) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = tx + 16 * c;
          if (d < D) {
            const float x = Vs[kk * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], x, acc[i][c]);
          }
        }
      }
      __syncthreads();  // before the next tile overwrites K, V and P
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 8; o >= 1; o >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, o);
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const float den = fmaxf(li, 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        if (d < D) ob[(q0 + r) * qstride + d] = acc[i][c] / den;
      }
    }
  }
}

template <int NC>
int launch(const float* q, const float* k, const float* v, float* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
           float scale, float softcap, cudaStream_t stream) {
  const int ld = D + 4;
  const int ks_len = BK * ld > BQ * PLD ? BK * ld : BQ * PLD;
  const size_t smem = sizeof(float) * (size_t)(BQ * ld + ks_len + BK * ld);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_kernel<NC><<<grid, NT, smem, stream>>>(
      q, k, v, out, Sq, Skv, Hq, Hkv, D, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Skv, int Hq, int Hkv, int D,
                                      int causal, int window, float scale,
                                      float softcap, void* stream) {
  if (D % 4 || D < 4 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(n)                                                      \
  case n:                                                                  \
    return launch<n>(qf, kf, vf, of, B, Sq, Skv, Hq, Hkv, D, causal, window, \
                     scale, softcap, st);
  switch ((D + 15) / 16) {
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(4) FLASH_CASE(8) FLASH_CASE(9)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

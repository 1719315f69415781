// Body of the batch-fused BLI(+)conv kernel #1 (paper §IV-D fusion).
//
// For grid row g (one output tile) and output pixel p:
//
//   out[g, p, :] = b + sum_{kk, c} patch[p, kk, c] * w[kk, c, :]
//   patch[p, kk, c] = sum_j coeff_j * x[src(idx_j), c]
//
// over the 4 BLI neighbours j, where src() turns a packed address into an
// x row, or rejects it (the neighbour then contributes zero):
//
//   ADDR_BATCH  (#1, dcn_fused_batch) plane-global addresses
//               a = tile * tp + offset of the row's image; a neighbour
//               counts iff its tile is one of the row's dep_cnt[g] deps
//               dep[g, :]; x row = img * t_in * tp + a.
//
// A row with dep_cnt = 0 writes b. The TPU kernel keeps the whole (bp*KK,
// C) f32 patch in VMEM (1.18 MB at bp = 64, C = 512); a Hopper block has
// at most 227 KB of shared memory, so the patch is built and consumed in
// chunks of BC input channels. A block owns (grid row, BP-pixel block,
// BO-output-channel block). It first resolves, once, where each neighbour
// lives (an x row or nothing), then per channel chunk gathers the
// deformed patch chunk into shared memory, stages the matching rows of w,
// and accumulates a 4x4 register tile per thread over KK*BC rows. The
// deformed intermediate never leaves the SM. #4 and #5 moved to the
// split-C tensor-core body of dcn_fused_split.cuh; #1 moves there next,
// and this body then goes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BP = 64;    // output pixels per block
constexpr int BO = 64;    // output channels per block
constexpr int BC = 16;    // input channels per shared-memory chunk
constexpr int NT = 256;   // threads: 16 (pixels) x 16 (channels), 4x4 each

// One addressing mode is left; dcn_fused_batch.cu names it.
enum Addr { ADDR_BATCH = 0 };

template <int MODE>
__global__ void __launch_bounds__(NT)
dcn_fused_kernel(const float* __restrict__ x, const int* __restrict__ row_id,
                 const int* __restrict__ dep, const int* __restrict__ dep_cnt,
                 const int* __restrict__ idx,
                 const float* __restrict__ coeff,
                 const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ out, int k_pad, int t_in, int tp, int P,
                 int KK, int C, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = (float*)smem;                        // [KK*BC][BP]
  float* Ws = As + KK * BC * BP;                   // [KK*BC][BO]
  long long* src = (long long*)(Ws + KK * BC * BO);  // [KK*BP][4]
  float* cf = (float*)(src + KK * BP * 4);         // [KK*BP][4]
  unsigned* depmask = (unsigned*)(cf + KK * BP * 4);  // [t_in / 32]

  const int g = blockIdx.x;
  const int p0 = blockIdx.y * BP, o0 = blockIdx.z * BO;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int cnt = dep_cnt[g];

  if (cnt == 0) {            // padding row: bias only
    for (int e = tid; e < BP * BO; e += NT) {
      const int p = p0 + e / BO, o = o0 + e % BO;
      if (p < P && o < O) out[((size_t)g * P + p) * O + o] = b[o];
    }
    return;
  }

  // Membership of a tile in the row's dep list, as a bitmask.
  const int mw = (t_in + 31) >> 5;
  for (int i = tid; i < mw; i += NT) depmask[i] = 0u;
  __syncthreads();
  for (int k = tid; k < cnt; k += NT) {
    const int dl = dep[(size_t)g * k_pad + k] % t_in;
    atomicOr(&depmask[dl >> 5], 1u << (dl & 31));
  }
  __syncthreads();
  // Every dep of a row belongs to one image: x rows of that image start
  // at img * t_in * tp, and a plane-global address a is row base + a.
  const long long img_base =
      (long long)(dep[(size_t)g * k_pad] / t_in) * t_in * tp;
  const int row = row_id[g];
  for (int q = tid; q < KK * BP; q += NT) {
    const int kk = q / BP, p = p0 + q % BP;
    for (int j = 0; j < 4; ++j) {
      long long s = -1;
      float c = 0.f;
      if (p < P) {
        const size_t off = (((size_t)row * P + p) * KK + kk) * 4 + j;
        const int a = idx[off];
        const int tile = a / tp;
        if (a >= 0 && tile < t_in &&
            ((depmask[tile >> 5] >> (tile & 31)) & 1u))
          s = img_base + a;
        if (s >= 0) c = coeff[off];
      }
      src[q * 4 + j] = s;
      cf[q * 4 + j] = c;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const bool vec = (C & 3) == 0;
  for (int c0 = 0; c0 < C; c0 += BC) {
    __syncthreads();
    // Gather the deformed patch chunk: thread q owns (kk, pixel) and
    // writes BC consecutive channel rows of As.
    for (int q = tid; q < KK * BP; q += NT) {
      float v[BC];
#pragma unroll
      for (int c = 0; c < BC; ++c) v[c] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long s = src[q * 4 + j];
        if (s < 0) continue;
        const float cj = cf[q * 4 + j];
        const float* xp = x + s * C + c0;
        if (vec) {
#pragma unroll
          for (int c = 0; c < BC; c += 4) {
            if (c0 + c < C) {
              const float4 xv = __ldg((const float4*)(xp + c));
              v[c] += cj * xv.x;
              v[c + 1] += cj * xv.y;
              v[c + 2] += cj * xv.z;
              v[c + 3] += cj * xv.w;
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < BC; ++c)
            if (c0 + c < C) v[c] += cj * __ldg(xp + c);
        }
      }
      const int kk = q / BP, pl = q % BP;
#pragma unroll
      for (int c = 0; c < BC; ++c) As[(kk * BC + c) * BP + pl] = v[c];
    }
    // Stage the matching KK*BC rows of w (row r = kk*BC + c).
    for (int e = tid; e < KK * BC * BO; e += NT) {
      const int r = e / BO, o = e % BO;
      const int kk = r / BC, c = c0 + r % BC;
      Ws[e] = (c < C && o0 + o < O)
                  ? __ldg(w + ((size_t)kk * C + c) * O + o0 + o)
                  : 0.f;
    }
    __syncthreads();
    const int rows = KK * BC;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) {
      const float4 a = *(const float4*)(As + r * BP + ty * 4);
      const float4 bv = *(const float4*)(Ws + r * BO + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bw[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx * 4 + j;
      if (o < O) out[((size_t)g * P + p) * O + o] = acc[i][j] + b[o];
    }
  }
}

// Launch #1 over G grid rows; returns cudaGetLastError().
template <int MODE>
int dcn_fused_launch(const void* x, const void* row_id, const void* dep,
                     const void* dep_cnt, const void* idx, const void* coeff,
                     const void* w, const void* b, void* out, int G,
                     int k_pad, int t_in, int tp, int P, int KK, int C,
                     int O, void* stream) {
  const int mask_words = (t_in + 31) / 32;
  const int smem = 4 * KK * BC * (BP + BO) + KK * BP * 4 * (8 + 4) +
                   4 * mask_words;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_fused_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, (P + BP - 1) / BP, (O + BO - 1) / BO);
  dcn_fused_kernel<MODE><<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)row_id, (const int*)dep,
      (const int*)dep_cnt, (const int*)idx, (const float*)coeff,
      (const float*)w, (const float*)b, (float*)out, k_pad, t_in, tp, P, KK,
      C, O);
  return (int)cudaGetLastError();
}

}  // namespace

// Standalone bilinear interpolation (paper Eq. 2) for Hopper.
//
// Replaces src/repro/kernels/dcn_bli.py `_bli_kernel` (`bli_tile_matmul`):
//
//   out[n, p, :] = sum_j [0 <= idx[n, p, j] < S] coeff[n, p, j]
//                        * x[n, idx[n, p, j], :]
//
// over the 4 BLI neighbours j of output row p of image n. The TPU forms a
// 4-hot (bp, S) interpolation matrix against iota(S) and runs it through
// the MXU as a matmul; an index outside [0, S) matches no column and
// contributes zero. On Hopper the same function is a gather of four rows
// and a weighted sum, and an out-of-range index is masked the same way.
//
// Bound: bytes. Each output element costs 4 multiply-adds on 4 reads, far
// below the FP32 ridge (~20 FLOP per byte): at the 14x14x512 DCN layers
// (S = 196, P = 196 * 9 = 1764 -> 1792, C = 512) the call moves the
// 0.4 MB input, 57 KB of indices and coefficients and the 3.7 MB output.
//
// Design: one thread per (image, row, 4 channels): it reads the row's 4
// indices and coefficients (shared by the 128 threads of the row through
// L1), gathers 4 float4s and writes one float4, so every load and store
// of the channel dimension is a coalesced 16-byte access. The input plane
// is small enough to stay in L2 across the gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <bool VEC>
__global__ void __launch_bounds__(NT)
bli_kernel(const float* __restrict__ x, const int* __restrict__ idx,
           const float* __restrict__ coeff, float* __restrict__ out,
           long long total, int P, int S, int C) {
  const int cw = VEC ? C / 4 : C;           // channel words per row
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= total) return;
  const int cv = (int)(e % cw);
  const long long row = e / cw;              // n * P + p
  const long long n = row / P;
  const float* xn = x + n * (long long)S * C;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc1 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = __ldg(idx + row * 4 + j);
    if (a < 0 || a >= S) continue;
    const float cj = __ldg(coeff + row * 4 + j);
    if (VEC) {
      const float4 v = __ldg((const float4*)(xn + (long long)a * C) + cv);
      acc.x += cj * v.x;
      acc.y += cj * v.y;
      acc.z += cj * v.z;
      acc.w += cj * v.w;
    } else {
      acc1 += cj * __ldg(xn + (long long)a * C + cv);
    }
  }
  if (VEC)
    ((float4*)(out + row * C))[cv] = acc;
  else
    out[row * C + cv] = acc1;
}

}  // namespace

extern "C" int bli_gather_launch(const void* x, const void* idx,
                                 const void* coeff, void* out, int N, int P,
                                 int S, int C, void* stream) {
  const bool vec = (C & 3) == 0;
  const long long total = (long long)N * P * (vec ? C / 4 : C);
  const long long blocks = (total + NT - 1) / NT;
  if (vec)
    bli_kernel<true><<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)idx, (const float*)coeff, (float*)out,
        total, P, S, C);
  else
    bli_kernel<false><<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)idx, (const float*)coeff, (float*)out,
        total, P, S, C);
  return (int)cudaGetLastError();
}

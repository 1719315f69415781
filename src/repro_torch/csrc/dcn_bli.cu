// Standalone bilinear interpolation (paper Eq. 2) for Hopper.
//
// Replaces src/repro/kernels/dcn_bli.py `_bli_kernel` (`bli_tile_matmul`):
//
//   out[n, p, :] = sum_j [0 <= idx[n, p, j] < S] coeff[n, p, j]
//                        * x[n, idx[n, p, j], :]
//
// over the 4 BLI neighbours j of output row p of image n; x float32,
// bfloat16 or float16, the sum in float32 rounded once to x's type. The TPU forms a
// 4-hot (bp, S) interpolation matrix against iota(S) and runs it through
// the MXU with the (S, bc) input block resident in VMEM; an index outside
// [0, S) matches no column and contributes zero. Here the same function
// is a gather of four rows and a weighted sum, masked the same way.
//
// Bound: bytes. Each output element costs 4 multiply-adds, far below the
// FP32 ridge: at the 14x14x512 DCN layer (S = 196, P = 1764 -> 1792,
// C = 512) a call reads a 0.4 MB plane and 57 KB of indices and
// coefficients and writes 3.7 MB (1.8 MB in bf16). The output is the
// traffic; the gathers read each slice row many times, and find it in L1.
//
// Design. Grid (row chunk, channel slice, image), no division on a
// thread's path: a block owns `rows` output rows of one image and one
// slice of `lw` words of the channels (a word is 16 bytes, or one element
// where a row is not 16-byte aligned; lw = 8, so 128 bytes, at C = 512).
// Lanes own consecutive words of a row, so a warp step covers 32 / lw
// rows and every store is part of a contiguous 128-byte run. A lane takes
// 2 rows a step: it loads each row's 4 indices and 4 coefficients as two
// 16-byte words (the lanes of a row share one broadcast load), issues all
// 8 gathers from global memory before any arithmetic (an index outside
// [0, S) reads a clamped row under a zero coefficient, so no branch
// stalls the loads), sums each row's four terms in j order with FMAs in
// float32, rounds once to x's type and writes its word with a streaming
// store: nothing here reads the output again. The block's slice stays in
// L1 across its rows, so one body serves every S, aligned or not. bf16
// words unpack by bit moves (a bf16 is the top half of a float32) and
// pack with cvt.rn.bf16x2; float16 words convert with the half2
// intrinsics (every float16 widens to float32 exactly). The host plan (kernels/dcn_bli.py `bli_plan`)
// sizes the grid to one wave of four blocks an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256, NWARPS = NT / 32, U = 2;  // U: rows a lane a step

// A lane's unit of the channel dimension: `raw` as loaded and stored, `n`
// float32 values once converted.
template <typename T, bool VEC>
struct Word;

template <>
struct Word<float, true> {
  using raw = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const raw& v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ static raw pack(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Word<float, false> {
  using raw = float;
  static constexpr int n = 1;
  __device__ static void unpack(const raw& v, float* f) { f[0] = v; }
  __device__ static raw pack(const float* f) { return f[0]; }
};

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return (uint32_t)__bfloat16_as_ushort(h.x) |
         ((uint32_t)__bfloat16_as_ushort(h.y) << 16);
}

template <>
struct Word<__nv_bfloat16, true> {
  using raw = uint4;  // 8 bfloat16
  static constexpr int n = 8;
  __device__ static void unpack(const raw& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static raw pack(const float* f) {
    return make_uint4(bf16x2_bits(f[0], f[1]), bf16x2_bits(f[2], f[3]),
                      bf16x2_bits(f[4], f[5]), bf16x2_bits(f[6], f[7]));
  }
};

template <>
struct Word<__nv_bfloat16, false> {
  using raw = unsigned short;
  static constexpr int n = 1;
  __device__ static void unpack(const raw& v, float* f) {
    f[0] = __uint_as_float((uint32_t)v << 16);
  }
  __device__ static raw pack(const float* f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  }
};

template <>
struct Word<__half, true> {
  using raw = uint4;  // 8 float16
  static constexpr int n = 8;
  __device__ static void unpack(const raw& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 p = __half22float2(*reinterpret_cast<const __half2*>(&w[k]));
      f[2 * k] = p.x;
      f[2 * k + 1] = p.y;
    }
  }
  __device__ static uint32_t bits(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static raw pack(const float* f) {
    return make_uint4(bits(f[0], f[1]), bits(f[2], f[3]), bits(f[4], f[5]),
                      bits(f[6], f[7]));
  }
};

template <>
struct Word<__half, false> {
  using raw = unsigned short;
  static constexpr int n = 1;
  __device__ static void unpack(const raw& v, float* f) {
    f[0] = __half2float(__ushort_as_half(v));
  }
  __device__ static raw pack(const float* f) {
    return __half_as_ushort(__float2half_rn(f[0]));
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
bli_kernel(const typename Word<T, VEC>::raw* __restrict__ x,
           const int4* __restrict__ idx, const float4* __restrict__ coeff,
           typename Word<T, VEC>::raw* __restrict__ out, int P, int S,
           int cw, int lsh, int rows) {
  using W = Word<T, VEC>;
  using R = typename W::raw;
  const int lw = 1 << lsh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.z;
  const int r_lo = blockIdx.x * rows;
  const int r_hi = min(P, r_lo + rows);
  const R* xn = x + (size_t)n * S * cw + blockIdx.y * lw;  // row a: a * cw
  R* on = out + (size_t)n * P * cw + blockIdx.y * lw;
  const int4* in = idx + (size_t)n * P;
  const float4* cn = coeff + (size_t)n * P;
  const int rps = 32 >> lsh;  // rows a warp covers in one step
  const int wd = lane & (lw - 1);

  if (S == 0) {  // every index is out of range: zeros, and nothing to read
    const float zero[W::n] = {};
    for (int r = r_lo + warp * rps + (lane >> lsh); r < r_hi;
         r += NWARPS * rps)
      __stcs(on + (size_t)r * cw + wd, W::pack(zero));
    return;
  }

  const int a_max = S - 1;
  for (int r0 = r_lo + warp * rps * U + (lane >> lsh); r0 < r_hi;
       r0 += NWARPS * rps * U) {
    int4 ix[U];
    float4 cf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = min(r0 + u * rps, r_hi - 1);
      ix[u] = __ldg(in + r);
      cf[u] = __ldg(cn + r);
    }
    R v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int a[4] = {ix[u].x, ix[u].y, ix[u].z, ix[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int aj = min(max(a[j], 0), a_max);
        v[u][j] = __ldg(xn + (size_t)aj * cw + wd);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * rps;
      const int a[4] = {ix[u].x, ix[u].y, ix[u].z, ix[u].w};
      const float c[4] = {cf[u].x, cf[u].y, cf[u].z, cf[u].w};
      float acc[W::n];
#pragma unroll
      for (int k = 0; k < W::n; ++k) acc[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float cj = (unsigned)a[j] < (unsigned)S ? c[j] : 0.f;
        float f[W::n];
        W::unpack(v[u][j], f);
#pragma unroll
        for (int k = 0; k < W::n; ++k) acc[k] = fmaf(cj, f[k], acc[k]);
      }
      if (r < r_hi) __stcs(on + (size_t)r * cw + wd, W::pack(acc));
    }
  }
}

template <typename T, bool VEC>
cudaError_t launch(dim3 grid, cudaStream_t st, const void* x, const void* idx,
                   const void* coeff, void* out, int P, int S, int cw,
                   int lsh, int rows) {
  using R = typename Word<T, VEC>::raw;
  bli_kernel<T, VEC><<<grid, NT, 0, st>>>((const R*)x, (const int4*)idx,
                                          (const float4*)coeff, (R*)out, P,
                                          S, cw, lsh, rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int vec, dim3 grid, cudaStream_t st, const void* x,
                     const void* idx, const void* coeff, void* out, int P,
                     int S, int cw, int lsh, int rows) {
  return vec ? launch<T, true>(grid, st, x, idx, coeff, out, P, S, cw, lsh,
                               rows)
             : launch<T, false>(grid, st, x, idx, coeff, out, P, S, cw, lsh,
                                rows);
}

}  // namespace

// One launch over N images of (S, C) planes -> (N, P, C), as planned by
// kernels/dcn_bli.py `bli_plan`: `dtype` picks x's type (0 float32, 1
// bfloat16, 2 float16), `vec` 16-byte words (else one element a lane),
// `lw` the words of a block's channel slice (a power of two up to 32 that
// divides the row's words), `rows` the output rows of a block, `chunks`
// the row chunks (at least ceil(P / rows)).
extern "C" int bli_gather_launch(const void* x, const void* idx,
                                 const void* coeff, void* out, int N, int P,
                                 int S, int C, int dtype, int vec, int lw,
                                 int rows, int chunks, void* stream) {
  const int elem = dtype ? 2 : 4;
  const int cw = vec ? C * elem / 16 : C;
  int lsh = 0;
  while ((1 << lsh) < lw) ++lsh;
  if (dtype < 0 || dtype > 2 || lw < 1 || lw > 32 || (1 << lsh) != lw ||
      cw % lw || rows < 1 || chunks < 1 || (long long)chunks * rows < P ||
      (vec && (C * elem) % 16))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(chunks, cw / lw, N);
  const cudaStream_t st = (cudaStream_t)stream;
  const auto run = dtype == 1   ? launch_t<__nv_bfloat16>
                   : dtype == 2 ? launch_t<__half>
                                : launch_t<float>;
  return (int)run(vec, grid, st, x, idx, coeff, out, P, S, cw, lsh, rows);
}

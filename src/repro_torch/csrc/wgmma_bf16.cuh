// Hopper 16-bit building blocks of the flash-attention kernel
// (flash_attention.cu) and the bf16 DCN body (dcn_fused_bf16.cuh): the
// wgmma products with bf16 or float16 operands and float32 accumulators
// (wgmma_16bit_ops.cuh, once a type), the descriptor of a swizzled operand,
// the packing of two floats into a 16-bit pair, and `Mma16<T>`, which
// names them by element type. The fences are those of wgmma_tf32.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace {
namespace tc {

// Two floats rounded to nearest bf16 in one 32-bit register: `lo` in the
// low half (the lower column of an A fragment pair), `hi` in the high one.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 values of a packed pair, widened (exactly) to float.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Shared-memory matrix descriptor of a swizzled layout as the TMA lands
// it (wgmma_tf32.cuh's `smem_desc` is the unswizzled one): `swz` bytes a
// row (128, 64 or 32; layout type 1, 2 or 3 in bits 62-63), 8-row atoms
// of 8 * swz bytes whose base must be aligned to them. K-major: `sbo` to
// the next 8 rows along M / N, `lbo` unused (16). MN-major: `sbo` to the
// next 8 rows along K, `lbo` to the next atom along M / N.
__device__ __forceinline__ uint64_t smem_desc_sw(const void* p, uint32_t lbo,
                                                 uint32_t sbo, int swz) {
  const uint64_t layout = swz == 128 ? 1 : swz == 64 ? 2 : 3;
  return smem_desc(p, lbo, sbo) | (layout << 62);
}

#define WG_TYPES ".bf16.bf16"
#define WG_NAME(x) wgmma_bf16_##x
#include "wgmma_16bit_ops.cuh"
#undef WG_NAME
#undef WG_TYPES
#define WG_TYPES ".f16.f16"
#define WG_NAME(x) wgmma_f16_##x
#include "wgmma_16bit_ops.cuh"
#undef WG_NAME
#undef WG_TYPES

// Two floats rounded to nearest float16 in one 32-bit register (`lo` in
// the low half), and the two values of such a pair, widened exactly.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float f16_lo(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float f16_hi(uint32_t w) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// The products and the packing by operand type T
// (__nv_bfloat16 or __half): `n64` and `rs<DP>` as wgmma_bf16_n64 and
// wgmma_bf16_rs, `pack` / `lo` / `hi` as pack_bf16 / bf16_lo / bf16_hi.
template <typename T>
struct Mma16;

template <>
struct Mma16<__nv_bfloat16> {
  __device__ static void n64(float (&d)[32], uint64_t da, uint64_t db,
                             int scale_d) {
    wgmma_bf16_n64(d, da, db, scale_d);
  }
  template <int DP>
  __device__ static void rs(float (&d)[DP / 2], const uint32_t (&a)[4],
                            uint64_t db, int scale_d) {
    wgmma_bf16_rs<DP>(d, a, db, scale_d);
  }
  __device__ static uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  __device__ static float lo(uint32_t w) { return bf16_lo(w); }
  __device__ static float hi(uint32_t w) { return bf16_hi(w); }
};

template <>
struct Mma16<__half> {
  __device__ static void n64(float (&d)[32], uint64_t da, uint64_t db,
                             int scale_d) {
    wgmma_f16_n64(d, da, db, scale_d);
  }
  template <int DP>
  __device__ static void rs(float (&d)[DP / 2], const uint32_t (&a)[4],
                            uint64_t db, int scale_d) {
    wgmma_f16_rs<DP>(d, a, db, scale_d);
  }
  __device__ static uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  __device__ static float lo(uint32_t w) { return f16_lo(w); }
  __device__ static float hi(uint32_t w) { return f16_hi(w); }
};

}  // namespace tc
}  // namespace

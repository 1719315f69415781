// The split rule of the split-KV decode bodies, one copy for both:
// flash_decode.cu (the float32 / float16-cache body) and attention_any.cu
// (the general body). kernels/flash_decode.py `split_ranges` is the same
// rule in Python.
//
// Each (sequence, kv head) cuts its visible keys [max(0, len - w),
// min(len, S)) into n = clamp(visible / keys, 1, splits) near-equal runs of
// whole TK-key tiles (0 runs where nothing is visible), where `keys` =
// max(MIN_KEYS, Hkv * (visible keys of the batch) / target), rounded up to
// whole tiles.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace kv_split {

constexpr int TK = 8;         // splits are cut in whole runs of TK keys
constexpr int MIN_KEYS = 64;  // fewest keys of a split that is not alone

__device__ __forceinline__ long long visible(int len, int S, int window) {
  const long long hi = min((long long)len, (long long)S);
  const long long lo = max(0LL, (long long)len - (long long)window);
  return max(0LL, hi - lo);
}

// The keys a split aims at: the batch's visible keys summed over a warp
// (every lane of the calling warp gets the same answer).
__device__ __forceinline__ long long keys_a_split(const int* lengths, int B,
                                                  int S, int window, int Hkv,
                                                  int target, int lane) {
  long long total = 0;
  for (int i = lane; i < B; i += 32) total += visible(lengths[i], S, window);
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  return (max((long long)MIN_KEYS, (total * Hkv + target - 1) / target) +
          TK - 1) / TK * TK;
}

// Split `sp` of a sequence: its keys [a, e) and the sequence's split
// count n (0 when it has no visible key).
struct Split {
  long long a, e;
  int n;
};

__device__ __forceinline__ Split split_of(int len, int S, int window,
                                          int splits, long long keys,
                                          int sp) {
  const long long lo = max(0LL, (long long)len - (long long)window);
  const long long nv = visible(len, S, window);
  const int n =
      nv > 0 ? (int)min((long long)splits, max(1LL, nv / keys)) : 0;
  const long long nt = (nv + TK - 1) / TK;
  const int ne = max(n, 1);
  return {lo + TK * (nt * sp / ne),
          min(lo + nv, lo + TK * (nt * (sp + 1) / ne)), n};
}

}  // namespace kv_split
}  // namespace

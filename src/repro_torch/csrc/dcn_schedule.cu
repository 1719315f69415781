// On-device tile scheduling (paper §IV-B/C) for Hopper: the TDT kernel
// and the Algorithm-1 greedy kernel.
//
// tdt_kernel replaces src/repro/kernels/dcn_schedule.py `_tdt_kernel`
// (`tdt_from_coords_device`). One block per output tile; threads walk the
// tile's tp*KK sampling coordinates, floor and clip them exactly as the
// reference does, decode the 4 BLI neighbours to input-tile ids and
// atomicOr them into a shared-memory bitmask that becomes the TDT row.
// Bound: bytes (coords in, one byte per table entry out); the work is a
// few integer ops per coordinate. The design reads each coordinate once,
// keeps the row in shared memory and writes it once.
//
// greedy_kernel replaces `_greedy_kernel` (`greedy_schedule_arrays`).
// Algorithm 1 is sequential in its steps, so ONE persistent block runs
// every step (the TPU grid dimension becomes a loop). The TDT is held as
// bit rows (n_out x ceil(n_in/32) words) in shared memory when it fits
// and in a global scratch buffer otherwise; the executed mask, the FIFO
// last-load sequence numbers and (loads_total, curr) stay in shared
// memory. Bound: latency — n_out dependent steps, each a block-wide
// popcount sweep, an argmax and a prefix sum separated by barriers; the
// bytes it must move (the table in, the class rows out) take far less.
// The design keeps every step on chip and stops the loop as soon as no
// dependent tile is left, filling the padded suffix directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeverLoaded = -(1 << 30);
constexpr int kGreedyThreads = 512;
constexpr int kSmemLimit = 232448;  // 227 KB opt-in shared memory per block

__device__ __forceinline__ void set_bit(unsigned* mask, int id) {
  atomicOr(&mask[id >> 5], 1u << (id & 31));
}

__global__ void tdt_kernel(const float* __restrict__ coords,
                           uint8_t* __restrict__ out, int H, int W, int KK,
                           int out_th, int out_tw, int out_cols, int in_h,
                           int in_w, int in_th, int in_tw, int in_cols,
                           int n_in) {
  extern __shared__ unsigned mask[];
  const int t = blockIdx.x;
  const int words = (n_in + 31) >> 5;
  for (int i = threadIdx.x; i < words; i += blockDim.x) mask[i] = 0u;
  __syncthreads();
  const int tr = t / out_cols, tc = t % out_cols;
  const int tpkk = out_th * out_tw * KK;
  for (int e = threadIdx.x; e < tpkk; e += blockDim.x) {
    const int pix = e / KK, k = e % KK;
    // Replicate-pad the ragged edge: a padded slot repeats the plane's
    // last row/column pixel, which lies in the same edge tile.
    const int r_img = min(tr * out_th + pix / out_tw, H - 1);
    const int c_img = min(tc * out_tw + pix % out_tw, W - 1);
    const float* cp = coords + ((size_t)(r_img * W + c_img) * KK + k) * 2;
    const float fr = fminf(fmaxf(floorf(cp[0]), 0.f), (float)(in_h - 1));
    const float fc = fminf(fmaxf(floorf(cp[1]), 0.f), (float)(in_w - 1));
    const int r0 = (int)fr, c0 = (int)fc;
    const int r1 = min(r0 + 1, in_h - 1), c1 = min(c0 + 1, in_w - 1);
    set_bit(mask, (r0 / in_th) * in_cols + c0 / in_tw);
    set_bit(mask, (r0 / in_th) * in_cols + c1 / in_tw);
    set_bit(mask, (r1 / in_th) * in_cols + c0 / in_tw);
    set_bit(mask, (r1 / in_th) * in_cols + c1 / in_tw);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_in; i += blockDim.x)
    out[(size_t)t * n_in + i] = (uint8_t)((mask[i >> 5] >> (i & 31)) & 1u);
}

// Block-wide max of a 64-bit key; scratch holds >= 33 entries.
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* scratch) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 16; off; off >>= 1) {
    unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  __syncthreads();
  if (lane == 0) scratch[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < nw ? scratch[lane] : 0ull;
    for (int off = 16; off; off >>= 1) {
      unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
      v = o > v ? o : v;
    }
    if (lane == 0) scratch[32] = v;
  }
  __syncthreads();
  return scratch[32];
}

// Block-wide exclusive prefix sum in thread order; *total gets the sum.
__device__ unsigned long long block_scan(unsigned long long v,
                                         unsigned long long* scratch,
                                         unsigned long long* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned long long inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    unsigned long long n = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += n;
  }
  __syncthreads();
  if (lane == 31) scratch[wid] = inc;
  __syncthreads();
  if (wid == 0) {
    unsigned long long s = lane < nw ? scratch[lane] : 0ull;
    unsigned long long si = s;
    for (int off = 1; off < 32; off <<= 1) {
      unsigned long long n = __shfl_up_sync(0xffffffffu, si, off);
      if (lane >= off) si += n;
    }
    if (lane < nw) scratch[lane] = si - s;
    if (lane == nw - 1) scratch[32] = si;
  }
  __syncthreads();
  *total = scratch[32];
  return scratch[wid] + inc - v;
}

// Three counters of at most 21 bits each, packed for one scan.
__device__ __forceinline__ unsigned long long pack3(unsigned a, unsigned b,
                                                    unsigned c) {
  return ((unsigned long long)a << 42) | ((unsigned long long)b << 21) | c;
}

__global__ void __launch_bounds__(kGreedyThreads)
greedy_kernel(const uint8_t* __restrict__ b, int* __restrict__ oid,
              int* __restrict__ klass, int* __restrict__ ovl,
              unsigned* bits_global, int n_out, int n_in, int m,
              int bits_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (n_in + 31) >> 5;
  unsigned long long* scratch = (unsigned long long*)smem;       // 33
  int* state = (int*)(scratch + 34);                             // 4
  unsigned* cur = (unsigned*)(state + 4);                        // W
  int* seq = (int*)(cur + W);                                    // n_in
  int* dep_cnt = seq + n_in;                                     // n_out
  int* executed = dep_cnt + n_out;                               // n_out
  unsigned* bits = bits_in_smem ? (unsigned*)(executed + n_out)  // n_out*W
                                : bits_global;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int e = tid; e < n_out * W; e += nt) {
    const int r = e / W, w0 = (e % W) * 32;
    unsigned word = 0u;
    for (int j = 0; j < 32 && w0 + j < n_in; ++j)
      if (b[(size_t)r * n_in + w0 + j]) word |= 1u << j;
    bits[e] = word;
  }
  for (int t = tid; t < n_in; t += nt) seq[t] = kNeverLoaded;
  __syncthreads();
  for (int r = tid; r < n_out; r += nt) {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __popc(bits[(size_t)r * W + w]);
    dep_cnt[r] = c;
    executed[r] = 0;
  }
  if (tid == 0) { state[0] = 0; state[1] = 0; }   // loads_total, curr
  __syncthreads();

  // Each thread owns a contiguous run of input ids, so per-thread
  // counts scanned in thread order give ascending-id ranks.
  const int chunk = (n_in + nt - 1) / nt;
  const int t_lo = min(tid * chunk, n_in), t_hi = min(t_lo + chunk, n_in);

  for (int i = 0; i < n_out; ++i) {
    const bool first = i == 0;
    const int curr = state[1];
    for (int w = tid; w < W; w += nt)
      cur[w] = first ? 0u : bits[(size_t)curr * W + w];
    __syncthreads();

    // Candidate score: dependency count on step 0 (Algorithm 1 line 2),
    // overlap with the current tile after. First maximum wins ties.
    unsigned long long best = 0ull;
    for (int r = tid; r < n_out; r += nt) {
      int score = 0;
      if (first) {
        score = dep_cnt[r];
      } else {
        for (int w = 0; w < W; ++w)
          score += __popc(bits[(size_t)r * W + w] & cur[w]);
      }
      const bool valid = dep_cnt[r] > 0 && !executed[r];
      const unsigned long long key =
          ((unsigned long long)(valid ? score + 1 : 0) << 32) |
          (unsigned long long)(0xffffffffu - (unsigned)r);
      best = key > best ? key : best;
    }
    best = block_max(best, scratch);
    const int nxt = (int)(0xffffffffu - (unsigned)(best & 0xffffffffull));
    const bool take = first || (best >> 32) > 0;
    if (!take) {
      // No dependent tile is left: every later step is padding too.
      for (size_t e = (size_t)i * n_in + tid; e < (size_t)n_out * n_in;
           e += nt)
        klass[e] = 3;
      for (int s = i + tid; s < n_out; s += nt) { oid[s] = -1; ovl[s] = 0; }
      return;
    }

    const int lt = state[0];
    const unsigned* nrow = bits + (size_t)nxt * W;
    unsigned n_seq_loc = 0, n_last_loc = 0, n_ovl_loc = 0;
    for (int t = t_lo; t < t_hi; ++t) {
      const bool nd = (nrow[t >> 5] >> (t & 31)) & 1u;
      const bool cd = (cur[t >> 5] >> (t & 31)) & 1u;
      const bool loaded = nd && seq[t] > lt - m;
      const bool lastv = cd && nd && !loaded;
      const bool seqv = nd && !loaded && !lastv;
      n_seq_loc += seqv;
      n_last_loc += lastv;
      n_ovl_loc += cd && nd;
    }
    unsigned long long tot;
    const unsigned long long ex =
        block_scan(pack3(n_seq_loc, n_last_loc, n_ovl_loc), scratch, &tot);
    const int n_seq = (int)((tot >> 42) & 0x1fffffull);
    const int n_last = (int)((tot >> 21) & 0x1fffffull);
    int r_seq = (int)((ex >> 42) & 0x1fffffull);
    int r_last = (int)((ex >> 21) & 0x1fffffull);
    for (int t = t_lo; t < t_hi; ++t) {
      const bool nd = (nrow[t >> 5] >> (t & 31)) & 1u;
      const bool cd = (cur[t >> 5] >> (t & 31)) & 1u;
      const bool loaded = nd && seq[t] > lt - m;
      const bool lastv = cd && nd && !loaded;
      const bool seqv = nd && !loaded && !lastv;
      int k = 3;
      if (loaded) {
        k = 0;
      } else if (seqv) {
        k = 1;
        seq[t] = lt + (++r_seq);            // inclusive rank, as on TPU
      } else if (lastv) {
        k = 2;
        seq[t] = lt + n_seq + (++r_last);
      }
      klass[(size_t)i * n_in + t] = k;
    }
    __syncthreads();
    if (tid == 0) {
      oid[i] = nxt;
      ovl[i] = (int)(tot & 0x1fffffull);
      executed[nxt] = 1;
      state[0] = lt + n_seq + n_last;
      state[1] = nxt;
    }
    __syncthreads();
  }
}

int greedy_smem(int n_out, int n_in, int bits_in_smem) {
  const long long W = (n_in + 31) / 32;
  long long bytes = 34 * 8 + 4 * 4 + 4 * W + 4LL * n_in + 8LL * n_out;
  if (bits_in_smem) bytes += 4 * W * n_out;
  return bytes > kSmemLimit ? -1 : (int)bytes;
}

}  // namespace

extern "C" int tdt_from_coords_launch(const void* coords, void* out, int H,
                                      int W, int KK, int out_th, int out_tw,
                                      int out_cols, int t_out, int in_h,
                                      int in_w, int in_th, int in_tw,
                                      int in_cols, int n_in, void* stream) {
  const int smem = 4 * ((n_in + 31) / 32);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tdt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tdt_kernel<<<t_out, 256, smem, (cudaStream_t)stream>>>(
      (const float*)coords, (uint8_t*)out, H, W, KK, out_th, out_tw,
      out_cols, in_h, in_w, in_th, in_tw, in_cols, n_in);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the greedy kernel needs, or -1 if it exceeds a
// block's limit (with the bit rows in shared memory or not).
extern "C" int greedy_schedule_smem_bytes(int n_out, int n_in,
                                          int bits_in_smem) {
  return greedy_smem(n_out, n_in, bits_in_smem);
}

extern "C" int greedy_schedule_launch(const void* b, void* oid, void* klass,
                                      void* ovl, void* bits_global,
                                      int n_out, int n_in, int m,
                                      int bits_in_smem, void* stream) {
  const int smem = greedy_smem(n_out, n_in, bits_in_smem);
  if (smem < 0 || (!bits_in_smem && bits_global == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  greedy_kernel<<<1, kGreedyThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)b, (int*)oid, (int*)klass, (int*)ovl,
      (unsigned*)bits_global, n_out, n_in, m, bits_in_smem);
  return (int)cudaGetLastError();
}

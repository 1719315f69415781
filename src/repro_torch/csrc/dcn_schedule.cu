// On-device tile scheduling (paper §IV-B/C) for Hopper: the TDT, the
// chain composition and Algorithm 1 for a list of images in ONE launch.
//
// Replaces src/repro/kernels/dcn_schedule.py `_tdt_kernel`
// (`tdt_from_coords_device`) and `_greedy_kernel`
// (`greedy_schedule_arrays`), and the torch glue that sat between and
// after them (`compose_tdt_chain_device`, the class-row argsort of
// `dispatch_arrays_from_klass`, `tdt_dispatch_arrays`, the oid gathers).
// One launch covers every listed image of one fused group. Per image:
//
//   * each layer's TDT as bit rows: a DCN layer's from its sampling
//     coordinates (floor, clip, the four BLI neighbours, ragged edges
//     replicate-padded), a standard conv's constant rows as given, or a
//     table given per image as 0/1 bytes;
//   * the composite of the chain, a bit-row OR product;
//   * Algorithm 1 on the composite: step 0 scores by dependency count,
//     later steps by overlap with the current tile, the first maximum
//     wins, and the next tile's inputs fall in the classes 0 loaded /
//     1 seq / 2 last / 3 not a dependency under FIFO residency
//     `seq > loads_total - m`. The kernel writes the load order (class-0
//     ids ascending, then class 1, then class 2) straight from the ranks
//     it computes, and the padded suffix once no dependent tile is left;
//   * each DCN layer's TDT bytes and its dispatch rows (dependencies in
//     ascending id order and their count; plane order, or gathered by
//     the schedule for the chain's last layer).
//
// Bound: bytes (coordinates in, tables out), which no launch approaches:
// the work is latency, n_out dependent steps of an argmax and a rank
// assignment. The design:
//   * small tables (rows of at most 32 tiles): a TDT row is one register
//     word. The image's warps build the rows (each OR-reduces a slice of
//     one tile's coordinates and merges it with one shared atomic), then
//     ONE warp composes and schedules: the argmax is `__reduce_max_sync`
//     over (score, -id) keys, the class ranks come from `__ballot_sync`
//     and `__popc`, and the step loop has no block barrier. Images share
//     a block only once they outnumber the SMs;
//   * larger tables (up to 4096 tiles): one block of 1024 threads per
//     image, the bit rows in shared memory (or in global scratch past the
//     227 KB limit), read as 128-bit words. A thread owns up
//     to four rows and four input ids, with their executed flags, counts
//     and FIFO state in registers. A step has three barriers (it had
//     about nine): the argmax is a warp reduction of 32-bit keys, one
//     barrier, then every warp reduces the <= 32 partials itself; the
//     class counts meet in one barrier, warp 0 scans them, one more.
//     Measured with clock64() stamps, a step at (784, 784) is bound by
//     the instructions its 32 warps issue, not by the barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kNeverLoaded = -(1 << 30);
constexpr int kMaxLayers = 8;
constexpr int kSmallThreads = 1024;         // 32 warps
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kLargeThreads = 1024;
constexpr int kComposeChunks = 4;           // composite rows of <= 4096 ids
constexpr int kPerThread = 4;               // rows and ids a block thread owns
constexpr int kSmemLimit = 232448;          // 227 KB opt-in per block

enum LayerKind { kCoords = 0, kRows = 1, kTable = 2 };

// Mirrors kernels/dcn_schedule.py `_Args` field for field.
struct SchedArgs {
  const void* src[kMaxLayers];     // kCoords: (N, H, W, KK, 2) float32;
                                   // kRows: (n_out, words) u32, all images;
                                   // kTable: (N, n_out, n_in) 0/1 bytes
  uint8_t* tdt[kMaxLayers];        // TDT bytes out (kCoords layers) or null
  int* exec_dep[kMaxLayers];       // dispatch rows out (n_out, k_pad) or null
  int* exec_cnt[kMaxLayers];       // their counts (n_out,)
  long long src_stride[kMaxLayers];  // per batch image: floats or bytes
  const int* images;               // (n_images,) batch index per image;
                                   // null: image k is batch image k
  int* oid;                        // (n_out,) scheduled tile, -1 padding
  int* dep;                        // (n_out, k_pad) load order, or null
  int* cnt;                        // (n_out,) dependency count, or null
  int* ovl;                        // (n_out,) reuse overlap
  int* klass;                      // (n_out, n_in) classes (one image), or null
  int* ar;                         // (n_out,) 0..n_out-1, or null
  int* zero;                       // (n_out,) zeros, or null
  unsigned* scratch;               // global bit tables, scratch_words a block
  long long out_stride;            // per image, int32 words (TDT: 4x bytes)
  long long scratch_words;
  int kind[kMaxLayers];
  int kk[kMaxLayers];
  int n_layers, n_images;
  int H, W;                        // coordinate plane
  int out_th, out_tw, out_cols, n_out;
  int in_h, in_w, in_th, in_tw, in_cols, n_in;
  int m, k_pad, greedy, last_gather;  // last_gather: layer whose rows follow
                                      // the schedule, -1 for none
  int small, imgs_per_block, tables_in_smem;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// n / d for 0 <= n < 2^22, d >= 1, through a float reciprocal: the
// estimate is off by at most one either way and is corrected.
struct Div {
  int d;
  float inv;
};

__device__ __forceinline__ Div make_div(int d) { return {d, 1.f / (float)d}; }

__device__ __forceinline__ int div_of(int n, Div v) {
  int q = __float2int_rz(__int2float_rn(n) * v.inv);
  q -= q * v.d > n;
  q += (q + 1) * v.d <= n;
  return q;
}

// What decoding a tile's coordinates needs, per layer.
struct Decode {
  Div kk, out_tw, in_th, in_tw;
};

__device__ __forceinline__ Decode make_decode(const SchedArgs& a, int kk) {
  return {make_div(kk), make_div(a.out_tw), make_div(a.in_th),
          make_div(a.in_tw)};
}

// Coordinate (pixel, tap) e of output tile (tr, tc), as the reference
// gathers it: a slot of a ragged edge tile repeats the plane's last
// row/column pixel, which lies in the same edge tile.
__device__ __forceinline__ const float* coord_of(const SchedArgs& a,
                                                 const Decode& dc,
                                                 const float* base, int tr,
                                                 int tc, int e) {
  const int pix = div_of(e, dc.kk), k = e - pix * dc.kk.d;
  const int pr = div_of(pix, dc.out_tw), pc = pix - pr * dc.out_tw.d;
  const int r = min(tr * a.out_th + pr, a.H - 1);
  const int c = min(tc * a.out_tw + pc, a.W - 1);
  return base + ((size_t)(r * a.W + c) * dc.kk.d + k) * 2;
}

// The input tiles of a coordinate's four BLI neighbours, floored and
// clipped to the input plane.
__device__ __forceinline__ void neighbour_tiles(const SchedArgs& a,
                                                const Decode& dc,
                                                const float* cp, int id[4]) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(cp));
  const float fr = fminf(fmaxf(floorf(v.x), 0.f), (float)(a.in_h - 1));
  const float fc = fminf(fmaxf(floorf(v.y), 0.f), (float)(a.in_w - 1));
  const int r0 = (int)fr, c0 = (int)fc;
  const int r1 = min(r0 + 1, a.in_h - 1), c1 = min(c0 + 1, a.in_w - 1);
  const int q0 = div_of(r0, dc.in_th), p0 = div_of(c0, dc.in_tw);
  const int q1 = q0 + (r1 - q0 * dc.in_th.d == dc.in_th.d);
  const int p1 = p0 + (c1 - p0 * dc.in_tw.d == dc.in_tw.d);
  id[0] = q0 * a.in_cols + p0;
  id[1] = q0 * a.in_cols + p1;
  id[2] = q1 * a.in_cols + p0;
  id[3] = q1 * a.in_cols + p1;
}

// Ascending ids of a bit row `row` (<= 32 ids) into dst[0, k_pad), zeros
// after them; one warp. Returns the count.
__device__ __forceinline__ int emit_word(unsigned row, int* dst, int k_pad,
                                         int lane) {
  const int c = __popc(row);
  if ((row >> lane) & 1u) dst[__popc(row & lanemask_lt())] = lane;
  for (int s = c + lane; s < k_pad; s += 32) dst[s] = 0;
  return c;
}

// The same from a row of 0/1 bytes of any length; one warp.
__device__ int emit_bytes(const uint8_t* row, int n, int* dst, int k_pad,
                          int lane) {
  int base = 0;
  for (int c = 0; c < n; c += 32) {
    const int t = c + lane;
    const bool b = t < n && row[t];
    const unsigned w = __ballot_sync(0xffffffffu, b);
    if (b) dst[base + __popc(w & lanemask_lt())] = t;
    base += __popc(w);
  }
  for (int s = base + lane; s < k_pad; s += 32) dst[s] = 0;
  return base;
}

// ---------------------------------------------------------------------------
// Small tables: <= 32 output and input tiles, one warp schedules an image
// ---------------------------------------------------------------------------

// Algorithm 1 by one warp. Lane r holds composite row r (0 past n_out);
// lane t holds input t's FIFO last-load sequence number.
__device__ void greedy_warp(const SchedArgs& a, unsigned row, long long ob,
                            int lane, int* oid_s) {
  const int n_out = a.n_out, n_in = a.n_in, m = a.m, kp = a.k_pad;
  const unsigned lt = lanemask_lt();
  const int dcnt = __popc(row);
  bool executed = false;
  int seq = kNeverLoaded, loads = 0;
  unsigned cur = 0u;
  int* oid = a.oid + ob;
  int* ovl = a.ovl + ob;
  int i = 0;
  for (; i < n_out; ++i) {
    const bool first = i == 0;
    const bool valid = dcnt > 0 && !executed;
    const unsigned score = first ? (unsigned)dcnt : __popc(row & cur);
    const unsigned key = ((valid ? score + 1u : 0u) << 5) | (31u - lane);
    const unsigned best = __reduce_max_sync(0xffffffffu, key);
    if (!first && (best >> 5) == 0u) break;   // the rest is padding
    const int nxt = 31 - (int)(best & 31u);
    const unsigned nrow = __shfl_sync(0xffffffffu, row, nxt);
    const bool nd = (nrow >> lane) & 1u, cd = (cur >> lane) & 1u;
    const bool loaded = nd && seq > loads - m;
    const bool lastv = cd && nd && !loaded;
    const bool seqv = nd && !loaded && !lastv;
    const unsigned b0 = __ballot_sync(0xffffffffu, loaded);
    const unsigned b1 = __ballot_sync(0xffffffffu, seqv);
    const unsigned b2 = __ballot_sync(0xffffffffu, lastv);
    const int n0 = __popc(b0), n1 = __popc(b1), n2 = __popc(b2);
    int k = 3, pos = -1;
    if (loaded) {
      k = 0;
      pos = __popc(b0 & lt);
    } else if (seqv) {
      k = 1;
      const int r = __popc(b1 & lt);
      pos = n0 + r;
      seq = loads + r + 1;
    } else if (lastv) {
      k = 2;
      const int r = __popc(b2 & lt);
      pos = n0 + n1 + r;
      seq = loads + n1 + r + 1;
    }
    if (a.dep) {
      int* d = a.dep + ob + (size_t)i * kp;
      if (pos >= 0) d[pos] = lane;
      for (int s = n0 + n1 + n2 + lane; s < kp; s += 32) d[s] = 0;
    }
    if (a.klass && lane < n_in) a.klass[(size_t)i * n_in + lane] = k;
    if (lane == 0) {
      oid[i] = nxt;
      oid_s[i] = nxt;
      ovl[i] = first ? 0 : (int)(best >> 5) - 1;
      if (a.cnt) a.cnt[ob + i] = n0 + n1 + n2;
    }
    executed = executed || lane == nxt;
    loads += n1 + n2;
    cur = nrow;
  }
  for (; i < n_out; ++i) {
    if (lane == 0) {
      oid[i] = -1;
      oid_s[i] = -1;
      ovl[i] = 0;
      if (a.cnt) a.cnt[ob + i] = 0;
    }
    if (a.dep)
      for (int s = lane; s < kp; s += 32) a.dep[ob + (size_t)i * kp + s] = 0;
    if (a.klass && lane < n_in) a.klass[(size_t)i * n_in + lane] = 3;
  }
}

__global__ void __launch_bounds__(kSmallThreads)
schedule_small_kernel(const SchedArgs a) {
  // Per image of the block: its layers' rows, then its schedule.
  extern __shared__ unsigned small_s[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpi = kSmallWarps / a.imgs_per_block;  // warps of one image
  const int q = warp / wpi, wl = warp - q * wpi;
  const int k = blockIdx.x * a.imgs_per_block + q;
  const bool live = k < a.n_images;
  const int img = !live ? 0 : a.images ? a.images[k] : k;
  const long long ob = (long long)k * a.out_stride;
  const int n_out = a.n_out, n_in = a.n_in, L = a.n_layers;
  unsigned* const rows_q = small_s + q * (L + 1) * 32;   // L x 32 rows
  int* const oid_q = (int*)(rows_q + L * 32);             // 32

  for (int e = threadIdx.x; e < a.imgs_per_block * (L + 1) * 32;
       e += kSmallThreads)
    small_s[e] = 0u;
  __syncthreads();

  if (live) {
    for (int j = 0; j < L; ++j) {
      unsigned* rows = rows_q + j * 32;
      if (a.kind[j] == kCoords) {
        const float* base = (const float*)a.src[j] + img * a.src_stride[j];
        const int kk = a.kk[j], tpkk = a.out_th * a.out_tw * kk;
        const Decode dc = make_decode(a, kk);
        // Each warp OR-reduces one slice of one tile's coordinates.
        const int parts = max(1, wpi / n_out);
        for (int item = wl; item < n_out * parts; item += wpi) {
          const int t = item % n_out, p = item / n_out;
          const int tr = t / a.out_cols, tc = t - tr * a.out_cols;
          unsigned word = 0u;
#pragma unroll 4
          for (int e = p * 32 + lane; e < tpkk; e += parts * 32) {
            int id[4];
            neighbour_tiles(a, dc, coord_of(a, dc, base, tr, tc, e), id);
            word |= (1u << id[0]) | (1u << id[1]) | (1u << id[2]) |
                    (1u << id[3]);
          }
          word = __reduce_or_sync(0xffffffffu, word);
          if (lane == 0) atomicOr(&rows[t], word);
        }
      } else if (a.kind[j] == kRows) {
        const unsigned* src = (const unsigned*)a.src[j];
        for (int r = wl * 32 + lane; r < n_out; r += wpi * 32) rows[r] = src[r];
      } else {
        const uint8_t* src = (const uint8_t*)a.src[j] + img * a.src_stride[j];
        for (int r = wl; r < n_out; r += wpi) {
          const unsigned w = __ballot_sync(
              0xffffffffu, lane < n_in && src[(size_t)r * n_in + lane] != 0);
          if (lane == 0) rows[r] = w;
        }
      }
    }
  }
  __syncthreads();

  if (live) {
    for (int j = 0; j < L; ++j) {
      if (!a.tdt[j]) continue;
      uint8_t* dst = a.tdt[j] + (size_t)k * 4 * a.out_stride;
      for (int e = wl * 32 + lane; e < n_out * n_in; e += wpi * 32) {
        const int r = e / n_in;
        dst[e] = (uint8_t)((rows_q[j * 32 + r] >> (e - r * n_in)) & 1u);
      }
    }
    for (int t = wl * 32 + lane; t < n_out; t += wpi * 32) {
      if (a.ar) a.ar[ob + t] = t;
      if (a.zero) a.zero[ob + t] = 0;
    }
    if (a.greedy && wl == 0) {
      // Composite: row o of (B_{L-1} . ... . B_0) is the OR of the rows
      // of the layer below over row o's bits.
      unsigned comp = rows_q[(L - 1) * 32 + lane];
      for (int j = L - 2; j >= 0; --j) {
        const unsigned up = rows_q[j * 32 + lane];
        unsigned nw = 0u;
#pragma unroll
        for (int mid = 0; mid < 32; ++mid) {
          const unsigned x = __shfl_sync(0xffffffffu, up, mid);
          if ((comp >> mid) & 1u) nw |= x;
        }
        comp = nw;
      }
      greedy_warp(a, comp, ob, lane, oid_q);
    }
  }
  __syncthreads();

  if (live) {
    for (int j = 0; j < L; ++j) {
      if (!a.exec_dep[j]) continue;
      const bool gather = j == a.last_gather;
      for (int s = wl; s < n_out; s += wpi) {
        const int o = gather ? oid_q[s] : s;
        const int c = emit_word(rows_q[j * 32 + max(o, 0)],
                                a.exec_dep[j] + ob + (size_t)s * a.k_pad,
                                a.k_pad, lane);
        if (lane == 0) a.exec_cnt[j][ob + s] = o >= 0 ? c : 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Larger tables: one block of kLargeThreads per image
// ---------------------------------------------------------------------------

// The block body keeps bit rows at a stride of `ws` words, a multiple of
// 4, so that a row is read as 128-bit words; the padding words are 0.
__host__ __device__ inline int row_stride(int n_in) {
  return ((n_in + 127) >> 7) << 2;
}

// A layer's bit rows into dst (n_out x ws); block-wide, ends in a
// barrier.
__device__ __forceinline__ void load_layer(const SchedArgs& a, int j,
                                           int img, unsigned* dst, int ws) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int wid = tid >> 5, nw = nt >> 5;
  const int n_out = a.n_out, n_in = a.n_in, words = (n_in + 31) >> 5;
  if (a.kind[j] == kRows) {
    const unsigned* src = (const unsigned*)a.src[j];
    for (int e = tid; e < n_out * ws; e += nt) {
      const int r = e / ws, w = e - r * ws;
      dst[e] = w < words ? src[(size_t)r * words + w] : 0u;
    }
  } else if (a.kind[j] == kTable) {
    const uint8_t* src = (const uint8_t*)a.src[j] + img * a.src_stride[j];
    for (int item = wid; item < n_out * ws; item += nw) {
      const int r = item / ws, t = (item - r * ws) * 32 + lane;
      const unsigned w = __ballot_sync(
          0xffffffffu, t < n_in && src[(size_t)r * n_in + t] != 0);
      if (lane == 0) dst[item] = w;
    }
  } else {
    const float* base = (const float*)a.src[j] + img * a.src_stride[j];
    const int kk = a.kk[j], tpkk = a.out_th * a.out_tw * kk;
    const Decode dc = make_decode(a, kk);
    for (int e = tid; e < n_out * ws; e += nt) dst[e] = 0u;
    __syncthreads();
    for (long long f = tid; f < (long long)n_out * tpkk; f += nt) {
      const int t = (int)(f / tpkk), e = (int)(f - (long long)t * tpkk);
      const int tr = t / a.out_cols, tc = t - tr * a.out_cols;
      int id[4];
      neighbour_tiles(a, dc, coord_of(a, dc, base, tr, tc, e), id);
      unsigned* row = dst + (size_t)t * ws;
#pragma unroll
      for (int n = 0; n < 4; ++n) atomicOr(&row[id[n] >> 5], 1u << (id[n] & 31));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void write_tdt(const SchedArgs& a,
                                          const unsigned* bits, int ws,
                                          uint8_t* dst) {
  const int n_in = a.n_in;
  for (long long e = threadIdx.x; e < (long long)a.n_out * n_in;
       e += blockDim.x) {
    const int r = (int)(e / n_in), t = (int)(e - (long long)r * n_in);
    dst[e] = (uint8_t)((bits[(size_t)r * ws + (t >> 5)] >> (t & 31)) & 1u);
  }
}

// comp = comp . up in place (row strides ws and up_ws): one warp per row
// reads its whole old row into registers before it writes the new one.
__device__ __forceinline__ void compose_rows(const SchedArgs& a,
                                             unsigned* comp, int ws,
                                             const unsigned* up, int up_ws) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5, words = (a.n_in + 31) >> 5;
  for (int o = wid; o < a.n_out; o += nw) {
    unsigned old[kComposeChunks], acc[kComposeChunks];
#pragma unroll
    for (int c = 0; c < kComposeChunks; ++c) {
      const int w = c * 32 + lane;
      old[c] = w < words ? comp[(size_t)o * ws + w] : 0u;
      acc[c] = 0u;
    }
#pragma unroll
    for (int c = 0; c < kComposeChunks; ++c) {
      for (int l = 0; l < 32 && c * 32 + l < words; ++l) {
        unsigned word = __shfl_sync(0xffffffffu, old[c], l);
        while (word) {
          const int mid = (c * 32 + l) * 32 + __ffs(word) - 1;
          word &= word - 1u;
#pragma unroll
          for (int c2 = 0; c2 < kComposeChunks; ++c2) {
            const int w2 = c2 * 32 + lane;
            if (w2 < words) acc[c2] |= up[(size_t)mid * up_ws + w2];
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kComposeChunks; ++c) {
      const int w = c * 32 + lane;
      if (w < words) comp[(size_t)o * ws + w] = acc[c];
    }
  }
}

// The block's step-loop scratch, in static shared memory.
struct StepSmem {
  unsigned pa[32];             // per-warp argmax keys
  int wc[64];                  // per-warp class counts (c0 | c1 << 16, c2)
  int ex[64];                  // their exclusive prefix over the warps
  int tot[2];                  // the step's class totals
};

// Inclusive scan over the warp's lanes of (x, y).
__device__ __forceinline__ void warp_scan2(int& x, int& y, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int nx = __shfl_up_sync(0xffffffffu, x, off);
    const int ny = __shfl_up_sync(0xffffffffu, y, off);
    if (lane >= off) { x += nx; y += ny; }
  }
}

// Algorithm 1 by the whole block. Thread tid owns rows tid + c * nt and
// the contiguous input ids [t_lo, t_hi), c < kPer, with their dependency
// counts, executed flags and FIFO sequence numbers in registers. A step
// has three barriers: after the per-warp argmax keys (then every warp
// reduces the <= 32 of them itself), after the per-warp class counts,
// and after warp 0 has scanned them (a scan repeated by every warp costs
// more than the barrier it saves: the step is bound by the instructions
// its 32 warps issue).
template <int kPer>
__device__ __forceinline__ void greedy_block(const SchedArgs& a,
                                             const unsigned* bits, int ws,
                                             StepSmem& sm, int* oid_s,
                                             long long ob) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int wid = tid >> 5, nw = nt >> 5;
  const int n_out = a.n_out, n_in = a.n_in, m = a.m, kp = a.k_pad;
  const int ws4 = ws >> 2;
  const unsigned lt = lanemask_lt();
  const int chunk = (n_in + nt - 1) / nt;
  const int t_lo = min(tid * chunk, n_in), t_hi = min(t_lo + chunk, n_in);
  int* oid = a.oid + ob;
  int* ovl = a.ovl + ob;

  unsigned dcnt[kPer];
  bool done[kPer];
  int seq[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int r = tid + c * nt;
    unsigned n = 0u;
    if (r < n_out)
      for (int w = 0; w < ws; ++w) n += __popc(bits[(size_t)r * ws + w]);
    dcnt[c] = n;
    done[c] = false;
    seq[c] = kNeverLoaded;
  }

  int loads = 0, curr = 0, i = 0;
  for (; i < n_out; ++i) {
    const bool first = i == 0;
    const unsigned* crow = bits + (size_t)curr * ws;
    // Argmax over keys (score + 1 if valid else 0) << 16 | 0xffff - id,
    // both below 2^16 here: the first maximum wins. A score after step 0
    // is the overlap with the current row, read as 128-bit words.
    unsigned key = 0u;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int r = tid + c * nt;
      if (r >= n_out) break;
      unsigned hi = 0u;
      if (dcnt[c] > 0u && !done[c]) {
        unsigned sc = dcnt[c];
        if (!first) {
          const uint4* x4 =
              reinterpret_cast<const uint4*>(bits + (size_t)r * ws);
          const uint4* y4 = reinterpret_cast<const uint4*>(crow);
          unsigned s0 = 0u, s1 = 0u;
#pragma unroll 4
          for (int q = 0; q < ws4; ++q) {
            const uint4 x = x4[q], y = y4[q];
            s0 += __popc(x.x & y.x) + __popc(x.y & y.y);
            s1 += __popc(x.z & y.z) + __popc(x.w & y.w);
          }
          sc = s0 + s1;
        }
        hi = sc + 1u;
      }
      key = max(key, hi << 16 | (0xffffu - (unsigned)r));
    }
    key = __reduce_max_sync(0xffffffffu, key);
    if (lane == 0) sm.pa[wid] = key;
    __syncthreads();
    const unsigned best =
        __reduce_max_sync(0xffffffffu, lane < nw ? sm.pa[lane] : 0u);
    const unsigned bhi = best >> 16;
    if (!first && bhi == 0u) break;             // the rest is padding
    const int nxt = (int)(0xffffu - (best & 0xffffu));
    const unsigned* nrow = bits + (size_t)nxt * ws;

    // Classes of the owned ids; counts packed as (c0 | c1 << 16, c2).
    int cls[kPer];
    int c01 = 0, c2 = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int t = t_lo + c;
      int k = 3;
      if (t < t_hi) {
        const bool nd = (nrow[t >> 5] >> (t & 31)) & 1u;
        const bool cd = !first && ((crow[t >> 5] >> (t & 31)) & 1u);
        k = !nd ? 3 : seq[c] > loads - m ? 0 : cd ? 2 : 1;
      }
      cls[c] = k;
      c01 += k == 0 ? 1 : k == 1 ? 1 << 16 : 0;
      c2 += k == 2;
    }
    int e01, e2, w01, w2;
    if (kPer == 1 || chunk == 1) {
      const unsigned b0 = __ballot_sync(0xffffffffu, cls[0] == 0);
      const unsigned b1 = __ballot_sync(0xffffffffu, cls[0] == 1);
      const unsigned b2 = __ballot_sync(0xffffffffu, cls[0] == 2);
      e01 = __popc(b0 & lt) | __popc(b1 & lt) << 16;
      e2 = __popc(b2 & lt);
      w01 = __popc(b0) | __popc(b1) << 16;
      w2 = __popc(b2);
    } else {
      int i01 = c01, i2 = c2;
      warp_scan2(i01, i2, lane);
      e01 = i01 - c01;
      e2 = i2 - c2;
      w01 = __shfl_sync(0xffffffffu, i01, 31);
      w2 = __shfl_sync(0xffffffffu, i2, 31);
    }
    if (lane == 0) { sm.wc[wid] = w01; sm.wc[32 + wid] = w2; }
    __syncthreads();
    if (wid == 0) {
      const int x01 = lane < nw ? sm.wc[lane] : 0;
      const int x2 = lane < nw ? sm.wc[32 + lane] : 0;
      int i01 = x01, i2 = x2;
      warp_scan2(i01, i2, lane);
      sm.ex[lane] = i01 - x01;
      sm.ex[32 + lane] = i2 - x2;
      if (lane == 31) { sm.tot[0] = i01; sm.tot[1] = i2; }
    }
    __syncthreads();
    const int n0 = sm.tot[0] & 0xffff, n1 = sm.tot[0] >> 16, n2 = sm.tot[1];
    const int p01 = sm.ex[wid] + e01;
    int r0 = p01 & 0xffff, r1 = p01 >> 16, r2 = sm.ex[32 + wid] + e2;

    int* drow = a.dep ? a.dep + ob + (size_t)i * kp : nullptr;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int t = t_lo + c;
      if (t >= t_hi) break;
      int pos = -1;
      if (cls[c] == 0) {
        pos = r0++;
      } else if (cls[c] == 1) {
        pos = n0 + r1;
        seq[c] = loads + ++r1;
      } else if (cls[c] == 2) {
        pos = n0 + n1 + r2;
        seq[c] = loads + n1 + ++r2;
      }
      if (drow && pos >= 0) drow[pos] = t;
      if (a.klass) a.klass[(size_t)i * n_in + t] = cls[c];
    }
    if (drow)
      for (int q = n0 + n1 + n2 + tid; q < kp; q += nt) drow[q] = 0;
    if (tid == 0) {
      oid[i] = nxt;
      oid_s[i] = nxt;
      ovl[i] = first ? 0 : (int)bhi - 1;
      if (a.cnt) a.cnt[ob + i] = n0 + n1 + n2;
    }
#pragma unroll
    for (int c = 0; c < kPer; ++c) done[c] = done[c] || tid + c * nt == nxt;
    loads += n1 + n2;
    curr = nxt;
  }
  for (int q = i + tid; q < n_out; q += nt) {
    oid[q] = -1;
    oid_s[q] = -1;
    ovl[q] = 0;
    if (a.cnt) a.cnt[ob + q] = 0;
  }
  if (a.dep)
    for (long long e = (long long)i * kp + tid; e < (long long)n_out * kp;
         e += nt)
      a.dep[ob + e] = 0;
  if (a.klass)
    for (long long e = (long long)i * n_in + tid;
         e < (long long)n_out * n_in; e += nt)
      a.klass[e] = 3;
}

// Dynamic shared memory: the schedule (n_out ints, padded to 16 bytes),
// then the bit tables when kSmem.
template <bool kSmem, int kPer>
__global__ void __launch_bounds__(kLargeThreads)
schedule_large_kernel(const SchedArgs a) {
  extern __shared__ __align__(16) unsigned dyn[];
  __shared__ StepSmem sm;
  const int n_out = a.n_out, n_in = a.n_in, L = a.n_layers;
  const int ws = row_stride(n_in);
  const int k = blockIdx.x, img = a.images ? a.images[k] : k;
  const long long ob = (long long)k * a.out_stride;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, wid = tid >> 5, nw = nt >> 5;
  int* oid_s = (int*)dyn;
  unsigned* comp = kSmem ? dyn + ((n_out + 3) & ~3)
                         : a.scratch + (size_t)k * a.scratch_words;
  unsigned* lay = comp + (size_t)n_out * ws;

  load_layer(a, L - 1, img, comp, ws);
  if (a.tdt[L - 1])
    write_tdt(a, comp, ws, a.tdt[L - 1] + (size_t)k * 4 * a.out_stride);
  __syncthreads();                 // comp is read above, composed below
  for (int j = L - 2; j >= 0; --j) {
    if (a.kind[j] == kRows) {
      compose_rows(a, comp, ws, (const unsigned*)a.src[j], (n_in + 31) >> 5);
    } else {
      load_layer(a, j, img, lay, ws);
      if (a.tdt[j])
        write_tdt(a, lay, ws, a.tdt[j] + (size_t)k * 4 * a.out_stride);
      compose_rows(a, comp, ws, lay, ws);
    }
    __syncthreads();
  }
  for (int t = tid; t < n_out; t += nt) {
    if (a.ar) a.ar[ob + t] = t;
    if (a.zero) a.zero[ob + t] = 0;
  }
  if (a.greedy) greedy_block<kPer>(a, comp, ws, sm, oid_s, ob);
  __syncthreads();

  // Dispatch rows from the TDT bytes (written above, or given).
  for (int j = 0; j < L; ++j) {
    if (!a.exec_dep[j]) continue;
    const uint8_t* tb =
        a.kind[j] == kCoords
            ? a.tdt[j] + (size_t)k * 4 * a.out_stride
            : (const uint8_t*)a.src[j] + img * a.src_stride[j];
    const bool gather = j == a.last_gather;
    for (int r = wid; r < n_out; r += nw) {
      const int o = gather ? oid_s[r] : r;
      const int c = emit_bytes(tb + (size_t)max(o, 0) * n_in, n_in,
                               a.exec_dep[j] + ob + (size_t)r * a.k_pad,
                               a.k_pad, lane);
      if (lane == 0) a.exec_cnt[j][ob + r] = o >= 0 ? c : 0;
    }
  }
}

__global__ void empty_kernel() {}

// Words of the block body's tables: the composite, and the layer being
// composed into it (chains).
long long table_words(int n_out, int n_in, int chain) {
  return (long long)row_stride(n_in) * n_out * (chain ? 2 : 1);
}

long long large_smem_bytes(int n_out, int n_in, int chain, int in_smem) {
  return 4LL * ((n_out + 3) & ~3) +
         (in_smem ? 4LL * table_words(n_out, n_in, chain) : 0);
}

// Dynamic smem limit set, per device and body: a function attribute
// holds for the current device only.
constexpr int kMaxDevices = 64;
std::mutex attr_mu;
long long attr_bytes[kMaxDevices][4] = {};

template <bool kSmem, int kPer>
int launch_large(const SchedArgs& a, long long smem, cudaStream_t st,
                 int slot) {
  {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> g(attr_mu);
    if (smem > attr_bytes[dev][slot]) {
      err = cudaFuncSetAttribute(
          schedule_large_kernel<kSmem, kPer>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      attr_bytes[dev][slot] = smem;
    }
  }
  schedule_large_kernel<kSmem, kPer>
      <<<a.n_images, kLargeThreads, (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the block body for an (n_out, n_in) table
// (chain: a layer is composed; in_smem: the tables live there), or -1 if
// that exceeds a block's limit.
extern "C" int schedule_group_smem_bytes(int n_out, int n_in, int chain,
                                         int in_smem) {
  const long long b = large_smem_bytes(n_out, n_in, chain, in_smem);
  return b > kSmemLimit ? -1 : (int)b;
}

// Words of global scratch per image when the tables do not live in
// shared memory.
extern "C" int schedule_group_scratch_words(int n_out, int n_in, int chain) {
  return (int)table_words(n_out, n_in, chain);
}

extern "C" int schedule_args_size() { return (int)sizeof(SchedArgs); }

extern "C" int schedule_group_launch(const void* args, void* stream) {
  const SchedArgs& a = *(const SchedArgs*)args;
  if (a.n_layers < 1 || a.n_layers > kMaxLayers || a.n_images < 1 ||
      a.n_out < 1 || a.n_in < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.small) {
    const int p = a.imgs_per_block;
    if (a.n_out > 32 || a.n_in > 32 || p < 1 || kSmallWarps % p != 0)
      return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)p * (a.n_layers + 1) * 32 * 4;  // <= 36 KB
    schedule_small_kernel<<<(a.n_images + p - 1) / p, kSmallThreads, smem,
                            st>>>(a);
    return (int)cudaGetLastError();
  }
  bool chain = false;
  for (int j = 0; j + 1 < a.n_layers; ++j) chain = chain || a.kind[j] != kRows;
  const long long smem =
      large_smem_bytes(a.n_out, a.n_in, chain, a.tables_in_smem);
  const int most = a.n_out > a.n_in ? a.n_out : a.n_in;
  if (smem > kSmemLimit ||
      (a.n_layers > 1 && a.n_in > 32 * 32 * kComposeChunks) ||
      (a.greedy && most > kPerThread * kLargeThreads) ||
      (!a.tables_in_smem && a.scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool one = most <= kLargeThreads;
  if (a.tables_in_smem)
    return one ? launch_large<true, 1>(a, smem, st, 0)
               : launch_large<true, kPerThread>(a, smem, st, 1);
  return one ? launch_large<false, 1>(a, smem, st, 2)
             : launch_large<false, kPerThread>(a, smem, st, 3);
}

// An empty kernel: the launch floor the schedule launch is measured
// against.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

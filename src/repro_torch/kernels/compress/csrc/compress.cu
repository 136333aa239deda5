// Fed-PLT uplink compression on the packed (N, M) agent buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/compress/kernel.py, all one pl.pallas_call
// (_row_blocked_call, :374):
//   rank_select    <- rank_select_2d (:384; _rank_select_kernel :261, _select_k :247):
//                     per (agent, segment) exact-k magnitude selection, topk (static
//                     k = max(1, int(ratio m))) and adaptive_topk (per-agent k_i from the
//                     energy of the descending squared magnitudes, clipped to [k, m]);
//                     ties kept in position order; columns outside every segment zero.
//   int8_quantize  <- int8_2d (_int8_kernel :341): per (agent, segment) symmetric int8
//                     quantize-dequantize.
// The plain versions are repro_torch/kernels/compress/ref.py; the kernels match them
// bit for bit (--fmad=false: every float operation rounds alone).
//
// Bound: bytes.  The least possible traffic is one read and one write of (N, M): at the
// trainer's shape (N = 4, M = 745,549,056, bf16) 11.93 GB, 3.561 ms at 3.35 TB/s.
//
// rank_select is a radix SELECT, not the reference's sort (nor its bitonic network): the
// key of an entry is the bit pattern of the float32 |x| (31 bits; NaN above inf), and the
// mask only needs the k-th largest key T, #(key > T), and the position rank of each tie.
//
// bf16: x is read twice and written once, 17.89 GB, plus the chunk histograms (about
// 0.4 GB written, read twice): about 5.6 ms at 3.35 TB/s.  The earlier three-read design
// took 17.8-18.2 ms on an H100 80GB HBM3 at 700 W (hist 2.43, ties 1.94, write 13.11 ms
// of a profiled call), its write a block scan on every tile; this one 8.2-8.8 ms on the
// same card (hist 2.73-2.79, write 4.34-4.44 ms).
//   (A) select_hist_kernel: key_hist.cuh's histogram of every chunk (at most 2^20 columns
//       of one segment) into its own row of H, 32,768 bins = every bf16 |x|.
//   (A') select_sum_kernel: per (row, segment) the bins summed over its chunks.
//   (B) select_exact_kernel: one block per (row, segment) walks the bins from the top.
//       topk: the bin holding the k-th entry (a block scan of counts).  adaptive_topk: one
//       thread accumulates count x square over the bins in float64, from the top, to
//       find k_i first.  The bin is T; #above and #ties come with it.
//   (C) tie_prefix_kernel: where only some ties are kept, each chunk's count of ties in
//       the segment's earlier chunks, from H[c][T] (no read of x).
//   (D) select_write_kernel: x where key > T, or key == T and the tie's position rank <
//       k - #above; 0 elsewhere and in gap columns.  A chunk whose ties are all kept or
//       all dropped (its tie prefix and H[c][T] say which) is elementwise; only the one
//       chunk of a (row, segment) where the kept ties end ranks them: a block scan per
//       step of 4 loads a thread, until the cut is passed.  Elsewhere eight 16-byte loads
//       in flight a thread, held two bf16 to a register, 256 threads a block, 4 blocks an
//       SM.
// float32 keeps the first design's two levels: (A) a per-(row, segment) histogram of key
// bits 30..16 per block of columns (128 KB dynamic smem), flushed with atomics; (B) the
// chosen high bin's low-bit histogram (key bits 15..0, 65,536 bins, global atomics), the
// energy walk using per-bin float64 energy sums at the first level and exact values at
// the second; (C) ties counted per block of columns; (D) the masked write ranking ties by
// a block scan of every tile.
// The float64 energy sums run in another order than the plain version's cumsum; the two
// choose the same k_i wherever energy * total is not within float64 rounding (~1e-16
// relative) of a prefix sum.
//
// int8: (A) per-(row, segment) max|x|: a block reduction, then atomicMax on the bits of
// the non-negative float.  (B) scale = dtype(max * fl32(1/127)) floored at the dtype's
// 1e-12, dtype(x / scale), rintf (half to even), saturated to [-128, 127], times the
// scale, rounded to the dtype: the plain version's operations one for one; a zero code
// gives +0.0, as the plain version's int8 cast does.  float32 runs them per entry.  bf16
// reads x twice and writes it once (17.89 GB, 5.34 ms at 3.35 TB/s) in chunks of 2^20
// columns: (A) absmax_kernel_packed, a packed unsigned max (__vmaxu2) on the |x| patterns,
// eight 16-byte loads a thread in flight; (B) quantize_kernel_table: each block builds its
// segment's code table -- the code of every |x| pattern up to the max, 32 KB of shared
// memory -- with the plain version's operations, then streams a gather, the sign, the
// clamp, one multiply and one rounding an entry, four 16-byte loads a thread in flight
// (eight spill at 64 registers).  Measured (chip_smoke.py phase 2, (4, 745,549,056) bf16, 18
// segments, on an "NVIDIA H100 80GB HBM3, 700.00 W"): 7.23-7.26 ms a call by CUDA events,
// 49% of the 3.561 ms bound, 6.0-6.1 ms of it in the kernels (a profiled call: absmax
// 1.86-1.88 ms at 3.2 TB/s, quantize 4.13-4.19 ms at 2.9 TB/s); the earlier design, an IEEE
// division an entry and one 16-byte load a thread in flight, took 15.90-16.10 ms in the same
// call (quantize 13.67 ms of a profiled call, on the same card in another run).
//
// Columns come in blocks of a chunk table built by the launcher (block -> segment or gap,
// column range); every offset is 64-bit (N * M > 2^31 at the trainer's shape).  Loads and
// stores are 16-byte vectors inside the range when the pointers allow, scalar at the edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "key_hist.cuh"

namespace {

constexpr int kHighBins = key_hist::kBins;  // key bits 30..16 (the sign bit of |x| is 0)
constexpr int kLowBins = 1 << 16;   // key bits 15..0 (float32 only)
constexpr int kBigThreads = 1024;   // histogram and select blocks
constexpr int kThreads = 512;       // streaming blocks
constexpr int kWriteThreads = 256;  // bf16 rank_select write blocks
constexpr int kWriteLoads = 8;      // 16-byte loads in flight per thread there
constexpr int kCutLoads = 4;        // and in the chunk where the kept ties end
constexpr int kInt8Loads = 4;       // and in the bf16 int8 write (8 spill at 64 registers)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the bits of the float32 |x|
__device__ __forceinline__ uint32_t key_of(float x) { return __float_as_uint(x) & 0x7FFFFFFFu; }
__device__ __forceinline__ uint32_t key_of(__nv_bfloat16 x) {
  return ((uint32_t)__bfloat16_as_ushort(x) & 0x7FFFu) << 16;
}

// |x| squared in the buffer dtype (the plain version's mag * mag)
template <typename T>
__device__ __forceinline__ double square_of(uint32_t key) {
  const float v = __uint_as_float(key);
  return (double)to_f(from_f<T>(v * v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// Column layout: segments, and a chunk table covering every column of a row once
// (segment chunks and gap chunks, in column order).
struct Layout {
  const int64_t* seg_lo;
  const int64_t* seg_hi;
  const int64_t* seg_k;        // static keep-count (topk k, adaptive_topk floor)
  const int64_t* chunk_lo;
  const int64_t* chunk_hi;
  const int64_t* chunk_seg;    // segment index, -1 for a gap
  const int64_t* chunk_first;  // first chunk of the same segment
  const int64_t* seg_first;    // each segment's first chunk
  const int64_t* seg_count;    // and its number of chunks
  int64_t n_segs, n_chunks, n_cols;
};

// Per-(row, segment) selection state, 10 int64 words.
struct RowSeg {
  long long k;          // keep count
  long long key;        // threshold key T: the k-th largest
  long long above;      // entries with key > T
  long long ties;       // entries with key == T
  long long bin;        // float32: high bin whose low histogram is inspected next (-1 none)
  long long bin_above;  // float32: entries in higher bins than `bin`
  long long cross;      // float32 adaptive: 1 while `bin` is the energy-crossing bin
  double s_before;      // float32 adaptive: energy of the higher bins
  double thr;           // float32 adaptive: energy * total
  long long pad;
};

// Calls f(e0, v, ok) once per tile for every thread of the block; the thread's V
// consecutive columns start at e0, ok marks those inside [lo, hi).  Tiles start at a
// column whose flat offset is a multiple of V, so a full group is one aligned vector.
template <typename T, int V, typename F>
__device__ __forceinline__ void for_each_tile(const T* row, int64_t row_off, int64_t lo,
                                              int64_t hi, F&& f) {
  const int64_t start = lo - (row_off + lo) % V;
  const int64_t step = (int64_t)blockDim.x * V;
  for (int64_t base = start; base < hi; base += step) {
    const int64_t e0 = base + (int64_t)threadIdx.x * V;
    T v[V];
    bool ok[V];
    if (e0 >= lo && e0 + V <= hi) {
      const Vec<T, V> w = *reinterpret_cast<const Vec<T, V>*>(row + e0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = w.v[k];
        ok[k] = true;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int64_t c = e0 + k;
        ok[k] = c >= lo && c < hi;
        v[k] = ok[k] ? row[c] : from_f<T>(0.f);
      }
    }
    f(e0, v, ok);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_group(T* row, int64_t e0, int64_t lo, int64_t hi,
                                            const T (&v)[V]) {
  if (e0 >= lo && e0 + V <= hi) {
    Vec<T, V> w;
#pragma unroll
    for (int k = 0; k < V; ++k) w.v[k] = v[k];
    *reinterpret_cast<Vec<T, V>*>(row + e0) = w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int64_t c = e0 + k;
      if (c >= lo && c < hi) row[c] = v[k];
    }
  }
}

template <typename T, int V>
__device__ void zero_fill(T* row, int64_t row_off, int64_t lo, int64_t hi) {
  const int64_t start = lo - (row_off + lo) % V;
  T z[V];
#pragma unroll
  for (int k = 0; k < V; ++k) z[k] = from_f<T>(0.f);
  for (int64_t base = start; base < hi; base += (int64_t)blockDim.x * V)
    store_group<T, V>(row, base + (int64_t)threadIdx.x * V, lo, hi, z);
}

// Exclusive prefix of v over the block's threads in thread order; *total = block sum.
// Every thread of the block must call it (it synchronises).
template <typename U>
__device__ U block_exclusive_scan(U v, U* total) {
  __shared__ U warp_sums[32];
  __shared__ U block_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  U inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const U t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  __syncthreads();  // an earlier call's readers are done with warp_sums
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const U w = lane < n_warps ? warp_sums[lane] : U(0);
    U wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const U t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) block_total = wi;
  }
  __syncthreads();
  *total = block_total;
  return warp_sums[warp] + inc - v;
}

struct Kth {
  long long bin, above, at;
};

// The bin holding the k-th largest entry (1 <= k <= sum of the counts), bins walked from
// the top: every thread gets the bin, the entries in higher bins, the entries in the bin.
__device__ Kth find_kth(const uint32_t* cnt, int n_bins, long long k) {
  __shared__ Kth res;
  const int per = n_bins / blockDim.x;
  const int top = n_bins - 1 - (int)threadIdx.x * per;
  unsigned long long local = 0;
  for (int i = 0; i < per; ++i) local += cnt[top - i];
  __syncthreads();  // an earlier call's readers are done with res
  if (threadIdx.x == 0) res = Kth{0, 0, 0};
  unsigned long long total;
  const unsigned long long before = block_exclusive_scan<unsigned long long>(local, &total);
  const unsigned long long kk = (unsigned long long)k;
  if (before < kk && kk <= before + local) {
    unsigned long long acc = before;
    for (int i = 0; i < per; ++i) {
      const unsigned long long c = cnt[top - i];
      if (acc + c >= kk) {
        res = Kth{top - i, (long long)acc, (long long)c};
        break;
      }
      acc += c;
    }
  }
  __syncthreads();
  return res;
}

// How many of c equal entries of square e, entering at prefix energy s < thr, keep the
// running sum s + j e below thr (j = 1..c).
__device__ long long count_below(double s, double e, long long c, double thr) {
  if (e == 0.0) return c;
  long long lo = 0, hi = c;  // the largest j in [0, c] with s + j e < thr
  while (lo < hi) {
    const long long mid = lo + (hi - lo + 1) / 2;
    if (s + (double)mid * e < thr) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ long long clamp_k(long long k, long long lo, long long hi) {
  return k < lo ? lo : (k > hi ? hi : k);
}

// ---------------------------------------------------------------------------
// rank_select
// ---------------------------------------------------------------------------

// (A, float32) High-bit histogram of one chunk of one row, added to its (row, segment)'s;
// with `energy` (adaptive_topk) also the float64 sum of the squares per bin.
template <typename T, int V>
__global__ void __launch_bounds__(kBigThreads)
    hist_high_kernel(const T* x, Layout L, uint32_t* hist, double* energy) {
  extern __shared__ uint32_t sh[];
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  if (seg < 0) return;
  for (int i = threadIdx.x; i < kHighBins; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int64_t rs = row * L.n_segs + seg;
  double* en = energy ? energy + rs * kHighBins : nullptr;
  const int64_t row_off = row * L.n_cols;
  for_each_tile<T, V>(x + row_off, row_off, L.chunk_lo[chunk], L.chunk_hi[chunk],
                      [&](int64_t, const T(&v)[V], const bool(&ok)[V]) {
#pragma unroll
                        for (int k = 0; k < V; ++k) {
                          if (!ok[k]) continue;
                          const uint32_t key = key_of(v[k]);
                          atomicAdd(&sh[key >> 16], 1u);
                          if (en) atomicAdd(&en[key >> 16], square_of<T>(key));
                        }
                      });
  __syncthreads();
  uint32_t* h = hist + rs * kHighBins;
  for (int i = threadIdx.x; i < kHighBins; i += blockDim.x)
    if (sh[i]) atomicAdd(&h[i], sh[i]);
}

// (B, bf16) where a high bin is one value, from the (row, segment)'s bin totals: k
// (adaptive: one thread walks the bins from the top in float64), then T's bin.
template <typename T>
__global__ void __launch_bounds__(kBigThreads)
    select_exact_kernel(Layout L, const uint32_t* hist, RowSeg* st, int adaptive,
                        double energy) {
  extern __shared__ uint32_t cnt[];
  __shared__ long long k_sh;
  const int64_t seg = blockIdx.x, row = blockIdx.y, rs = row * L.n_segs + seg;
  const uint32_t* h = hist + rs * kHighBins;
  for (int i = threadIdx.x; i < kHighBins; i += blockDim.x) cnt[i] = h[i];
  const long long m = L.seg_hi[seg] - L.seg_lo[seg];
  const long long k_floor = L.seg_k[seg];
  if (threadIdx.x == 0) k_sh = k_floor;
  __syncthreads();
  if (adaptive && threadIdx.x == 0) {
    double total = 0.0;
    for (int b = kHighBins - 1; b >= 0; --b)
      if (cnt[b]) total += (double)cnt[b] * square_of<T>((uint32_t)b << 16);
    total = fmax(total, 1e-30);
    const double thr = energy * total;
    double s = 0.0;
    long long below = 0;
    for (int b = kHighBins - 1; b >= 0; --b) {
      const uint32_t c = cnt[b];
      if (!c) continue;
      const double e = square_of<T>((uint32_t)b << 16);
      const double g = (double)c * e;
      if (s + g < thr) {
        s += g;
        below += c;
        continue;
      }
      below += count_below(s, e, c, thr);
      break;
    }
    k_sh = clamp_k(1 + below, k_floor, m);
  }
  __syncthreads();
  const long long k = k_sh;
  const Kth r = find_kth(cnt, kHighBins, k);
  if (threadIdx.x == 0) {
    RowSeg& s = st[rs];
    s.k = k;
    s.key = r.bin << 16;
    s.above = r.above;
    s.ties = r.at;
    s.bin = -1;
  }
}

// (B, float32, first level) topk: T's high bin.  adaptive_topk: the high bin where the
// energy walk crosses energy * total (or k = m when it never does).
__global__ void __launch_bounds__(kBigThreads)
    select_stage1_kernel(Layout L, const uint32_t* hist, const double* energy_hist,
                         RowSeg* st, int adaptive, double energy) {
  __shared__ long long bin_sh, above_sh;
  __shared__ double s_sh, thr_sh;
  const int64_t seg = blockIdx.x, row = blockIdx.y, rs = row * L.n_segs + seg;
  const uint32_t* h = hist + rs * kHighBins;
  const long long m = L.seg_hi[seg] - L.seg_lo[seg];
  long long k = L.seg_k[seg];
  RowSeg& s = st[rs];
  if (adaptive) {
    if (threadIdx.x == 0) {
      const double* en = energy_hist + rs * kHighBins;
      double total = 0.0;
      for (int b = kHighBins - 1; b >= 0; --b)
        if (h[b]) total += en[b];
      total = fmax(total, 1e-30);
      const double thr = energy * total;
      double acc = 0.0;
      long long above = 0, bin = -1;
      for (int b = kHighBins - 1; b >= 0; --b) {
        if (!h[b]) continue;
        if (acc + en[b] < thr) {
          acc += en[b];
          above += h[b];
        } else {
          bin = b;
          break;
        }
      }
      bin_sh = bin;
      above_sh = above;
      s_sh = acc;
      thr_sh = thr;
    }
    __syncthreads();
    if (bin_sh >= 0) {
      if (threadIdx.x == 0) {
        s.bin = bin_sh;
        s.bin_above = above_sh;
        s.cross = 1;
        s.s_before = s_sh;
        s.thr = thr_sh;
      }
      return;
    }
    k = m;  // every prefix stays below the threshold
  }
  const Kth r = find_kth(h, kHighBins, k);
  if (threadIdx.x == 0) {
    s.k = k;
    s.bin = r.bin;
    s.bin_above = r.above;
    s.cross = 0;
  }
}

// (A, float32, second level) low-bit histogram of the entries in the row-segment's
// inspected high bin.
template <typename T, int V>
__global__ void hist_low_kernel(const T* x, Layout L, const RowSeg* st, uint32_t* hist_lo) {
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  if (seg < 0) return;
  const int64_t rs = row * L.n_segs + seg;
  const long long bin = st[rs].bin;
  if (bin < 0) return;
  uint32_t* h = hist_lo + rs * kLowBins;
  const int64_t row_off = row * L.n_cols;
  for_each_tile<T, V>(x + row_off, row_off, L.chunk_lo[chunk], L.chunk_hi[chunk],
                      [&](int64_t, const T(&v)[V], const bool(&ok)[V]) {
#pragma unroll
                        for (int k = 0; k < V; ++k) {
                          const uint32_t key = key_of(v[k]);
                          if (ok[k] && (long long)(key >> 16) == bin)
                            atomicAdd(&h[key & 0xFFFFu], 1u);
                        }
                      });
}

// (B, float32, second level) adaptive crossing bin: finish the energy walk over its exact
// values to get k, then find k's high bin; if that is another bin, clear the low histogram
// and leave it for the next low pass.  Otherwise (and for topk) T from the low histogram.
__global__ void __launch_bounds__(kBigThreads)
    select_stage2_kernel(Layout L, const uint32_t* hist, uint32_t* hist_lo, RowSeg* st) {
  __shared__ long long k_sh;
  const int64_t seg = blockIdx.x, row = blockIdx.y, rs = row * L.n_segs + seg;
  RowSeg& s = st[rs];
  const long long bin = s.bin, bin_above = s.bin_above, cross = s.cross;
  const double s_before = s.s_before, thr = s.thr;
  long long k = s.k;
  __syncthreads();
  if (bin < 0) return;
  uint32_t* lo_h = hist_lo + rs * kLowBins;
  const long long m = L.seg_hi[seg] - L.seg_lo[seg];
  if (cross) {
    if (threadIdx.x == 0) {
      double acc = s_before;
      long long below = bin_above;
      for (int b = kLowBins - 1; b >= 0; --b) {
        const uint32_t c = lo_h[b];
        if (!c) continue;
        const double e = square_of<float>(((uint32_t)bin << 16) | (uint32_t)b);
        const double g = (double)c * e;
        if (acc + g < thr) {
          acc += g;
          below += c;
          continue;
        }
        below += count_below(acc, e, c, thr);
        break;
      }
      k_sh = clamp_k(1 + below, L.seg_k[seg], m);
    }
    __syncthreads();
    k = k_sh;
    const Kth r = find_kth(hist + rs * kHighBins, kHighBins, k);
    if (r.bin != bin) {
      for (int i = threadIdx.x; i < kLowBins; i += blockDim.x) lo_h[i] = 0;
      if (threadIdx.x == 0) {
        s.k = k;
        s.bin = r.bin;
        s.bin_above = r.above;
        s.cross = 0;
      }
      return;
    }
  }
  const Kth r = find_kth(lo_h, kLowBins, k - bin_above);
  if (threadIdx.x == 0) {
    s.k = k;
    s.key = (bin << 16) | r.bin;
    s.above = bin_above + r.above;
    s.ties = r.at;
    s.bin = -1;
  }
}

__device__ __forceinline__ bool ranks_ties(const RowSeg& s) {
  const long long need = s.k - s.above;
  return need > 0 && need < s.ties;
}

// (C, float32) entries equal to T in one chunk, where only some ties are kept.
template <typename T, int V>
__global__ void count_ties_kernel(const T* x, Layout L, const RowSeg* st, uint32_t* ties) {
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  if (seg < 0) return;
  const RowSeg& s = st[row * L.n_segs + seg];
  if (!ranks_ties(s)) return;
  const uint32_t t_key = (uint32_t)s.key;
  uint32_t local = 0;
  const int64_t row_off = row * L.n_cols;
  for_each_tile<T, V>(x + row_off, row_off, L.chunk_lo[chunk], L.chunk_hi[chunk],
                      [&](int64_t, const T(&v)[V], const bool(&ok)[V]) {
#pragma unroll
                        for (int k = 0; k < V; ++k) local += ok[k] && key_of(v[k]) == t_key;
                      });
  uint32_t total;
  block_exclusive_scan<uint32_t>(local, &total);
  if (threadIdx.x == 0) ties[row * L.n_chunks + chunk] = total;
}

// (D, float32) the masked write; gap chunks write zeros.
template <typename T, int V>
__global__ void write_select_kernel(const T* x, T* out, Layout L, const RowSeg* st,
                                    const uint32_t* ties) {
  __shared__ long long rank_sh;
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  const int64_t lo = L.chunk_lo[chunk], hi = L.chunk_hi[chunk];
  const int64_t row_off = row * L.n_cols;
  if (seg < 0) {
    zero_fill<T, V>(out + row_off, row_off, lo, hi);
    return;
  }
  const RowSeg& s = st[row * L.n_segs + seg];
  const uint32_t t_key = (uint32_t)s.key;
  const long long need = s.k - s.above;
  const bool rank = ranks_ties(s);
  const bool keep_ties = need >= s.ties;  // used when not ranking: all ties or none
  long long rank0 = 0;
  if (rank) {
    if (threadIdx.x == 0) {
      long long p = 0;
      for (int64_t j = L.chunk_first[chunk]; j < chunk; ++j) p += ties[row * L.n_chunks + j];
      rank_sh = p;
    }
    __syncthreads();
    rank0 = rank_sh;
  }
  T* orow = out + row_off;
  for_each_tile<T, V>(x + row_off, row_off, lo, hi,
                      [&](int64_t e0, const T(&v)[V], const bool(&ok)[V]) {
                        T o[V];
                        bool tie[V];
                        uint32_t n_tie = 0;
#pragma unroll
                        for (int k = 0; k < V; ++k) {
                          const uint32_t key = key_of(v[k]);
                          tie[k] = ok[k] && key == t_key;
                          n_tie += tie[k];
                          const bool keep = key > t_key || (tie[k] && keep_ties);
                          o[k] = keep ? v[k] : from_f<T>(0.f);
                        }
                        if (rank) {
                          uint32_t tile_ties;
                          long long r = rank0 + block_exclusive_scan<uint32_t>(n_tie, &tile_ties);
#pragma unroll
                          for (int k = 0; k < V; ++k) {
                            if (!tie[k]) continue;
                            o[k] = r < need ? v[k] : from_f<T>(0.f);
                            ++r;
                          }
                          rank0 += tile_ties;
                        }
                        store_group<T, V>(orow, e0, lo, hi, o);
                      });
}

// (A, bf16) one chunk's histogram into its row of H (n_rows x n_chunks x kHighBins).
template <int V>
__global__ void __launch_bounds__(key_hist::kHistThreads)
    select_hist_kernel(const __nv_bfloat16* x, Layout L, uint32_t* H) {
  extern __shared__ uint32_t sh[];
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  if (L.chunk_seg[chunk] < 0) return;
  const int64_t row_off = row * L.n_cols;
  key_hist::chunk_histogram<V>(x + row_off, row_off, L.chunk_lo[chunk], L.chunk_hi[chunk], sh,
                               H + (row * L.n_chunks + chunk) * kHighBins);
}

// (A', bf16) grid (segments x kSumBlocks, rows): each bin's total over the segment's
// chunks, into tot (n_rows x n_segs x kHighBins).
constexpr int kSumBlocks = kHighBins / key_hist::kSumThreads;
__global__ void __launch_bounds__(key_hist::kSumThreads)
    select_sum_kernel(Layout L, uint32_t* H, uint32_t* tot) {
  const int64_t seg = blockIdx.x / kSumBlocks, row = blockIdx.y;
  const int bin = (blockIdx.x % kSumBlocks) * key_hist::kSumThreads + threadIdx.x;
  key_hist::interval_bin_sums<false>(H + row * L.n_chunks * kHighBins, L.seg_first[seg],
                                     L.seg_count[seg], bin,
                                     tot + (row * L.n_segs + seg) * kHighBins + bin);
}

// (C, bf16) grid (segments, rows): where only some ties are kept, each chunk's count of
// ties in the segment's earlier chunks (H[c][T], scanned in chunk order).
__global__ void __launch_bounds__(kBigThreads)
    tie_prefix_kernel(Layout L, const uint32_t* H, const RowSeg* st, uint32_t* tie_pre) {
  const int64_t seg = blockIdx.x, row = blockIdx.y;
  const RowSeg& s = st[row * L.n_segs + seg];
  if (!ranks_ties(s)) return;
  const int64_t bin = s.key >> 16, first = L.seg_first[seg], count = L.seg_count[seg];
  const uint32_t* h = H + (row * L.n_chunks + first) * kHighBins + bin;
  uint32_t* pre = tie_pre + row * L.n_chunks + first;
  uint32_t carry = 0;
  for (int64_t c0 = 0; c0 < count; c0 += blockDim.x) {  // uniform over the block
    const int64_t c = c0 + threadIdx.x;
    const uint32_t v = c < count ? h[c * kHighBins] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan<uint32_t>(v, &total);
    if (c < count) pre[c] = carry + ex;
    carry += total;
  }
}

// Columns [lo, hi) of one chunk: out = x where bin > t_bin, or bin == t_bin and the tie is
// kept; else +0.0.  kRank: ties are ranked in column order from rank0 and kept while the
// rank is below need (a block scan a step until the cut is passed; every thread of the
// block calls it); otherwise ties are kept iff keep_ties.  The thread's u-th load of a step
// covers columns base + (u * blockDim + thread) * V ..., so every load is coalesced and the
// step's column order is (u, thread, k).
template <int V, int U, bool kRank>
__device__ __forceinline__ void write_steps(const uint16_t* xr, uint16_t* orow, int64_t row_off,
                                            int64_t lo, int64_t hi, uint32_t t_bin,
                                            bool keep_ties, long long rank0, long long need) {
  static_assert(!kRank || U <= 4, "the ranked ties of a step fit one 64-bit scan");
  const int64_t start = lo - (row_off + lo) % V;
  const int64_t step = (int64_t)blockDim.x * V;
  for (int64_t base = start; base < hi; base += U * step) {  // uniform over the block
    const bool rank = kRank && rank0 < need;  // uniform: the cut is in this step or later
    const bool hold = keep_ties || rank;      // ties stay until ranked
    key_hist::Packed<V> v[U];
    uint32_t tie[U];  // bit k: entry k of load u lies in the chunk and equals T
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t e0 = base + u * step + (int64_t)threadIdx.x * V;
      uint32_t ok = (1u << V) - 1u;
      if (V == 8 && e0 >= lo && e0 + V <= hi) {
        v[u] = *reinterpret_cast<const key_hist::Packed<V>*>(xr + e0);
      } else {  // the chunk's edges, and every column of an unaligned buffer
#pragma unroll
        for (int k = 0; k < (V + 1) / 2; ++k) v[u].w[k] = 0u;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int64_t c = e0 + k;
          if (c >= lo && c < hi) v[u].w[k >> 1] |= (uint32_t)xr[c] << (16 * (k & 1));
          else ok &= ~(1u << k);
        }
      }
      tie[u] = 0;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const uint32_t b = v[u].get(k) & 0x7FFFu;
        if (kRank && b == t_bin) tie[u] |= 1u << k;
        if (!(b > t_bin || (b == t_bin && hold))) v[u].clear(k);  // +0.0
      }
      tie[u] &= ok;
    }
    if (rank) {
      // the thread's ties of load u in 16-bit field u (a field's block sum is at most
      // blockDim x 8)
      unsigned long long n_tie = 0, tot;
#pragma unroll
      for (int u = 0; u < U; ++u) n_tie += (unsigned long long)__popc(tie[u]) << (16 * u);
      const unsigned long long ex = block_exclusive_scan<unsigned long long>(n_tie, &tot);
      long long before = rank0;  // ties in this step's earlier loads, then the thread's own
#pragma unroll
      for (int u = 0; u < U; ++u) {
        long long r = before + (long long)((ex >> (16 * u)) & 0xFFFFu);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (!(tie[u] >> k & 1u)) continue;
          if (r >= need) v[u].clear(k);
          ++r;
        }
        before += (long long)((tot >> (16 * u)) & 0xFFFFu);
      }
      rank0 = before;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t e0 = base + u * step + (int64_t)threadIdx.x * V;
      if (V == 8 && e0 >= lo && e0 + V <= hi) {
        *reinterpret_cast<key_hist::Packed<V>*>(orow + e0) = v[u];
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int64_t c = e0 + k;
          if (c >= lo && c < hi) orow[c] = (uint16_t)v[u].get(k);
        }
      }
    }
  }
}

// (D, bf16) the masked write of one chunk; gap chunks write zeros.  A chunk keeps all its
// ties or none, from its tie prefix and its own count H[c][T], except the one chunk of a
// (row, segment) where the kept ties end: it ranks them, with fewer loads a step.
template <int V>
__global__ void __launch_bounds__(kWriteThreads, 4)
    select_write_kernel(const __nv_bfloat16* x, __nv_bfloat16* out, Layout L, const RowSeg* st,
                        const uint32_t* H, const uint32_t* tie_pre) {
  static_assert(V == 1 || V == 8, "one bf16 or one 16-byte vector a load");
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  const int64_t lo = L.chunk_lo[chunk], hi = L.chunk_hi[chunk];
  const int64_t row_off = row * L.n_cols;
  if (seg < 0) {
    zero_fill<__nv_bfloat16, V>(out + row_off, row_off, lo, hi);
    return;
  }
  const RowSeg& s = st[row * L.n_segs + seg];
  const uint32_t t_bin = (uint32_t)(s.key >> 16);
  const long long need = s.k - s.above;
  bool keep_ties = need >= s.ties;
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x + row_off);
  uint16_t* orow = reinterpret_cast<uint16_t*>(out + row_off);
  if (ranks_ties(s)) {
    const long long pre = tie_pre[row * L.n_chunks + chunk];
    const long long here = H[(row * L.n_chunks + chunk) * kHighBins + t_bin];
    if (pre < need && need < pre + here) {  // the cut
      write_steps<V, kCutLoads, true>(xr, orow, row_off, lo, hi, t_bin, false, pre, need);
      return;
    }
    keep_ties = pre + here <= need;
  }
  write_steps<V, kWriteLoads, false>(xr, orow, row_off, lo, hi, t_bin, keep_ties, 0, 0);
}

// ---------------------------------------------------------------------------
// int8_quantize
// ---------------------------------------------------------------------------

// (A, float32) per-(row, segment) max|x| as the bits of the non-negative float
template <typename T, int V>
__global__ void absmax_kernel(const T* x, Layout L, uint32_t* amax) {
  __shared__ uint32_t warp_max[32];
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  if (seg < 0) return;
  uint32_t mx = 0;
  const int64_t row_off = row * L.n_cols;
  for_each_tile<T, V>(x + row_off, row_off, L.chunk_lo[chunk], L.chunk_hi[chunk],
                      [&](int64_t, const T(&v)[V], const bool(&ok)[V]) {
#pragma unroll
                        for (int k = 0; k < V; ++k)
                          if (ok[k]) mx = max(mx, key_of(v[k]));
                      });
  mx = __reduce_max_sync(0xffffffffu, mx);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < (int)((blockDim.x + 31) >> 5) ? warp_max[lane] : 0u;
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) atomicMax(&amax[row * L.n_segs + seg], mx);
  }
}

// (B, float32) quantize-dequantize; gap chunks write zeros
template <typename T, int V>
__global__ void quantize_kernel(const T* x, T* out, Layout L, const uint32_t* amax,
                                float inv127, float floor_) {
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  const int64_t lo = L.chunk_lo[chunk], hi = L.chunk_hi[chunk];
  const int64_t row_off = row * L.n_cols;
  if (seg < 0) {
    zero_fill<T, V>(out + row_off, row_off, lo, hi);
    return;
  }
  const float a = __uint_as_float(amax[row * L.n_segs + seg]);
  float scale = to_f(from_f<T>(a * inv127));
  scale = scale < floor_ ? floor_ : scale;
  T* orow = out + row_off;
  for_each_tile<T, V>(x + row_off, row_off, lo, hi,
                      [&](int64_t e0, const T(&v)[V], const bool(&)[V]) {
                        T o[V];
#pragma unroll
                        for (int k = 0; k < V; ++k) {
                          const float d = to_f(from_f<T>(to_f(v[k]) / scale));
                          // + 0: a zero code is +0.0, as the plain version's int8 cast
                          const float q = fminf(fmaxf(rintf(d), -128.f), 127.f) + 0.0f;
                          o[k] = from_f<T>(q * scale);
                        }
                        store_group<T, V>(orow, e0, lo, hi, o);
                      });
}

// One load of V bf16 patterns at columns e0 .. e0 + V - 1 of a row: a 16-byte vector inside
// [lo, hi) when V = 8, else scalars, 0 outside [lo, hi).
template <int V>
__device__ __forceinline__ key_hist::Packed<V> load_packed(const uint16_t* r, int64_t e0,
                                                           int64_t lo, int64_t hi) {
  key_hist::Packed<V> v;
  if (V == 8 && e0 >= lo && e0 + V <= hi) return *reinterpret_cast<const key_hist::Packed<V>*>(r + e0);
#pragma unroll
  for (int k = 0; k < (V + 1) / 2; ++k) v.w[k] = 0u;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t c = e0 + k;
    if (c >= lo && c < hi) v.w[k >> 1] |= (uint32_t)r[c] << (16 * (k & 1));
  }
  return v;
}

template <int V>
__device__ __forceinline__ void store_packed(uint16_t* r, int64_t e0, int64_t lo, int64_t hi,
                                             const key_hist::Packed<V>& v) {
  if (V == 8 && e0 >= lo && e0 + V <= hi) {
    *reinterpret_cast<key_hist::Packed<V>*>(r + e0) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int64_t c = e0 + k;
    if (c >= lo && c < hi) r[c] = (uint16_t)v.get(k);
  }
}

// (A, bf16) per-(row, segment) max|x|: a packed unsigned max of the |x| patterns (bits &
// 0x7fff, ordered as key_of orders them), kWriteLoads 16-byte loads a thread in flight; one
// atomicMax a block on the key (pattern << 16).
template <int V>
__global__ void __launch_bounds__(kWriteThreads, 4)
    absmax_kernel_packed(const __nv_bfloat16* x, Layout L, uint32_t* amax) {
  static_assert(V == 1 || V == 8, "one bf16 or one 16-byte vector a load");
  __shared__ uint32_t warp_max[kWriteThreads / 32];
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  if (seg < 0) return;
  const int64_t lo = L.chunk_lo[chunk], hi = L.chunk_hi[chunk];
  const int64_t row_off = row * L.n_cols;
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x + row_off);
  const int64_t start = lo - (row_off + lo) % V;
  const int64_t step = (int64_t)blockDim.x * V;
  uint32_t mx = 0;  // two |x| patterns, one a half word
  for (int64_t base = start; base < hi; base += kWriteLoads * step) {
    key_hist::Packed<V> v[kWriteLoads];
#pragma unroll
    for (int u = 0; u < kWriteLoads; ++u)
      v[u] = load_packed<V>(xr, base + u * step + (int64_t)threadIdx.x * V, lo, hi);
#pragma unroll
    for (int u = 0; u < kWriteLoads; ++u)
#pragma unroll
      for (int k = 0; k < (V + 1) / 2; ++k) mx = __vmaxu2(mx, v[u].w[k] & 0x7FFF7FFFu);
  }
  mx = __reduce_max_sync(0xffffffffu, max(mx & 0xFFFFu, mx >> 16));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = mx;
  __syncthreads();
  if (warp == 0) {
    mx = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0u;
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (lane == 0) atomicMax(&amax[row * L.n_segs + seg], mx << 16);
  }
}

// (B, bf16) quantize-dequantize through the (row, segment)'s code table; gap chunks write
// zeros.  The block first builds, in shared memory, the code of every |x| pattern p up to
// the segment's max with the plain version's operations -- bf16(p / scale), rint, saturated
// at 128 (a NaN quotient: 0, as the plain version's int8 cast gives on the card) -- then
// streams: q = -code for a negative x, min(code, 127) otherwise (the clamp after the sign;
// an integer, so a zero code is +0), out = bf16(q * scale).  kInt8Loads 16-byte loads a
// thread in flight, two bf16 a register, 256 threads a block, 4 blocks an SM.
template <int V>
__global__ void __launch_bounds__(kWriteThreads, 4)
    quantize_kernel_table(const __nv_bfloat16* x, __nv_bfloat16* out, Layout L,
                          const uint32_t* amax, float inv127, float floor_) {
  static_assert(V == 1 || V == 8, "one bf16 or one 16-byte vector a load");
  __shared__ uint8_t code[kHighBins];
  const int64_t chunk = blockIdx.x, row = blockIdx.y;
  const int64_t seg = L.chunk_seg[chunk];
  const int64_t lo = L.chunk_lo[chunk], hi = L.chunk_hi[chunk];
  const int64_t row_off = row * L.n_cols;
  if (seg < 0) {
    zero_fill<__nv_bfloat16, V>(out + row_off, row_off, lo, hi);
    return;
  }
  const uint32_t a_key = amax[row * L.n_segs + seg];
  float scale = __bfloat162float(__float2bfloat16_rn(__uint_as_float(a_key) * inv127));
  scale = scale < floor_ ? floor_ : scale;
  for (uint32_t p = threadIdx.x; p <= (a_key >> 16); p += blockDim.x) {
    const float v = __bfloat162float(__ushort_as_bfloat16((unsigned short)p));
    const float r = rintf(__bfloat162float(__float2bfloat16_rn(v / scale)));
    code[p] = r >= 128.f ? 128 : (r >= 1.f ? (uint8_t)r : 0);
  }
  __syncthreads();
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x + row_off);
  uint16_t* orow = reinterpret_cast<uint16_t*>(out + row_off);
  const int64_t start = lo - (row_off + lo) % V;
  const int64_t step = (int64_t)blockDim.x * V;
  for (int64_t base = start; base < hi; base += kInt8Loads * step) {
    key_hist::Packed<V> v[kInt8Loads];
#pragma unroll
    for (int u = 0; u < kInt8Loads; ++u)
      v[u] = load_packed<V>(xr, base + u * step + (int64_t)threadIdx.x * V, lo, hi);
#pragma unroll
    for (int u = 0; u < kInt8Loads; ++u) {
#pragma unroll
      for (int k = 0; k < (V + 1) / 2; ++k) {
        float f[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t b = (v[u].w[k] >> (16 * h)) & 0xFFFFu;
          const int c = code[b & 0x7FFFu];
          f[h] = (float)((b & 0x8000u) ? -c : min(c, 127)) * scale;
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(f[0], f[1]);
        v[u].w[k] = *reinterpret_cast<const uint32_t*>(&o);
      }
    }
#pragma unroll
    for (int u = 0; u < kInt8Loads; ++u)
      store_packed<V>(orow, base + u * step + (int64_t)threadIdx.x * V, lo, hi, v[u]);
  }
}


// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

#define RETURN_IF_ERROR()                        \
  do {                                           \
    const cudaError_t e_ = cudaGetLastError();   \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// float32: the two-level radix select.
template <int V>
int rank_select_f32_launch(const float* x, float* out, int64_t n_rows, const Layout& L,
                           int adaptive, double energy, uint32_t* hist_hi, uint32_t* hist_lo,
                           double* energy_hi, RowSeg* st, uint32_t* ties, cudaStream_t s) {
  const dim3 chunks((unsigned)L.n_chunks, (unsigned)n_rows);
  const dim3 segs((unsigned)L.n_segs, (unsigned)n_rows);
  const size_t hist_smem = kHighBins * sizeof(uint32_t);
  if (L.n_segs > 0) {
    cudaFuncSetAttribute(hist_high_kernel<float, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)hist_smem);
    hist_high_kernel<float, V><<<chunks, kBigThreads, hist_smem, s>>>(
        x, L, hist_hi, adaptive ? energy_hi : nullptr);
    RETURN_IF_ERROR();
    select_stage1_kernel<<<segs, kBigThreads, 0, s>>>(L, hist_hi, energy_hi, st, adaptive,
                                                       energy);
    RETURN_IF_ERROR();
    for (int pass = 0; pass < 2; ++pass) {  // adaptive may inspect a second high bin
      hist_low_kernel<float, V><<<chunks, kThreads, 0, s>>>(x, L, st, hist_lo);
      RETURN_IF_ERROR();
      select_stage2_kernel<<<segs, kBigThreads, 0, s>>>(L, hist_hi, hist_lo, st);
      RETURN_IF_ERROR();
    }
    count_ties_kernel<float, V><<<chunks, kThreads, 0, s>>>(x, L, st, ties);
    RETURN_IF_ERROR();
  }
  write_select_kernel<float, V><<<chunks, kThreads, 0, s>>>(x, out, L, st, ties);
  RETURN_IF_ERROR();
  return 0;
}

// bf16: the chunk histograms, two reads of x.  tot: the per-(row, segment) bin totals;
// H: the per-(row, chunk) histograms; tie_pre: per (row, chunk).
template <int V>
int rank_select_bf16_launch(const __nv_bfloat16* x, __nv_bfloat16* out, int64_t n_rows,
                            const Layout& L, int adaptive, double energy, uint32_t* tot,
                            uint32_t* H, RowSeg* st, uint32_t* tie_pre, cudaStream_t s) {
  const dim3 chunks((unsigned)L.n_chunks, (unsigned)n_rows);
  const dim3 segs((unsigned)L.n_segs, (unsigned)n_rows);
  const size_t hist_smem = kHighBins * sizeof(uint32_t);
  if (L.n_segs > 0) {
    cudaFuncSetAttribute(select_hist_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)hist_smem);
    select_hist_kernel<V><<<chunks, key_hist::kHistThreads, hist_smem, s>>>(x, L, H);
    RETURN_IF_ERROR();
    select_sum_kernel<<<dim3((unsigned)(L.n_segs * kSumBlocks), (unsigned)n_rows),
                        key_hist::kSumThreads, 0, s>>>(L, H, tot);
    RETURN_IF_ERROR();
    cudaFuncSetAttribute(select_exact_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)hist_smem);
    select_exact_kernel<__nv_bfloat16><<<segs, kBigThreads, hist_smem, s>>>(L, tot, st, adaptive,
                                                                            energy);
    RETURN_IF_ERROR();
    tie_prefix_kernel<<<segs, kBigThreads, 0, s>>>(L, H, st, tie_pre);
    RETURN_IF_ERROR();
  }
  select_write_kernel<V><<<chunks, kWriteThreads, 0, s>>>(x, out, L, st, H, tie_pre);
  RETURN_IF_ERROR();
  return 0;
}

template <typename T, int V>
int int8_launch(const T* x, T* out, int64_t n_rows, const Layout& L, uint32_t* amax,
                float inv127, float floor_, cudaStream_t s) {
  const dim3 chunks((unsigned)L.n_chunks, (unsigned)n_rows);
  if (L.n_segs > 0) {
    absmax_kernel<T, V><<<chunks, kThreads, 0, s>>>(x, L, amax);
    RETURN_IF_ERROR();
  }
  quantize_kernel<T, V><<<chunks, kThreads, 0, s>>>(x, out, L, amax, inv127, floor_);
  RETURN_IF_ERROR();
  return 0;
}

template <int V>
int int8_bf16_launch(const __nv_bfloat16* x, __nv_bfloat16* out, int64_t n_rows,
                     const Layout& L, uint32_t* amax, float inv127, float floor_,
                     cudaStream_t s) {
  const dim3 chunks((unsigned)L.n_chunks, (unsigned)n_rows);
  if (L.n_segs > 0) {
    absmax_kernel_packed<V><<<chunks, kWriteThreads, 0, s>>>(x, L, amax);
    RETURN_IF_ERROR();
  }
  quantize_kernel_table<V><<<chunks, kWriteThreads, 0, s>>>(x, out, L, amax, inv127, floor_);
  RETURN_IF_ERROR();
  return 0;
}

Layout make_layout(const int64_t* seg_lo, const int64_t* seg_hi, const int64_t* seg_k,
                   const int64_t* seg_first, const int64_t* seg_count, int64_t n_segs,
                   const int64_t* chunk_lo, const int64_t* chunk_hi, const int64_t* chunk_seg,
                   const int64_t* chunk_first, int64_t n_chunks, int64_t n_cols) {
  return Layout{seg_lo,    seg_hi,    seg_k,    chunk_lo, chunk_hi, chunk_seg,
                chunk_first, seg_first, seg_count, n_segs,  n_chunks, n_cols};
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vec: 16-byte vectors allowed (both pointers aligned);
// mode: 0 topk, 1 adaptive_topk.  seg_first / seg_count: each segment's chunks.  Scratch
// from the caller.  float32, zeroed: hist_hi (N S 32768 u32), hist_lo (N S 65536 u32),
// energy_hi (adaptive: N S 32768 f64), state (N S RowSeg), ties (N n_chunks u32).  bf16,
// nothing zeroed: hist_hi (the bin totals, N S 32768 u32), chunk_hist (N n_chunks 32768
// u32, 16-byte aligned), state (N S RowSeg), ties (the tie prefixes, N n_chunks u32).
// Returns the first launch's cudaGetLastError() that is not 0, -1 for an unknown dtype,
// else 0.
extern "C" int repro_rank_select(const void* x, void* out, int64_t n_rows, int64_t n_cols,
                                 int dtype, int vec, int mode, double energy,
                                 const int64_t* seg_lo, const int64_t* seg_hi,
                                 const int64_t* seg_k, const int64_t* seg_first,
                                 const int64_t* seg_count, int64_t n_segs,
                                 const int64_t* chunk_lo, const int64_t* chunk_hi,
                                 const int64_t* chunk_seg, const int64_t* chunk_first,
                                 int64_t n_chunks, void* hist_hi, void* hist_lo, void* energy_hi,
                                 void* chunk_hist, void* state, void* ties, void* stream) {
  const Layout L = make_layout(seg_lo, seg_hi, seg_k, seg_first, seg_count, n_segs, chunk_lo,
                               chunk_hi, chunk_seg, chunk_first, n_chunks, n_cols);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t *hh = (uint32_t*)hist_hi, *hl = (uint32_t*)hist_lo, *tc = (uint32_t*)ties;
  uint32_t* ch = (uint32_t*)chunk_hist;
  double* eh = (double*)energy_hi;
  RowSeg* st = (RowSeg*)state;
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  __nv_bfloat16* ob = (__nv_bfloat16*)out;
  switch (dtype) {
    case 0:
      return vec ? rank_select_f32_launch<4>((const float*)x, (float*)out, n_rows, L, mode,
                                             energy, hh, hl, eh, st, tc, s)
                 : rank_select_f32_launch<1>((const float*)x, (float*)out, n_rows, L, mode,
                                             energy, hh, hl, eh, st, tc, s);
    case 1:
      return vec ? rank_select_bf16_launch<8>(xb, ob, n_rows, L, mode, energy, hh, ch, st, tc, s)
                 : rank_select_bf16_launch<1>(xb, ob, n_rows, L, mode, energy, hh, ch, st, tc,
                                              s);
  }
  return -1;
}

// amax: N S u32, zeroed by the caller; floor_ is 1e-12 rounded to the dtype.
extern "C" int repro_int8_quantize(const void* x, void* out, int64_t n_rows, int64_t n_cols,
                                   int dtype, int vec, const int64_t* seg_lo,
                                   const int64_t* seg_hi, int64_t n_segs,
                                   const int64_t* chunk_lo, const int64_t* chunk_hi,
                                   const int64_t* chunk_seg, const int64_t* chunk_first,
                                   int64_t n_chunks, void* amax, float inv127, float floor_,
                                   void* stream) {
  const Layout L = make_layout(seg_lo, seg_hi, nullptr, nullptr, nullptr, n_segs, chunk_lo,
                               chunk_hi, chunk_seg, chunk_first, n_chunks, n_cols);
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* am = (uint32_t*)amax;
  switch (dtype) {
    case 0:
      return vec ? int8_launch<float, 4>((const float*)x, (float*)out, n_rows, L, am, inv127,
                                         floor_, s)
                 : int8_launch<float, 1>((const float*)x, (float*)out, n_rows, L, am, inv127,
                                         floor_, s);
    case 1:
      return vec ? int8_bf16_launch<8>((const __nv_bfloat16*)x, (__nv_bfloat16*)out, n_rows, L,
                                       am, inv127, floor_, s)
                 : int8_bf16_launch<1>((const __nv_bfloat16*)x, (__nv_bfloat16*)out, n_rows, L,
                                       am, inv127, floor_, s);
  }
  return -1;
}

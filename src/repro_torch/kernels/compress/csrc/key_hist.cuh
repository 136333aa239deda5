// Per-chunk histograms of the bf16 magnitude key, for Hopper (sm_90a).
//
// Shared by compress.cu (rank_select on bf16) and segment_ranks.cu (the bf16 counting
// rank).  The magnitude key of an entry is the bit pattern of the float32 |x| (NaN above
// inf, +-0.0 equal); for bf16 only its bits 30..16 vary, and they are the bf16 pattern
// without its sign bit.  So a bin of key >> 16 -- 32,768 of them -- holds one value, and a
// histogram of the bins is an exact count of every value.
//
// chunk_histogram: one block counts one chunk (a launcher's range of at most a fixed number
// of columns of one row, never across a column interval) into 128 KB of shared memory and
// stores all 32,768 counts to the chunk's own row of H with plain 16-byte stores: no
// global atomics, and every later pass can read a chunk's counts.  Each entry is one
// shared-memory atomicAdd; four 16-byte loads a thread are in flight before their
// increments.  Warp aggregation (__match_any_sync on the bin, one add per group of
// lanes) made the pass 10x slower on an H100 80GB HBM3 at 700 W (23.6 ms against
// 2.43 ms for plain atomics at the trainer's packed increment): MATCH costs more
// than the bank conflicts and same-address retries it saves, even on all-equal rows.
//
// interval_bin_sums: one thread per bin walks an interval's chunks in column order, 8 loads
// in flight, and writes the bin's total over the interval; with kPrefix it leaves in H, for
// each chunk, the bin's count in the interval's earlier chunks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace key_hist {

constexpr int kBins = 1 << 15;      // bf16 |x| patterns = float32 key bits 30..16
constexpr int kHistThreads = 1024;  // 128 KB of bins: one block an SM, so the most threads
constexpr int kSumThreads = 256;    // interval_bin_sums blocks (kBins is a multiple)

// V bf16 patterns of one load, two to a 32-bit word (V = 1: the low half of w[0]); V = 8
// is one 16-byte vector.
template <int V>
struct alignas(V == 8 ? 16 : 4) Packed {
  uint32_t w[(V + 1) / 2];
  __device__ __forceinline__ uint32_t get(int k) const {
    return (w[k >> 1] >> (16 * (k & 1))) & 0xFFFFu;
  }
  __device__ __forceinline__ void clear(int k) { w[k >> 1] &= ~(0xFFFFu << (16 * (k & 1))); }
};

// Called by every thread of a block of kHistThreads.  row: the row's first entry, row_off
// its flat offset (vector loads start at flat offsets that are multiples of V); [lo, hi)
// the chunk's columns.  V = 8 only when the buffer's pointer is 16-byte aligned.  sh:
// kBins u32 of dynamic shared memory.  H: the chunk's kBins counts, 16-byte aligned.
template <int V>
__device__ void chunk_histogram(const __nv_bfloat16* row, int64_t row_off, int64_t lo,
                                int64_t hi, uint32_t* sh, uint32_t* H) {
  constexpr int kLoads = 4;
  for (int i = threadIdx.x; i < kBins; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const uint16_t* r = reinterpret_cast<const uint16_t*>(row);
  const int64_t start = lo - (row_off + lo) % V;
  const int64_t step = (int64_t)blockDim.x * V;
  for (int64_t base = start; base < hi; base += kLoads * step) {  // uniform over the block
    uint32_t bin[kLoads][V];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int64_t e0 = base + u * step + (int64_t)threadIdx.x * V;
      if (V == 8 && e0 >= lo && e0 + V <= hi) {
        const Packed<V> w = *reinterpret_cast<const Packed<V>*>(r + e0);
#pragma unroll
        for (int k = 0; k < V; ++k) bin[u][k] = w.get(k) & 0x7FFFu;
      } else {  // the chunk's edges, and every column of an unaligned buffer
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int64_t c = e0 + k;
          bin[u][k] = (c >= lo && c < hi) ? (r[c] & 0x7FFFu) : 0xFFFFFFFFu;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (bin[u][k] != 0xFFFFFFFFu) atomicAdd(&sh[bin[u][k]], 1u);
    }
  }
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(sh);
  uint4* dst = reinterpret_cast<uint4*>(H);
  for (int i = threadIdx.x; i < kBins / 4; i += blockDim.x) dst[i] = src[i];
}

// One thread per bin of one (row, interval).  Hrow: the row's H (n_chunks x kBins); the
// interval's chunks are [first, first + count).  Writes the bin's total to *tot; with
// kPrefix, H[c][bin] becomes the bin's count in the chunks [first, c).
template <bool kPrefix>
__device__ void interval_bin_sums(uint32_t* Hrow, int64_t first, int64_t count, int bin,
                                  uint32_t* tot) {
  constexpr int kBatch = 8;
  uint32_t* p = Hrow + first * kBins + bin;
  uint32_t s = 0;
  int64_t c = 0;
  for (; c + kBatch <= count; c += kBatch) {
    uint32_t v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = p[(c + j) * kBins];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (kPrefix) p[(c + j) * kBins] = s;
      s += v[j];
    }
  }
  for (; c < count; ++c) {
    const uint32_t v = p[c * kBins];
    if (kPrefix) p[c * kBins] = s;
    s += v;
  }
  *tot = s;
}

}  // namespace key_hist

// Stable descending-|x| ranks within column intervals, for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/compress/kernel.py reached through
// segment_ranks_2d (:398; body _segment_ranks_kernel :334 over _segment_ranks :192, the
// one pl.pallas_call of _row_blocked_call :374): for every row of an (N, M) float32 or
// bfloat16 buffer, the int32 rank of each entry within its column interval -- the
// segments and each gap before, between or after them (_column_intervals :80) -- in
// stable descending order of the magnitude key (the bits of the float32 |x|; NaN above
// inf, +-0.0 tie), ties in column order.  The plain version is
// repro_torch/kernels/compress/ref.py segment_ranks_ref; the kernel matches it bit for bit.
//
// Bound: bytes.  The least traffic is one read of x and one write of the int32 ranks: at
// the trainer's packed increment (N = 4, M = 745,549,056, bf16) 17.89 GB, 5.341 ms at
// 3.35 TB/s.
//
// bf16: a counting rank.  A bf16 key has 15 free bits, so the rank of entry j of interval
// I is
//   #(keys of I above key_j) + #(key_j in I's earlier chunks) + #(key_j earlier in j's chunk),
// with no global sort and no scattered global write.  Its traffic: x read twice, the ranks
// written once (23.86 GB), and the chunk histograms (about 0.4 GB written, read and
// rewritten, read):
// about 7.6 ms at 3.35 TB/s.  The radix sort, which this replaces for bf16, took
// 333.4-335.9 ms on an H100 80GB HBM3 at 700 W, 96% of it in scattered 4-byte writes; this
// design takes 39.5-40.0 ms on the same card (hist 2.74-2.78, bases 0.79-0.80, rank
// 35.8 ms): its rank pass is bound, by count, by shared-memory wavefronts and issue, not
// by bytes.
//   (A) rank_hist_kernel: key_hist.cuh's 32,768-bin histogram of every chunk (at most 2^20
//       columns of one interval) into its own row of H.
//   (B) rank_sum_kernel: per (row, interval) and bin, a walk over the interval's chunks in
//       column order leaves in H[c][bin] the bin's count in the earlier chunks and writes
//       the bin's total; rank_above_kernel scans the totals from the top bin down, so
//       above[bin] = #(keys of I above bin).
//   (C) rank_write_kernel: one block per chunk loads base[bin] = H[c][bin] + above[bin]
//       (128 KB of shared memory) and walks the chunk in tiles of 8,192 columns.  The hard
//       part is the stable count among equal keys across the 32 warps of a block.  A tile
//       is ranked in shared memory by a stable block sort of (bin << 13 | position): two
//       LSD passes of 8-bit digits, each a per-warp count (eight ballots group the lanes
//       of a round by digit), an exclusive scan of the 32 x 256 counters and a scatter
//       into one 32 KB buffer (two sets of counters alternate, so a pass clears the
//       next one's while it counts: four barriers a pass).  Equal bins then lie together
//       in column order; the run of bin b that starts at sorted index s0 takes ranks
//       base[b] + (s - s0), and its last entry advances base[b] by the run's length: one
//       update per distinct bin of the tile.  Per-warp counts of the tile's distinct
//       bins were the other choice; they need a cross-warp prefix per bin, which is the
//       same scan without the bound on its size.  The ranks go back through the buffer
//       and out in column order, coalesced.  The next tile's 8 loads a thread are in
//       flight during the sort.
// float32 keeps the stable LSD radix sort of (key, column) pairs per (row, interval):
// its 31-bit key has no 32,768-bin counting form.  8-bit digits of the complemented key
// ck = 0x7FFFFFFF - key (ascending ck is descending |x|), four passes (shifts 0, 8, 16,
// 24).  The first pass reads x (the key computed, the column implicit), the last writes
// rank[column] = position - interval start, the ones between move pairs from one scratch
// buffer to the other.  Each pass:
//   (A) radix_hist_kernel: a 256-bin digit histogram of every tile (4096 positions of one
//       interval; tiles never straddle an interval) in shared memory, stored at
//       first * 256 + digit * count + (tile - first) for the tiles [first, first + count)
//       of the interval, i.e. per interval digit-major, tile-minor.
//   (B) three scan kernels: an exclusive scan of that array per row.  Because the
//       intervals partition [0, M) in column order, the scan at interval l starts at its
//       first column: the scanned entry of (tile, digit) is the row position where that
//       tile's entries of that digit go.
//   (C) scatter_kernel: each warp owns 256 consecutive positions of the tile (8 rounds of
//       32 lanes, in position order); __match_any_sync groups the lanes of a round by
//       digit, per-warp digit counters in shared memory (an exclusive prefix over the
//       warps, plus the tile's base from (B)) give each entry its stable destination.
//       Its cost is the scattered writes (a follow-up stages each digit run whole).
// Rows go in groups whose scratch the launcher bounds; offsets into x and the ranks are
// 64-bit (N M > 2^31 at the full shape), positions inside a row 32-bit (the launcher
// refuses M >= 2^31).  The float32 sort's loads are scalar, so any alignment of x works;
// the bf16 histogram loads 16-byte vectors when the launcher says x is aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "key_hist.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: the radix sort
// ---------------------------------------------------------------------------

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;      // scatter and histogram blocks
constexpr int kItems = 8;                  // positions per lane
constexpr int kTile = kThreads * kItems;   // 4096 positions of one interval
constexpr int kRadix = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;
constexpr int kScanChunk = kScanThreads * kScanItems;  // scanned entries per block
constexpr uint32_t kNoDigit = 0x100;       // lanes past the end of a tile

#define RETURN_IF_ERROR()                   \
  do {                                      \
    cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

// the complemented 31-bit magnitude key
__device__ __forceinline__ uint32_t ckey_of(float x) {
  return 0x7FFFFFFFu - (__float_as_uint(x) & 0x7FFFFFFFu);
}

// One tile: positions [lo, hi) of the interval whose tiles are [first, first + count).
struct Tile {
  int64_t lo, hi, first, count;
};

__device__ __forceinline__ int64_t hist_index(const Tile& tl, int64_t t, int d) {
  return tl.first * kRadix + (int64_t)d * tl.count + (t - tl.first);
}

// (A) grid (n_tiles, rows of the group)
template <bool kFirst>
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const float* x, const uint32_t* key_in, int64_t n_cols, int64_t row0,
                  const Tile* tiles, int64_t n_tiles, int shift, uint32_t* hist) {
  __shared__ uint32_t h[kRadix];
  const int64_t t = blockIdx.x, r = blockIdx.y;
  for (int i = threadIdx.x; i < kRadix; i += kThreads) h[i] = 0;
  __syncthreads();
  const Tile tl = tiles[t];
  const int64_t xoff = (row0 + r) * n_cols, soff = r * n_cols;
  for (int64_t p = tl.lo + threadIdx.x; p < tl.hi; p += kThreads) {
    const uint32_t k = kFirst ? ckey_of(x[xoff + p]) : key_in[soff + p];
    atomicAdd(&h[(k >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  uint32_t* H = hist + r * n_tiles * kRadix;
  for (int d = threadIdx.x; d < kRadix; d += kThreads) H[hist_index(tl, t, d)] = h[d];
}

// Exclusive scan of one value per thread over a block of kScanThreads; returns the
// thread's prefix and leaves the block total in *total.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* warp_sums,
                                                         uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t n = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += n;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const uint32_t before = warp == 0 ? 0u : warp_sums[warp - 1];
  *total = warp_sums[kScanThreads / 32 - 1];
  __syncthreads();
  return before + incl - v;
}

// (B1) grid (n_chunks, rows): the sum of every chunk of kScanChunk entries
__global__ void __launch_bounds__(kScanThreads)
scan_reduce_kernel(const uint32_t* hist, int64_t len, uint32_t* partial, int64_t n_chunks) {
  __shared__ uint32_t warp_sums[32];
  const int64_t r = blockIdx.y, c = blockIdx.x;
  const uint32_t* H = hist + r * len;
  const int64_t base = c * kScanChunk + (int64_t)threadIdx.x * kScanItems;
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (base + i < len) s += H[base + i];
  uint32_t total;
  block_exclusive_scan(s, warp_sums, &total);
  if (threadIdx.x == 0) partial[r * n_chunks + c] = total;
}

// (B2) grid (1, rows): exclusive scan of the chunk sums, in place
__global__ void __launch_bounds__(kScanThreads)
scan_partials_kernel(uint32_t* partial, int64_t n_chunks) {
  __shared__ uint32_t warp_sums[32];
  uint32_t* P = partial + (int64_t)blockIdx.y * n_chunks;
  uint32_t carry = 0;
  for (int64_t c0 = 0; c0 < n_chunks; c0 += kScanThreads) {
    const int64_t c = c0 + threadIdx.x;
    const uint32_t v = c < n_chunks ? P[c] : 0u;
    uint32_t total;
    const uint32_t ex = block_exclusive_scan(v, warp_sums, &total);
    if (c < n_chunks) P[c] = carry + ex;
    carry += total;
  }
}

// (B3) grid (n_chunks, rows): the exclusive scan of every chunk, from its carry-in
__global__ void __launch_bounds__(kScanThreads)
scan_apply_kernel(uint32_t* hist, int64_t len, const uint32_t* partial, int64_t n_chunks) {
  __shared__ uint32_t warp_sums[32];
  const int64_t r = blockIdx.y, c = blockIdx.x;
  uint32_t* H = hist + r * len;
  const int64_t base = c * kScanChunk + (int64_t)threadIdx.x * kScanItems;
  uint32_t v[kScanItems], s = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = base + i < len ? H[base + i] : 0u;
    s += v[i];
  }
  uint32_t total;
  uint32_t run = partial[r * n_chunks + c] + block_exclusive_scan(s, warp_sums, &total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < len) H[base + i] = run;
    run += v[i];
  }
}

// (C) grid (n_tiles, rows of the group)
template <bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const float* x, const uint32_t* key_in, const uint32_t* col_in, uint32_t* key_out,
               uint32_t* col_out, int32_t* rank, int64_t n_cols, int64_t row0,
               const Tile* tiles, int64_t n_tiles, int shift, const uint32_t* hist) {
  __shared__ uint32_t wcount[kWarps][kRadix];
  const int64_t t = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t lanes_below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads) (&wcount[0][0])[i] = 0u;
  __syncthreads();
  const Tile tl = tiles[t];
  const int64_t xoff = (row0 + r) * n_cols, soff = r * n_cols;
  const int64_t wlo = tl.lo + (int64_t)warp * (32 * kItems);
  uint32_t key[kItems], col[kItems];

  // this warp's digit counts, its positions in order
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = wlo + i * 32 + lane;
    const bool ok = p < tl.hi;
    uint32_t k = 0u, c = 0u;
    if (ok) {
      if (kFirst) {
        k = ckey_of(x[xoff + p]);
        c = (uint32_t)p;
      } else {
        k = key_in[soff + p];
        c = col_in[soff + p];
      }
    }
    key[i] = k;
    col[i] = c;
    const uint32_t d = ok ? (k >> shift) & 0xFFu : kNoDigit;
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    if (ok && lane == __ffs(peers) - 1) wcount[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per digit: the tile's base, then an exclusive prefix over the warps
  if (threadIdx.x < kRadix) {
    const int d = threadIdx.x;
    uint32_t run = hist[r * n_tiles * kRadix + hist_index(tl, t, d)];
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = wcount[w][d];
      wcount[w][d] = run;
      run += c;
    }
  }
  __syncthreads();

  const int64_t start = kLast ? tiles[tl.first].lo : 0;  // the interval's first position
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t p = wlo + i * 32 + lane;
    const bool ok = p < tl.hi;
    const uint32_t d = ok ? (key[i] >> shift) & 0xFFu : kNoDigit;
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    if (ok) {
      const uint32_t dest = wcount[warp][d] + __popc(peers & lanes_below);
      if (kLast) {
        rank[xoff + col[i]] = (int32_t)((int64_t)dest - start);
      } else {
        key_out[soff + dest] = key[i];
        col_out[soff + dest] = col[i];
      }
    }
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) wcount[warp][d] += __popc(peers);
    __syncwarp();
  }
}

int sort_launch(const float* x, int32_t* rank, int64_t n_rows, int64_t n_cols,
                const Tile* tiles, int64_t n_tiles, int64_t group, uint32_t* key_a,
                uint32_t* col_a, uint32_t* key_b, uint32_t* col_b, uint32_t* hist,
                uint32_t* partial, cudaStream_t s) {
  constexpr int kPasses = 4;
  const int64_t len = n_tiles * kRadix;
  const int64_t n_chunks = (len + kScanChunk - 1) / kScanChunk;
  for (int64_t row0 = 0; row0 < n_rows; row0 += group) {
    const int64_t g = n_rows - row0 < group ? n_rows - row0 : group;
    const dim3 tile_grid((unsigned)n_tiles, (unsigned)g);
    const dim3 scan_grid((unsigned)n_chunks, (unsigned)g);
    uint32_t *kin = nullptr, *cin = nullptr, *kout = key_a, *cout_ = col_a;
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = 8 * pass;
      if (pass == 0)
        radix_hist_kernel<true><<<tile_grid, kThreads, 0, s>>>(x, nullptr, n_cols, row0, tiles,
                                                              n_tiles, shift, hist);
      else
        radix_hist_kernel<false><<<tile_grid, kThreads, 0, s>>>(x, kin, n_cols, row0, tiles,
                                                               n_tiles, shift, hist);
      RETURN_IF_ERROR();
      scan_reduce_kernel<<<scan_grid, kScanThreads, 0, s>>>(hist, len, partial, n_chunks);
      RETURN_IF_ERROR();
      scan_partials_kernel<<<dim3(1, (unsigned)g), kScanThreads, 0, s>>>(partial, n_chunks);
      RETURN_IF_ERROR();
      scan_apply_kernel<<<scan_grid, kScanThreads, 0, s>>>(hist, len, partial, n_chunks);
      RETURN_IF_ERROR();
      if (pass == 0)
        scatter_kernel<true, false><<<tile_grid, kThreads, 0, s>>>(
            x, nullptr, nullptr, kout, cout_, rank, n_cols, row0, tiles, n_tiles, shift, hist);
      else if (pass == kPasses - 1)
        scatter_kernel<false, true><<<tile_grid, kThreads, 0, s>>>(
            x, kin, cin, nullptr, nullptr, rank, n_cols, row0, tiles, n_tiles, shift, hist);
      else
        scatter_kernel<false, false><<<tile_grid, kThreads, 0, s>>>(
            x, kin, cin, kout, cout_, rank, n_cols, row0, tiles, n_tiles, shift, hist);
      RETURN_IF_ERROR();
      // the pass's output is the next pass's input; the other buffer takes its output
      kin = kout;
      cin = cout_;
      kout = kout == key_a ? key_b : key_a;
      cout_ = cout_ == col_a ? col_b : col_a;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// bf16: the counting rank
// ---------------------------------------------------------------------------

using key_hist::kBins;

// One chunk: columns [lo, hi) of interval `interval` (an index into the interval table).
struct Chunk {
  int64_t lo, hi, interval, pad;
};
// One interval: its chunks are [first, first + count) of the chunk table.
struct Interval {
  int64_t first, count;
};

constexpr int kRankWarps = kScanThreads / 32;            // 32: the scan's block
constexpr int kRankItems = 8;                            // columns per thread and tile
constexpr int kRankTile = kScanThreads * kRankItems;     // 8,192 columns
constexpr int kPosBits = 13;                             // a position in the tile
constexpr uint32_t kNoBin = 0x8000u;                     // columns past the chunk: last
constexpr int kSumBlocks = kBins / key_hist::kSumThreads;
constexpr int kCntStride = kRankWarps + 1;              // counter (d, w) at d * 33 + w
constexpr int kCnt = kRadix * kCntStride;
constexpr size_t kRankSmem =
    (size_t)(kBins + kRankTile + 2 * kCnt) * sizeof(uint32_t);  // 226 KB: one block an SM
static_assert(kRankTile == 1 << kPosBits, "a tile position has kPosBits bits");
static_assert(kRankWarps * kRadix == 8 * kScanThreads, "the counter scan's layout");

// (A) grid (n_chunks, rows of the group)
template <int V>
__global__ void __launch_bounds__(key_hist::kHistThreads)
rank_hist_kernel(const __nv_bfloat16* x, int64_t n_cols, int64_t row0, const Chunk* chunks,
                 int64_t n_chunks, uint32_t* H) {
  extern __shared__ uint32_t sh[];
  const int64_t c = blockIdx.x, r = blockIdx.y;
  const int64_t row_off = (row0 + r) * n_cols;
  key_hist::chunk_histogram<V>(x + row_off, row_off, chunks[c].lo, chunks[c].hi, sh,
                               H + (r * n_chunks + c) * kBins);
}

// (B1) grid (intervals x kSumBlocks, rows of the group): H[c][bin] becomes the bin's count
// in the interval's chunks before c; tot (rows x intervals x kBins) the bin's total.
__global__ void __launch_bounds__(key_hist::kSumThreads)
rank_sum_kernel(const Interval* ivs, int64_t n_ivs, int64_t n_chunks, uint32_t* H,
                uint32_t* tot) {
  const int64_t iv = blockIdx.x / kSumBlocks, r = blockIdx.y;
  const int bin = (blockIdx.x % kSumBlocks) * key_hist::kSumThreads + threadIdx.x;
  key_hist::interval_bin_sums<true>(H + r * n_chunks * kBins, ivs[iv].first, ivs[iv].count,
                                    bin, tot + (r * n_ivs + iv) * kBins + bin);
}

// (B2) grid (intervals, rows of the group): tot[bin] becomes the count of the interval's
// keys in higher bins.  Thread t owns the 32 bins below kBins - 32 t.
__global__ void __launch_bounds__(kScanThreads)
rank_above_kernel(uint32_t* tot, int64_t n_ivs) {
  __shared__ uint32_t warp_sums[32];
  uint32_t* a = tot + ((int64_t)blockIdx.y * n_ivs + blockIdx.x) * kBins;
  constexpr int kPer = kBins / kScanThreads;
  const int top = kBins - kPer * (int)threadIdx.x;
  uint32_t v[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    v[j] = a[top - 1 - j];
    sum += v[j];
  }
  uint32_t total;
  uint32_t run = block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    a[top - 1 - j] = run;
    run += v[j];
  }
}

// The tile's bf16 patterns for thread (warp, lane): item i is column t0 + warp * 256 +
// i * 32 + lane, 0xFFFFFFFF past hi.
__device__ __forceinline__ void load_tile(const uint16_t* xr, int64_t t0, int64_t hi,
                                          uint32_t (&raw)[kRankItems]) {
  const int64_t c0 = t0 + (threadIdx.x >> 5) * (32 * kRankItems) + (threadIdx.x & 31);
#pragma unroll
  for (int i = 0; i < kRankItems; ++i) {
    const int64_t c = c0 + i * 32;
    raw[i] = c < hi ? (uint32_t)xr[c] : 0xFFFFFFFFu;
  }
}

// The lanes of the warp whose 8-bit digit equals this lane's: eight ballots.  (One
// __match_any_sync an entry made the chunk histogram 23.6 ms instead of 2.4 ms at the
// trainer's packed increment on an H100: about 50 SM cycles a warp-wide match.)
__device__ __forceinline__ uint32_t same_digit_lanes(uint32_t d) {
  uint32_t peers = 0xFFFFFFFFu;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t bit = (d >> k) & 1u;
    const uint32_t set = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// One stable counting pass over the tile's values by their 8-bit digit at `shift`.  On
// entry v[i] of (warp, lane) is the value at index warp * 256 + i * 32 + lane of the
// current order and cnt is zero; on return buf holds the values in the new order, v[i] the
// value at that index of it, and cnt_next (which the caller last read before the pass's
// first barrier) is zero.  Four barriers.
__device__ __forceinline__ void tile_pass(uint32_t (&v)[kRankItems], int shift, uint32_t* buf,
                                          uint32_t* cnt, uint32_t* cnt_next,
                                          uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < kCnt; i += kScanThreads) cnt_next[i] = 0u;
  uint32_t* wc = cnt + warp;  // this warp's counter of digit d: wc[d * kCntStride]
  uint32_t off[kRankItems];
#pragma unroll
  for (int i = 0; i < kRankItems; ++i) {
    const uint32_t d = (v[i] >> shift) & 0xFFu;
    const uint32_t peers = same_digit_lanes(d);
    const uint32_t c = wc[d * kCntStride];
    off[i] = c + __popc(peers & lanes_below);
    __syncwarp();
    if (lane == __ffs(peers) - 1) wc[d * kCntStride] = c + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // exclusive scan of the counters, digit-major and warp-minor: thread t owns digit t / 4
  // of the warps 8 (t % 4) .. 8 (t % 4) + 7 (the stride of 33 keeps a warp's reads here,
  // and its lanes' counters above, on distinct banks)
  const int d = threadIdx.x >> 2, w0 = (threadIdx.x & 3) * 8;
  uint32_t c[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = cnt[d * kCntStride + w0 + j];
    sum += c[j];
  }
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  uint32_t before = lane < warp ? warp_sums[lane] : 0u;  // the earlier warps' total
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xFFFFFFFFu, before, o);
  uint32_t run = before + incl - sum;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cnt[d * kCntStride + w0 + j] = run;
    run += c[j];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRankItems; ++i)
    buf[wc[((v[i] >> shift) & 0xFFu) * kCntStride] + off[i]] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRankItems; ++i) v[i] = buf[warp * (32 * kRankItems) + i * 32 + lane];
}

// (C) grid (n_chunks, rows of the group), kRankSmem of dynamic shared memory
__global__ void __launch_bounds__(kScanThreads)
rank_write_kernel(const __nv_bfloat16* x, int32_t* rank, int64_t n_cols, int64_t row0,
                  const Chunk* chunks, int64_t n_chunks, const uint32_t* H,
                  const uint32_t* above, int64_t n_ivs) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t warp_sums[32];
  uint32_t* base = smem;              // kBins: the rank of each bin's next entry
  uint32_t* buf = base + kBins;       // kRankTile: the tile, sorted; then its ranks
  uint32_t* cnt = buf + kRankTile;    // two sets of kRadix x kCntStride digit counters
  const int64_t c = blockIdx.x, r = blockIdx.y;
  const Chunk ch = chunks[c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  {
    const uint4* h = reinterpret_cast<const uint4*>(H + (r * n_chunks + c) * kBins);
    const uint4* a = reinterpret_cast<const uint4*>(above + (r * n_ivs + ch.interval) * kBins);
    uint4* b = reinterpret_cast<uint4*>(base);
    for (int i = threadIdx.x; i < kBins / 4; i += kScanThreads) {
      const uint4 p = h[i], q = a[i];
      b[i] = make_uint4(p.x + q.x, p.y + q.y, p.z + q.z, p.w + q.w);
    }
    for (int i = threadIdx.x; i < kCnt; i += kScanThreads) cnt[i] = 0u;
    __syncthreads();
  }
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x) + (row0 + r) * n_cols;
  int32_t* out = rank + (row0 + r) * n_cols;
  uint32_t raw[kRankItems];
  load_tile(xr, ch.lo, ch.hi, raw);
  for (int64_t t0 = ch.lo; t0 < ch.hi; t0 += kRankTile) {  // uniform over the block
    uint32_t v[kRankItems];
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      const uint32_t pos = warp * (32 * kRankItems) + i * 32 + lane;
      const uint32_t bin = raw[i] == 0xFFFFFFFFu ? kNoBin : (raw[i] & 0x7FFFu);
      v[i] = bin << kPosBits | pos;
    }
    if (t0 + kRankTile < ch.hi) load_tile(xr, t0 + kRankTile, ch.hi, raw);
    tile_pass(v, kPosBits, buf, cnt, cnt + kCnt, warp_sums);
    tile_pass(v, kPosBits + 8, buf, cnt + kCnt, cnt, warp_sums);
    // v[i]: the sorted value at index s = warp * 256 + i * 32 + lane; buf: the sorted
    // tile.  The run of bin b that opens at s0 takes base[b] + (s - s0); its last entry
    // moves base[b] past the run.
    uint32_t closes = 0;  // bit i: v[i] closes its bin's run
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      const uint32_t s = warp * (32 * kRankItems) + i * 32 + lane, bin = v[i] >> kPosBits;
      if (s == kRankTile - 1 || (buf[s + 1] >> kPosBits) != bin) closes |= 1u << i;
      if (bin != kNoBin && (s == 0 || (buf[s - 1] >> kPosBits) != bin)) base[bin] -= s;
    }
    __syncthreads();  // every read of the sorted tile, and every opening, is done
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      const uint32_t s = warp * (32 * kRankItems) + i * 32 + lane, bin = v[i] >> kPosBits;
      if (bin != kNoBin) buf[v[i] & (kRankTile - 1)] = base[bin] + s;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      const uint32_t s = warp * (32 * kRankItems) + i * 32 + lane, bin = v[i] >> kPosBits;
      if (bin != kNoBin && (closes >> i & 1u)) base[bin] += s + 1;
    }
#pragma unroll
    for (int i = 0; i < kRankItems; ++i) {
      const int64_t p = i * kScanThreads + threadIdx.x;
      if (t0 + p < ch.hi) out[t0 + p] = (int32_t)buf[p];
    }
  }
}

template <int V>
int count_launch(const __nv_bfloat16* x, int32_t* rank, int64_t n_rows, int64_t n_cols,
                 const Chunk* chunks, int64_t n_chunks, const Interval* ivs, int64_t n_ivs,
                 int64_t group, uint32_t* H, uint32_t* tot, cudaStream_t s) {
  const size_t hist_smem = kBins * sizeof(uint32_t);
  cudaFuncSetAttribute(rank_hist_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)hist_smem);
  cudaFuncSetAttribute(rank_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRankSmem);
  for (int64_t row0 = 0; row0 < n_rows; row0 += group) {
    const unsigned g = (unsigned)(n_rows - row0 < group ? n_rows - row0 : group);
    rank_hist_kernel<V><<<dim3((unsigned)n_chunks, g), key_hist::kHistThreads, hist_smem, s>>>(
        x, n_cols, row0, chunks, n_chunks, H);
    RETURN_IF_ERROR();
    rank_sum_kernel<<<dim3((unsigned)(n_ivs * kSumBlocks), g), key_hist::kSumThreads, 0, s>>>(
        ivs, n_ivs, n_chunks, H, tot);
    RETURN_IF_ERROR();
    rank_above_kernel<<<dim3((unsigned)n_ivs, g), kScanThreads, 0, s>>>(tot, n_ivs);
    RETURN_IF_ERROR();
    rank_write_kernel<<<dim3((unsigned)n_chunks, g), kScanThreads, kRankSmem, s>>>(
        x, rank, n_cols, row0, chunks, n_chunks, H, tot, n_ivs);
    RETURN_IF_ERROR();
  }
  return 0;
}

}  // namespace

// float32.  tiles: n_tiles x {lo, hi, first, count} int64, covering every column of a row
// once, in column order.  Scratch from the caller, nothing zeroed: key_a, col_a, key_b,
// col_b (group x n_cols u32 each), hist (group x n_tiles x 256 u32), partial (group x
// ceil(n_tiles 256 / 4096) u32).  Rows go in groups of `group`.  Returns the first
// launch's cudaGetLastError() that is not 0, else 0.
extern "C" int repro_segment_ranks_sort(const void* x, void* rank, int64_t n_rows,
                                        int64_t n_cols, const int64_t* tiles, int64_t n_tiles,
                                        int64_t group, void* key_a, void* col_a, void* key_b,
                                        void* col_b, void* hist, void* partial, void* stream) {
  return sort_launch((const float*)x, (int32_t*)rank, n_rows, n_cols, (const Tile*)tiles,
                     n_tiles, group, (uint32_t*)key_a, (uint32_t*)col_a, (uint32_t*)key_b,
                     (uint32_t*)col_b, (uint32_t*)hist, (uint32_t*)partial,
                     (cudaStream_t)stream);
}

// bfloat16.  chunks: n_chunks x {lo, hi, interval, 0} int64, covering every column of a
// row once, in column order, none across an interval; intervals: n_ivs x {first chunk,
// chunk count}.  vec: x is 16-byte aligned.  Scratch from the caller, nothing zeroed: hist
// (group x n_chunks x 32768 u32, 16-byte aligned), tot (group x n_ivs x 32768 u32, 16-byte
// aligned).  Rows go in groups of `group`.  Returns the first launch's cudaGetLastError()
// that is not 0, else 0.
extern "C" int repro_segment_ranks_count(const void* x, void* rank, int64_t n_rows,
                                         int64_t n_cols, int vec, const int64_t* chunks,
                                         int64_t n_chunks, const int64_t* intervals,
                                         int64_t n_ivs, int64_t group, void* hist, void* tot,
                                         void* stream) {
  const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
  const Chunk* ch = (const Chunk*)chunks;
  const Interval* iv = (const Interval*)intervals;
  return vec ? count_launch<8>(xb, (int32_t*)rank, n_rows, n_cols, ch, n_chunks, iv, n_ivs,
                               group, (uint32_t*)hist, (uint32_t*)tot, (cudaStream_t)stream)
             : count_launch<1>(xb, (int32_t*)rank, n_rows, n_cols, ch, n_chunks, iv, n_ivs,
                               group, (uint32_t*)hist, (uint32_t*)tot, (cudaStream_t)stream);
}

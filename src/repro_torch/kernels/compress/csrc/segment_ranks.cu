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
// the trainer's packed increment (N = 4, M = 745,549,056, bf16) 17.89 GB, 5.34 ms at
// 3.35 TB/s.  This first design is a sort and moves several times that.
//
// Design: a stable LSD radix sort of (key, column) pairs per (row, interval), 8-bit
// digits of the complemented key ck = 0x7FFFFFFF - key, so ascending ck is descending |x|
// and a stable sort keeps ties in column order.  bf16 keys vary only in bits 16..30: two
// passes (shifts 16, 24); float32 four (0, 8, 16, 24).  The first pass reads x (the key
// computed, the column implicit), the last writes rank[column] = position - interval
// start, the ones between move pairs from one scratch buffer to the other.  Each pass:
//   (A) hist_kernel: a 256-bin digit histogram of every tile (4096 positions of one
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
//       On an H100 the scatter is 96% of the time at the full shape, and its cost is the
//       scattered writes (nine ballots in place of the match left the time unchanged):
//       the next design ranks bf16 keys by counting, writing the ranks in column order.
// Rows go in groups whose scratch (two (g, M) key and column buffers, the histograms) the
// launcher bounds; offsets into x and the ranks are 64-bit (N M > 2^31 at the full shape),
// positions inside a row 32-bit (the launcher refuses M >= 2^31).  Loads are scalar, so
// any alignment of x works.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ uint32_t ckey_of(__nv_bfloat16 x) {
  return 0x7FFFFFFFu - (((uint32_t)__bfloat16_as_ushort(x) & 0x7FFFu) << 16);
}

// One tile: positions [lo, hi) of the interval whose tiles are [first, first + count).
struct Tile {
  int64_t lo, hi, first, count;
};

__device__ __forceinline__ int64_t hist_index(const Tile& tl, int64_t t, int d) {
  return tl.first * kRadix + (int64_t)d * tl.count + (t - tl.first);
}

// (A) grid (n_tiles, rows of the group)
template <typename T, bool kFirst>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* x, const uint32_t* key_in, int64_t n_cols, int64_t row0,
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
template <typename T, bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const T* x, const uint32_t* key_in, const uint32_t* col_in, uint32_t* key_out,
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

template <typename T>
int ranks_launch(const T* x, int32_t* rank, int64_t n_rows, int64_t n_cols, const Tile* tiles,
                 int64_t n_tiles, int64_t group, uint32_t* key_a, uint32_t* col_a,
                 uint32_t* key_b, uint32_t* col_b, uint32_t* hist, uint32_t* partial,
                 cudaStream_t s) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kPasses = kBf16 ? 2 : 4;
  const int first_shift = kBf16 ? 16 : 0;
  const int64_t len = n_tiles * kRadix;
  const int64_t n_chunks = (len + kScanChunk - 1) / kScanChunk;
  for (int64_t row0 = 0; row0 < n_rows; row0 += group) {
    const int64_t g = n_rows - row0 < group ? n_rows - row0 : group;
    const dim3 tile_grid((unsigned)n_tiles, (unsigned)g);
    const dim3 scan_grid((unsigned)n_chunks, (unsigned)g);
    uint32_t *kin = nullptr, *cin = nullptr, *kout = key_a, *cout_ = col_a;
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = first_shift + 8 * pass;
      if (pass == 0)
        hist_kernel<T, true><<<tile_grid, kThreads, 0, s>>>(x, nullptr, n_cols, row0, tiles,
                                                             n_tiles, shift, hist);
      else
        hist_kernel<T, false><<<tile_grid, kThreads, 0, s>>>(x, kin, n_cols, row0, tiles,
                                                              n_tiles, shift, hist);
      RETURN_IF_ERROR();
      scan_reduce_kernel<<<scan_grid, kScanThreads, 0, s>>>(hist, len, partial, n_chunks);
      RETURN_IF_ERROR();
      scan_partials_kernel<<<dim3(1, (unsigned)g), kScanThreads, 0, s>>>(partial, n_chunks);
      RETURN_IF_ERROR();
      scan_apply_kernel<<<scan_grid, kScanThreads, 0, s>>>(hist, len, partial, n_chunks);
      RETURN_IF_ERROR();
      if (pass == 0)
        scatter_kernel<T, true, false><<<tile_grid, kThreads, 0, s>>>(
            x, nullptr, nullptr, kout, cout_, rank, n_cols, row0, tiles, n_tiles, shift, hist);
      else if (pass == kPasses - 1)
        scatter_kernel<T, false, true><<<tile_grid, kThreads, 0, s>>>(
            x, kin, cin, nullptr, nullptr, rank, n_cols, row0, tiles, n_tiles, shift, hist);
      else
        scatter_kernel<T, false, false><<<tile_grid, kThreads, 0, s>>>(
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

}  // namespace

// dtype: 0 float32, 1 bfloat16.  tiles: n_tiles x {lo, hi, first, count} int64, covering
// every column of a row once, in column order.  Scratch from the caller, nothing zeroed:
// key_a, col_a (group x n_cols u32 each), key_b, col_b (float32 only, the same size),
// hist (group x n_tiles x 256 u32), partial (group x ceil(n_tiles 256 / 4096) u32).  Rows
// go in groups of `group`.  Returns the first launch's cudaGetLastError() that is not 0,
// -1 for an unknown dtype, else 0.
extern "C" int repro_segment_ranks(const void* x, void* rank, int64_t n_rows, int64_t n_cols,
                                   int dtype, const int64_t* tiles, int64_t n_tiles,
                                   int64_t group, void* key_a, void* col_a, void* key_b,
                                   void* col_b, void* hist, void* partial, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Tile* tl = (const Tile*)tiles;
  uint32_t *ka = (uint32_t*)key_a, *ca = (uint32_t*)col_a, *kb = (uint32_t*)key_b,
           *cb = (uint32_t*)col_b, *h = (uint32_t*)hist, *pt = (uint32_t*)partial;
  switch (dtype) {
    case 0:
      return ranks_launch<float>((const float*)x, (int32_t*)rank, n_rows, n_cols, tl, n_tiles,
                                 group, ka, ca, kb, cb, h, pt, s);
    case 1:
      return ranks_launch<__nv_bfloat16>((const __nv_bfloat16*)x, (int32_t*)rank, n_rows,
                                         n_cols, tl, n_tiles, group, ka, ca, kb, cb, h, pt, s);
  }
  return -1;
}

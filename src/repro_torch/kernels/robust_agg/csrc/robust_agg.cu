// Byzantine-robust column aggregate of the packed (N, M) agent buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/robust_agg/kernel.py: sort_aggregate_2d
// (pl.pallas_call at :175; body _sort_agg_kernel :144).  For each column j:
//   sort the N values by (dead_i, total-order key of x_ij), dead_i = live_i == 0;
//   trimmed_mean:  pairwise sum of positions trim <= p < n_live - trim, times the float32
//                  reciprocal 1 / max(n_live - 2 trim, 1);
//   coord_median:  0.5 (v_lo + v_hi), lo = floor((n_live - 1) / 2), hi = n_live / 2;
//   the float32 result rounded to the buffer dtype -> out (1, M).
// The plain version is repro_torch/kernels/robust_agg/ref.py; the kernel matches it bit for
// bit (--fmad=false: every float operation rounds alone).
//
// Bound.  The least traffic is one read of (N, M) and one write of (1, M): at the trainer's
// shape (N = 4, M = 745,549,056, bf16) 7.455 GB, 2.225 ms at 3.35 TB/s.  The sort adds
// compare-exchanges (2 integer min/max each) over the padded power of two P >= N: 6 a column
// at P = 4, far below the bytes; 1,596 at P = 128 and 26,592 at P = 1024 (the lane routes'
// network), where the integer lanes (64 an SM) and not the bytes bound the kernel.
// Four routes, by P (kernel.py's route_plan picks one; each launch is tallied by route):
//
// register (P <= 32; sort_aggregate_kernel): one thread owns V whole columns.  It walks the
//   N rows itself, so every column's N keys sit in its registers and the sort is a
//   compare-exchange network over P, fully unrolled (a template on P).  Threads of a warp
//   read neighbouring columns of each row: 16-byte vectors (V = 8 bf16 or 4 fp32 columns
//   a thread) when the width and the pointers allow it, one column a thread otherwise.  Each
//   block copies the (N,) live row to shared memory once and counts n_live itself: no host
//   synchronisation.  The column loads are issued before the live row is read.
//
// warp (64 <= P <= 1024) and block (2048 <= P <= 16,384; sort_aggregate_lanes_kernel): a
//   group of G = P / 32 threads holds one column, K = 32 keys a thread, in the blocked layout
//   p = t K + j (t the thread in the group, j the register).  G <= 32 is a lane group inside
//   a warp; above, the group is G / 32 warps of one block.  bf16 keys are 16 bits (the widened
//   float32 key's low half carries no order), so one 32-bit register holds the keys of two
//   neighbouring columns and one packed __vminu2 / __vmaxu2 does two compare-exchanges;
//   float32 keeps one 32-bit key a register.  The network: each thread sorts its K registers
//   (Batcher's odd-even merge sort), then bitonic merges with a mirror first stage (p against
//   p ^ (size - 1), then p against p ^ stride, the smaller key always to the lower position):
//   stages with stride < K are register-only, stages across threads take one
//   __shfl_xor_sync a key inside a warp, or one round through shared memory between warps of
//   a block group.  At P = 1024: 26,592 compare-exchanges a column (28,160 for a bitonic
//   network), 15 of its 55 stages by shuffles.
//   Loads: a persistent grid (the blocks an SM that fit, looping over tiles) reads the live
//   row once per block, counts n_live and n_kept there, and keeps a bit a register of which of
//   its rows are live.  A tile is the block's neighbouring columns (two a group for bf16, one
//   for float32: 32 bytes a row at P = 1024, 512 at P = 64) of every row; it is read
//   row-contiguous (16-byte loads when aligned) into shared memory, rows padded to RS words so
//   that each group picks its column's keys out of it without bank conflicts (a group's
//   threads read rows j G + t: any assignment of rows to positions serves a sort).
//
// scratch (P > 16,384; sort_aggregate_tile_kernel): a block of 512 threads sorts kGlobalTile
//   neighbouring columns in a (P, tile) position-major array in a global scratch buffer the
//   wrapper allocates: a bitonic network of log2(P) (log2(P) + 1) / 2 stages, each one
//   compare-exchange for every pair of every column, a barrier between stages.  Bound by those
//   compare-exchanges, not by the bytes: correctness first.
//
// Keys.  bf16 widens to float32 by a 16-bit shift of its bits, so NaN payloads, +-inf and -0.0
// keep their order; the int32 key is b ^ ((b >> 31) & 0x7FFFFFFF) with an arithmetic shift
// (its own inverse), then biased by 2^31 into an unsigned whose order is the total order.
// Dead rows take the largest key in place of their own.  For a 0/1 live row every position
// a statistic reads is below n_live, where the live values sit in order; dead rows and the
// padding sort above them and are never read (a live value whose key is the largest one
// ties with them, and its bits are the same).  When every row is dead, the rows sort by
// their own keys, as (1, key) pairs do in the reference: coord_median then reads position 0.
//
// Bit equality with the plain version: the selected values are zero-padded to P and summed
// with v[i] += v[i + h], h = P/2, ..., 1 (on the lane routes the levels h >= K pair threads,
// the levels h < K registers; each warp turns its values round through shared memory so
// that every level runs in registers but the last log2(min(G, 32)), which are shuffles: the
// same tree, trimmed_lanes).  The median's two values are each the only
// non-zero leaf of such a tree, which for P > 1 gives v + 0.0f (-0.0 becomes +0.0, as the
// reference's median of -0.0 is +0.0); the lane routes add the 0.0f and skip the tree.  The
// reciprocal is an IEEE division, then a multiply; lo is a floor division (-1 when
// n_live = 0).  All offsets are 64-bit: N * M exceeds 2^31 at the trainer's shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;  // the largest P of the register route
constexpr int kVecKeys = 64;  // keys a thread holds at once on the vector path
constexpr uint32_t kLast = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

enum { TRIMMED_MEAN = 0, COORD_MEDIAN = 1 };
enum { ROUTE_REGISTER = 0, ROUTE_WARP = 1, ROUTE_BLOCK = 2, ROUTE_SCRATCH = 3 };

// Launches by route, counted where each launch succeeds.  Read by repro_sort_aggregate_routes.
std::atomic<int64_t> g_routes[4];

int counted(int route, int err) {
  if (err == 0) g_routes[route].fetch_add(1, std::memory_order_relaxed);
  return err;
}

__device__ __forceinline__ uint32_t bits_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// float32 bits -> unsigned key in IEEE total order
__device__ __forceinline__ uint32_t order_key(uint32_t b) {
  const int32_t s = (int32_t)b;
  return (uint32_t)(s ^ ((s >> 31) & 0x7FFFFFFF)) ^ 0x80000000u;
}

// the exact inverse of order_key
__device__ __forceinline__ float order_val(uint32_t key) {
  const int32_t k = (int32_t)(key ^ 0x80000000u);
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ int floor_half(int a) { return a >= 0 ? a / 2 : -((1 - a) / 2); }

// ascending bitonic network over P keys; every index is a compile-time constant, so the
// keys stay in registers
template <int P>
__device__ __forceinline__ void sort_keys(uint32_t (&k)[P]) {
#pragma unroll
  for (int size = 2; size <= P; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const uint32_t lo = min(k[i], k[j]), hi = max(k[i], k[j]);
          const bool up = (i & size) == 0;
          k[i] = up ? lo : hi;
          k[j] = up ? hi : lo;
        }
      }
    }
  }
}

// v[i] += v[i + h] for h = P/2, ..., 1: the plain version's pairwise tree
template <int P>
__device__ __forceinline__ float pairwise_sum(float (&v)[P]) {
#pragma unroll
  for (int h = P / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] = v[i] + v[i + h];
  }
  return v[0];
}

template <int P>
__device__ __forceinline__ float reduce_sorted(const uint32_t (&k)[P], int stat, int trim,
                                               int n_live) {
  float v[P];
  if (stat == TRIMMED_MEAN) {
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = (p >= trim && p < n_live - trim) ? order_val(k[p]) : 0.f;
    const int d = n_live - 2 * trim;
    const float inv = 1.f / (float)(d > 1 ? d : 1);
    return pairwise_sum<P>(v) * inv;
  }
  const int lo = floor_half(n_live - 1), hi = n_live / 2;
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = p == lo ? order_val(k[p]) : 0.f;
  const float v_lo = pairwise_sum<P>(v);
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = p == hi ? order_val(k[p]) : 0.f;
  const float v_hi = pairwise_sum<P>(v);
  return 0.5f * (v_lo + v_hi);
}

template <typename T, int P, int V>
__global__ void __launch_bounds__(kThreads)
    sort_aggregate_kernel(const T* __restrict__ x, const float* __restrict__ live,
                          T* __restrict__ out, int n_rows, int64_t n_cols, int stat, int trim) {
  // the column loads go out first: they do not wait for the live row
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  const bool active = col < n_cols;
  Vec<T, V> val[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (active && i < n_rows) {
      const T* row = x + (int64_t)i * n_cols + col;
      if (V > 1) {
        val[i] = *reinterpret_cast<const Vec<T, V>*>(row);
      } else {
        val[i].v[0] = row[0];
      }
    }
  }

  __shared__ float s_live[kMaxRows];
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) s_live[i] = live ? live[i] : 1.f;
  __syncthreads();
  int n_live = 0, n_kept = 0;
  for (int i = 0; i < n_rows; ++i) {
    n_live += (int)s_live[i];
    n_kept += s_live[i] != 0.f;
  }
  if (!active) return;
  const bool all_dead = n_kept == 0;

  uint32_t k[V][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const bool keep = i < n_rows && (all_dead || s_live[i] != 0.f);
#pragma unroll
    for (int c = 0; c < V; ++c) k[c][i] = keep ? order_key(bits_of(val[i].v[c])) : kLast;
  }
  Vec<T, V> res;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    sort_keys<P>(k[c]);
    res.v[c] = from_f<T>(reduce_sorted<P>(k[c], stat, trim, n_live));
  }
  if (V > 1) {
    *reinterpret_cast<Vec<T, V>*>(out + col) = res;
  } else {
    out[col] = res.v[0];
  }
}

// ---------------------------------------------------------------------------------------------
// The warp and block routes (64 <= P <= 16,384): K keys a thread over a group of G threads
// ---------------------------------------------------------------------------------------------

constexpr int kKeys = 32;          // K: keys a thread
constexpr int kLaneThreads = 256;  // threads a block, or G where a group is larger

// The keys of one 32-bit register: one float32 column, or two bf16 columns (column 2c in the
// low half) as two 16-bit total-order keys.  kZero is the key of +0.0 in every column.
template <typename T> struct Keys;

template <> struct Keys<float> {
  static constexpr int kCols = 1;
  static constexpr uint32_t kZero = 0x80000000u;
  static __device__ __forceinline__ uint32_t key(uint32_t w) { return order_key(w); }
  static __device__ __forceinline__ uint32_t lo(uint32_t a, uint32_t b) { return min(a, b); }
  static __device__ __forceinline__ uint32_t hi(uint32_t a, uint32_t b) { return max(a, b); }
  static __device__ __forceinline__ void vals(uint32_t key, float (&v)[1]) { v[0] = order_val(key); }
};

// each 16-bit half's sign bit copied over the half (prmt's sign-replicating byte selectors)
__device__ __forceinline__ uint32_t half_signs(uint32_t w) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %1, 0xBB99;" : "=r"(m) : "r"(w));
  return m;
}

template <> struct Keys<__nv_bfloat16> {
  static constexpr int kCols = 2;
  static constexpr uint32_t kZero = 0x80008000u;
  // per half: b ^ 0x8000 for a positive pattern, ~b for a negative one (the high half of
  // order_key of the widened float; its low half is 0x0000 or 0xFFFF, no order)
  static __device__ __forceinline__ uint32_t key(uint32_t w) {
    return w ^ (half_signs(w) | 0x80008000u);
  }
  static __device__ __forceinline__ uint32_t lo(uint32_t a, uint32_t b) { return __vminu2(a, b); }
  static __device__ __forceinline__ uint32_t hi(uint32_t a, uint32_t b) { return __vmaxu2(a, b); }
  // the inverse of key (a key's sign bit is set for a positive pattern), widened exactly
  static __device__ __forceinline__ void vals(uint32_t key, float (&v)[2]) {
    const uint32_t b = key ^ (~half_signs(key) | 0x80008000u);
    v[0] = __uint_as_float(b << 16);
    v[1] = __uint_as_float(b & 0xFFFF0000u);
  }
};

// The block shape of a group size G: BT threads, RW words (groups) a tile row, RS words
// between tile rows in shared memory.  RS makes a warp's reads of one register conflict-free:
// lane l of group g reads word (j G + l) RS + g; with RS = (32 / G) x odd for G <= 32 the
// banks l RS + g are distinct, and for G >= 32 (one group a warp) any odd RS is.  Dynamic
// shared memory: the tile, or for G > 32 the block's keys (BT K words, the network's rounds
// between warps and the tree's levels between warps), then each warp's tree area: 32 rows of
// K + 1 words.
template <int G>
struct LaneShape {
  static constexpr int kBT = G > kLaneThreads ? G : kLaneThreads;
  static constexpr int kRW = kBT / G;
  static constexpr int kRS = G <= 32 ? kRW + 32 / G : (kRW > 1 ? kRW + 1 : 1);
  static constexpr int kMinBlocks = kBT >= 512 ? 1 : 2;
  static constexpr int kTree = 32 * (kKeys + 1);  // words of a warp's tree area
  __host__ __device__ static constexpr size_t head(int n_rows) {
    const size_t tile = (size_t)n_rows * kRS, ex = G > 32 ? (size_t)kBT * kKeys : 0;
    return tile > ex ? tile : ex;
  }
  __host__ __device__ static constexpr size_t words(int n_rows) {
    return head(n_rows) + (size_t)(kBT / 32) * kTree;
  }
};

template <typename KT>
__device__ __forceinline__ uint32_t pick(bool lower, uint32_t a, uint32_t b) {
  return lower ? KT::lo(a, b) : KT::hi(a, b);
}

// One network stage across threads: position (t, j) against (t ^ D, j), or, for the mirror
// stage, (t ^ D, K - 1 - j); the lower position keeps the smaller key.  D < 32: a shuffle
// inside the warp; else one round through shared memory (ex: the block's BT x K words).
template <typename KT, int K, int BT>
__device__ __forceinline__ void across(uint32_t (&k)[K], int D, bool lower, bool mirror,
                                       uint32_t* ex) {
  if (D < 32) {
    if (mirror) {
#pragma unroll
      for (int j = 0; j < K / 2; ++j) {
        const uint32_t a = __shfl_xor_sync(kFull, k[K - 1 - j], D);
        const uint32_t b = __shfl_xor_sync(kFull, k[j], D);
        k[j] = pick<KT>(lower, k[j], a);
        k[K - 1 - j] = pick<KT>(lower, k[K - 1 - j], b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) k[j] = pick<KT>(lower, k[j], __shfl_xor_sync(kFull, k[j], D));
    }
    return;
  }
  __syncthreads();  // the previous round's reads (or the tile's) are done
#pragma unroll
  for (int j = 0; j < K; ++j) ex[j * BT + threadIdx.x] = k[j];
  __syncthreads();
  const int src = threadIdx.x ^ D;
#pragma unroll
  for (int j = 0; j < K; ++j) k[j] = pick<KT>(lower, k[j], ex[(mirror ? K - 1 - j : j) * BT + src]);
}

// Ascending sort over the group's P = K G keys, blocked p = t K + j.  First each thread sorts
// its K registers by Batcher's odd-even merge sort (191 compare-exchanges at K = 32, where
// bitonic merges take 240); then bitonic merges of sizes 2K ... P, each a mirror stage and
// strides size/4 ... 1, the stages below stride K in registers.
template <typename KT, int K, int G, int BT>
__device__ __forceinline__ void sort_lanes(uint32_t (&k)[K], int t, uint32_t* ex) {
  constexpr int P = K * G;
#pragma unroll
  for (int p = 1; p < K; p <<= 1) {
#pragma unroll
    for (int d = p; d >= 1; d >>= 1) {
      const int r = d % p;  // Batcher's merge-exchange: i + r against i + r + d
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i + d < K && i >= r && ((i - r) / d) % 2 == 0 && i / (2 * p) == (i + d) / (2 * p)) {
          const uint32_t a = KT::lo(k[i], k[i + d]), b = KT::hi(k[i], k[i + d]);
          k[i] = a;
          k[i + d] = b;
        }
      }
    }
  }
#pragma unroll
  for (int size = 2 * K; size <= P; size <<= 1) {
    across<KT, K, BT>(k, size / K - 1, (t & (size / K / 2)) == 0, true, ex);
#pragma unroll
    for (int stride = size / 4; stride >= 1; stride >>= 1) {
      if (stride < K) {
#pragma unroll
        for (int i = 0; i < K; ++i) {
          const int j = i ^ stride;
          if (j > i) {
            const uint32_t a = KT::lo(k[i], k[j]), b = KT::hi(k[i], k[j]);
            k[i] = a;
            k[j] = b;
          }
        }
      } else {
        across<KT, K, BT>(k, stride / K, (t & (stride / K)) == 0, false, ex);
      }
    }
  }
}

// The tile of columns [col0, col0 + RW S) of rows [0, n_rows) -> s[r RS + w], word w holding
// the S columns of group w.  Row-contiguous: 16-byte loads (or RW words where a row is
// shorter) when the tile is whole and the buffer allows vectors, single entries otherwise.
template <typename T, int RW, int RS>
__device__ __forceinline__ void stage_tile(const T* __restrict__ x, int n_rows, int64_t n_cols,
                                           int64_t col0, int vec, uint32_t* s) {
  constexpr int S = 4 / (int)sizeof(T);
  if (vec && col0 + RW * S <= n_cols) {
    constexpr int CW = RW >= 4 ? 4 : RW;  // words a load
    constexpr int QC = RW / CW;
    for (int i = threadIdx.x; i < n_rows * QC; i += blockDim.x) {
      const int r = i / QC, q = i % QC;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(x + (int64_t)r * n_cols + col0) + q * CW;
      uint32_t* dst = s + r * RS + q * CW;
      if constexpr (CW == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      } else if constexpr (CW == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        dst[0] = v.x;
        dst[1] = v.y;
      } else {
        dst[0] = *src;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n_rows * RW; i += blockDim.x) {
      const int r = i / RW, w = i % RW;
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const int64_t col = col0 + w * S + c;
        if (col < n_cols) word |= bits_of(x[(int64_t)r * n_cols + col]) >> (16 * (S - 1 - c));
      }
      s[r * RS + w] = word;
    }
  }
}

// v[i] += v[i + h] for h = H, H/2, ..., 1 in registers: with H = N/2, v[0] ends with the
// pairwise tree's sum of v[0 .. N)
template <int H, int N>
__device__ __forceinline__ void halve(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < H; ++i) v[i] = v[i] + v[i + H];
  if constexpr (H > 1) halve<H / 2>(v);
}

// The trimmed mean: the positions trim <= p < n_live - trim keep their values, the others
// +0.0 (their keys become kZero), summed over the plain version's tree v[p] += v[p + h],
// h = P/2 ... 1, whose levels h >= K pair threads t and t + h/K and levels h < K pair
// registers.  Levels between warps (G > 32) go through red; then each warp's lanes write
// their values as rows of their tree area (K + 1 words a row: conflict-free both ways), and
// lane u of a group of W = min(G, 32) lanes reads registers j = u + W i of every row: the
// levels across the group's rows, then the levels h >= W over i in registers, then the
// levels h < W by __shfl_down_sync.  Lane 0 of each group ends with the sums.
template <typename KT, int K, int G, int BT>
__device__ __forceinline__ void trimmed_lanes(const uint32_t (&k)[K], int t, int g, int trim,
                                              int n_live, float* red, float* tree,
                                              float (&res)[KT::kCols]) {
  constexpr int S = KT::kCols, W = G < 32 ? G : 32, R = K + 1;
  const int lo_j = min(max(trim - t * K, 0), K), hi_j = min(max(n_live - trim - t * K, 0), K);
  const uint32_t below_hi = hi_j >= 32 ? ~0u : (1u << hi_j) - 1u;
  const uint32_t window = hi_j > lo_j ? below_hi & ~((1u << lo_j) - 1u) : 0u;
  float v[S][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float f[S];
    KT::vals((window >> j) & 1u ? k[j] : KT::kZero, f);
#pragma unroll
    for (int c = 0; c < S; ++c) v[c][j] = f[c];
  }
  // levels h = P/2 ... 32 K: threads t < D add thread t + D's values, D = h / K
#pragma unroll
  for (int D = G / 2; D >= 32; D >>= 1) {
#pragma unroll
    for (int c = 0; c < S; ++c) {
      __syncthreads();
      float* slot = red + (size_t)g * K * (G / 2);
      if (t >= D && t < 2 * D) {
#pragma unroll
        for (int j = 0; j < K; ++j) slot[j * (G / 2) + t - D] = v[c][j];
      }
      __syncthreads();
      if (t < D) {
#pragma unroll
        for (int j = 0; j < K; ++j) v[c][j] = v[c][j] + slot[j * (G / 2) + t];
      }
    }
  }
  const int lane = threadIdx.x & 31, first = lane & ~(W - 1), u = lane - first;
  float* area = tree + (threadIdx.x >> 5) * 32 * R;
  const int d = n_live - 2 * trim;
  const float inv = 1.f / (float)(d > 1 ? d : 1);
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (c > 0) __syncwarp();  // the previous column's reads are done
#pragma unroll
    for (int j = 0; j < K; ++j) area[lane * R + j] = v[c][j];
    __syncwarp();
    float w[K / W];
#pragma unroll
    for (int i = 0; i < K / W; ++i) {
      float rows[W];
#pragma unroll
      for (int r = 0; r < W; ++r) rows[r] = area[(first + r) * R + u + W * i];
      if constexpr (W > 1) halve<W / 2>(rows);
      w[i] = rows[0];
    }
    if constexpr (K / W > 1) halve<K / W / 2>(w);
    float sum = w[0];
#pragma unroll
    for (int h = W / 2; h >= 1; h >>= 1) sum = sum + __shfl_down_sync(kFull, sum, h);
    res[c] = sum * inv;
  }
}

// The median's two keys, from the threads that hold positions lo and hi; each value alone
// through the zero-padded tree is v + 0.0f (P > 1), and 0.0f for lo = -1.
template <typename KT, int K, int G>
__device__ __forceinline__ void median_lanes(const uint32_t (&k)[K], int t, int g, int lo,
                                             int hi, uint32_t* s_sel, float (&res)[KT::kCols]) {
  uint32_t sel_lo = 0, sel_hi = 0;
  const int j_lo = lo & (K - 1), j_hi = hi & (K - 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    sel_lo = j == j_lo ? k[j] : sel_lo;
    sel_hi = j == j_hi ? k[j] : sel_hi;
  }
  uint32_t key_lo, key_hi;
  if (G <= 32) {
    const int base = (threadIdx.x & 31) & ~(G - 1);
    key_lo = __shfl_sync(kFull, sel_lo, base + (lo >= 0 ? lo / K : 0));
    key_hi = __shfl_sync(kFull, sel_hi, base + hi / K);
  } else {
    __syncthreads();
    if (lo >= 0 && t == lo / K) s_sel[2 * g] = sel_lo;
    if (t == hi / K) s_sel[2 * g + 1] = sel_hi;
    __syncthreads();
    key_lo = s_sel[2 * g];
    key_hi = s_sel[2 * g + 1];
  }
  float f_lo[KT::kCols], f_hi[KT::kCols];
  KT::vals(key_lo, f_lo);
  KT::vals(key_hi, f_hi);
#pragma unroll
  for (int c = 0; c < KT::kCols; ++c) {
    const float v_lo = lo >= 0 ? __fadd_rn(f_lo[c], 0.f) : 0.f;
    const float v_hi = __fadd_rn(f_hi[c], 0.f);
    res[c] = 0.5f * (v_lo + v_hi);
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(LaneShape<G>::kBT, LaneShape<G>::kMinBlocks)
    sort_aggregate_lanes_kernel(const T* __restrict__ x, const float* __restrict__ live,
                                T* __restrict__ out, int n_rows, int64_t n_cols, int stat,
                                int trim, int vec) {
  using KT = Keys<T>;
  using Sh = LaneShape<G>;
  constexpr int K = kKeys, BT = Sh::kBT, RW = Sh::kRW, RS = Sh::kRS, S = KT::kCols;
  extern __shared__ uint32_t smem[];
  __shared__ int s_count[2];
  __shared__ uint32_t s_sel[2 * RW];
  const int g = threadIdx.x / G, t = threadIdx.x % G;

  // once a block: n_live, n_kept, and which of this thread's rows j G + t are kept
  if (threadIdx.x == 0) s_count[0] = s_count[1] = 0;
  __syncthreads();
  int nl = 0, nk = 0;
  for (int i = threadIdx.x; i < n_rows; i += BT) {
    const float l = live ? live[i] : 1.f;
    nl += (int)l;
    nk += l != 0.f;
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    nl += __shfl_xor_sync(kFull, nl, o);
    nk += __shfl_xor_sync(kFull, nk, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&s_count[0], nl);
    atomicAdd(&s_count[1], nk);
  }
  __syncthreads();
  const int n_live = s_count[0];
  const bool all_dead = s_count[1] == 0;
  uint32_t keep = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int row = j * G + t;
    if (row < n_rows && (all_dead || !live || live[row] != 0.f)) keep |= 1u << j;
  }
  const int lo = floor_half(n_live - 1), hi = n_live / 2;

  const int64_t n_tiles = (n_cols + RW * S - 1) / (RW * S);
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t col0 = tile * RW * S;
    __syncthreads();  // the previous tile's shared memory is free
    stage_tile<T, RW, RS>(x, n_rows, n_cols, col0, vec, smem);
    __syncthreads();
    uint32_t k[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      k[j] = (keep >> j) & 1u ? KT::key(smem[(j * G + t) * RS + g]) : kLast;
    sort_lanes<KT, K, G, BT>(k, t, smem);
    float res[S];
    if (stat == TRIMMED_MEAN) {
      trimmed_lanes<KT, K, G, BT>(k, t, g, trim, n_live, reinterpret_cast<float*>(smem),
                                  reinterpret_cast<float*>(smem + Sh::head(n_rows)), res);
    } else {
      median_lanes<KT, K, G>(k, t, g, lo, hi, s_sel, res);
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const int64_t col = col0 + g * S + c;
        if (col < n_cols) out[col] = from_f<T>(res[c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------------------------
// The scratch route (P > 16,384): a (P, tile) key array in a global scratch buffer
// ---------------------------------------------------------------------------------------------

constexpr int kTileThreads = 512;
constexpr int kGlobalTile = 8;  // columns a block

// s[p * tile + c] summed over p by the plain version's pairwise tree; the sum lands in s[c]
__device__ void tile_tree_sum(float* s, int64_t pow2, int tile) {
  for (int64_t h = pow2 / 2; h >= 1; h >>= 1) {
    for (int64_t q = threadIdx.x; q < h * tile; q += blockDim.x) s[q] = s[q] + s[q + h * tile];
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    sort_aggregate_tile_kernel(const T* __restrict__ x, const float* __restrict__ live,
                               T* __restrict__ out, int n_rows, int64_t n_cols, int64_t pow2,
                               int stat, int trim, uint32_t* __restrict__ scratch) {
  constexpr int tile = kGlobalTile, log_tile = 3;
  __shared__ int s_live, s_kept;
  if (threadIdx.x == 0) s_live = s_kept = 0;
  __syncthreads();
  int nl = 0, nk = 0;
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) {
    const float l = live ? live[i] : 1.f;
    nl += (int)l;
    nk += l != 0.f;
  }
  atomicAdd(&s_live, nl);
  atomicAdd(&s_kept, nk);
  __syncthreads();
  const int n_live = s_live;
  const bool all_dead = s_kept == 0;
  uint32_t* keys = scratch + (int64_t)blockIdx.x * pow2 * tile;
  float* vals = reinterpret_cast<float*>(keys);
  const int64_t n_keys = pow2 * tile;
  const int64_t n_tiles = (n_cols + tile - 1) / tile;
  const int lo = floor_half(n_live - 1), hi = n_live / 2;

  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t col0 = t * tile;
    for (int64_t q = threadIdx.x; q < n_keys; q += blockDim.x) {
      const int64_t p = q >> log_tile, col = col0 + (q & (tile - 1));
      uint32_t k = kLast;
      if (p < n_rows && col < n_cols && (all_dead || !live || live[p] != 0.f))
        k = order_key(bits_of(x[p * n_cols + col]));
      keys[q] = k;
    }
    __syncthreads();
    for (int64_t size = 2; size <= pow2; size <<= 1) {
      for (int64_t stride = size >> 1; stride > 0; stride >>= 1) {
        const int log_stride = __ffsll(stride) - 1;
        for (int64_t q = threadIdx.x; q < n_keys / 2; q += blockDim.x) {
          const int64_t pp = q >> log_tile, c = q & (tile - 1);
          const int64_t i = ((pp >> log_stride) << (log_stride + 1)) | (pp & (stride - 1));
          const int64_t a = (i << log_tile) + c, b = ((i + stride) << log_tile) + c;
          const uint32_t ka = keys[a], kb = keys[b];
          const uint32_t kl = min(ka, kb), kh = max(ka, kb);
          const bool up = (i & size) == 0;
          keys[a] = up ? kl : kh;
          keys[b] = up ? kh : kl;
        }
        __syncthreads();
      }
    }
    const int c = threadIdx.x;
    const int64_t col = col0 + c;
    if (stat == TRIMMED_MEAN) {
      for (int64_t q = threadIdx.x; q < n_keys; q += blockDim.x) {
        const int64_t p = q >> log_tile;
        vals[q] = (p >= trim && p < n_live - trim) ? order_val(keys[q]) : 0.f;
      }
      __syncthreads();
      tile_tree_sum(vals, pow2, tile);
      const int d = n_live - 2 * trim;
      const float inv = 1.f / (float)(d > 1 ? d : 1);
      if (c < tile && col < n_cols) out[col] = from_f<T>(vals[c] * inv);
    } else {
      // the two selected values, each summed alone over the zero-padded positions
      float v[2];
      const uint32_t k_lo = (c < tile && lo >= 0) ? keys[(int64_t)lo * tile + c] : 0u;
      const uint32_t k_hi = c < tile ? keys[(int64_t)hi * tile + c] : 0u;
      for (int r = 0; r < 2; ++r) {
        const int pos = r == 0 ? lo : hi;
        __syncthreads();
        for (int64_t q = threadIdx.x; q < n_keys; q += blockDim.x) vals[q] = 0.f;
        __syncthreads();
        if (c < tile && pos >= 0) vals[(int64_t)pos * tile + c] = order_val(r == 0 ? k_lo : k_hi);
        __syncthreads();
        tile_tree_sum(vals, pow2, tile);
        v[r] = c < tile ? vals[c] : 0.f;
      }
      if (c < tile && col < n_cols) out[col] = from_f<T>(0.5f * (v[0] + v[1]));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------------------------

template <typename T, int P, int V>
int launch(const void* x, const float* live, void* out, int n_rows, int64_t n_cols, int stat,
           int trim, cudaStream_t stream) {
  const int64_t items = (n_cols + V - 1) / V;
  const unsigned int blocks = (unsigned int)((items + kThreads - 1) / kThreads);
  sort_aggregate_kernel<T, P, V><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, live, (T*)out, n_rows, n_cols, stat, trim);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int launch_p(const void* x, const float* live, void* out, int n_rows, int64_t n_cols, int vec,
             int stat, int trim, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if constexpr (P * VV <= kVecKeys) {
    if (vec) return launch<T, P, VV>(x, live, out, n_rows, n_cols, stat, trim, stream);
  }
  return launch<T, P, 1>(x, live, out, n_rows, n_cols, stat, trim, stream);
}

template <typename T>
int dispatch(const void* x, const float* live, void* out, int n_rows, int64_t n_cols, int pow2,
             int vec, int stat, int trim, cudaStream_t s) {
  switch (pow2) {
    case 1: return launch_p<T, 1>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
    case 2: return launch_p<T, 2>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
    case 4: return launch_p<T, 4>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
    case 8: return launch_p<T, 8>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
    case 16: return launch_p<T, 16>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
    case 32: return launch_p<T, 32>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
  }
  return -2;
}

// The lane kernel of group size G, with its dynamic shared memory allowed up to the most any
// n_rows <= P needs: set once (above 48 KB a kernel must ask); its error, if it failed.
template <typename T, int G>
cudaError_t lanes_ready() {
  static const cudaError_t set = cudaFuncSetAttribute(
      sort_aggregate_lanes_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(LaneShape<G>::words(kKeys * G) * sizeof(uint32_t)));
  return set;
}

template <typename T>
struct LaunchLanes {
  template <int G>
  static int run(const void* x, const float* live, void* out, int n_rows, int64_t n_cols,
                 int vec, int grid, int stat, int trim, cudaStream_t stream) {
    const cudaError_t set = lanes_ready<T, G>();
    if (set != cudaSuccess) return (int)set;
    const size_t smem = LaneShape<G>::words(n_rows) * sizeof(uint32_t);
    sort_aggregate_lanes_kernel<T, G><<<grid, LaneShape<G>::kBT, smem, stream>>>(
        (const T*)x, live, (T*)out, n_rows, n_cols, stat, trim, vec);
    return counted(G <= 32 ? ROUTE_WARP : ROUTE_BLOCK, (int)cudaGetLastError());
  }
};

template <typename T>
struct Occupancy {
  template <int G>
  static int run(int n_rows) {
    const cudaError_t set = lanes_ready<T, G>();
    if (set != cudaSuccess) return -(int)set;
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sort_aggregate_lanes_kernel<T, G>, LaneShape<G>::kBT,
        LaneShape<G>::words(n_rows) * sizeof(uint32_t));
    return e == cudaSuccess ? blocks : -(int)e;
  }
};

// Op::run<G>(args...) for the group size G = pow2 / kKeys of the lane routes; -2 for another.
template <typename Op, typename... A>
int by_group(int pow2, A... args) {
  switch (pow2) {
    case 2 * kKeys: return Op::template run<2>(args...);
    case 4 * kKeys: return Op::template run<4>(args...);
    case 8 * kKeys: return Op::template run<8>(args...);
    case 16 * kKeys: return Op::template run<16>(args...);
    case 32 * kKeys: return Op::template run<32>(args...);
    case 64 * kKeys: return Op::template run<64>(args...);
    case 128 * kKeys: return Op::template run<128>(args...);
    case 256 * kKeys: return Op::template run<256>(args...);
    case 512 * kKeys: return Op::template run<512>(args...);
  }
  return -2;
}

template <typename T>
int launch_tile(const void* x, const float* live, void* out, int n_rows, int64_t n_cols,
                int64_t pow2, int grid, int stat, int trim, void* scratch, cudaStream_t stream) {
  sort_aggregate_tile_kernel<T><<<grid, kTileThreads, 0, stream>>>(
      (const T*)x, live, (T*)out, n_rows, n_cols, pow2, stat, trim, (uint32_t*)scratch);
  return counted(ROUTE_SCRATCH, (int)cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  live: (n_rows,) float32 or null (every row live).
// stat: 0 trimmed_mean, 1 coord_median.  Every entry point returns the launch's
// cudaGetLastError() (0 = launched), -1 for an unknown dtype, -2 for a pow2 its route does not
// take.

// The register route: pow2, the power of two P >= n_rows, is 1 ... 32.
extern "C" int repro_sort_aggregate(const void* x, const void* live, void* out, int64_t n_rows,
                                    int64_t n_cols, int dtype, int pow2, int vec, int stat,
                                    int trim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* lv = (const float*)live;
  int err;
  switch (dtype) {
    case 0:
      err = dispatch<float>(x, lv, out, (int)n_rows, n_cols, pow2, vec, stat, trim, s);
      break;
    case 1:
      err = dispatch<__nv_bfloat16>(x, lv, out, (int)n_rows, n_cols, pow2, vec, stat, trim, s);
      break;
    default:
      return -1;
  }
  return err == -2 ? err : counted(ROUTE_REGISTER, err);
}

// The warp (pow2 64 ... 1024) and block (2048 ... 16,384) routes over grid blocks (a
// persistent grid: each loops over its tiles).  vec: x's pointer is 16-byte aligned and its
// rows are a multiple of 16 bytes.
extern "C" int repro_sort_aggregate_lanes(const void* x, const void* live, void* out,
                                          int64_t n_rows, int64_t n_cols, int dtype, int pow2,
                                          int vec, int grid, int stat, int trim, void* stream) {
  if (n_rows > pow2 || grid < 1) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lv = (const float*)live;
  switch (dtype) {
    case 0:
      return by_group<LaunchLanes<float>>(pow2, x, lv, out, (int)n_rows, n_cols, vec, grid, stat,
                                          trim, s);
    case 1:
      return by_group<LaunchLanes<__nv_bfloat16>>(pow2, x, lv, out, (int)n_rows, n_cols, vec,
                                                  grid, stat, trim, s);
  }
  return -1;
}

// Blocks of the lane kernel for (dtype, pow2) that fit one SM at n_rows rows; a negative
// value is a CUDA error, negated; -2 as above.
extern "C" int repro_sort_aggregate_lanes_occupancy(int dtype, int pow2, int64_t n_rows) {
  if (n_rows > pow2) return -2;
  switch (dtype) {
    case 0: return by_group<Occupancy<float>>(pow2, (int)n_rows);
    case 1: return by_group<Occupancy<__nv_bfloat16>>(pow2, (int)n_rows);
  }
  return -1;
}

// The scratch route for pow2 > 16,384: kGlobalTile columns a block over grid blocks; scratch
// is a uint32 buffer of grid * pow2 * kGlobalTile keys.
extern "C" int repro_sort_aggregate_tile(const void* x, const void* live, void* out,
                                         int64_t n_rows, int64_t n_cols, int dtype, int64_t pow2,
                                         int grid, int stat, int trim, void* scratch,
                                         void* stream) {
  if (grid < 1 || !scratch || n_rows > pow2) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lv = (const float*)live;
  switch (dtype) {
    case 0:
      return launch_tile<float>(x, lv, out, (int)n_rows, n_cols, pow2, grid, stat, trim,
                                scratch, s);
    case 1:
      return launch_tile<__nv_bfloat16>(x, lv, out, (int)n_rows, n_cols, pow2, grid, stat, trim,
                                        scratch, s);
  }
  return -1;
}

// out[0..3]: launches so far of the register, warp, block and scratch routes.
extern "C" void repro_sort_aggregate_routes(int64_t* out) {
  for (int r = 0; r < 4; ++r) out[r] = g_routes[r].load();
}

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
// Bound: bytes.  The least traffic is one read of (N, M) and one write of (1, M): at the
// trainer's shape (N = 4, M = 745,549,056, bf16) 7.455 GB, 2.225 ms at 3.35 TB/s.  The sort
// is a handful of integer compare-exchanges per column (5 for an optimal network at N = 4,
// 6 for the bitonic one used here), far below the card's operations-per-byte ridge.
//
// Design.  Not the Pallas kernel's structure (a 256-column block transposed in VMEM and
// bitonic-sorted along the lanes): for P <= 128 (the register path) one thread owns V whole
// columns.  It walks the N rows itself, so every column's N keys sit in its registers and the
// sort is a compare-exchange network over the padded power of two P >= N, fully unrolled (a
// template on P in {1, 2, ..., 128}).  Threads of a warp read neighbouring columns
// of each row: 16-byte vectors (V = 8 bf16 or 4 fp32 columns a thread) when the width and
// the pointers allow it and P V <= 64 keys fit the registers, one column a thread
// otherwise.  Each block copies the (N,) live row to shared memory once and counts n_live
// itself: no host synchronisation.  The column loads are issued before the live row is
// read, so a block's two trips to device memory overlap.
//
// Above 128 rows (the tile path, sort_aggregate_tile_kernel) a block of 512 threads owns a
// tile of T neighbouring columns and sorts their P keys in a (P, T) array, position-major (the
// T keys of one position side by side): a bitonic network of log2(P) (log2(P) + 1) / 2
// stages, each one compare-exchange for every pair of every column, a barrier between stages.
// The array lives in shared memory while P T 4 bytes fit kTileBytes (T = kTileBytes / 4P,
// from 64 columns at P = 256 down to 1 at P = 16,384); above that in a global scratch buffer
// the wrapper allocates (kGlobalTile columns a block, a grid the scratch bounds).  The pairwise
// sums run in the same array: the selected values replace the keys and the halving
// v[i] += v[i + h] walks down the positions.  Such a tile is bound by its shared-memory
// compare-exchanges (P log2(P)^2 / 4 a column), not by the bytes: correctness first.
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
// with v[i] += v[i + h], h = P/2, ..., 1 (never by indexing the selected element: -0.0 + 0.0
// is +0.0, and the reference's median of -0.0 is +0.0); the reciprocal is an IEEE division,
// then a multiply; lo is a floor division (-1 when n_live = 0).  All offsets are 64-bit:
// N * M exceeds 2^31 at the trainer's shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;
constexpr int kVecKeys = 64;  // keys a thread holds at once on the vector path
constexpr uint32_t kLast = 0xFFFFFFFFu;

enum { TRIMMED_MEAN = 0, COORD_MEDIAN = 1 };

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
// The tile path (P > 128): a (P, T) key array in shared memory or in a global scratch buffer
// ---------------------------------------------------------------------------------------------

constexpr int kTileThreads = 512;
constexpr int kTileBytes = 64 * 1024;  // the shared-memory array of one block
constexpr int kGlobalTile = 8;         // columns a block on the scratch path

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
                               int tile, int stat, int trim, uint32_t* __restrict__ scratch) {
  extern __shared__ uint32_t s_keys[];
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
  uint32_t* keys = scratch ? scratch + (int64_t)blockIdx.x * pow2 * tile : s_keys;
  float* vals = reinterpret_cast<float*>(keys);
  const int64_t n_keys = pow2 * tile;
  const int64_t n_tiles = (n_cols + tile - 1) / tile;
  const int lo = floor_half(n_live - 1), hi = n_live / 2;

  const int log_tile = __ffs(tile) - 1;  // tile is a power of two
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

template <typename T>
int launch_tile(const void* x, const float* live, void* out, int n_rows, int64_t n_cols,
                int64_t pow2, int tile, int grid, int stat, int trim, void* scratch,
                cudaStream_t stream) {
  const size_t smem = scratch ? 0 : (size_t)pow2 * tile * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(sort_aggregate_tile_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kTileBytes);
    if (e != cudaSuccess) return (int)e;
  }
  sort_aggregate_tile_kernel<T><<<grid, kTileThreads, smem, stream>>>(
      (const T*)x, live, (T*)out, n_rows, n_cols, pow2, tile, stat, trim, (uint32_t*)scratch);
  return (int)cudaGetLastError();
}

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
    case 64: return launch_p<T, 64>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
    case 128: return launch_p<T, 128>(x, live, out, n_rows, n_cols, vec, stat, trim, s);
  }
  return -2;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  live: (n_rows,) float32 or null (every row live).
// pow2: the power of two P >= n_rows the sort runs over (1 ... 128; larger P take
// repro_sort_aggregate_tile).  stat: 0 trimmed_mean,
// 1 coord_median.  Returns the launch's cudaGetLastError() (0 = launched), -1 for an unknown
// dtype, -2 for an unsupported pow2.
extern "C" int repro_sort_aggregate(const void* x, const void* live, void* out, int64_t n_rows,
                                    int64_t n_cols, int dtype, int pow2, int vec, int stat,
                                    int trim, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* lv = (const float*)live;
  switch (dtype) {
    case 0:
      return dispatch<float>(x, lv, out, (int)n_rows, n_cols, pow2, vec, stat, trim, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, lv, out, (int)n_rows, n_cols, pow2, vec, stat, trim, s);
  }
  return -1;
}

// The tile path for pow2 > 128: tile columns a block over grid blocks; scratch is null (the
// (pow2, tile) key array in shared memory: pow2 * tile * 4 <= kTileBytes) or a uint32 buffer
// of grid * pow2 * tile keys.  Returns as repro_sort_aggregate does; -3 for a tile that does
// not fit (more columns than threads, or a shared-memory array above kTileBytes).
extern "C" int repro_sort_aggregate_tile(const void* x, const void* live, void* out,
                                         int64_t n_rows, int64_t n_cols, int dtype, int64_t pow2,
                                         int tile, int grid, int stat, int trim, void* scratch,
                                         void* stream) {
  if (tile < 1 || tile > kTileThreads || (tile & (tile - 1)) || grid < 1 ||
      (!scratch && pow2 * tile * (int64_t)sizeof(uint32_t) > kTileBytes))
    return -3;
  cudaStream_t s = (cudaStream_t)stream;
  const float* lv = (const float*)live;
  switch (dtype) {
    case 0:
      return launch_tile<float>(x, lv, out, (int)n_rows, n_cols, pow2, tile, grid, stat, trim,
                                scratch, s);
    case 1:
      return launch_tile<__nv_bfloat16>(x, lv, out, (int)n_rows, n_cols, pow2, tile, grid, stat,
                                        trim, scratch, s);
  }
  return -1;
}

// Fed-PLT round edges on the packed (N, M) agent buffer, for Hopper (sm_90a).
//
// Replaces the TPU kernels of repro/kernels/round_edge/kernel.py:
//   round_uplink    <- round_uplink_2d   (_uplink_kernel, _uplink_lagged_kernel)
//   round_downlink  <- round_downlink_2d (_downlink_kernel,
//                      _downlink_lagged_kernel, _downlink_body)
//   round_uplink_partial     <- round_uplink_partial_2d (_partial_sum_kernel)
//   round_downlink_presummed <- round_downlink_presummed_2d
//                               (_downlink_presummed_kernel)
//
//   uplink:   y = prox(mean_i seen_i)  (1, M);   v = 2 y - z  (N, M)
//   downlink: y recomputed as above;
//             x' = u_i != 0 ? w : x;   z' = u_i != 0 ? z + c (w - y) : z
//   (seen is z itself for the exact exchange, the coordinator's lagged
//   copy t under compression; c = 2 * damping)
//
// The sharded halves run on one rank's contiguous row block of the agent
// axis (N_local rows).  partial: s = sum_i seen_i  (1, M), float32 in row
// order, stored once in the buffer dtype (the caller all-reduces the
// partials and finishes / N -> prox -> reflection at coordinator size).
// presummed: the downlink above with y read from the replicated (1, M)
// row instead of recomputed -- a rank cannot form the cross-rank mean.
// They share the column-owned thread design below.  At one rank of the
// trainer's shape the partial moves (N + 1) M * 2 B = 7.46 GB (2.23 ms at
// 3.35 TB/s) and the presummed downlink (5 N + 1) M * 2 B = 31.3 GB
// (9.35 ms): both bound by bytes, y read once per column group.
//
// Bound: bytes.  Each launch is one pass over the agent stack with a few
// float operations per byte, far below the card's ops-per-byte ridge.  At
// the trainer's shape (N = 4, M = 745,549,056, bf16) the exact uplink
// moves (2N + 1) M * 2 B = 13.4 GB and the exact downlink 5 N M * 2 B =
// 29.8 GB: 4.0 ms and 8.9 ms at 3.35 TB/s.
//
// Design against that bound.  Each thread owns V consecutive columns
// (16 bytes: 8 bf16 or 4 fp32) and walks the N agent rows itself, so the
// agent-axis mean is a register loop -- no cross-block reduction, no
// atomics, and zbar never reaches device memory.  The sum runs in fp32 in
// row order 0..N-1 in both kernels, so the downlink's recomputed y equals
// the uplink's y bit for bit; recomputing it costs no extra bytes beyond
// the N rows of seen, which the exact downlink reads anyway as z (the
// second read of each row comes from L1/L2).  Loads and stores are
// 16-byte vectors when the width and the pointers allow it, scalar
// otherwise.  y is rounded to the buffer dtype once and that stored value
// feeds the reflection and the z-update.  Selects are ternaries on the
// stored bits, never u * new + (1 - u) * old, so a NaN row of w for an
// inactive agent cannot leak.  All offsets are 64-bit: N * M exceeds 2^31
// at the trainer's shape.  Compiled with --fmad=false so the float chain
// rounds exactly like the plain PyTorch version, one operation at a time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

enum { PROX_NONE = 0, PROX_SHRINK = 1, PROX_CLIP = 2 };

// The coded prox (repro_torch/core/prox.py): identity; soft threshold a
// then scale b; clip to [a, b].  NaN passes through, as in PyTorch.
__device__ __forceinline__ float apply_prox(float y, int code, float a, float b) {
  if (y != y) return y;
  if (code == PROX_SHRINK) {
    float m = fabsf(y) - a;
    m = m > 0.f ? m : 0.f;
    float s = y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f);
    return (s * m) * b;
  }
  if (code == PROX_CLIP) {
    float r = y < a ? a : y;
    return r > b ? b : r;
  }
  return y;
}

// y for V columns starting at `col`: fp32 row-order sum, times the fp32
// reciprocal 1/N, prox, then rounded to T (the stored coordinator value
// every consumer sees).
template <typename T, int V>
__device__ __forceinline__ void coordinator(const T* seen, int64_t n_rows, int64_t stride,
                                            int64_t col, int code, float a, float b,
                                            float (&y)[V]) {
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int64_t i = 0; i < n_rows; ++i) {
    Vec<T, V> s = *reinterpret_cast<const Vec<T, V>*>(seen + i * stride + col);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] + to_f(s.v[k]);
  }
  const float inv_n = 1.f / (float)n_rows;
#pragma unroll
  for (int k = 0; k < V; ++k) y[k] = to_f(from_f<T>(apply_prox(acc[k] * inv_n, code, a, b)));
}

template <typename T, int V>
__global__ void uplink_kernel(const T* seen, const T* z, T* y_out, T* v_out,
                              int64_t n_rows, int64_t n_cols, int code, float a, float b) {
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= n_cols) return;
  float y[V];
  coordinator<T, V>(seen, n_rows, n_cols, col, code, a, b, y);
  Vec<T, V> yo;
#pragma unroll
  for (int k = 0; k < V; ++k) yo.v[k] = from_f<T>(y[k]);
  *reinterpret_cast<Vec<T, V>*>(y_out + col) = yo;
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t off = i * n_cols + col;
    Vec<T, V> zv = *reinterpret_cast<const Vec<T, V>*>(z + off);
    Vec<T, V> vo;
#pragma unroll
    for (int k = 0; k < V; ++k) vo.v[k] = from_f<T>(2.f * y[k] - to_f(zv.v[k]));
    *reinterpret_cast<Vec<T, V>*>(v_out + off) = vo;
  }
}

// The z-update and selects of every row for V columns starting at `col`,
// given the coordinator value y of those columns.
template <typename T, int V>
__device__ __forceinline__ void update_rows(const T* x, const T* w, const T* z, const float* u,
                                            T* x_out, T* z_out, int64_t n_rows, int64_t n_cols,
                                            int64_t col, float c, const float (&y)[V]) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t off = i * n_cols + col;
    const bool active = u[i] != 0.f;
    Vec<T, V> xv = *reinterpret_cast<const Vec<T, V>*>(x + off);
    Vec<T, V> wv = *reinterpret_cast<const Vec<T, V>*>(w + off);
    Vec<T, V> zv = *reinterpret_cast<const Vec<T, V>*>(z + off);
    Vec<T, V> xo, zo;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      xo.v[k] = active ? wv.v[k] : xv.v[k];
      const float upd = to_f(zv.v[k]) + c * (to_f(wv.v[k]) - y[k]);
      zo.v[k] = active ? from_f<T>(upd) : zv.v[k];
    }
    *reinterpret_cast<Vec<T, V>*>(x_out + off) = xo;
    *reinterpret_cast<Vec<T, V>*>(z_out + off) = zo;
  }
}

template <typename T, int V>
__global__ void downlink_kernel(const T* x, const T* w, const T* z, const T* seen,
                                const float* u, T* x_out, T* z_out, int64_t n_rows,
                                int64_t n_cols, int code, float a, float b, float c) {
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= n_cols) return;
  float y[V];
  coordinator<T, V>(seen, n_rows, n_cols, col, code, a, b, y);
  update_rows<T, V>(x, w, z, u, x_out, z_out, n_rows, n_cols, col, c, y);
}

// Sharded uplink, local half: the column sums of one rank's rows.
template <typename T, int V>
__global__ void partial_sum_kernel(const T* seen, T* s_out, int64_t n_rows, int64_t n_cols) {
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= n_cols) return;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  for (int64_t i = 0; i < n_rows; ++i) {
    Vec<T, V> s = *reinterpret_cast<const Vec<T, V>*>(seen + i * n_cols + col);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = acc[k] + to_f(s.v[k]);
  }
  Vec<T, V> so;
#pragma unroll
  for (int k = 0; k < V; ++k) so.v[k] = from_f<T>(acc[k]);
  *reinterpret_cast<Vec<T, V>*>(s_out + col) = so;
}

// Sharded downlink: the z-update and selects of one rank's rows, given y.
template <typename T, int V>
__global__ void downlink_presummed_kernel(const T* x, const T* w, const T* z, const T* y_in,
                                          const float* u, T* x_out, T* z_out, int64_t n_rows,
                                          int64_t n_cols, float c) {
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (col >= n_cols) return;
  float y[V];
  Vec<T, V> yv = *reinterpret_cast<const Vec<T, V>*>(y_in + col);
#pragma unroll
  for (int k = 0; k < V; ++k) y[k] = to_f(yv.v[k]);
  update_rows<T, V>(x, w, z, u, x_out, z_out, n_rows, n_cols, col, c, y);
}

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n_cols, int v) {
  const int64_t items = (n_cols + v - 1) / v;
  return (unsigned int)((items + kThreads - 1) / kThreads);
}

template <typename T>
int uplink(const void* seen, const void* z, void* y, void* v, int64_t n_rows, int64_t n_cols,
           int vec, int code, float a, float b, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (vec) {
    uplink_kernel<T, VV><<<blocks_for(n_cols, VV), kThreads, 0, stream>>>(
        (const T*)seen, (const T*)z, (T*)y, (T*)v, n_rows, n_cols, code, a, b);
  } else {
    uplink_kernel<T, 1><<<blocks_for(n_cols, 1), kThreads, 0, stream>>>(
        (const T*)seen, (const T*)z, (T*)y, (T*)v, n_rows, n_cols, code, a, b);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int downlink(const void* x, const void* w, const void* z, const void* seen, const float* u,
             void* x_out, void* z_out, int64_t n_rows, int64_t n_cols, int vec, int code,
             float a, float b, float c, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (vec) {
    downlink_kernel<T, VV><<<blocks_for(n_cols, VV), kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)z, (const T*)seen, u, (T*)x_out, (T*)z_out,
        n_rows, n_cols, code, a, b, c);
  } else {
    downlink_kernel<T, 1><<<blocks_for(n_cols, 1), kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)z, (const T*)seen, u, (T*)x_out, (T*)z_out,
        n_rows, n_cols, code, a, b, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int partial(const void* seen, void* s, int64_t n_rows, int64_t n_cols, int vec,
            cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (vec) {
    partial_sum_kernel<T, VV><<<blocks_for(n_cols, VV), kThreads, 0, stream>>>(
        (const T*)seen, (T*)s, n_rows, n_cols);
  } else {
    partial_sum_kernel<T, 1><<<blocks_for(n_cols, 1), kThreads, 0, stream>>>(
        (const T*)seen, (T*)s, n_rows, n_cols);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int presummed(const void* x, const void* w, const void* z, const void* y, const float* u,
              void* x_out, void* z_out, int64_t n_rows, int64_t n_cols, int vec, float c,
              cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  if (vec) {
    downlink_presummed_kernel<T, VV><<<blocks_for(n_cols, VV), kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)z, (const T*)y, u, (T*)x_out, (T*)z_out, n_rows,
        n_cols, c);
  } else {
    downlink_presummed_kernel<T, 1><<<blocks_for(n_cols, 1), kThreads, 0, stream>>>(
        (const T*)x, (const T*)w, (const T*)z, (const T*)y, u, (T*)x_out, (T*)z_out, n_rows,
        n_cols, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  Returns the launch's
// cudaGetLastError() (0 = launched), or -1 for an unknown dtype.
extern "C" int repro_round_uplink(const void* seen, const void* z, void* y, void* v,
                                  int64_t n_rows, int64_t n_cols, int dtype, int vec, int code,
                                  float a, float b, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return uplink<float>(seen, z, y, v, n_rows, n_cols, vec, code, a, b, s);
    case 1: return uplink<__nv_bfloat16>(seen, z, y, v, n_rows, n_cols, vec, code, a, b, s);
    case 2: return uplink<__half>(seen, z, y, v, n_rows, n_cols, vec, code, a, b, s);
  }
  return -1;
}

extern "C" int repro_round_downlink(const void* x, const void* w, const void* z, const void* seen,
                                    const float* u, void* x_out, void* z_out, int64_t n_rows,
                                    int64_t n_cols, int dtype, int vec, int code, float a,
                                    float b, float c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return downlink<float>(x, w, z, seen, u, x_out, z_out, n_rows, n_cols, vec, code, a, b, c, s);
    case 1:
      return downlink<__nv_bfloat16>(x, w, z, seen, u, x_out, z_out, n_rows, n_cols, vec, code,
                                     a, b, c, s);
    case 2:
      return downlink<__half>(x, w, z, seen, u, x_out, z_out, n_rows, n_cols, vec, code, a, b,
                              c, s);
  }
  return -1;
}

extern "C" int repro_round_uplink_partial(const void* seen, void* s, int64_t n_rows,
                                          int64_t n_cols, int dtype, int vec, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return partial<float>(seen, s, n_rows, n_cols, vec, st);
    case 1: return partial<__nv_bfloat16>(seen, s, n_rows, n_cols, vec, st);
    case 2: return partial<__half>(seen, s, n_rows, n_cols, vec, st);
  }
  return -1;
}

extern "C" int repro_round_downlink_presummed(const void* x, const void* w, const void* z,
                                              const void* y, const float* u, void* x_out,
                                              void* z_out, int64_t n_rows, int64_t n_cols,
                                              int dtype, int vec, float c, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return presummed<float>(x, w, z, y, u, x_out, z_out, n_rows, n_cols, vec, c, st);
    case 1:
      return presummed<__nv_bfloat16>(x, w, z, y, u, x_out, z_out, n_rows, n_cols, vec, c, st);
    case 2:
      return presummed<__half>(x, w, z, y, u, x_out, z_out, n_rows, n_cols, vec, c, st);
  }
  return -1;
}

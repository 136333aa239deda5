// Fused Fed-PLT local step for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/fedplt_update/kernel.py:
//   fedplt_update <- fedplt_update_2d (_update_kernel, _update_noise_kernel)
//
//   out = w - gamma (g + inv_rho (w - v)) [+ t]
//
// in float32, stored in w's dtype; t is the optional DP-noise operand.
// `out` may be `w` itself (the trainer updates its iterate in place).
//
// Bound: bytes.  Three reads and one write (four reads with t) with five
// float operations per element.  At the trainer's shape (4 x 745,549,056
// bf16) one launch moves 23.9 GB (29.8 GB with t): 7.1 ms (8.9 ms) at
// 3.35 TB/s.
//
// Design against that bound: one flat pass over the whole contiguous
// buffer (the agent axis and the packed leaves are one index space), each
// thread owning V consecutive elements (16 bytes: 8 bf16 or 4 fp32) with
// vector loads and stores when the length and the pointers allow, scalar
// otherwise.  No shared memory, no reuse -- there is none to exploit.
// Offsets are 64-bit: the buffer holds 2,982,196,224 elements at the
// trainer's shape, past 2^31.  Compiled with --fmad=false so the chain
// rounds one operation at a time, exactly like the plain PyTorch version.

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

template <typename T, int V>
__global__ void update_kernel(const T* w, const T* g, const T* v, const T* t, T* out, int64_t n,
                              float gamma, float inv_rho) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (i >= n) return;
  Vec<T, V> wv = *reinterpret_cast<const Vec<T, V>*>(w + i);
  Vec<T, V> gv = *reinterpret_cast<const Vec<T, V>*>(g + i);
  Vec<T, V> vv = *reinterpret_cast<const Vec<T, V>*>(v + i);
  float r[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float wf = to_f(wv.v[k]);
    r[k] = wf - gamma * (to_f(gv.v[k]) + inv_rho * (wf - to_f(vv.v[k])));
  }
  if (t != nullptr) {
    Vec<T, V> tv = *reinterpret_cast<const Vec<T, V>*>(t + i);
#pragma unroll
    for (int k = 0; k < V; ++k) r[k] = r[k] + to_f(tv.v[k]);
  }
  Vec<T, V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) o.v[k] = from_f<T>(r[k]);
  *reinterpret_cast<Vec<T, V>*>(out + i) = o;
}

constexpr int kThreads = 256;

template <typename T>
int update(const void* w, const void* g, const void* v, const void* t, void* out, int64_t n,
           int vec, float gamma, float inv_rho, cudaStream_t stream) {
  constexpr int VV = 16 / sizeof(T);
  const int per = vec ? VV : 1;
  const int64_t items = (n + per - 1) / per;
  const unsigned int blocks = (unsigned int)((items + kThreads - 1) / kThreads);
  if (vec) {
    update_kernel<T, VV><<<blocks, kThreads, 0, stream>>>(
        (const T*)w, (const T*)g, (const T*)v, (const T*)t, (T*)out, n, gamma, inv_rho);
  } else {
    update_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(
        (const T*)w, (const T*)g, (const T*)v, (const T*)t, (T*)out, n, gamma, inv_rho);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16; t may be null.  Returns the
// launch's cudaGetLastError() (0 = launched), or -1 for an unknown dtype.
extern "C" int repro_fedplt_update(const void* w, const void* g, const void* v, const void* t,
                                   void* out, int64_t n, int dtype, int vec, float gamma,
                                   float inv_rho, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return update<float>(w, g, v, t, out, n, vec, gamma, inv_rho, s);
    case 1: return update<__nv_bfloat16>(w, g, v, t, out, n, vec, gamma, inv_rho, s);
    case 2: return update<__half>(w, g, v, t, out, n, vec, gamma, inv_rho, s);
  }
  return -1;
}

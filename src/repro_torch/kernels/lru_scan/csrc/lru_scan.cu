// Diagonal linear recurrence for Hopper (sm_90a), forward and backward.
//
// Replaces the TPU kernel of repro/kernels/lru_scan/kernel.py:
//   lru_scan_fwd <- lru_scan_bsw (_lru_kernel)
// and adds the backward that the reference leaves to autodiff
// (lru_scan_bwd).  Over (B, S, W), channels W innermost:
//
//   forward   h_t = a_t h_{t-1} + b_t                  (h_{-1} = 0)
//   backward  lam_t = g_t + a_{t+1} lam_{t+1}          (lam_{S-1} = g_{S-1})
//             db_t = lam_t,  da_t = lam_t h_{t-1}
//
// in float32, stored in the operands' dtype (float32 or bfloat16); the
// backward reads the forward's h as stored.
//
// Bound: bytes.  The forward reads a and b once and writes h once, the
// backward reads g, a and h once and writes da and db once, with two
// float operations per element each.  At the trainer's Mamba scan (B 2,
// S 512, W = 8192 x 16, float32) that is 1.611 GB forward and 2.684 GB
// backward: 0.481 ms and 0.801 ms at 3.35 TB/s.
//
// Design: one thread per (b, channel) column walks time in order (the
// backward from S-1 down), carrying h (lam and a_{t+1}) in a register.
// Neighbouring threads take neighbouring channels, so every load and
// store of a warp is one coalesced row segment.  The loads do not depend
// on the carry: each thread loads kUnroll steps of its operands before it
// computes them, so that many loads are in flight while the dependent
// chain runs.  The TPU kernel's in-chunk associative scan and its carry
// across sequential grid steps are not needed here: the time loop is
// inside the thread.  With few columns (RG-LRU: B x W = 5,120) the grid
// is small and the walk is latency-bound; a chunk-parallel scan (chunk
// scans, then a carry pass) is the remedy, left to later work.  Offsets
// are 64-bit: B x S x W passes 2^31 at Mamba's width for S >= 8192.
// Compiled with --fmad=false, so each product and sum rounds on its own,
// exactly like the plain PyTorch version (kernels/lru_scan/ref.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

template <typename T>
__global__ void lru_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                               T* __restrict__ h, int64_t S, int64_t W, int64_t n_cols) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  const int64_t bi = col / W;
  const int64_t base = bi * S * W + (col - bi * W);
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float hv = 0.0f;
  int64_t t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      av[k] = to_f(ap[(t + k) * W]);
      bv[k] = to_f(bp[(t + k) * W]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      hv = av[k] * hv + bv[k];
      hp[(t + k) * W] = from_f<T>(hv);
    }
  }
  for (; t < S; ++t) {
    hv = to_f(ap[t * W]) * hv + to_f(bp[t * W]);
    hp[t * W] = from_f<T>(hv);
  }
}

template <typename T>
__global__ void lru_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                               const T* __restrict__ g, T* __restrict__ da,
                               T* __restrict__ db, int64_t S, int64_t W, int64_t n_cols) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cols) return;
  const int64_t bi = col / W;
  const int64_t base = bi * S * W + (col - bi * W);
  const T* ap = a + base;
  const T* hp = h + base;
  const T* gp = g + base;
  T* dap = da + base;
  T* dbp = db + base;
  // t = S - 1: lam = g_{S-1}
  int64_t t = S - 1;
  float lam = to_f(gp[t * W]);
  dbp[t * W] = from_f<T>(lam);
  dap[t * W] = from_f<T>(lam * (t ? to_f(hp[(t - 1) * W]) : 0.0f));
  float a_next = to_f(ap[t * W]);
  // steps t .. t - kUnroll + 1, all with t - k >= 1 (h_{t-k-1} exists)
  for (t = S - 2; t >= kUnroll; t -= kUnroll) {
    float gv[kUnroll], av[kUnroll], hv[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      gv[k] = to_f(gp[(t - k) * W]);
      av[k] = to_f(ap[(t - k) * W]);
      hv[k] = to_f(hp[(t - k - 1) * W]);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      lam = gv[k] + a_next * lam;
      dbp[(t - k) * W] = from_f<T>(lam);
      dap[(t - k) * W] = from_f<T>(lam * hv[k]);
      a_next = av[k];
    }
  }
  for (; t >= 0; --t) {
    lam = to_f(gp[t * W]) + a_next * lam;
    dbp[t * W] = from_f<T>(lam);
    dap[t * W] = from_f<T>(lam * (t ? to_f(hp[(t - 1) * W]) : 0.0f));
    a_next = to_f(ap[t * W]);
  }
}

inline unsigned int blocks_for(int64_t n_cols) {
  return (unsigned int)((n_cols + kThreads - 1) / kThreads);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Every operand is a contiguous (B, S, W)
// array, B, S, W >= 1.  Returns the launch's cudaGetLastError() (0 =
// launched), or -1 for an unknown dtype.
extern "C" int repro_lru_scan_fwd(const void* a, const void* b, void* h, int64_t B, int64_t S,
                                  int64_t W, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = B * W;
  switch (dtype) {
    case 0:
      lru_fwd_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
          (const float*)a, (const float*)b, (float*)h, S, W, n);
      break;
    case 1:
      lru_fwd_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
          (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)h, S, W, n);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int repro_lru_scan_bwd(const void* a, const void* h, const void* g, void* da,
                                  void* db, int64_t B, int64_t S, int64_t W, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = B * W;
  switch (dtype) {
    case 0:
      lru_bwd_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
          (const float*)a, (const float*)h, (const float*)g, (float*)da, (float*)db, S, W, n);
      break;
    case 1:
      lru_bwd_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
          (const __nv_bfloat16*)a, (const __nv_bfloat16*)h, (const __nv_bfloat16*)g,
          (__nv_bfloat16*)da, (__nv_bfloat16*)db, S, W, n);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

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
// Design: every (b, channel) column is walked in time order by one thread
// (the backward from S-1 down), carrying h (lam and a_{t+1}) in a
// register, so each result is the plain version's, rounded the same way.
// The TPU kernel's in-chunk associative scan and its carry across grid
// steps are not used: they re-associate the recurrence, and the walk is
// not what binds (two rounded operations a step).  What binds is bytes in
// flight, so two kernels share the walk:
//
// - The ring kernel (lru_*_kernel_tma; 16-byte aligned operands whose
//   rows are a multiple of 16 bytes).  A CTA is one warp; lane c walks
//   column c of a tile of kTile = 32 columns of one batch row.  TMA boxes
//   of kSteps = 32 steps x kTile columns of every operand
//   fill a ring of kRing = 8 stages in shared memory, up to six stages
//   ahead of the walk; the walk reads shared memory, writes each result
//   over an operand it has read, and the stage leaves as one TMA store.
//   Steps and columns outside the operands read as zeros and are not
//   stored, so ragged S and W need no branch.  The slot of stage k is
//   refilled once that stage's store has read it.
// - The per-column kernel (lru_*_kernel; any operands): a thread a column,
//   neighbouring threads neighbouring channels (coalesced rows), kUnroll
//   steps of loads issued ahead of the dependent chain.
//
// The per-column kernel's offsets are 64-bit: B x S x W passes 2^31 at
// Mamba's width for S >= 8192.  Compiled with --fmad=false, so each
// product and sum rounds on its own, exactly like the plain PyTorch
// version (kernels/lru_scan/ref.py).
//
// Measured (chip_smoke.py phase 10b, float32, forward / backward, CUDA events around one call,
// the host's launch path included, on an "NVIDIA H100 80GB HBM3, 700.00 W"): the ring kernel
// takes 0.613-0.652 / 1.003-1.047 ms at the Mamba scan (74-78% / 77-80% of the byte bound),
// 0.040-0.049 / 0.050-0.058 ms at the RG-LRU scan (B 2, S 512, W 2560; bound 0.0094 / 0.0157)
// and 0.137-0.139 / 0.198-0.199 ms at B 1, S 8192 (54% / 63% of 0.0751 / 0.1252); the
// per-column kernel 0.622-0.624 / 1.048-1.065, 0.052-0.064 / 0.100-0.120 and 0.778-0.781 /
// 0.987-0.991 ms in the same call.  In recurrentgemma-2b's profiled round (16 forward and 16
// backward bf16 launches) the ring kernels hold the device 0.438-0.439 ms, the per-column
// ones 1.856-1.862.  Results written straight from the walk to global memory kept a single
// warp at about 30 (forward) and 90 (backward) cycles a step; through the ring and one TMA
// store a stage, the walk's only memory traffic is shared.

#include <cuda.h>  // CUtensorMap; the encoder comes from the driver at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

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

inline unsigned int blocks_for(int64_t n_cols) {
  return (unsigned int)((n_cols + kThreads - 1) / kThreads);
}

// ----------------------------------------------------------------------------------------------
// The ring kernels: a CTA is one warp that walks a tile of kTile columns of one batch row; TMA
// boxes of kSteps time steps x kTile columns of each operand fill a ring of kRing stages in shared
// memory ahead of the walk.
// ----------------------------------------------------------------------------------------------

constexpr int kTile = 32;   // columns of a CTA: one 128-byte float32 row a step
constexpr int kSteps = 32;  // time steps of a ring stage (one TMA box a operand)
constexpr int kRing = 8;    // stages of the ring: up to kRing - 2 loading ahead of the walk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 128-byte alignment of the ring (TMA's destination)
__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 127u) & ~127u) - a);
}

// one box (kTile columns x kSteps steps of batch row `batch`) of a (B, S, W) operand into shared
// memory, counted on `bar`; coordinates innermost first, negative or past the end read as 0
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int step, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(step), "r"(batch)
      : "memory");
}

// one box of shared memory out to a (B, S, W) operand, in the issuing thread's bulk group;
// steps and columns outside the operand are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int col,
                                          int step, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(step), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// until the thread's bulk groups but the newest have read their shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_newest() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// the walk's writes to shared memory (generic proxy), seen by a TMA store (async proxy)
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Lane 0: fill ring slot st % kRing with stage st, the boxes of kOps operands whose first
// steps are step0 + lag[o] (lag -1: h_{t-1} beside g_t and a_t).
template <int kOps, uint32_t kBox>
__device__ __forceinline__ void fill_stage(uint8_t* ring, uint64_t* full,
                                           const CUtensorMap* const (&maps)[kOps],
                                           const int (&lag)[kOps], int st, int col0, int step0,
                                           int batch) {
  const int slot = st % kRing;
  uint8_t* dst = ring + (size_t)slot * kOps * kBox;
  // the walk's reads of this slot (generic proxy) come before the TMA writes (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_expect_tx(&full[slot], kOps * kBox);
#pragma unroll
  for (int o = 0; o < kOps; ++o)
    tma_load(dst + o * kBox, maps[o], &full[slot], col0, step0 + lag[o], batch);
}

// Each stage's h is written over its a in the ring and leaves as a TMA store; the slot of stage
// st - 1 is refilled (stage st - 1 + kRing) once that stage's store has read it.
template <typename T>
__global__ void __launch_bounds__(32)
    lru_fwd_kernel_tma(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb,
                       const __grid_constant__ CUtensorMap mh, int S, int n_tiles) {
  constexpr int kOps = 2;
  constexpr uint32_t kBox = kSteps * kTile * sizeof(T);
  extern __shared__ uint8_t smem[];
  uint8_t* ring = align128(smem);  // kRing x kOps x (kSteps x kTile)
  __shared__ uint64_t full[kRing];
  const int lane = threadIdx.x;
  const int bi = blockIdx.x / n_tiles;
  const int col0 = (blockIdx.x - bi * n_tiles) * kTile;
  const int n_stages = (S + kSteps - 1) / kSteps;
  const CUtensorMap* const maps[kOps] = {&ma, &mb};
  const int lag[kOps] = {0, 0};
  if (lane == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int st = 0; st < n_stages && st < kRing; ++st)
      fill_stage<kOps, kBox>(ring, full, maps, lag, st, col0, st * kSteps, bi);
  }
  __syncwarp();
  float hv = 0.0f;
  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kRing;
    mbar_wait(&full[slot], (uint32_t)(st / kRing) & 1u);
    T* const tile = reinterpret_cast<T*>(ring + (size_t)slot * kOps * kBox);
    T* av = tile + lane;  // a_t in, h_t out (lane: the column)
    const T* bv = av + kSteps * kTile;
    const int steps = min(kSteps, S - st * kSteps);
    if (steps == kSteps) {
#pragma unroll
      for (int d = 0; d < kSteps; ++d) {
        hv = to_f(av[d * kTile]) * hv + to_f(bv[d * kTile]);
        av[d * kTile] = from_f<T>(hv);
      }
    } else {
      for (int d = 0; d < steps; ++d) {
        hv = to_f(av[d * kTile]) * hv + to_f(bv[d * kTile]);
        av[d * kTile] = from_f<T>(hv);
      }
    }
    fence_to_async();
    __syncwarp();
    if (lane == 0) {
      tma_store(&mh, tile, col0, st * kSteps, bi);
      bulk_commit();
      const int next = st - 1 + kRing;
      if (st > 0 && next < n_stages) {
        bulk_wait_read_all_but_newest();
        fill_stage<kOps, kBox>(ring, full, maps, lag, next, col0, next * kSteps, bi);
      }
    }
  }
  if (lane == 0) bulk_wait_all();
}

// Stage st holds the steps of block k = n_stages - 1 - st, y0 = k kSteps .. y0 + kSteps - 1
// (the first stage's top steps lie past S): g_t and a_t, and h_{t-1} in a box one step lower
// (h_{-1} reads as 0).  The walk goes down from the stage's top step; db_t is written over
// g_t and da_t over h_{t-1}, and both leave as TMA stores of the block (steps past S are not
// written).
template <typename T>
__global__ void __launch_bounds__(32)
    lru_bwd_kernel_tma(const __grid_constant__ CUtensorMap mg,
                       const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mh,
                       const __grid_constant__ CUtensorMap mda,
                       const __grid_constant__ CUtensorMap mdb, int S, int n_tiles) {
  constexpr int kOps = 3;
  constexpr uint32_t kBox = kSteps * kTile * sizeof(T);
  extern __shared__ uint8_t smem[];
  uint8_t* ring = align128(smem);  // kRing x kOps x (kSteps x kTile)
  __shared__ uint64_t full[kRing];
  const int lane = threadIdx.x;
  const int bi = blockIdx.x / n_tiles;
  const int col0 = (blockIdx.x - bi * n_tiles) * kTile;
  const int n_stages = (S + kSteps - 1) / kSteps;
  const CUtensorMap* const maps[kOps] = {&mg, &ma, &mh};
  const int lag[kOps] = {0, 0, -1};
  if (lane == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int st = 0; st < n_stages && st < kRing; ++st)
      fill_stage<kOps, kBox>(ring, full, maps, lag, st, col0, (n_stages - 1 - st) * kSteps, bi);
  }
  __syncwarp();
  float lam = 0.0f, a_next = 0.0f;
  for (int st = 0; st < n_stages; ++st) {
    const int slot = st % kRing;
    mbar_wait(&full[slot], (uint32_t)(st / kRing) & 1u);
    T* const tile = reinterpret_cast<T*>(ring + (size_t)slot * kOps * kBox);
    T* gv = tile + lane;                  // g_t in, db_t out (lane: the column)
    const T* av = gv + kSteps * kTile;
    T* hv = gv + 2 * kSteps * kTile;      // h_{t-1} in, da_t out
    const int y0 = (n_stages - 1 - st) * kSteps;
    if (st > 0) {
#pragma unroll
      for (int r = kSteps - 1; r >= 0; --r) {
        lam = to_f(gv[r * kTile]) + a_next * lam;
        const float hp = to_f(hv[r * kTile]);
        a_next = to_f(av[r * kTile]);
        gv[r * kTile] = from_f<T>(lam);
        hv[r * kTile] = from_f<T>(lam * hp);
      }
    } else {  // the top block: from t = S - 1, where lam = g_{S-1}
      for (int r = S - 1 - y0; r >= 0; --r) {
        const float g = to_f(gv[r * kTile]);
        lam = r == S - 1 - y0 ? g : g + a_next * lam;
        const float hp = to_f(hv[r * kTile]);
        a_next = to_f(av[r * kTile]);
        gv[r * kTile] = from_f<T>(lam);
        hv[r * kTile] = from_f<T>(lam * hp);
      }
    }
    fence_to_async();
    __syncwarp();
    if (lane == 0) {
      tma_store(&mdb, tile, col0, y0, bi);
      tma_store(&mda, tile + 2 * kSteps * kTile, col0, y0, bi);
      bulk_commit();
      const int next = st - 1 + kRing;
      if (st > 0 && next < n_stages) {
        bulk_wait_read_all_but_newest();
        fill_stage<kOps, kBox>(ring, full, maps, lag, next, col0,
                               (n_stages - 1 - next) * kSteps, bi);
      }
    }
  }
  if (lane == 0) bulk_wait_all();
}

template <typename T, int kOps>
constexpr int ring_smem() {
  return kRing * kOps * kSteps * kTile * (int)sizeof(T) + 128;  // + alignment
}

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

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the library does not
// link libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

template <typename T> constexpr CUtensorMapDataType tma_dtype();
template <> constexpr CUtensorMapDataType tma_dtype<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType tma_dtype<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Boxes of kTile columns x kSteps steps of one batch row of a (B, S, W) operand, unswizzled;
// steps and columns outside the operand read as zeros.  A 16-byte aligned base and W x
// sizeof(T) a multiple of 16 (ring_ok).  The encoder needs a context current on the calling
// thread, which a thread that has made no runtime call yet lacks (autograd's device thread
// may run a backward's first kernel here; the encoder then fails with
// CUDA_ERROR_INVALID_CONTEXT), so the launchers make a runtime call first (allow_smem).
template <typename T>
int make_map(CUtensorMap* map, const void* base, int64_t B, int64_t S, int64_t W) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T), (cuuint64_t)S * W * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)kTile, (cuuint32_t)kSteps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, tma_dtype<T>(), 3, const_cast<void*>(base), dims, strides, box,
                         unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int fwd_tma(const T* a, const T* b, T* h, int64_t B, int64_t S, int64_t W, cudaStream_t s) {
  constexpr int smem = ring_smem<T, 2>();
  const cudaError_t e = allow_smem(lru_fwd_kernel_tma<T>, smem);  // first: see make_map
  if (e != cudaSuccess) return (int)e;
  CUtensorMap ma, mb, mh;
  int r = make_map<T>(&ma, a, B, S, W);
  if (r == 0) r = make_map<T>(&mb, b, B, S, W);
  if (r == 0) r = make_map<T>(&mh, h, B, S, W);
  if (r != 0) return r;
  const int64_t n_tiles = (W + kTile - 1) / kTile;
  lru_fwd_kernel_tma<T><<<(unsigned int)(B * n_tiles), 32, smem, s>>>(ma, mb, mh, (int)S,
                                                                         (int)n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_tma(const T* a, const T* h, const T* g, T* da, T* db, int64_t B, int64_t S, int64_t W,
            cudaStream_t s) {
  constexpr int smem = ring_smem<T, 3>();
  const cudaError_t e = allow_smem(lru_bwd_kernel_tma<T>, smem);  // first: see make_map
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mg, ma, mh, mda, mdb;
  int r = make_map<T>(&mg, g, B, S, W);
  if (r == 0) r = make_map<T>(&ma, a, B, S, W);
  if (r == 0) r = make_map<T>(&mh, h, B, S, W);
  if (r == 0) r = make_map<T>(&mda, da, B, S, W);
  if (r == 0) r = make_map<T>(&mdb, db, B, S, W);
  if (r != 0) return r;
  const int64_t n_tiles = (W + kTile - 1) / kTile;
  lru_bwd_kernel_tma<T><<<(unsigned int)(B * n_tiles), 32, smem, s>>>(mg, ma, mh, mda, mdb,
                                                                         (int)S, (int)n_tiles);
  return (int)cudaGetLastError();
}

// Whether TMA can copy every operand: 16-byte aligned bases and rows of W entries a multiple of
// 16 bytes.  Else the per-column kernel takes them.
template <typename T>
bool ring_ok(int64_t W, std::initializer_list<const void*> operands) {
  if ((W * (int64_t)sizeof(T)) % 16 != 0) return false;
  for (const void* p : operands)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Launches by kernel, counted where each launch succeeds: [0] the ring kernels, [1] the
// per-column ones (forward and backward together).  Read by repro_lru_scan_routes.
std::atomic<int64_t> g_routes[2];

int counted(int route, int err) {
  if (err == 0) g_routes[route].fetch_add(1, std::memory_order_relaxed);
  return err;
}

template <typename T>
int fwd_launch(const T* a, const T* b, T* h, int64_t B, int64_t S, int64_t W, cudaStream_t s) {
  if (ring_ok<T>(W, {a, b, h})) return counted(0, fwd_tma<T>(a, b, h, B, S, W, s));
  lru_fwd_kernel<T><<<blocks_for(B * W), kThreads, 0, s>>>(a, b, h, S, W, B * W);
  return counted(1, (int)cudaGetLastError());
}

template <typename T>
int bwd_launch(const T* a, const T* h, const T* g, T* da, T* db, int64_t B, int64_t S,
               int64_t W, cudaStream_t s) {
  if (ring_ok<T>(W, {a, h, g, da, db}))
    return counted(0, bwd_tma<T>(a, h, g, da, db, B, S, W, s));
  lru_bwd_kernel<T><<<blocks_for(B * W), kThreads, 0, s>>>(a, h, g, da, db, S, W, B * W);
  return counted(1, (int)cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Every operand is a contiguous (B, S, W) array, B, S, W >= 1.
// The ring kernel takes the operands where TMA can copy them (ring_ok), the per-column kernel
// any others.  Returns the launch's cudaGetLastError() (0 = launched), or -1 for an unknown dtype.
extern "C" int repro_lru_scan_fwd(const void* a, const void* b, void* h, int64_t B, int64_t S,
                                  int64_t W, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return fwd_launch<float>((const float*)a, (const float*)b, (float*)h, B, S, W, s);
    case 1:
      return fwd_launch<__nv_bfloat16>((const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
                                       (__nv_bfloat16*)h, B, S, W, s);
  }
  return -1;
}

// out[0]: launches of the ring kernels so far, out[1]: of the per-column kernels.
extern "C" void repro_lru_scan_routes(int64_t* out) {
  out[0] = g_routes[0].load();
  out[1] = g_routes[1].load();
}

extern "C" int repro_lru_scan_bwd(const void* a, const void* h, const void* g, void* da,
                                  void* db, int64_t B, int64_t S, int64_t W, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return bwd_launch<float>((const float*)a, (const float*)h, (const float*)g, (float*)da,
                               (float*)db, B, S, W, s);
    case 1:
      return bwd_launch<__nv_bfloat16>((const __nv_bfloat16*)a, (const __nv_bfloat16*)h,
                                       (const __nv_bfloat16*)g, (__nv_bfloat16*)da,
                                       (__nv_bfloat16*)db, B, S, W, s);
  }
  return -1;
}

// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/flash_attention/kernel.py: flash_attention_bhsd
// (pl.pallas_call at :93; body _flash_kernel :26).  The reference has no backward kernel (it
// trains by autodiff of its XLA attention); the backward kernels here are the closed-form
// gradient of the same function.  q (B, S, H, D), k and v (B, T, Hkv, D), float32 or bfloat16,
// contiguous; query head h reads kv head h / G, G = H / Hkv (index mapping, no repeat).
//   forward:  s = (q k^T) D^-1/2, optionally cap tanh(s / cap); masked (kpos <= qpos when
//             causal, kpos > qpos - window) to the finite -1e30; online softmax with a float32
//             (m, l, acc) carry and p kept in float32 for p v; o = acc / max(l, 1e-30) in q's
//             dtype, lse = m + log l in float32 (B, H, S).
//   backward: delta = rowsum(dO * O) (flash_bwd_delta_kernel); then, with p = exp(s - lse),
//             ds = p (dp - delta), dp = dO v^T, times 1 - (s / cap)^2 under a softcap, and ds = 0
//             on masked entries: dV = p^T dO, dK = D^-1/2 ds^T q (flash_bwd_dkdv_kernel*, one
//             CTA per kv block), dQ = D^-1/2 ds k (flash_bwd_dq_kernel*, one CTA per q block).
//             No atomics: two runs give the same bits.
// The plain version is repro_torch/kernels/flash_attention/ref.py (the full softmax in float32).
//
// Masks.  A row with no visible key (possible only with a window and S > T + window - 1)
// gives the mean of v over all T keys, as the finite fill does in the reference: its forward
// CTA walks every key block, as the Pallas grid does; its backward takes p = 1/T on every key
// and ds = 0.  Every other row skips the key blocks outside its causal window: a skipped block
// would add exp(-1e30 - m) = 0 to l and acc, or, met first, would be wiped by the correction
// exp(-1e30 - m) = 0, so the result is the same.  Keys at or past T (the ragged tail) are not
// keys at all: they take -inf and p = 0, even in a row with no visible key.  The reference's
// grid (S // block_q, T // block_k) drops ragged tails; this kernel does not.
//
// Bound: operations.  One (query, key) pair that a row sees costs 4 D floating-point operations
// forward (q k and p v) and 10 D backward (the five products s, dp, dV, dK, dQ); the bytes are
// q, k, v, o (and dO, dq, dk, dv) once each.  At gemma2-2b's shape (H 8, Hkv 4, D 256) the
// operations dominate from a few hundred tokens on.
//
// bfloat16: tensor cores (the *_wgmma kernels).  Every product runs as wgmma with float32
// accumulation.  q k^T and dO v^T multiply two bf16 operands: exact products, summed in float32.
// p (and in the backward ds) is float32, as in the reference, so p v, p^T dO, ds^T q and ds k
// split it into NSPLIT bf16 terms (hi = bf16(p), lo = bf16(p - hi)), one wgmma per term into the
// same float32 accumulator: p is carried to 2^-17 of itself, the float32 sums' own order of
// error (a single bf16 term misses the bf16 tolerance of the check; the CPU emulation in the
// tests shows both).  The softmax arithmetic stays explicit float32 expf / tanhf / logf.  On
// this card the tensor-core products are 2 D + 2 NSPLIT D operations a pair forward and
// 4 D + 6 NSPLIT D backward at 989 TFLOP/s.  What holds the kernels below that is the
// float32 elementwise work between the products (masks, the precise tanhf softcap, expf,
// the splits; separately rounded under --fmad=false), which takes the CUDA cores about as
// long as the products take the tensor cores; the two consumer warpgroups of a CTA overlap
// one's elementwise work with the other's products (a software pipeline inside a warpgroup,
// s of the next step issued with p v of this one, made them no faster).  At the trainer's
// 512 tokens the grid bounds them too: 64-128 CTAs on 132 SMs, the longest 8 steps.
//   Tiles: a consumer warpgroup owns 64 rows of one head; K and V steps are 64 keys (forward,
//   dK/dV: 64 queries a step) or 32 (dQ).  Operands sit in shared memory as 64-column panels
//   of 128-byte rows in the 128-byte swizzle, written by TMA (cp.async.bulk.tensor, boxes of
//   64 columns of one head; rows past S or T and columns past D read as zeros): the layout
//   wgmma reads, K-major for s and dp, MN-major (the transpose flag) for the B operand of the
//   products with p and ds, whose A operand is the score accumulator repacked in registers.
//   D is padded to DP in {64, 128, 256}; every accumulator a thread holds is 32 floats a
//   panel, so at D 256 a warpgroup carries one (64 x 256) float32 accumulator.
//   Copies: one producer thread issues the TMA loads into a ring of 2 stages, signalled by
//   mbarriers (full: the bytes arrived; empty: the 8 consumer warps are done), so the next
//   step's copies overlap this step's products.  384 threads: 2 consumer warpgroups and a
//   producer warpgroup, which hands its registers to the consumers (setmaxnreg: 240 a
//   consumer thread, so the D = 256 accumulators do not spill).
//   forward: a CTA holds 128 query rows (two warpgroups) and streams K and V; the longest
//   (last, under a causal mask) q blocks are launched first.
//   dK/dV: dK and dV of 64 keys do not both fit one warpgroup's registers at D 256, so the two
//   warpgroups split them: one computes p^T and accumulates dV = p^T dO, the other computes p^T
//   and dp^T and accumulates dK = ds^T q; Q and dO stream through the ring.  A CTA takes one
//   query head: with G > 1 (GQA, and MQA's 10 heads over 1) the heads of a group are spread
//   over CTAs, each writing float32 partials that flash_bwd_dkdv_reduce_kernel sums in head
//   order and rounds once.
//   dQ: a separate kernel that recomputes s and dp (128 rows a CTA, K and V streamed), so no
//   float atomics: the cost is the two score products done twice.
// float32: the CUDA-core kernels (flash_fwd_kernel, flash_bwd_dkdv_kernel, flash_bwd_dq_kernel):
// tensor cores have no float32 product at float32 precision.  256 threads; tiles staged in
// shared memory as float32, row-major with rows padded by 4 floats, so a quarter-warp reading
// 16-byte vectors of 8 consecutive rows hits 8 distinct bank groups.  A thread owns the score
// elements (ty + 16 r, tx + 16 c), ty = tid / 16, tx = tid % 16: the 16 threads of a row sit in
// one half-warp, so row maxima and sums are shuffles.  In the forward the same thread owns the
// output rows ty + 16 r and the columns 4 tx + 64 c4 .. + 3 of acc, so the softmax correction
// stays in registers.  Forward tiles: 64 query rows, 32 keys; backward tiles: 32 x 32; one
// dK/dV CTA loops over the G query heads of its group.  Products are explicit fmaf chains (the
// library is built with --fmad=false).  Shared memory above 48 KB is opted into per kernel.

#include <cuda.h>  // CUtensorMap; the encoder comes from the driver at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr int BQF = 64;  // forward: query rows per CTA
constexpr int BKF = 32;  // forward: keys per step
constexpr int BB = 32;   // backward: query rows and keys per tile

struct Geom {
  int S, T, H, Hkv, G, D;
  int causal, window;  // window <= 0: none
  float cap;           // cap <= 0: none
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// the keys [lo, hi] a row sees (empty when lo > hi)
__device__ __forceinline__ int row_lo(const Geom& g, int q) {
  return g.window > 0 ? max(0, q - g.window + 1) : 0;
}
__device__ __forceinline__ int row_hi(const Geom& g, int q) {
  return g.causal ? min(g.T - 1, q) : g.T - 1;
}
__device__ __forceinline__ bool row_dead(const Geom& g, int q) {
  return row_lo(g, q) > row_hi(g, q);
}
__device__ __forceinline__ bool visible(const Geom& g, int q, int kpos) {
  return (!g.causal || kpos <= q) && (g.window <= 0 || kpos > q - g.window);
}

// the scaled, softcapped score, as the reference rounds it
__device__ __forceinline__ float score(const Geom& g, float dot) {
  float x = dot * g.scale;
  if (g.cap > 0.f) x = g.cap * tanhf(x / g.cap);
  return x;
}

// four consecutive float32 elements (one 16-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [r0, r0 + R) of one head of a (B, L, heads, D) tensor into sm[R][DP + 4] as float32;
// rows past L and columns past D are zero.  Four columns a thread per load: D % 4 == 0 and the
// operands are 16-byte aligned (kernel.py checks both).
template <typename T, int R, int DP>
__device__ __forceinline__ void load_tile(float* sm, const T* base, int r0, int L,
                                          int64_t row_stride, int D) {
  constexpr int PADW = DP + 4, Q4 = DP / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < R * Q4; idx += kThreads) {
    const int r = idx / Q4, d = (idx % Q4) * 4, row = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L && d < D) val = load4(base + (int64_t)row * row_stride + d);
    *reinterpret_cast<float4*>(&sm[r * PADW + d]) = val;
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// max / sum over the 16 threads of a row (one half-warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// store rows of a (BQ x DP) float32 accumulator (rows ty + 16 r, columns 4 tx + 64 c4 .. + 3)
// into one head of a (B, L, heads, D) tensor, dividing by div[r] when given
template <typename T, int RQ, int NC4>
__device__ __forceinline__ void store_rows(T* base, int64_t row_stride, int r0, int L, int D,
                                           float4 (&acc)[RQ][NC4], const float* div) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= L) continue;
    T* dst = base + (int64_t)row * row_stride;
#pragma unroll
    for (int c4 = 0; c4 < NC4; ++c4) {
      const float vals[4] = {acc[r][c4].x, acc[r][c4].y, acc[r][c4].z, acc[r][c4].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * c4 + e;
        if (d < D) dst[d] = from_f<T>(div ? vals[e] / div[r] : vals[e]);
      }
    }
  }
}

// ----------------------------------------------------------------------------------------------
// Forward
// ----------------------------------------------------------------------------------------------

template <int DP>
constexpr size_t fwd_smem_floats() {
  return (size_t)(BQF + 2 * BKF) * (DP + 4) + (size_t)BQF * (BKF + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Geom g) {
  constexpr int PADW = DP + 4, PS = BKF + 1;
  constexpr int RQ = BQF / 16, RC = BKF / 16, NC4 = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQF * PADW;
  float* Vs = Ks + BKF * PADW;
  float* Ps = Vs + BKF * PADW;

  const int q0 = blockIdx.x * BQF, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / g.G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrs = (int64_t)g.H * g.D, krs = (int64_t)g.Hkv * g.D;
  const T* qb = q + ((int64_t)b * g.S * g.H + h) * g.D;
  const T* kb = k + ((int64_t)b * g.T * g.Hkv + hk) * g.D;
  const T* vb = v + ((int64_t)b * g.T * g.Hkv + hk) * g.D;

  load_tile<T, BQF, DP>(Qs, qb, q0, g.S, qrs, g.D);

  const int qlast = min(q0 + BQF, g.S) - 1;
  int k_begin = 0, k_end = g.T;
  if (!row_dead(g, qlast)) {  // no row of the block is dead: its keys only
    k_begin = row_lo(g, q0);
    k_end = row_hi(g, qlast) + 1;
  }

  float m[RQ], l[RQ];
  float4 acc[RQ][NC4];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < NC4; ++c4) acc[r][c4] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = (k_begin / BKF) * BKF; k0 < k_end; k0 += BKF) {
    __syncthreads();  // the previous step's readers of Ks, Vs, Ps (and Qs's writers) are done
    load_tile<T, BKF, DP>(Ks, kb, k0, g.T, krs, g.D);
    load_tile<T, BKF, DP>(Vs, vb, k0, g.T, krs, g.D);
    __syncthreads();

    float s[RQ][RC];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < RC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[RQ], bk[RC];
#pragma unroll
      for (int r = 0; r < RQ; ++r) a[r] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * r) * PADW + d]);
#pragma unroll
      for (int c = 0; c < RC; ++c) bk[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * PADW + d]);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < RC; ++c) fma4(s[r][c], a[r], bk[c]);
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float x;
        if (kpos >= g.T) x = -INFINITY;           // not a key
        else if (!visible(g, qpos, kpos)) x = kNegInf;
        else x = score(g, s[r][c]);
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max16(mx));
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float p = expf(s[r][c] - m_new);
        Ps[(ty + 16 * r) * PS + tx + 16 * c] = p;
        psum += p;
      }
      l[r] = l[r] * corr + psum;  // this thread's share of the row sum
      m[r] = m_new;
#pragma unroll
      for (int c4 = 0; c4 < NC4; ++c4) {
        acc[r][c4].x *= corr;
        acc[r][c4].y *= corr;
        acc[r][c4].z *= corr;
        acc[r][c4].w *= corr;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BKF; ++j) {
      float pr[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) pr[r] = Ps[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c4 = 0; c4 < NC4; ++c4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * PADW + 4 * tx + 64 * c4]);
#pragma unroll
        for (int r = 0; r < RQ; ++r) axpy4(acc[r][c4], pr[r], vv);
      }
    }
  }

  float lsum[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    lsum[r] = fmaxf(row_sum16(l[r]), 1e-30f);
    const int row = q0 + ty + 16 * r;
    if (tx == 0 && row < g.S) lse[((int64_t)b * g.H + h) * g.S + row] = m[r] + logf(lsum[r]);
  }
  store_rows<T, RQ, NC4>(o + ((int64_t)b * g.S * g.H + h) * g.D, qrs, q0, g.S, g.D, acc, lsum);
}

// ----------------------------------------------------------------------------------------------
// Backward
// ----------------------------------------------------------------------------------------------

// delta[b, h, s] = sum_d dO * O, one warp per (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, Geom g) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* op = o + row * g.D;
  const T* dp = dout + row * g.D;
  float acc = 0.f;
  for (int d = lane; d < g.D; d += 32) acc = fmaf(to_f(dp[d]), to_f(op[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t sh = (int64_t)g.S * g.H;
    const int64_t b = row / sh, s = (row % sh) / g.H, h = row % g.H;
    delta[(b * g.H + h) * g.S + s] = acc;
  }
}

// p and the scaled score gradient ds of a 32 x 32 tile: rows q0 + ty + 16 r of Qs / dOs (with
// their lse and delta in Ls / Dl), keys k0 + tx + 16 c of Ks / Vs
template <int DP>
__device__ __forceinline__ void bwd_tile(const Geom& g, const float* Qs, const float* dOs,
                                         const float* Ks, const float* Vs, const float* Ls,
                                         const float* Dl, int q0, int k0, float (&p)[2][2],
                                         float (&ds)[2][2]) {
  constexpr int PADW = DP + 4;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[2], da[2], bk[2], bv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * r) * PADW + d]);
      da[r] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * r) * PADW + d]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      bk[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * PADW + d]);
      bv[c] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * c) * PADW + d]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        fma4(s[r][c], a[r], bk[c]);
        fma4(dp[r][c], da[r], bv[c]);
      }
  }
  const float inv_t = 1.f / (float)g.T;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = ty + 16 * r, qpos = q0 + i;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kpos = k0 + tx + 16 * c;
      p[r][c] = 0.f;
      ds[r][c] = 0.f;
      if (qpos >= g.S || kpos >= g.T) continue;
      if (row_dead(g, qpos)) {  // the mean of v: p = 1/T, no score gradient
        p[r][c] = inv_t;
        continue;
      }
      if (!visible(g, qpos, kpos)) continue;
      const float x = score(g, s[r][c]);
      const float pp = expf(x - Ls[i]);
      float d_ = pp * (dp[r][c] - Dl[i]);
      if (g.cap > 0.f) {
        const float t = x / g.cap;
        d_ = d_ * (1.f - t * t);
      }
      p[r][c] = pp;
      ds[r][c] = d_ * g.scale;
    }
  }
}

template <int DP>
constexpr size_t dkdv_smem_floats() {
  return (size_t)4 * BB * (DP + 4) + (size_t)2 * BB * (BB + 1) + 2 * BB;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, Geom g) {
  constexpr int PADW = DP + 4, PS = BB + 1, NC4 = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BB * PADW;
  float* Qs = Vs + BB * PADW;
  float* dOs = Qs + BB * PADW;
  float* Ps = dOs + BB * PADW;
  float* dSs = Ps + BB * PS;
  float* Ls = dSs + BB * PS;
  float* Dl = Ls + BB;

  const int k0 = blockIdx.x * BB, hk = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrs = (int64_t)g.H * g.D, krs = (int64_t)g.Hkv * g.D;
  const int64_t kvoff = ((int64_t)b * g.T * g.Hkv + hk) * g.D;
  load_tile<T, BB, DP>(Ks, k + kvoff, k0, g.T, krs, g.D);
  load_tile<T, BB, DP>(Vs, v + kvoff, k0, g.T, krs, g.D);

  // the q blocks whose rows see a key of this block: [qa, qb) by the masks, then the rows
  // with no visible key at all, [dead0, S), which read every key
  const int klast = min(k0 + BB, g.T) - 1;
  const int qa = g.causal ? k0 : 0;
  const int qb = g.window > 0 ? min(g.S, klast + g.window) : g.S;
  const int dead0 = g.window > 0 ? g.T + g.window - 1 : g.S;
  const int nblk = (g.S + BB - 1) / BB;
  const int first_a = qa / BB, last_a = qa < qb ? (qb - 1) / BB : first_a - 1;
  const int first_d = dead0 < g.S ? max(last_a + 1, dead0 / BB) : nblk;

  float4 acc_k[2][NC4], acc_v[2][NC4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c4 = 0; c4 < NC4; ++c4) {
      acc_k[r][c4] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_v[r][c4] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int gi = 0; gi < g.G; ++gi) {
    const int h = hk * g.G + gi;
    const int64_t qoff = ((int64_t)b * g.S * g.H + h) * g.D;
    const float* lse_h = lse + ((int64_t)b * g.H + h) * g.S;
    const float* delta_h = delta + ((int64_t)b * g.H + h) * g.S;
    for (int blk = first_a; blk < nblk; ++blk) {
      if (blk > last_a && blk < first_d) blk = first_d;
      if (blk >= nblk) break;
      const int q0 = blk * BB;
      __syncthreads();  // the previous step's readers are done
      load_tile<T, BB, DP>(Qs, q + qoff, q0, g.S, qrs, g.D);
      load_tile<T, BB, DP>(dOs, dout + qoff, q0, g.S, qrs, g.D);
      if (threadIdx.x < BB) {
        const int row = q0 + threadIdx.x;
        Ls[threadIdx.x] = row < g.S ? lse_h[row] : 0.f;
        Dl[threadIdx.x] = row < g.S ? delta_h[row] : 0.f;
      }
      __syncthreads();
      float p[2][2], ds[2][2];
      bwd_tile<DP>(g, Qs, dOs, Ks, Vs, Ls, Dl, q0, k0, p, ds);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          Ps[(ty + 16 * r) * PS + tx + 16 * c] = p[r][c];
          dSs[(ty + 16 * r) * PS + tx + 16 * c] = ds[r][c];
        }
      __syncthreads();
      // dV[j] += p[i, j] dO[i], dK[j] += ds[i, j] q[i] for this thread's keys j = ty + 16 r
#pragma unroll 4
      for (int i = 0; i < BB; ++i) {
        float pr[2], dr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pr[r] = Ps[i * PS + ty + 16 * r];
          dr[r] = dSs[i * PS + ty + 16 * r];
        }
#pragma unroll
        for (int c4 = 0; c4 < NC4; ++c4) {
          const float4 o4 = *reinterpret_cast<const float4*>(&dOs[i * PADW + 4 * tx + 64 * c4]);
          const float4 q4 = *reinterpret_cast<const float4*>(&Qs[i * PADW + 4 * tx + 64 * c4]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            axpy4(acc_v[r][c4], pr[r], o4);
            axpy4(acc_k[r][c4], dr[r], q4);
          }
        }
      }
    }
  }
  store_rows<T, 2, NC4>(dk + kvoff, krs, k0, g.T, g.D, acc_k, nullptr);
  store_rows<T, 2, NC4>(dv + kvoff, krs, k0, g.T, g.D, acc_v, nullptr);
}

template <int DP>
constexpr size_t dq_smem_floats() {
  return (size_t)4 * BB * (DP + 4) + (size_t)BB * (BB + 1) + 2 * BB;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Geom g) {
  constexpr int PADW = DP + 4, PS = BB + 1, NC4 = DP / 64;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BB * PADW;
  float* Ks = dOs + BB * PADW;
  float* Vs = Ks + BB * PADW;
  float* dSs = Vs + BB * PADW;
  float* Ls = dSs + BB * PS;
  float* Dl = Ls + BB;

  const int q0 = blockIdx.x * BB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / g.G;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrs = (int64_t)g.H * g.D, krs = (int64_t)g.Hkv * g.D;
  const int64_t qoff = ((int64_t)b * g.S * g.H + h) * g.D;
  const int64_t kvoff = ((int64_t)b * g.T * g.Hkv + hk) * g.D;
  load_tile<T, BB, DP>(Qs, q + qoff, q0, g.S, qrs, g.D);
  load_tile<T, BB, DP>(dOs, dout + qoff, q0, g.S, qrs, g.D);
  if (threadIdx.x < BB) {
    const int row = q0 + threadIdx.x;
    const int64_t at = ((int64_t)b * g.H + h) * g.S + row;
    Ls[threadIdx.x] = row < g.S ? lse[at] : 0.f;
    Dl[threadIdx.x] = row < g.S ? delta[at] : 0.f;
  }

  // dead rows have no score gradient; the others see keys [lo(q0), hi(qlast)]
  const int qlast = min(q0 + BB, g.S) - 1;
  int k_begin = 0, k_end = 0;
  if (!row_dead(g, q0)) {
    k_begin = row_lo(g, q0);
    k_end = row_hi(g, qlast) + 1;
  }

  float4 acc[2][NC4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c4 = 0; c4 < NC4; ++c4) acc[r][c4] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = (k_begin / BB) * BB; k0 < k_end; k0 += BB) {
    __syncthreads();  // the previous step's readers are done (and the resident tiles written)
    load_tile<T, BB, DP>(Ks, k + kvoff, k0, g.T, krs, g.D);
    load_tile<T, BB, DP>(Vs, v + kvoff, k0, g.T, krs, g.D);
    __syncthreads();
    float p[2][2], ds[2][2];
    bwd_tile<DP>(g, Qs, dOs, Ks, Vs, Ls, Dl, q0, k0, p, ds);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) dSs[(ty + 16 * r) * PS + tx + 16 * c] = ds[r][c];
    __syncthreads();
    // dQ[i] += ds[i, j] k[j] for this thread's rows i = ty + 16 r
#pragma unroll 4
    for (int j = 0; j < BB; ++j) {
      float dr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) dr[r] = dSs[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c4 = 0; c4 < NC4; ++c4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&Ks[j * PADW + 4 * tx + 64 * c4]);
#pragma unroll
        for (int r = 0; r < 2; ++r) axpy4(acc[r][c4], dr[r], k4);
      }
    }
  }
  store_rows<T, 2, NC4>(dq + qoff, qrs, q0, g.S, g.D, acc, nullptr);
}

// ----------------------------------------------------------------------------------------------
// bfloat16 on the tensor cores: TMA, mbarriers and wgmma
// ----------------------------------------------------------------------------------------------

constexpr int WG = 128;                       // threads of a warpgroup
constexpr int kConsumers = 2;                 // consumer warpgroups a CTA
constexpr int kTcThreads = (kConsumers + 1) * WG;  // and one producer warpgroup
constexpr int kStages = 2;                    // the ring's stages
constexpr int TR = 64;                        // rows of a warpgroup's tile; keys of a step
constexpr int BKQ = 32;                       // keys of a dQ step
constexpr int PANEL = 64;                     // bf16 columns of a 128-byte row
constexpr int NSPLIT = 2;                     // bf16 terms of a float32 operand (p, ds)
constexpr uint32_t SLAB = TR * 128;           // one 64-row panel: 8 KB
constexpr uint32_t SLAB_Q = BKQ * 128;        // one 32-row panel: 4 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 1024-byte alignment of the dynamic shared memory: the 128-byte swizzle repeats every 8 rows
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
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

// thread 0 sets up the barrier of the resident tiles (`once`) and the ring's: full[s] takes
// the producer's arrival and the bytes of a stage, empty[s] one arrival a consumer warp
__device__ __forceinline__ void init_barriers(uint64_t* once, uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// one TMA box (64 columns x rows of one head) of a (B, L, heads, D) tensor into shared memory,
// counted on `bar`; coordinates innermost first (column, head, row, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row),
      "r"(batch)
      : "memory");
}

// wgmma operand descriptors, 128-byte swizzle: 8-row groups 1024 bytes apart (SBO).  K-major
// (s, dp): a k16 step is +32 bytes inside the 128-byte row.  MN-major (the B of the products
// with p and ds): a k16 step is 16 rows, +2048 bytes; one instruction covers one 64-column
// panel, and both strides are set to the 1024 bytes between its two 8-row groups.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads of an accumulator above the wait that completes it
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// a CTA of three warpgroups starts at 168 registers a thread, which would spill the D = 256
// accumulators: the producer warpgroup gives its registers to the consumers (24 + 2 x 240)
__device__ __forceinline__ void producer_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
}
__device__ __forceinline__ void consumer_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
}

// D (64 x 64, float32) (+)= A (64 x 16) B^T, A and B bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32, float32) (+)= A (64 x 16) B^T, A and B bf16 in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) B, B bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// The A operands (registers) of NK k16 steps from a float32 accumulator x of a 64-row tile:
// accumulator element v of a thread sits at row 8 ((v >> 1) & 1) of its pair and column
// 8 (v >> 2) + 2 (lane & 3) + (v & 1), which is where a k16 step's A fragment wants column
// 16 kk + ... of the same row.  Term t is bf16(x - the terms before it).
template <int NK>
__device__ __forceinline__ void split_terms(const float (&x)[8 * NK], uint32_t (&a)[NSPLIT][NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x0 = x[8 * kk + 2 * i], x1 = x[8 * kk + 2 * i + 1];
#pragma unroll
      for (int t = 0; t < NSPLIT; ++t) {
        const __nv_bfloat16 b0 = __float2bfloat16_rn(x0), b1 = __float2bfloat16_rn(x1);
        a[t][kk][i] = pack2(b0, b1);
        x0 -= __bfloat162float(b0);
        x1 -= __bfloat162float(b1);
      }
    }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// acc[p] (+)= the products of the A terms with the B panels at b (64 columns each, `slab`
// bytes apart; NK k16 steps of 16 rows), one wgmma per (panel, step, term)
template <int NP, int NK>
__device__ __forceinline__ void mma_terms(float (&acc)[NP][32], const uint32_t (&a)[NSPLIT][NK][4],
                                          const uint8_t* b, uint32_t slab) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int t = 0; t < NSPLIT; ++t) wgmma_rs_n64(acc[p], a[t][kk], desc_mn(b + p * slab + kk * 2048));
}

// s = A B^T over DP columns: A a 64-row tile, B a 64-row tile (`bslab` bytes a panel)
template <int NP>
__device__ __forceinline__ void mma_scores64(float (&s)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(s, desc_k(a + p * SLAB + 32 * kk), desc_k(b + p * SLAB + 32 * kk), p | kk);
}
template <int NP>
__device__ __forceinline__ void mma_scores32(float (&s)[16], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n32(s, desc_k(a + p * SLAB + 32 * kk), desc_k(b + p * SLAB_Q + 32 * kk), p | kk);
}

template <int DP>
constexpr size_t tc_smem_bytes() {  // six 64-row tiles, the barriers, the alignment slack
  return 6 * (size_t)(DP / PANEL) * SLAB + 64 + 1024;
}

// ----------------------------------------------------------------------------------------------
// Forward, bfloat16
// ----------------------------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, Geom g) {
  constexpr int NP = DP / PANEL;
  constexpr uint32_t TILE = NP * SLAB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);  // kConsumers tiles of 64 rows
  uint8_t* Ks = Qs + kConsumers * TILE;  // kStages tiles
  uint8_t* Vs = Ks + kStages * TILE;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + kStages * TILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kConsumers * TR);  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  const int qlast = min(q0 + kConsumers * TR, g.S) - 1;
  int k_begin = 0, k_end = g.T;
  if (!row_dead(g, qlast)) {  // no row of the block is dead: its keys only
    k_begin = row_lo(g, q0);
    k_end = row_hi(g, qlast) + 1;
  }
  const int kstart = (k_begin / TR) * TR;
  const int nsteps = (k_end - kstart + TR - 1) / TR;

  init_barriers(qbar, full, empty);

  const int wg = threadIdx.x / WG;
  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every copy
    producer_registers();
    if (threadIdx.x == kConsumers * WG) {
      mbar_expect_tx(qbar, kConsumers * TILE);
      for (int w = 0; w < kConsumers; ++w)
        for (int p = 0; p < NP; ++p)
          tma_load(Qs + w * TILE + p * SLAB, &tq, qbar, p * PANEL, h, q0 + w * TR, b);
      for (int j = 0; j < nsteps; ++j) {
        const int s = j % kStages, k0 = kstart + j * TR;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE);
        for (int p = 0; p < NP; ++p) {
          tma_load(Ks + s * TILE + p * SLAB, &tk, &full[s], p * PANEL, hk, k0, b);
          tma_load(Vs + s * TILE + p * SLAB, &tv, &full[s], p * PANEL, hk, k0, b);
        }
      }
    }
    return;
  }
  consumer_registers();

  // a consumer warpgroup: rows wq0 .. wq0 + 63; this thread's rows ra and ra + 8
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int wq0 = q0 + wg * TR, ra = wq0 + 16 * warp + lane / 4, cq = 2 * (lane & 3);
  const bool rows = wq0 < g.S;
  const int wlast = min(wq0 + TR, g.S) - 1;
  const bool all_keys = rows && row_dead(g, wlast);
  const int wlo = rows ? row_lo(g, wq0) : 0, whi = rows ? row_hi(g, wlast) : -1;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint8_t* Qw = Qs + wg * TILE;
  mbar_wait(qbar, 0);

  for (int j = 0; j < nsteps; ++j) {
    const int s = j % kStages, k0 = kstart + j * TR;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (rows && (all_keys || (k0 <= whi && k0 + TR - 1 >= wlo))) {
      float sc[32];
      zero(sc);
      wg_fence();
      mma_scores64<NP>(sc, Qw, Ks + s * TILE);
      wg_commit();
      wg_wait_all();
      reg_fence(sc);

      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int r = (v >> 1) & 1, qpos = ra + 8 * r;
        const int kpos = k0 + 8 * (v >> 2) + cq + (v & 1);
        float x;
        if (kpos >= g.T) x = -INFINITY;  // not a key
        else if (!visible(g, qpos, kpos)) x = kNegInf;
        else x = score(g, sc[v]);
        sc[v] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 threads of a row are one quad
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int r = (v >> 1) & 1;
        const float p = expf(sc[v] - m[r]);
        sc[v] = p;
        psum[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];  // this thread's share
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int v = 0; v < 32; ++v) acc[p][v] *= corr[(v >> 1) & 1];

      uint32_t pa[NSPLIT][4][4];
      split_terms<4>(sc, pa);
      wg_fence();
      mma_terms<NP, 4>(acc, pa, Vs + s * TILE, SLAB);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }
  if (!rows) return;

  float lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    lsum[r] = fmaxf(t, 1e-30f);
    const int row = ra + 8 * r;
    if ((lane & 3) == 0 && row < g.S) lse[((int64_t)b * g.H + h) * g.S + row] = m[r] + logf(lsum[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= g.S) continue;
    __nv_bfloat16* dst = o + (((int64_t)b * g.S + row) * g.H + h) * g.D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = p * PANEL + 8 * c + cq;
        if (col < g.D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __halves2bfloat162(
              __float2bfloat16_rn(acc[p][4 * c + 2 * r] / lsum[r]),
              __float2bfloat16_rn(acc[p][4 * c + 2 * r + 1] / lsum[r]));
      }
  }
}

// ----------------------------------------------------------------------------------------------
// Backward, bfloat16
// ----------------------------------------------------------------------------------------------

// one consumer warpgroup of the dK/dV kernel: DK accumulates dK = ds^T q into out (or the dK
// partials), else dV = p^T dO
template <int DP, bool DK>
__device__ __forceinline__ void dkdv_consumer(const Geom& g, const uint8_t* Ks, const uint8_t* Vs,
                                              const uint8_t* Qs, const uint8_t* dOs,
                                              uint64_t* kvbar, uint64_t* full, uint64_t* empty,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              __nv_bfloat16* __restrict__ out,
                                              float* __restrict__ part, int B, int k0, int h,
                                              int b, int first_a, int na, int first_d,
                                              int nsteps) {
  constexpr int NP = DP / PANEL;
  constexpr uint32_t TILE = NP * SLAB;
  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int rk = k0 + 16 * warp + lane / 4, cq = 2 * (lane & 3);  // keys rk and rk + 8
  const int hk = h / g.G;
  const float* lse_h = lse + ((int64_t)b * g.H + h) * g.S;
  const float* delta_h = delta + ((int64_t)b * g.H + h) * g.S;
  const float inv_t = 1.f / (float)g.T;

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  mbar_wait(kvbar, 0);

  for (int j = 0; j < nsteps; ++j) {
    const int s = j % kStages, q0 = (j < na ? first_a + j : first_d + j - na) * TR;
    const uint8_t* Qt = Qs + s * TILE;
    const uint8_t* dOt = dOs + s * TILE;
    mbar_wait(&full[s], (j / kStages) & 1);
    float st[32], dpt[DK ? 32 : 1];
    zero(st);
    zero(dpt);
    wg_fence();
    mma_scores64<NP>(st, Ks, Qt);
    if constexpr (DK) mma_scores64<NP>(dpt, Vs, dOt);
    wg_commit();
    wg_wait_all();
    reg_fence(st);
    reg_fence(dpt);
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int key = rk + 8 * ((v >> 1) & 1), qpos = q0 + 8 * (v >> 2) + cq + (v & 1);
      float p = 0.f, ds = 0.f;
      if (qpos < g.S && key < g.T) {
        if (row_dead(g, qpos)) {  // the mean of v: p = 1/T, no score gradient
          p = inv_t;
        } else if (visible(g, qpos, key)) {
          const float x = score(g, st[v]);
          p = expf(x - lse_h[qpos]);
          if constexpr (DK) {
            float d_ = p * (dpt[v] - delta_h[qpos]);
            if (g.cap > 0.f) {
              const float t = x / g.cap;
              d_ = d_ * (1.f - t * t);
            }
            ds = d_ * g.scale;
          }
        }
      }
      st[v] = DK ? ds : p;
    }
    uint32_t pa[NSPLIT][4][4];
    split_terms<4>(st, pa);
    wg_fence();
    mma_terms<NP, 4>(acc, pa, DK ? Qt : dOt, SLAB);
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const int64_t n = (int64_t)B * g.T * g.Hkv * g.D;
  if (part) part += (DK ? 0 : g.G * n) + (h % g.G) * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = rk + 8 * r;
    if (key >= g.T) continue;
    const int64_t at = (((int64_t)b * g.T + key) * g.Hkv + hk) * g.D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = p * PANEL + 8 * c + cq;
        if (col >= g.D) continue;
        const float x0 = acc[p][4 * c + 2 * r], x1 = acc[p][4 * c + 2 * r + 1];
        if (part)
          *reinterpret_cast<float2*>(part + at + col) = make_float2(x0, x1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + at + col) =
              __halves2bfloat162(__float2bfloat16_rn(x0), __float2bfloat16_rn(x1));
      }
  }
}

// dK and dV of 64 keys of one kv head from one query head h (blockIdx.y): warpgroup 0
// accumulates dV = p^T dO, warpgroup 1 dK = ds^T q (both recompute s^T = K Q^T; warpgroup 1
// also dp^T = V dO^T).  Rows of the accumulators are keys, columns queries, so p^T and ds^T are
// the A operands as they stand.  With G > 1 the float32 result goes to part (dK partials, then
// dV partials, each (G, B, T, Hkv, D)); else straight to dk, dv.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkdv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                            const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, float* __restrict__ part, int B, Geom g) {
  constexpr int NP = DP / PANEL;
  constexpr uint32_t TILE = NP * SLAB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + TILE;
  uint8_t* Qs = Vs + TILE;                // kStages tiles
  uint8_t* dOs = Qs + kStages * TILE;     // kStages tiles
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(dOs + kStages * TILE);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * TR, h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  // the q blocks whose rows see a key of this block: [first_a, first_a + na) by the masks,
  // then the blocks of rows with no visible key at all, [first_d, nblk), which read every key
  const int klast = min(k0 + TR, g.T) - 1;
  const int qa = g.causal ? k0 : 0;
  const int qb = g.window > 0 ? min(g.S, klast + g.window) : g.S;
  const int dead0 = g.window > 0 ? g.T + g.window - 1 : g.S;
  const int nblk = (g.S + TR - 1) / TR;
  const int first_a = qa / TR;
  const int na = qa < qb ? (qb - 1) / TR - first_a + 1 : 0;
  const int first_d = dead0 < g.S ? max(first_a + na, dead0 / TR) : nblk;
  const int nsteps = na + max(0, nblk - first_d);

  init_barriers(kvbar, full, empty);

  const int wg = threadIdx.x / WG;
  if (wg == kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers * WG) {
      mbar_expect_tx(kvbar, 2 * TILE);
      for (int p = 0; p < NP; ++p) {
        tma_load(Ks + p * SLAB, &tk, kvbar, p * PANEL, hk, k0, b);
        tma_load(Vs + p * SLAB, &tv, kvbar, p * PANEL, hk, k0, b);
      }
      for (int j = 0; j < nsteps; ++j) {
        const int s = j % kStages, q0 = (j < na ? first_a + j : first_d + j - na) * TR;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE);
        for (int p = 0; p < NP; ++p) {
          tma_load(Qs + s * TILE + p * SLAB, &tq, &full[s], p * PANEL, h, q0, b);
          tma_load(dOs + s * TILE + p * SLAB, &tdo, &full[s], p * PANEL, h, q0, b);
        }
      }
    }
    return;
  }
  consumer_registers();
  if (wg == 1)
    dkdv_consumer<DP, true>(g, Ks, Vs, Qs, dOs, kvbar, full, empty, lse, delta, dk, part, B, k0,
                            h, b, first_a, na, first_d, nsteps);
  else
    dkdv_consumer<DP, false>(g, Ks, Vs, Qs, dOs, kvbar, full, empty, lse, delta, dv, part, B, k0,
                             h, b, first_a, na, first_d, nsteps);
}

// dk, dv = the sums of the G float32 partials in head order, rounded once
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_reduce_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int64_t n, int G) {
  const int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* src = part + (int64_t)which * G * n + i;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int gi = 1; gi < G; ++gi) {
      const float4 x = *reinterpret_cast<const float4*>(src + gi * n);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>((which ? dv : dk) + i);
    dst[0] = __halves2bfloat162(__float2bfloat16_rn(acc.x), __float2bfloat16_rn(acc.y));
    dst[1] = __halves2bfloat162(__float2bfloat16_rn(acc.z), __float2bfloat16_rn(acc.w));
  }
}

// dQ of 128 query rows of one head (two warpgroups of 64), K and V streamed 32 keys a step:
// s = Q K^T and dp = dO V^T again, ds, then dQ += ds K
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                          const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, Geom g) {
  constexpr int NP = DP / PANEL;
  constexpr uint32_t TILE = NP * SLAB, KTILE = NP * SLAB_Q;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);      // kConsumers tiles
  uint8_t* dOs = Qs + kConsumers * TILE;  // kConsumers tiles
  uint8_t* Ks = dOs + kConsumers * TILE;  // kStages tiles of 32 rows
  uint8_t* Vs = Ks + kStages * KTILE;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + kStages * KTILE);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kConsumers * TR);  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / g.G;
  // dead rows have no score gradient; the others see keys [lo(q0), hi(qlast)]
  const int qlast = min(q0 + kConsumers * TR, g.S) - 1;
  int k_begin = 0, k_end = 0;
  if (!row_dead(g, q0)) {
    k_begin = row_lo(g, q0);
    k_end = row_hi(g, qlast) + 1;
  }
  const int kstart = (k_begin / BKQ) * BKQ;
  const int nsteps = k_end > kstart ? (k_end - kstart + BKQ - 1) / BKQ : 0;

  init_barriers(qbar, full, empty);

  const int wg = threadIdx.x / WG;
  if (wg == kConsumers) {
    producer_registers();
    if (threadIdx.x == kConsumers * WG) {
      mbar_expect_tx(qbar, 2 * kConsumers * TILE);
      for (int w = 0; w < kConsumers; ++w)
        for (int p = 0; p < NP; ++p) {
          tma_load(Qs + w * TILE + p * SLAB, &tq, qbar, p * PANEL, h, q0 + w * TR, b);
          tma_load(dOs + w * TILE + p * SLAB, &tdo, qbar, p * PANEL, h, q0 + w * TR, b);
        }
      for (int j = 0; j < nsteps; ++j) {
        const int s = j % kStages, k0 = kstart + j * BKQ;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KTILE);
        for (int p = 0; p < NP; ++p) {
          tma_load(Ks + s * KTILE + p * SLAB_Q, &tk, &full[s], p * PANEL, hk, k0, b);
          tma_load(Vs + s * KTILE + p * SLAB_Q, &tv, &full[s], p * PANEL, hk, k0, b);
        }
      }
    }
    return;
  }
  consumer_registers();

  const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
  const int wq0 = q0 + wg * TR, ra = wq0 + 16 * warp + lane / 4, cq = 2 * (lane & 3);
  // a warpgroup whose first row is dead (or past S) has no score gradient at all
  const bool rows = wq0 < g.S && !row_dead(g, wq0);
  const int wlast = min(wq0 + TR, g.S) - 1;
  const int wlo = rows ? row_lo(g, wq0) : 0, whi = rows ? row_hi(g, wlast) : -1;
  float L[2], Dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    const int64_t at = ((int64_t)b * g.H + h) * g.S + row;
    L[r] = row < g.S ? lse[at] : 0.f;
    Dl[r] = row < g.S ? delta[at] : 0.f;
  }

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  const uint8_t* Qw = Qs + wg * TILE;
  const uint8_t* dOw = dOs + wg * TILE;
  mbar_wait(qbar, 0);

  for (int j = 0; j < nsteps; ++j) {
    const int s = j % kStages, k0 = kstart + j * BKQ;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (rows && k0 <= whi && k0 + BKQ - 1 >= wlo) {
      float sc[16], dp[16];
      zero(sc);
      zero(dp);
      wg_fence();
      mma_scores32<NP>(sc, Qw, Ks + s * KTILE);
      mma_scores32<NP>(dp, dOw, Vs + s * KTILE);
      wg_commit();
      wg_wait_all();
      reg_fence(sc);
      reg_fence(dp);
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        const int r = (v >> 1) & 1, qpos = ra + 8 * r;
        const int kpos = k0 + 8 * (v >> 2) + cq + (v & 1);
        float ds = 0.f;
        if (qpos < g.S && kpos < g.T && !row_dead(g, qpos) && visible(g, qpos, kpos)) {
          const float x = score(g, sc[v]);
          const float p = expf(x - L[r]);
          float d_ = p * (dp[v] - Dl[r]);
          if (g.cap > 0.f) {
            const float t = x / g.cap;
            d_ = d_ * (1.f - t * t);
          }
          ds = d_ * g.scale;
        }
        sc[v] = ds;
      }
      uint32_t pa[NSPLIT][2][4];
      split_terms<2>(sc, pa);
      wg_fence();
      mma_terms<NP, 2>(acc, pa, Ks + s * KTILE, SLAB_Q);
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) reg_fence(acc[p]);
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (wq0 >= g.S) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= g.S) continue;
    __nv_bfloat16* dst = dq + (((int64_t)b * g.S + row) * g.H + h) * g.D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = p * PANEL + 8 * c + cq;
        if (col < g.D)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) = __halves2bfloat162(
              __float2bfloat16_rn(acc[p][4 * c + 2 * r]), __float2bfloat16_rn(acc[p][4 * c + 2 * r + 1]));
      }
  }
}

// ----------------------------------------------------------------------------------------------
// Launchers
// ----------------------------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               const Geom& g, cudaStream_t st) {
  const size_t smem = fwd_smem_floats<DP>() * sizeof(float);
  cudaError_t e = allow_smem(flash_fwd_kernel<float, DP>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.S + BQF - 1) / BQF, g.H, B);
  flash_fwd_kernel<float, DP><<<grid, kThreads, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, g);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
               const Geom& g, cudaStream_t st) {
  const int64_t rows = (int64_t)B * g.S * g.H;
  const int per = kThreads / 32;
  flash_bwd_delta_kernel<float><<<(unsigned)((rows + per - 1) / per), kThreads, 0, st>>>(
      (const float*)o, (const float*)dout, delta, rows, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = dkdv_smem_floats<DP>() * sizeof(float);
  e = allow_smem(flash_bwd_dkdv_kernel<float, DP>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<float, DP><<<dim3((g.T + BB - 1) / BB, g.Hkv, B), kThreads, smem_kv, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_q = dq_smem_floats<DP>() * sizeof(float);
  e = allow_smem(flash_bwd_dq_kernel<float, DP>, smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<float, DP><<<dim3((g.S + BB - 1) / BB, g.H, B), kThreads, smem_q, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, g);
  return (int)cudaGetLastError();
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

// TMA boxes of 64 columns x `rows` rows of one head of a (B, L, heads, D) bfloat16 tensor,
// 128-byte swizzled; rows past L and columns past D read as zeros.  D % 8 == 0 and a 16-byte
// aligned base (kernel.py checks both).
int make_map(CUtensorMap* map, const void* base, int B, int64_t L, int heads, int D, int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)L * heads * D * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                  const Geom& g, cudaStream_t st) {
  // a runtime call before the encoder, which needs a context current on this thread
  const size_t smem = tc_smem_bytes<DP>();
  cudaError_t e = allow_smem(flash_fwd_kernel_wgmma<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  int r = make_map(&mq, q, B, g.S, g.H, g.D, TR);
  if (r == 0) r = make_map(&mk, k, B, g.T, g.Hkv, g.D, TR);
  if (r == 0) r = make_map(&mv, v, B, g.T, g.Hkv, g.D, TR);
  if (r != 0) return r;
  const dim3 grid((g.S + kConsumers * TR - 1) / (kConsumers * TR), g.H, B);
  flash_fwd_kernel_wgmma<DP><<<grid, kTcThreads, smem, st>>>(mq, mk, mv, (__nv_bfloat16*)o, lse, g);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, void* dk, void* dv, float* part,
                  int B, const Geom& g, cudaStream_t st) {
  if (g.G > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * g.S * g.H;
  const int per = kThreads / 32;
  flash_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)((rows + per - 1) / per), kThreads, 0, st>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, delta, rows, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap mq, mk, mv, mdo, mk32, mv32;
  int r = make_map(&mq, q, B, g.S, g.H, g.D, TR);
  if (r == 0) r = make_map(&mdo, dout, B, g.S, g.H, g.D, TR);
  if (r == 0) r = make_map(&mk, k, B, g.T, g.Hkv, g.D, TR);
  if (r == 0) r = make_map(&mv, v, B, g.T, g.Hkv, g.D, TR);
  if (r == 0) r = make_map(&mk32, k, B, g.T, g.Hkv, g.D, BKQ);
  if (r == 0) r = make_map(&mv32, v, B, g.T, g.Hkv, g.D, BKQ);
  if (r != 0) return r;
  const size_t smem = tc_smem_bytes<DP>();

  e = allow_smem(flash_bwd_dkdv_kernel_wgmma<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel_wgmma<DP><<<dim3((g.T + TR - 1) / TR, g.H, B), kTcThreads, smem, st>>>(
      mq, mk, mv, mdo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
      g.G > 1 ? part : nullptr, B, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (g.G > 1) {
    const int64_t n = (int64_t)B * g.T * g.Hkv * g.D;
    const int64_t threads = n / 4;
    flash_bwd_dkdv_reduce_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                                   st>>>(part, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, g.G);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  e = allow_smem(flash_bwd_dq_kernel_wgmma<DP>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.S + kConsumers * TR - 1) / (kConsumers * TR), g.H, B);
  flash_bwd_dq_kernel_wgmma<DP><<<grid, kTcThreads, smem, st>>>(mq, mk32, mv32, mdo, lse, delta,
                                                                 (__nv_bfloat16*)dq, g);
  return (int)cudaGetLastError();
}

Geom make_geom(int64_t S, int64_t T, int H, int Hkv, int D, int causal, int window, float cap,
               float scale) {
  Geom g;
  g.S = (int)S;
  g.T = (int)T;
  g.H = H;
  g.Hkv = Hkv;
  g.G = H / Hkv;
  g.D = D;
  g.causal = causal;
  g.window = window;
  g.cap = cap;
  g.scale = scale;
  return g;
}

}  // namespace

// dtype: 0 float32 (the CUDA-core kernels), 1 bfloat16 (the tensor-core kernels); window <= 0
// and cap <= 0 mean none.  Every operand 16-byte aligned; D % 4 == 0 (float32) or D % 8 == 0
// (bfloat16).  Returns cudaGetLastError, or the error of a tensor map that could not be made.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int64_t B, int64_t S, int64_t T, int H, int Hkv, int D,
                               int dtype, int causal, int window, float cap, float scale,
                               void* stream) {
  const Geom g = make_geom(S, T, H, Hkv, D, causal, window, cap, scale);
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  const int b = (int)B;
  if (dtype == 0) {
    if (D <= 64) return launch_fwd<64>(q, k, v, o, l, b, g, st);
    if (D <= 128) return launch_fwd<128>(q, k, v, o, l, b, g, st);
    return launch_fwd<256>(q, k, v, o, l, b, g, st);
  }
  if (D <= 64) return launch_fwd_tc<64>(q, k, v, o, l, b, g, st);
  if (D <= 128) return launch_fwd_tc<128>(q, k, v, o, l, b, g, st);
  return launch_fwd_tc<256>(q, k, v, o, l, b, g, st);
}

// part: bfloat16 with H > Hkv only, a float32 scratch of 2 G B T Hkv D elements (the dK and dV
// partials of the heads of a group); may be null otherwise.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, void* part, int64_t B, int64_t S, int64_t T,
                               int H, int Hkv, int D, int dtype, int causal, int window,
                               float cap, float scale, void* stream) {
  const Geom g = make_geom(S, T, H, Hkv, D, causal, window, cap, scale);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  float* pt = (float*)part;
  const int b = (int)B;
  if (dtype == 0) {
    if (D <= 64) return launch_bwd<64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
    if (D <= 128) return launch_bwd<128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
    return launch_bwd<256>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
  }
  if (D <= 64) return launch_bwd_tc<64>(q, k, v, o, dout, l, dl, dq, dk, dv, pt, b, g, st);
  if (D <= 128) return launch_bwd_tc<128>(q, k, v, o, dout, l, dl, dq, dk, dv, pt, b, g, st);
  return launch_bwd_tc<256>(q, k, v, o, dout, l, dl, dq, dk, dv, pt, b, g, st);
}

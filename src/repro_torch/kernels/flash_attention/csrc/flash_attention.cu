// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of repro/kernels/flash_attention/kernel.py: flash_attention_bhsd
// (pl.pallas_call at :93; body _flash_kernel :26).  The reference has no backward kernel (it
// trains by autodiff of its XLA attention); the three backward kernels here are the closed-form
// gradient of the same function.  q (B, S, H, D), k and v (B, T, Hkv, D), float32 or bfloat16,
// contiguous; query head h reads kv head h / G, G = H / Hkv (index mapping, no repeat).
//   forward:  s = (q k^T) D^-1/2, optionally cap tanh(s / cap); masked (kpos <= qpos when
//             causal, kpos > qpos - window) to the finite -1e30; online softmax with a float32
//             (m, l, acc) carry and p kept in float32 for p v; o = acc / max(l, 1e-30) in q's
//             dtype, lse = m + log l in float32 (B, H, S).
//   backward: delta = rowsum(dO * O) (flash_bwd_delta_kernel); then, with p = exp(s - lse),
//             ds = p (dp - delta), dp = dO v^T, times 1 - (s / cap)^2 under a softcap, and ds = 0
//             on masked entries: dV = p^T dO, dK = D^-1/2 ds^T q (flash_bwd_dkdv_kernel, one CTA
//             per (b, kv head, kv block), looping over the G query heads of its group and the q
//             blocks in a fixed order), dQ = D^-1/2 ds k (flash_bwd_dq_kernel, one CTA per
//             (b, h, q block)).  No atomics: two runs give the same bits.
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
// operations dominate from a few hundred tokens on.  Each product is priced at the rate of its
// operand types: with bfloat16 inputs, q k^T and dO v^T multiply two bfloat16 operands (exact
// in float32; the bfloat16 tensor-core rate with float32 accumulation), while p v, p^T dO,
// ds^T q and ds k carry the float32 p or ds (the float32 rate).  This first design computes
// every product in float32 on the CUDA cores; tensor cores (wgmma) for the bfloat16 products
// and TMA are a later step.
//
// Design.  256 threads; tiles staged in shared memory as float32, row-major with rows padded
// by 4 floats, so a quarter-warp reading 16-byte vectors of 8 consecutive rows hits 8 distinct
// bank groups.  A thread owns the score elements (ty + 16 r, tx + 16 c), ty = tid / 16,
// tx = tid % 16: the 16 threads of a row sit in one half-warp, so row maxima and sums are
// shuffles.  In the forward the same thread owns the output rows ty + 16 r and the columns
// 4 tx + 64 c4 .. + 3 of acc, so the softmax correction stays in registers.  Forward tiles:
// 64 query rows, 32 keys; backward tiles: 32 x 32.  D is padded to the template's DP in
// {64, 128, 256} with zeros.  Products are explicit fmaf chains (the library is built with
// --fmad=false).  Shared memory above 48 KB is opted into per kernel.

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
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// four consecutive elements as float32 (one 16-byte or 8-byte load)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);  // element 0 in the low half of u.x
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// rows [r0, r0 + R) of one head of a (B, L, heads, D) tensor into sm[R][DP + 4] as float32;
// rows past L and columns past D are zero.  Four columns a thread per load: D % 4 == 0 and the
// operands are 4-element aligned (kernel.py checks both).
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
// Launchers
// ----------------------------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
               const Geom& g, cudaStream_t st) {
  const size_t smem = fwd_smem_floats<DP>() * sizeof(float);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, DP>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.S + BQF - 1) / BQF, g.H, B);
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, g);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int B,
               const Geom& g, cudaStream_t st) {
  const int64_t rows = (int64_t)B * g.S * g.H;
  const int per = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0, st>>>(
      (const T*)o, (const T*)dout, delta, rows, g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_kv = dkdv_smem_floats<DP>() * sizeof(float);
  e = allow_smem(flash_bwd_dkdv_kernel<T, DP>, smem_kv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<T, DP><<<dim3((g.T + BB - 1) / BB, g.Hkv, B), kThreads, smem_kv, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem_q = dq_smem_floats<DP>() * sizeof(float);
  e = allow_smem(flash_bwd_dq_kernel<T, DP>, smem_q);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<T, DP><<<dim3((g.S + BB - 1) / BB, g.H, B), kThreads, smem_q, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, g);
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

// dtype: 0 float32, 1 bfloat16; window <= 0 and cap <= 0 mean none.  D % 4 == 0 and every
// operand 16-byte (float32) or 8-byte (bfloat16) aligned.  Returns cudaGetLastError.
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int64_t B, int64_t S, int64_t T, int H, int Hkv, int D,
                               int dtype, int causal, int window, float cap, float scale,
                               void* stream) {
  const Geom g = make_geom(S, T, H, Hkv, D, causal, window, cap, scale);
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  const int b = (int)B;
  if (dtype == 0) {
    if (D <= 64) return launch_fwd<float, 64>(q, k, v, o, l, b, g, st);
    if (D <= 128) return launch_fwd<float, 128>(q, k, v, o, l, b, g, st);
    return launch_fwd<float, 256>(q, k, v, o, l, b, g, st);
  }
  if (D <= 64) return launch_fwd<__nv_bfloat16, 64>(q, k, v, o, l, b, g, st);
  if (D <= 128) return launch_fwd<__nv_bfloat16, 128>(q, k, v, o, l, b, g, st);
  return launch_fwd<__nv_bfloat16, 256>(q, k, v, o, l, b, g, st);
}

extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int64_t B, int64_t S, int64_t T, int H,
                               int Hkv, int D, int dtype, int causal, int window, float cap,
                               float scale, void* stream) {
  const Geom g = make_geom(S, T, H, Hkv, D, causal, window, cap, scale);
  cudaStream_t st = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  const int b = (int)B;
  if (dtype == 0) {
    if (D <= 64) return launch_bwd<float, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
    if (D <= 128) return launch_bwd<float, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
    return launch_bwd<float, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
  }
  if (D <= 64) return launch_bwd<__nv_bfloat16, 64>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
  if (D <= 128)
    return launch_bwd<__nv_bfloat16, 128>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
  return launch_bwd<__nv_bfloat16, 256>(q, k, v, o, dout, l, dl, dq, dk, dv, b, g, st);
}

// The Mamba-1 selective scan with its output contraction, for Hopper (sm_90a), forward and
// backward.
//
// Replaces no Pallas kernel.  It is the port's counterpart of the reference's XLA stand-ins
// ssm_mix_seq and ssm_mix_fused (repro/models/ssm.py:96 and :123), which the reference names
// the stand-ins of the lru_scan kernel's VMEM-resident scan: the scan coefficients are made,
// used and dropped inside the time loop, so the (B, S, d_in, n) state never reaches device
// memory.  Over (B, S, d_in) with state n (n <= 32), per channel (b, d, i):
//
//   a_t  = exp(dt_t A_i)          bx_t = (dt_t u_t) B_t,i      (rounded to bf16 and widened
//                                                               back under a bf16 scan dtype)
//   h_t  = a_t h_{t-1} + bx_t     (h_{-1} = 0, float32)
//   y_t  = sum_i h_t,i C_t,i + D u_t
//
// in the reference's order of operations (_ssm_coeffs, repro/models/ssm.py:61-63), every
// product and sum rounded on its own (--fmad=false), expf as torch.exp computes it (no
// --use_fast_math).  The sum over i is one fixed tree: the P = 2^ceil(log2 n) lanes of a
// channel group take an xor butterfly (offsets P/2 .. 1; lanes past n add 0), which the plain
// version copies as s[..., :P/2] + s[..., P/2:], then :P/4, ... (kernels/lru_scan/ref.py).
//
// The backward, given gy = dL/dy, walks time in reverse:
//
//   lam_t = gy_t C_t,i + a_{t+1} lam_{t+1}       (lam_{S-1} = gy_{S-1} C_{S-1},i)
//   da_t  = lam_t h_{t-1},  dbx_t = lam_t        (rounded to bf16 under a bf16 scan dtype:
//                                                 the transpose of the reference's astype)
//   dp_t  = da_t a_t (a_t the float32 exp)       ddt_t = sum_i dp_t A_i + dq_t u_t
//   dq_t  = sum_i dbx_t B_t,i                    du_t  = dq_t dt_t + gy_t D
//   dA_i  = sum_{b,t} dp_t dt_t                  dD    = sum_{b,t} gy_t u_t
//   dB_t,i = sum_d dbx_t (dt_t u_t)              dC_t,i = sum_d gy_t h_t
//
// Bound at the trainer's shape (B 2, S 512, d_in 8192, n 16): the forward reads dt (float32),
// u (bf16) and writes y (float32), 83.9 MB or 25 us at 3.35 TB/s, and takes 134,217,728 expf,
// 32 us at the MUFU's 16 a clock an SM (132 SMs, 1.98 GHz): operations bound it.  The backward
// reads dt, u, gy and the checkpoints and writes ddt and du, 155 MB, 46 us: bytes bound it.
//
// Design.  A block owns kD channels d of one batch row and a lane group of P lanes for each
// (P x kD threads, kD = min(64, 256 / P)); the lane of state i walks its channel in time order,
// carrying h in a register, so every result is the plain version's, rounded the same way.  No
// chunk-parallel scan: it re-associates the recurrence.  The block stages tiles of dt, u (gy)
// over kD columns and B, C over n columns, for a span of steps, in shared memory, so each
// global row is read as one coalesced segment and not two floats a warp a step.  The forward
// stores h_{kQ-1} for every span of Q <= 128 steps as a float32 checkpoint, (B, ceil(S/Q),
// d_in, n): 4.2 MB at the trainer's shape where the state is 537 MB.  The backward takes spans
// from the last: from the span's checkpoint it walks the span forward once, keeping h at the
// head of every kBwdSteps sub-span in shared memory, then per sub-span (last first) rebuilds h
// and the float32 a in shared memory and walks it in reverse.  Sums across lanes are butterfly
// trees; sums over d_in (dB, dC), over b (dA, dD) and across blocks go through per-block
// partial buffers and a second pass (ssm_reduce_kernel) in one fixed order: no atomics, the same
// bits on every run.  Offsets are 64-bit.
//
// Measured: see PERF.md (chip_smoke.py phases 14a / 14b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;         // largest state n (one warp of lanes)
constexpr int kBlockLanes = 256;  // threads of a block for n >= 4
constexpr int kMaxD = 64;         // channels d of a block
constexpr int kFwdSteps = 32;     // steps of a staged forward tile
constexpr int kBwdSteps = 16;     // steps of a backward sub-span
constexpr int kMaxChunk = 128;    // the longest checkpoint span Q
constexpr int kMaxSub = kMaxChunk / kBwdSteps;

template <int P>
struct Tile {
  static constexpr int kD = kBlockLanes / P < kMaxD ? kBlockLanes / P : kMaxD;
  static constexpr int kThreads = kD * P;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The sum over the P lanes of a group (P a power of two, at most 32): after the level of offset
// o lane i holds v_i + v_(i^o), the same bits on both lanes (IEEE addition commutes), so every
// lane ends with the sum s[:P/2] + s[P/2:], then [:P/4] + [P/4:P/2], ... of the plain version.
template <int P>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows row0 .. row0 + len - 1 of a (rows, d_in) operand, columns d0 .. d0 + kD - 1, into
// s[steps][kD] as float; entries past the operand read as 0.
template <int kD, int kThreads, typename T>
__device__ __forceinline__ void stage_cols(float* s, const T* __restrict__ x, int64_t row0,
                                           int len, int d0, int d_in, int tid) {
  for (int i = tid; i < len * kD; i += kThreads) {
    const int r = i / kD, c = i - r * kD;
    s[i] = d0 + c < d_in ? to_f(x[(row0 + r) * d_in + d0 + c]) : 0.0f;
  }
}

// Rows row0 .. row0 + len - 1 of a (rows, n) operand into s[steps][kMaxN].
template <int kThreads>
__device__ __forceinline__ void stage_state(float* s, const float* __restrict__ x, int64_t row0,
                                            int len, int n, int tid) {
  const float* src = x + row0 * n;
  for (int i = tid; i < len * n; i += kThreads) {
    const int r = i / n;
    s[r * kMaxN + (i - r * n)] = src[i];
  }
}

template <typename TU, int P>
__global__ void __launch_bounds__(Tile<P>::kThreads)
    ssm_fwd_kernel(const float* __restrict__ dt, const TU* __restrict__ u,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ Dv,
                   float* __restrict__ y, float* __restrict__ ckpt, int S, int d_in, int n, int Q,
                   int n_dblk, int scan_bf16) {
  constexpr int kD = Tile<P>::kD, kThreads = Tile<P>::kThreads, kT = kFwdSteps;
  __shared__ float s_dt[kT * kD], s_u[kT * kD], s_y[kT * kD];
  __shared__ float s_B[kT * kMaxN], s_C[kT * kMaxN];
  const int tid = threadIdx.x, dl = tid / P, ni = tid - dl * P;
  const int bi = blockIdx.x / n_dblk;
  const int d0 = (blockIdx.x - bi * n_dblk) * kD, d = d0 + dl;
  const bool dvalid = d < d_in, valid = dvalid && ni < n;
  const float Av = valid ? A[(int64_t)d * n + ni] : 0.0f;
  const float Dd = dvalid ? Dv[d] : 0.0f;
  const int n_ck = (S + Q - 1) / Q;
  const int64_t row0 = (int64_t)bi * S;
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int len = min(kT, S - t0);
    __syncthreads();  // the previous tile's reads of the stages and of s_y are done
    stage_cols<kD, kThreads>(s_dt, dt, row0 + t0, len, d0, d_in, tid);
    stage_cols<kD, kThreads>(s_u, u, row0 + t0, len, d0, d_in, tid);
    stage_state<kThreads>(s_B, Bm, row0 + t0, len, n, tid);
    stage_state<kThreads>(s_C, Cm, row0 + t0, len, n, tid);
    __syncthreads();
    for (int r = 0; r < len; ++r) {
      const int t = t0 + r;
      if (valid && t % Q == 0) ckpt[(((int64_t)bi * n_ck + t / Q) * d_in + d) * n + ni] = h;
      const float dtv = s_dt[r * kD + dl], uv = s_u[r * kD + dl];
      float s = 0.0f;
      if (valid) {
        float a = expf(dtv * Av);
        float bx = (dtv * uv) * s_B[r * kMaxN + ni];
        if (scan_bf16) {
          a = round_bf16(a);
          bx = round_bf16(bx);
        }
        h = a * h + bx;
        s = h * s_C[r * kMaxN + ni];
      }
      s = group_sum<P>(s);
      if (ni == 0) s_y[r * kD + dl] = s + Dd * uv;
    }
    __syncthreads();
    for (int i = tid; i < len * kD; i += kThreads) {
      const int r = i / kD, c = i - r * kD;
      if (d0 + c < d_in) y[(row0 + t0 + r) * d_in + d0 + c] = s_y[i];
    }
  }
}

template <int P>
constexpr int bwd_smem_bytes() {
  constexpr int kD = Tile<P>::kD, kThreads = Tile<P>::kThreads, kT = kBwdSteps;
  return (int)sizeof(float) *
         (2 * kT * kThreads + kMaxSub * kThreads + 5 * kT * kD + 2 * kT * kMaxN);
}

template <typename TU, int P>
__global__ void __launch_bounds__(Tile<P>::kThreads)
    ssm_bwd_kernel(const float* __restrict__ dt, const TU* __restrict__ u,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ Dv,
                   const float* __restrict__ gy, const float* __restrict__ ckpt,
                   float* __restrict__ ddt, float* __restrict__ du, float* __restrict__ partB,
                   float* __restrict__ partC, float* __restrict__ partA,
                   float* __restrict__ partD, int Bn, int S, int d_in, int n, int Q, int n_dblk,
                   int scan_bf16) {
  constexpr int kD = Tile<P>::kD, kThreads = Tile<P>::kThreads, kT = kBwdSteps;
  extern __shared__ float smem[];
  float* s_h = smem;                       // [kT][kThreads]: h_t, then the dC terms
  float* s_a = s_h + kT * kThreads;        // [kT][kThreads]: float32 a_t, then the dB terms
  float* s_sub = s_a + kT * kThreads;      // [kMaxSub][kThreads]: h ahead of each sub-span
  float* s_dt = s_sub + kMaxSub * kThreads;  // [kT][kD] each
  float* s_u = s_dt + kT * kD;
  float* s_g = s_u + kT * kD;
  float* s_ddt = s_g + kT * kD;
  float* s_du = s_ddt + kT * kD;
  float* s_B = s_du + kT * kD;             // [kT][kMaxN] each
  float* s_C = s_B + kT * kMaxN;
  const int tid = threadIdx.x, dl = tid / P, ni = tid - dl * P;
  const int bi = blockIdx.x / n_dblk, blk_d = blockIdx.x - bi * n_dblk;
  const int d0 = blk_d * kD, d = d0 + dl;
  const bool dvalid = d < d_in, valid = dvalid && ni < n;
  const float Av = valid ? A[(int64_t)d * n + ni] : 0.0f;
  const float Dd = dvalid ? Dv[d] : 0.0f;
  const int n_ck = (S + Q - 1) / Q;
  const int64_t row0 = (int64_t)bi * S;
  float lam = 0.0f, a_next = 0.0f, accA = 0.0f, accD = 0.0f;
  bool top = true;  // the next step walked is t = S - 1
  for (int k = n_ck - 1; k >= 0; --k) {
    const int s0 = k * Q, slen = min(Q, S - s0), nsub = (slen + kT - 1) / kT;
    // the span forward from its checkpoint: h ahead of every sub-span
    float h = valid ? ckpt[(((int64_t)bi * n_ck + k) * d_in + d) * n + ni] : 0.0f;
    for (int j = 0; j < nsub; ++j) {
      s_sub[j * kThreads + tid] = h;
      if (j == nsub - 1) break;
      const int t0 = s0 + j * kT;  // a whole sub-span: kT steps
      __syncthreads();
      stage_cols<kD, kThreads>(s_dt, dt, row0 + t0, kT, d0, d_in, tid);
      stage_cols<kD, kThreads>(s_u, u, row0 + t0, kT, d0, d_in, tid);
      stage_state<kThreads>(s_B, Bm, row0 + t0, kT, n, tid);
      __syncthreads();
      if (valid) {
        for (int r = 0; r < kT; ++r) {
          const float dtv = s_dt[r * kD + dl];
          float a = expf(dtv * Av);
          float bx = (dtv * s_u[r * kD + dl]) * s_B[r * kMaxN + ni];
          if (scan_bf16) {
            a = round_bf16(a);
            bx = round_bf16(bx);
          }
          h = a * h + bx;
        }
      }
    }
    // the sub-spans, last first: rebuild h and a, then walk back
    for (int j = nsub - 1; j >= 0; --j) {
      const int t0 = s0 + j * kT, len = min(kT, s0 + slen - t0);
      __syncthreads();  // the previous sub-span's partial sums and stores are done
      stage_cols<kD, kThreads>(s_dt, dt, row0 + t0, len, d0, d_in, tid);
      stage_cols<kD, kThreads>(s_u, u, row0 + t0, len, d0, d_in, tid);
      stage_cols<kD, kThreads>(s_g, gy, row0 + t0, len, d0, d_in, tid);
      stage_state<kThreads>(s_B, Bm, row0 + t0, len, n, tid);
      stage_state<kThreads>(s_C, Cm, row0 + t0, len, n, tid);
      __syncthreads();
      float hv = s_sub[j * kThreads + tid];
      for (int r = 0; r < len; ++r) {
        float a32 = 0.0f;
        if (valid) {
          const float dtv = s_dt[r * kD + dl];
          a32 = expf(dtv * Av);
          float a = a32;
          float bx = (dtv * s_u[r * kD + dl]) * s_B[r * kMaxN + ni];
          if (scan_bf16) {
            a = round_bf16(a);
            bx = round_bf16(bx);
          }
          hv = a * hv + bx;
        }
        s_h[r * kThreads + tid] = hv;
        s_a[r * kThreads + tid] = a32;
      }
      for (int r = len - 1; r >= 0; --r) {
        const float dtv = s_dt[r * kD + dl], uv = s_u[r * kD + dl], gv = s_g[r * kD + dl];
        float tA = 0.0f, tB = 0.0f, cB = 0.0f, cC = 0.0f;
        if (valid) {
          const float ht = s_h[r * kThreads + tid];
          const float hp = r ? s_h[(r - 1) * kThreads + tid] : s_sub[j * kThreads + tid];
          const float a32 = s_a[r * kThreads + tid];
          const float dh = gv * s_C[r * kMaxN + ni];
          lam = top ? dh : dh + a_next * lam;
          float da = lam * hp, dbx = lam;
          if (scan_bf16) {
            da = round_bf16(da);
            dbx = round_bf16(dbx);
          }
          const float dp = da * a32;
          accA = accA + dp * dtv;
          tA = dp * Av;
          tB = dbx * s_B[r * kMaxN + ni];
          cB = dbx * (dtv * uv);
          cC = gv * ht;
          a_next = scan_bf16 ? round_bf16(a32) : a32;
        }
        top = false;
        tA = group_sum<P>(tA);
        tB = group_sum<P>(tB);
        if (ni == 0) {
          s_ddt[r * kD + dl] = tA + tB * uv;
          s_du[r * kD + dl] = tB * dtv + gv * Dd;
          accD = accD + gv * uv;
        }
        // h_t and a_t are read for the last time at this step (the step below reads h_{t-2})
        s_h[r * kThreads + tid] = cC;
        s_a[r * kThreads + tid] = cB;
      }
      __syncthreads();
      // dB and dC of this block's channels: each (step, i) sums its kD terms in channel order
      for (int i = tid; i < len * n; i += kThreads) {
        const int r = i / n, c = i - r * n;
        const float* tb = s_a + r * kThreads + c;
        const float* tc = s_h + r * kThreads + c;
        float sb = tb[0], sc = tc[0];
        for (int q = 1; q < kD; ++q) {
          sb = sb + tb[q * P];
          sc = sc + tc[q * P];
        }
        const int64_t o = (((int64_t)blk_d * Bn + bi) * S + t0 + r) * n + c;
        partB[o] = sb;
        partC[o] = sc;
      }
      for (int i = tid; i < len * kD; i += kThreads) {
        const int r = i / kD, c = i - r * kD;
        if (d0 + c < d_in) {
          const int64_t o = (row0 + t0 + r) * d_in + d0 + c;
          ddt[o] = s_ddt[i];
          du[o] = s_du[i];
        }
      }
    }
  }
  if (valid) partA[((int64_t)bi * d_in + d) * n + ni] = accA;
  if (ni == 0 && dvalid) partD[(int64_t)bi * d_in + d] = accD;
}

// out[m] = part[0][m] + part[1][m] + ... + part[K-1][m], in that order.
__global__ void ssm_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int K,
                                  int64_t M) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = part[i];
  for (int k = 1; k < K; ++k) s = s + part[(int64_t)k * M + i];
  out[i] = s;
}

int reduce_in_order(const float* part, float* out, int64_t K, int64_t M, cudaStream_t s) {
  if (M == 0) return 0;
  ssm_reduce_kernel<<<(unsigned int)((M + 255) / 256), 256, 0, s>>>(part, out, (int)K, M);
  return (int)cudaGetLastError();
}

template <int P>
int64_t dblocks(int64_t d_in) {
  return (d_in + Tile<P>::kD - 1) / Tile<P>::kD;
}

int lanes_for(int64_t n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

template <typename TU, int P>
int fwd_launch(const float* dt, const TU* u, const float* Bm, const float* Cm, const float* A,
               const float* Dv, float* y, float* ckpt, int64_t Bn, int64_t S, int64_t d_in,
               int64_t n, int64_t Q, int scan_bf16, cudaStream_t s) {
  const int64_t n_dblk = dblocks<P>(d_in);
  ssm_fwd_kernel<TU, P><<<(unsigned int)(Bn * n_dblk), Tile<P>::kThreads, 0, s>>>(
      dt, u, Bm, Cm, A, Dv, y, ckpt, (int)S, (int)d_in, (int)n, (int)Q, (int)n_dblk, scan_bf16);
  return (int)cudaGetLastError();
}

template <typename TU, int P>
int bwd_launch(const float* dt, const TU* u, const float* Bm, const float* Cm, const float* A,
               const float* Dv, const float* gy, const float* ckpt, float* ddt, float* du,
               float* dB, float* dC, float* dA, float* dD, float* scratch, int64_t Bn, int64_t S,
               int64_t d_in, int64_t n, int64_t Q, int scan_bf16, cudaStream_t s) {
  const int64_t n_dblk = dblocks<P>(d_in);
  const int64_t mB = Bn * S * n;
  float* partB = scratch;
  float* partC = partB + n_dblk * mB;
  float* partA = partC + n_dblk * mB;
  float* partD = partA + Bn * d_in * n;
  constexpr int smem = bwd_smem_bytes<P>();
  cudaError_t e = cudaFuncSetAttribute(ssm_bwd_kernel<TU, P>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssm_bwd_kernel<TU, P><<<(unsigned int)(Bn * n_dblk), Tile<P>::kThreads, smem, s>>>(
      dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, partB, partC, partA, partD, (int)Bn, (int)S,
      (int)d_in, (int)n, (int)Q, (int)n_dblk, scan_bf16);
  int r = (int)cudaGetLastError();
  if (r == 0) r = reduce_in_order(partB, dB, n_dblk, mB, s);
  if (r == 0) r = reduce_in_order(partC, dC, n_dblk, mB, s);
  if (r == 0) r = reduce_in_order(partA, dA, Bn, d_in * n, s);
  if (r == 0) r = reduce_in_order(partD, dD, Bn, d_in, s);
  return r;
}

template <typename TU>
int fwd_by_lanes(const float* dt, const void* u, const float* Bm, const float* Cm,
                 const float* A, const float* Dv, float* y, float* ckpt, int64_t Bn, int64_t S,
                 int64_t d_in, int64_t n, int64_t Q, int scan_bf16, cudaStream_t s) {
  const TU* uu = (const TU*)u;
  switch (lanes_for(n)) {
#define REPRO_SSM_FWD(P) \
  case P:                \
    return fwd_launch<TU, P>(dt, uu, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n, Q, scan_bf16, s);
    REPRO_SSM_FWD(1)
    REPRO_SSM_FWD(2)
    REPRO_SSM_FWD(4)
    REPRO_SSM_FWD(8)
    REPRO_SSM_FWD(16)
    REPRO_SSM_FWD(32)
#undef REPRO_SSM_FWD
  }
  return -1;
}

template <typename TU>
int bwd_by_lanes(const float* dt, const void* u, const float* Bm, const float* Cm,
                 const float* A, const float* Dv, const float* gy, const float* ckpt, float* ddt,
                 float* du, float* dB, float* dC, float* dA, float* dD, float* scratch,
                 int64_t Bn, int64_t S, int64_t d_in, int64_t n, int64_t Q, int scan_bf16,
                 cudaStream_t s) {
  const TU* uu = (const TU*)u;
  switch (lanes_for(n)) {
#define REPRO_SSM_BWD(P)                                                                     \
  case P:                                                                                   \
    return bwd_launch<TU, P>(dt, uu, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB, dC, dA, dD,       \
                             scratch, Bn, S, d_in, n, Q, scan_bf16, s);
    REPRO_SSM_BWD(1)
    REPRO_SSM_BWD(2)
    REPRO_SSM_BWD(4)
    REPRO_SSM_BWD(8)
    REPRO_SSM_BWD(16)
    REPRO_SSM_BWD(32)
#undef REPRO_SSM_BWD
  }
  return -1;
}

bool shape_ok(int64_t Bn, int64_t S, int64_t d_in, int64_t n, int64_t Q) {
  return Bn >= 1 && S >= 1 && d_in >= 1 && n >= 1 && n <= kMaxN && Q >= 1 && Q <= kMaxChunk &&
         S < (1ll << 31) && d_in < (1ll << 31);
}

}  // namespace

// The channels d of a block at state n: the plain version sums dB and dC over d in blocks of
// this many channels, as the kernel does.
extern "C" int repro_ssm_scan_block_channels(int64_t n) {
  switch (lanes_for(n)) {
    case 1: return Tile<1>::kD;
    case 2: return Tile<2>::kD;
    case 4: return Tile<4>::kD;
    case 8: return Tile<8>::kD;
    case 16: return Tile<16>::kD;
    case 32: return Tile<32>::kD;
  }
  return -1;
}

// Floats of the backward's scratch: the per-block partial sums of dB, dC, dA and dD.
extern "C" int64_t repro_ssm_scan_scratch(int64_t Bn, int64_t S, int64_t d_in, int64_t n) {
  const int64_t kd = repro_ssm_scan_block_channels(n);
  if (kd <= 0) return -1;
  const int64_t n_dblk = (d_in + kd - 1) / kd;
  return 2 * n_dblk * Bn * S * n + Bn * d_in * n + Bn * d_in;
}

// u_dtype: 0 float32, 1 bfloat16; scan_bf16: 1 rounds a and bx to bfloat16.  dt, gy, y, ddt, du
// are contiguous (B, S, d_in) float32, u (B, S, d_in) of u_dtype, B and C (B, S, n) float32, A
// (d_in, n), D (d_in,), ckpt (B, ceil(S / Q), d_in, n) float32; 1 <= n <= 32, 1 <= Q <= 128.
// Returns the launches' cudaGetLastError() (0 = launched), or -1 for arguments out of range.
extern "C" int repro_ssm_scan_fwd(const float* dt, const void* u, const float* Bm,
                                  const float* Cm, const float* A, const float* Dv, float* y,
                                  float* ckpt, int64_t Bn, int64_t S, int64_t d_in, int64_t n,
                                  int64_t Q, int u_dtype, int scan_bf16, void* stream) {
  if (!shape_ok(Bn, S, d_in, n, Q)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (u_dtype) {
    case 0:
      return fwd_by_lanes<float>(dt, u, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n, Q, scan_bf16, s);
    case 1:
      return fwd_by_lanes<__nv_bfloat16>(dt, u, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n, Q,
                                         scan_bf16, s);
  }
  return -1;
}

// As the forward; dB, dC (B, S, n), dA (d_in, n), dD (d_in,) float32, and scratch of
// repro_ssm_scan_scratch floats.
extern "C" int repro_ssm_scan_bwd(const float* dt, const void* u, const float* Bm,
                                  const float* Cm, const float* A, const float* Dv,
                                  const float* gy, const float* ckpt, float* ddt, float* du,
                                  float* dB, float* dC, float* dA, float* dD, float* scratch,
                                  int64_t Bn, int64_t S, int64_t d_in, int64_t n, int64_t Q,
                                  int u_dtype, int scan_bf16, void* stream) {
  if (!shape_ok(Bn, S, d_in, n, Q)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (u_dtype) {
    case 0:
      return bwd_by_lanes<float>(dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB, dC, dA, dD,
                                 scratch, Bn, S, d_in, n, Q, scan_bf16, s);
    case 1:
      return bwd_by_lanes<__nv_bfloat16>(dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB, dC, dA,
                                         dD, scratch, Bn, S, d_in, n, Q, scan_bf16, s);
  }
  return -1;
}

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
// --use_fast_math).  The sum over i is one fixed tree, the halving tree of the plain version
// (kernels/lru_scan/ref.py lane_tree_sum): zero-padded to P = 2^ceil(log2 n) states, then
// s[..., :P/2] + s[..., P/2:], then :P/4, ...
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
// Bound at the trainer's shape (B 2, S 512, d_in 8192, n 16; 134,217,728 state entries): the
// forward takes one expf an entry, 32 us at the MUFU's 16 a clock an SM (132 SMs, 1.98 GHz),
// above its 84.6 MB of dt, u and y (25 us at 3.35 TB/s).  The backward's 18 separately rounded
// float operations an entry (no FMA under --fmad=false: 128 a clock an SM, 33.4e12/s) take
// 74 us, above its 152.4 MB (45 us): operations bound both.
//
// Design.  A lane group of G lanes walks one channel (b, d) in time order, lane l holding the
// K = P / G states l, l + G, l + 2G, ... in registers, so every result is the plain version's,
// rounded the same way (no chunk-parallel scan: it re-associates the recurrence).  With states
// strided so, the halving tree's first log2 K levels pair registers of one lane (s[k] +
// s[k + K/2], ...) and only its last log2 G levels pair lanes: the plain version's tree, bit
// for bit.  The plan (ssm_plan in kernel.py) takes K = min(P, 4), G = P / K: at n 16 four
// lanes of four states, two lane levels in place of four.  A block holds kD = 64 channels of
// one batch row (64 G threads).  Each lane reads dt_t and u_t once a step for its K states
// and forms q = dt u once; B and C are staged with a lane's K states side by side, one 16-byte
// shared load for K 4.  When n is a power of two no state is padded and the sums take no
// selects.
//
// Tiles of time (32 steps forward, 8 backward; compile-time lengths, the steps unrolled, a
// ragged last tile on its own path) pass through a double-buffered ring in shared memory: a
// thread issues its global loads of the next tile into registers before it scans this one and
// stores them to the other buffer after it, so the loads are in flight during the scan.
//
// The forward takes y's lane levels as xor shuffles, stages y in shared memory and writes a
// tile's rows coalesced after it (one barrier a tile).  It stores h ahead of every 8-step
// sub-span as a float32 checkpoint, (B, ceil(S/8), d_in, P) in the lanes' state order: 67 MB at
// the trainer's shape where the state is 537 MB.
//
// The backward takes the sub-spans from the last.  From its checkpoint it rebuilds the
// sub-span's float32 a in registers (one expf an entry in all) and h, in registers under a
// float32 scan and in shared memory under a bf16 one (whose roundings need the registers),
// then walks it in reverse.  The lanes store their levels of ddt's and du's trees; after the
// walk the block takes the lane levels in the same pairs and writes ddt and du coalesced.  dB
// and dC: each (step, state) sums the block's channels in 4 groups of 16, each in channel
// order, then the halving tree over the groups (xor shuffles over 4 adjacent lanes); per-block
// partial sums; one second launch (ssm_reduce_kernel) adds them across blocks in order.  dA
// and dD are register sums over t, then over b in order.  No atomics: the same bits on every
// run.  Two barriers a sub-span.  Offsets are 64-bit.
//
// Instantiations (G, K): (1,1) (1,2) (1,4) (2,4) (4,4) (8,4) for n in 1, 2, 3-4, 5-8, 9-16,
// 17-32, one for each P; the C launcher tallies the launches of each.
//
// Measured: see PERF.md (chip_smoke.py phases 14a / 14b).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxN = 32;       // largest state n (one warp of lanes)
constexpr int kD = 64;          // channels d of a block
constexpr int kSub = 8;         // steps between checkpoints: the backward's sub-span
constexpr int kFwdSteps = 32;   // steps of a forward tile
constexpr int kGroups = 4;      // groups of channels in a block's dB / dC sums
constexpr int kGroupPad = 8;    // floats after each group's terms in shared memory

template <int G, int K>
struct Lanes {
  static constexpr int P = G * K;
  static constexpr int kThreads = kD * G;
  static constexpr int kLogG = G == 1 ? 0 : G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : G == 16 ? 4 : 5;
  static constexpr int kLogK = K == 1 ? 0 : K == 2 ? 1 : K == 4 ? 2 : K == 8 ? 3 : K == 16 ? 4 : 5;
  // the backward keeps a sub-span's a (and h under a float32 scan) in registers, at most 128
  // a thread where 512 threads share an SM, so that the trainer's blocks run in one wave
  static constexpr int kBwdMinBlocks = 512 / kThreads;
  // a step's dB (dC) terms in shared memory, [channel][state] with 8 floats after every group
  // of 16 channels (so that the 4 groups' reads in the reduction fall on distinct banks) and
  // P after the step
  static constexpr int kStride = kD * P + kGroups * kGroupPad + P;
};

__device__ __forceinline__ float widen(float x) { return x; }
// a bfloat16's bits, widened exactly as __bfloat162float does
__device__ __forceinline__ float widen(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}
// x rounded to bfloat16 and widened back, in one instruction: the pair conversion puts
// bf16(x) in the upper half and bf16(0) = 0 in the lower, which read as a float is the widened
// value (as __bfloat162float(__float2bfloat16_rn(x)), NaN to a NaN)
__device__ __forceinline__ float round_bf16(float x) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x), "f"(0.0f));
  return __uint_as_float(r);
}
template <bool kBf16>
__device__ __forceinline__ float to_scan(float x) {
  return kBf16 ? round_bf16(x) : x;
}
// K consecutive floats (16-byte aligned for K % 4 == 0, 8-byte for K 2).
template <int K>
__device__ __forceinline__ void load_k(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z, v[4 * q + 3] = x.w;
    }
  } else if constexpr (K == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The halving tree over K values in place, s[k] + s[k + K/2], then s[k] + s[k + K/4], ...;
// returns the sum.
template <int K>
__device__ __forceinline__ float halving_sum(float (&s)[K]) {
#pragma unroll
  for (int lv = 1; lv <= Lanes<1, K>::kLogK; ++lv) {
#pragma unroll
    for (int k = 0; k < (K >> lv); ++k) s[k] = s[k] + s[k + (K >> lv)];
  }
  return s[0];
}

// The sum over a channel's P states, lane l of the group holding states l + k G in s[k]: the
// plain version's halving tree, its pairs (j, j + half) for half = P/2 .. G lying in one
// lane's registers (k, k + half / G), those for half = G/2 .. 1 across lanes l and l ^ half.
// After a shuffle level both lanes hold the same bits (IEEE addition commutes).
template <int G, int K>
__device__ __forceinline__ float group_sum(float (&s)[K]) {
  float v = halving_sum<K>(s);
#pragma unroll
  for (int lv = 1; lv <= Lanes<G, K>::kLogG; ++lv)
    v = v + __shfl_xor_sync(0xffffffffu, v, G >> lv);
  return v;
}

// A thread's share of a tile of kT steps x kD channels of a (rows, d_in) operand, held in
// registers from its global loads until stored to shared memory as float (entries past the
// operand as 0): issued before a tile's scan and stored after it, the loads of the next tile
// are in flight while this one is scanned.  T is float or a bfloat16's bits.
template <int kT, int kThreads, typename T>
struct ColShare {
  static constexpr int kE = kT * kD, kN = (kE + kThreads - 1) / kThreads;
  T v[kN];
  __device__ __forceinline__ void load(const T* __restrict__ x, int64_t row0, int len, int d0,
                                       int d_in, int tid) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = tid + j * kThreads, r = e / kD, c = e - r * kD;
      v[j] = (e < kE && r < len && d0 + c < d_in) ? x[(row0 + r) * d_in + d0 + c] : T(0);
    }
  }
  __device__ __forceinline__ void store(float* s, int tid) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = tid + j * kThreads;
      if (kE % kThreads == 0 || e < kE) s[e] = widen(v[j]);
    }
  }
};

// The same for a tile of kT steps of a (rows, n) operand (B or C), stored as s[step][p] with
// p = l K + k holding state i = l + k G (0 past n): a lane's K states side by side.
template <int kT, int kThreads, int G, int K>
struct StateShare {
  static constexpr int P = G * K, kE = kT * P, kN = (kE + kThreads - 1) / kThreads;
  float v[kN];
  __device__ __forceinline__ void load(const float* __restrict__ x, int64_t row0, int len, int n,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = tid + j * kThreads, r = e / P, p = e - r * P;
      const int i = p / K + (p % K) * G;
      v[j] = (e < kE && r < len && i < n) ? x[(row0 + r) * n + i] : 0.0f;
    }
  }
  __device__ __forceinline__ void store(float* s, int tid) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = tid + j * kThreads;
      if (kE % kThreads == 0 || e < kE) s[e] = v[j];
    }
  }
};

template <int G, int K>
__host__ __device__ constexpr int fwd_stage_floats() {
  return 3 * kFwdSteps * kD + 2 * kFwdSteps * Lanes<G, K>::P;  // dt, u, y [kT][kD]; B, C
}

// Steps r0 .. r0 + kSub - 1 of a forward tile (those below len unless kFull), y_t into
// s_y[step][channel] by the group's lane 0.  Under kPad (n < P) the padded states add 0.
template <int G, int K, bool kBf16, bool kFull, bool kPad>
__device__ __forceinline__ void fwd_sub_span(float (&h)[K], const float (&Ak)[K],
                                             const bool (&pad)[K], float Dd,
                                             const float* s_dt, const float* s_u,
                                             const float* s_B, const float* s_C, float* s_y,
                                             int r0, int len, int dl, int l) {
  constexpr int P = G * K;
#pragma unroll
  for (int r = 0; r < kSub; ++r) {
    if (!kFull && r >= len) break;
    const int rr = r0 + r;
    const float dtv = s_dt[rr * kD + dl], uv = s_u[rr * kD + dl], q = dtv * uv;
    float Bv[K], Cv[K], s[K];
    load_k<K>(Bv, s_B + rr * P + l * K);
    load_k<K>(Cv, s_C + rr * P + l * K);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float a = to_scan<kBf16>(expf(dtv * Ak[k]));
      const float bx = to_scan<kBf16>(q * Bv[k]);
      h[k] = a * h[k] + bx;
      s[k] = kPad && pad[k] ? 0.0f : h[k] * Cv[k];
    }
    const float v = group_sum<G, K>(s);
    if (l == 0) s_y[rr * kD + dl] = v + Dd * uv;
  }
}

// Rows 0 .. len - 1 of a staged [steps][kD] tile out to rows row0 .. of a (rows, d_in) array,
// the block's nvalid channels from d0: one coalesced row segment a step.
template <int kThreads>
__device__ __forceinline__ void write_rows(float* __restrict__ x, const float* s, int64_t row0,
                                           int len, int d0, int d_in, int nvalid, int tid) {
  for (int e = tid; e < len * kD; e += kThreads) {
    const int r = e / kD, c = e - r * kD;
    if (c < nvalid) x[(row0 + r) * d_in + d0 + c] = s[e];
  }
}

template <typename TU, int G, int K, bool kBf16>
__global__ void __launch_bounds__(Lanes<G, K>::kThreads)
    ssm_fwd_kernel(const float* __restrict__ dt, const TU* __restrict__ u,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ Dv,
                   float* __restrict__ y, float* __restrict__ ckpt, int S, int d_in, int n,
                   int n_dblk) {
  using L = Lanes<G, K>;
  constexpr int P = L::P, kThreads = L::kThreads, kT = kFwdSteps;
  constexpr int kStage = fwd_stage_floats<G, K>();
  extern __shared__ float4 smem_v[];
  float* smem = reinterpret_cast<float*>(smem_v);
  const int tid = threadIdx.x, dl = tid / G, l = tid - dl * G;
  const int bi = blockIdx.x / n_dblk, d0 = (blockIdx.x - bi * n_dblk) * kD, d = d0 + dl;
  const bool dvalid = d < d_in, padded = n < P;
  const int nvalid = min(kD, d_in - d0);
  float Ak[K], h[K];
  bool pad[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = l + k * G;
    pad[k] = i >= n;
    Ak[k] = dvalid && i < n ? A[(int64_t)d * n + i] : 0.0f;
    h[k] = 0.0f;
  }
  const float Dd = dvalid ? Dv[d] : 0.0f;
  const int n_ck = (S + kSub - 1) / kSub, n_tiles = (S + kT - 1) / kT;
  const int64_t row0 = (int64_t)bi * S;
  // checkpoint c of this lane's states: ck + c d_in P
  float* ck = ckpt + ((int64_t)bi * n_ck * d_in + d) * P + l * K;
  ColShare<kT, kThreads, float> p_dt;
  ColShare<kT, kThreads, TU> p_u;
  StateShare<kT, kThreads, G, K> p_B, p_C;
  auto fetch = [&](int t0) {
    const int len = min(kT, S - t0);
    p_dt.load(dt, row0 + t0, len, d0, d_in, tid);
    p_u.load(u, row0 + t0, len, d0, d_in, tid);
    p_B.load(Bm, row0 + t0, len, n, tid);
    p_C.load(Cm, row0 + t0, len, n, tid);
  };
  auto put = [&](float* b) {
    p_dt.store(b, tid);
    p_u.store(b + kT * kD, tid);
    p_B.store(b + 3 * kT * kD, tid);
    p_C.store(b + 3 * kT * kD + kT * P, tid);
  };
  fetch(0);
  put(smem);
  __syncthreads();
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kT, len = min(kT, S - t0);
    if (j + 1 < n_tiles) fetch(t0 + kT);
    float* b = smem + (j & 1) * kStage;
    const float *s_dt = b, *s_u = b + kT * kD, *s_B = b + 3 * kT * kD, *s_C = s_B + kT * P;
    float* s_y = b + 2 * kT * kD;
    if (j > 0)  // the previous tile's y, from the other stage
      write_rows<kThreads>(y, smem + ((j - 1) & 1) * kStage + 2 * kT * kD, row0 + t0 - kT, kT,
                           d0, d_in, nvalid, tid);
#pragma unroll 1
    for (int g = 0; g < len; g += kSub) {
      if (dvalid) store_k<K>(ck + (int64_t)((t0 + g) / kSub) * d_in * P, h);
      if (g + kSub <= len) {
        if (padded)
          fwd_sub_span<G, K, kBf16, true, true>(h, Ak, pad, Dd, s_dt, s_u, s_B, s_C, s_y, g,
                                                kSub, dl, l);
        else
          fwd_sub_span<G, K, kBf16, true, false>(h, Ak, pad, Dd, s_dt, s_u, s_B, s_C, s_y, g,
                                                 kSub, dl, l);
      } else {
        fwd_sub_span<G, K, kBf16, false, true>(h, Ak, pad, Dd, s_dt, s_u, s_B, s_C, s_y, g,
                                               len - g, dl, l);
      }
    }
    if (j + 1 < n_tiles) put(smem + ((j + 1) & 1) * kStage);
    __syncthreads();  // this tile's reads and y are done; the next one's stores are visible
  }
  const int t0 = (n_tiles - 1) * kT;
  write_rows<kThreads>(y, smem + ((n_tiles - 1) & 1) * kStage + 2 * kT * kD, row0 + t0,
                       S - t0, d0, d_in, nvalid, tid);
}

template <int G, int K>
__host__ __device__ constexpr int bwd_stage_floats() {
  return 3 * kSub * kD + 2 * kSub * Lanes<G, K>::P;  // dt, u, gy [kSub][kD]; B, C [kSub][P]
}

template <int G, int K>
__host__ __device__ constexpr int bwd_smem_floats() {
  // two stages; the dB and dC terms [2][kSub][kStride]; the lanes' partial sums of ddt's and
  // du's trees [kSub][2][kD][G]; D [kD]
  return 2 * bwd_stage_floats<G, K>() + 2 * kSub * Lanes<G, K>::kStride + 2 * kSub * kD * G +
         kD;
}

// One sub-span of the backward (len steps; kSub unless kFull is false): h and the float32 a
// rebuilt from the checkpoint `head`, then the walk back.  a stays in registers; h too under a
// float32 scan, while under a bf16 scan, whose roundings need registers of their own, h goes
// to the lane's own dC-term slots in shared memory (each slot read back before the step's dC
// term replaces it).  The dB and dC terms of step r go to t_B / t_C + r kStride + dl P +
// (dl / 16) 8 + l K; the lane's levels of the trees of ddt and du (sum_i dp A_i and sum_i dbx
// B_i) to s_t [r][0 / 1][dl][l], whose last log2 G levels the block takes after the walk.
// lam starts at -0 and a_{t+1} at 0, so that the first step's lam = dh + 0 (-0) is dh, bit
// for bit.  Under kPad (n < P) the padded states add 0.
template <int G, int K, bool kBf16, bool kFull, bool kPad>
__device__ __forceinline__ void bwd_sub_span(
    const float (&head)[K], const float (&Ak)[K], const bool (&pad)[K], float (&lam)[K],
    float (&an)[K], float (&accA)[K], float& accD, const float* s_dt, const float* s_u,
    const float* s_g, const float* s_B, const float* s_C, float* t_B, float* t_C, float* s_t,
    int len, int dl, int l) {
  using L = Lanes<G, K>;
  constexpr int P = L::P;
  constexpr int kHs = kBf16 ? 1 : kSub;  // steps of h held in registers
  // this lane's K terms of step r: + r kStride
  const int at = dl * P + dl / (kD / kGroups) * kGroupPad + l * K;
  float as[kSub][K], hs[kHs][K];
  {
    float h[K];
#pragma unroll
    for (int k = 0; k < K; ++k) h[k] = head[k];
#pragma unroll
    for (int r = 0; r < kSub; ++r) {
      if (!kFull && r >= len) break;
      const float dtv = s_dt[r * kD + dl], q = dtv * s_u[r * kD + dl];
      float Bv[K];
      load_k<K>(Bv, s_B + r * P + l * K);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        as[r][k] = expf(dtv * Ak[k]);
        const float bx = to_scan<kBf16>(q * Bv[k]);
        h[k] = to_scan<kBf16>(as[r][k]) * h[k] + bx;
        if constexpr (!kBf16) hs[r][k] = h[k];
      }
      if constexpr (kBf16) store_k<K>(t_C + r * L::kStride + at, h);
    }
  }
  float ht[K];  // h_t of the step walked (bf16 scan)
  if constexpr (kBf16) load_k<K>(ht, t_C + (len - 1) * L::kStride + at);
#pragma unroll
  for (int r = kSub - 1; r >= 0; --r) {
    if (!kFull && r >= len) continue;
    const float dtv = s_dt[r * kD + dl], uv = s_u[r * kD + dl], gv = s_g[r * kD + dl];
    const float q = dtv * uv;
    float Bv[K], Cv[K], hp[K], tA[K], tB[K], cB[K], cC[K];
    load_k<K>(Bv, s_B + r * P + l * K);
    load_k<K>(Cv, s_C + r * P + l * K);
    if (r == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) hp[k] = head[k];
    } else if constexpr (kBf16) {
      load_k<K>(hp, t_C + (r - 1) * L::kStride + at);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) hp[k] = hs[r > 0 ? r - 1 : 0][k];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lam[k] = gv * Cv[k] + an[k] * lam[k];
      const float da = to_scan<kBf16>(lam[k] * hp[k]), dbx = to_scan<kBf16>(lam[k]);
      const float dp = da * as[r][k];
      accA[k] = accA[k] + dp * dtv;
      tA[k] = kPad && pad[k] ? 0.0f : dp * Ak[k];
      tB[k] = kPad && pad[k] ? 0.0f : dbx * Bv[k];
      cB[k] = dbx * q;
      if constexpr (kBf16) {
        cC[k] = gv * ht[k];
        ht[k] = hp[k];
      } else {
        cC[k] = gv * hs[r][k];
      }
      an[k] = to_scan<kBf16>(as[r][k]);
    }
    s_t[(2 * r * kD + dl) * G + l] = halving_sum<K>(tA);
    s_t[((2 * r + 1) * kD + dl) * G + l] = halving_sum<K>(tB);
    accD = accD + gv * uv;
    store_k<K>(t_B + r * L::kStride + at, cB);
    store_k<K>(t_C + r * L::kStride + at, cC);
  }
}

template <typename TU, int G, int K, bool kBf16>
__global__ void __launch_bounds__(Lanes<G, K>::kThreads, Lanes<G, K>::kBwdMinBlocks)
    ssm_bwd_kernel(const float* __restrict__ dt, const TU* __restrict__ u,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ A, const float* __restrict__ Dv,
                   const float* __restrict__ gy, const float* __restrict__ ckpt,
                   float* __restrict__ ddt, float* __restrict__ du, float* __restrict__ partB,
                   float* __restrict__ partC, float* __restrict__ partA,
                   float* __restrict__ partD, int Bn, int S, int d_in, int n, int n_dblk) {
  using L = Lanes<G, K>;
  constexpr int P = L::P, kThreads = L::kThreads, kStage = bwd_stage_floats<G, K>();
  constexpr int V = P < 4 ? P : 4;  // states a thread sums in the dB / dC reduction
  extern __shared__ float4 smem_v[];
  float* smem = reinterpret_cast<float*>(smem_v);
  float* terms = smem + 2 * kStage;                 // [2: dB, dC][kSub][kStride]
  float* s_t = terms + 2 * kSub * L::kStride;       // [kSub][2][kD][G]
  float* s_D = s_t + 2 * kSub * kD * G;             // [kD]
  const int tid = threadIdx.x, dl = tid / G, l = tid - dl * G;
  const int bi = blockIdx.x / n_dblk, blk_d = blockIdx.x - bi * n_dblk;
  const int d0 = blk_d * kD, d = d0 + dl;
  const bool dvalid = d < d_in, padded = n < P;
  const int nvalid = min(kD, d_in - d0);
  float Ak[K], lam[K], an[K], accA[K], head[K], next[K];
  bool pad[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = l + k * G;
    pad[k] = i >= n;
    Ak[k] = dvalid && i < n ? A[(int64_t)d * n + i] : 0.0f;
    lam[k] = -0.0f;
    an[k] = accA[k] = 0.0f;
  }
  float accD = 0.0f;
  const int n_ck = (S + kSub - 1) / kSub;
  const int64_t row0 = (int64_t)bi * S;
  const float* ck = ckpt + ((int64_t)bi * n_ck * d_in + d) * P + l * K;
  ColShare<kSub, kThreads, float> p_dt, p_g;
  ColShare<kSub, kThreads, TU> p_u;
  StateShare<kSub, kThreads, G, K> p_B, p_C;
  auto fetch = [&](int j) {
    const int t0 = j * kSub, len = min(kSub, S - t0);
    p_dt.load(dt, row0 + t0, len, d0, d_in, tid);
    p_u.load(u, row0 + t0, len, d0, d_in, tid);
    p_g.load(gy, row0 + t0, len, d0, d_in, tid);
    p_B.load(Bm, row0 + t0, len, n, tid);
    p_C.load(Cm, row0 + t0, len, n, tid);
    if (dvalid) {
      load_k<K>(next, ck + (int64_t)j * d_in * P);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) next[k] = 0.0f;
    }
  };
  auto put = [&](float* b) {
    p_dt.store(b, tid);
    p_u.store(b + kSub * kD, tid);
    p_g.store(b + 2 * kSub * kD, tid);
    p_B.store(b + 3 * kSub * kD, tid);
    p_C.store(b + 3 * kSub * kD + kSub * P, tid);
  };
  fetch(n_ck - 1);
  put(smem + ((n_ck - 1) & 1) * kStage);
  for (int c = tid; c < kD; c += kThreads) s_D[c] = c < nvalid ? Dv[d0 + c] : 0.0f;
  __syncthreads();
  for (int j = n_ck - 1; j >= 0; --j) {
    const int t0 = j * kSub, len = min(kSub, S - t0);
#pragma unroll
    for (int k = 0; k < K; ++k) head[k] = next[k];
    if (j > 0) fetch(j - 1);
    const float* b = smem + (j & 1) * kStage;
    const float *s_dt = b, *s_u = b + kSub * kD, *s_g = b + 2 * kSub * kD;
    const float *s_B = b + 3 * kSub * kD, *s_C = s_B + kSub * P;
    float *t_B = terms, *t_C = terms + kSub * L::kStride;
    if (len < kSub)
      bwd_sub_span<G, K, kBf16, false, true>(head, Ak, pad, lam, an, accA, accD, s_dt, s_u,
                                             s_g, s_B, s_C, t_B, t_C, s_t, len, dl, l);
    else if (padded)
      bwd_sub_span<G, K, kBf16, true, true>(head, Ak, pad, lam, an, accA, accD, s_dt, s_u,
                                            s_g, s_B, s_C, t_B, t_C, s_t, kSub, dl, l);
    else
      bwd_sub_span<G, K, kBf16, true, false>(head, Ak, pad, lam, an, accA, accD, s_dt, s_u,
                                             s_g, s_B, s_C, t_B, t_C, s_t, kSub, dl, l);
    if (j > 0) put(smem + ((j - 1) & 1) * kStage);
    __syncthreads();  // the terms, ddt and du are written; the next sub-span's stage is stored
    // ddt and du: the last log2 G levels of their trees (the lanes' partial sums in order: the
    // xor levels' pairs), then sa + sb u and sb dt + gy D; one coalesced row segment a step
    for (int e = tid; e < len * kD; e += kThreads) {
      const int r = e / kD, c = e - r * kD;
      if (c >= nvalid) continue;
      float ta[G], tb[G];
      load_k<G>(ta, s_t + (2 * r * kD + c) * G);
      load_k<G>(tb, s_t + ((2 * r + 1) * kD + c) * G);
      const float sa = halving_sum<G>(ta), sb = halving_sum<G>(tb);
      const int64_t o = (row0 + t0 + r) * d_in + d0 + c;
      ddt[o] = sa + sb * s_u[e];
      du[o] = sb * s_dt[e] + s_g[e] * s_D[c];
    }
    // dB and dC of this block's channels: for each (step, state), each of the 4 groups of 16
    // channels summed in channel order (the plain version's zero padding past d_in adding +0
    // once), then the halving tree over the groups, (g0 + g2) + (g1 + g3), by xor shuffles
    // across the 4 adjacent lanes that hold them; V states a lane.  Every warp runs the loop
    // the same number of times (its trip count is a multiple of 32), so the shuffles see
    // whole warps.
    for (int o = tid; o < 2 * kSub * (P / V) * kGroups; o += kThreads) {
      const int g = o % kGroups, item = o / kGroups;
      const int which = item / (kSub * (P / V)), rem = item - which * kSub * (P / V);
      const int r = rem / (P / V), p0 = (rem - r * (P / V)) * V;
      const int c0 = g * (kD / kGroups), c1 = min(c0 + kD / kGroups, nvalid);
      const float* col = terms + (which * kSub + r) * L::kStride + g * kGroupPad + p0;
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.0f;
      if (c0 < c1) {
        load_k<V>(acc, col + c0 * P);
#pragma unroll 4
        for (int c = c0 + 1; c < c1; ++c) {
          float x[V];
          load_k<V>(x, col + c * P);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = acc[v] + x[v];
        }
        if (c1 < c0 + kD / kGroups) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = acc[v] + 0.0f;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[v] = acc[v] + __shfl_xor_sync(0xffffffffu, acc[v], 2);
        acc[v] = acc[v] + __shfl_xor_sync(0xffffffffu, acc[v], 1);
      }
      if (g != 0 || r >= len) continue;
      float* out = (which ? partC : partB) + (((int64_t)blk_d * Bn + bi) * S + t0 + r) * n;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int p = p0 + v, i = p / K + (p % K) * G;
        if (i < n) out[i] = acc[v];
      }
    }
    __syncthreads();  // the terms, ddt and du are read
  }
  if (dvalid) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!pad[k]) partA[((int64_t)bi * d_in + d) * n + l + k * G] = accA[k];
    if (l == 0) partD[(int64_t)bi * d_in + d] = accD;
  }
}

// The sums across blocks: out[m] = part[0][m] + part[1][m] + ... + part[K-1][m], in that order,
// for four arrays (dB, dC over the channel blocks; dA, dD over b) in one launch.
struct InOrder {
  const float* part[4];
  float* out[4];
  int K[4];
  int64_t M[4];
  int64_t first_block[5];  // blocks before each array's
};

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads) ssm_reduce_kernel(InOrder job) {
  int a = 0;
  while (a < 3 && blockIdx.x >= job.first_block[a + 1]) ++a;
  const int64_t i = (blockIdx.x - job.first_block[a]) * kReduceThreads + threadIdx.x;
  const int64_t M = job.M[a];
  if (i >= M) return;
  const float* part = job.part[a];
  float s = part[i];
#pragma unroll 16
  for (int k = 1; k < job.K[a]; ++k) s = s + part[(int64_t)k * M + i];
  job.out[a][i] = s;
}

int lanes_for(int64_t n) {
  int P = 1;
  while (P < n) P <<= 1;
  return P;
}

int64_t dblocks(int64_t d_in) { return (d_in + kD - 1) / kD; }

// The instantiations (G, K), one for each P = 1, 2, 4, .., 32: K = min(P, 4), G = P / K.
constexpr int kRoutes = 6;
constexpr int kRouteG[kRoutes] = {1, 1, 1, 2, 4, 8};
constexpr int kRouteK[kRoutes] = {1, 2, 4, 4, 4, 4};

// The route of state n (the index of log2 P); -1 where n is out of range.
int route_of(int64_t n) {
  if (n < 1 || n > kMaxN) return -1;
  int r = 0;
  while ((1 << r) < n) ++r;
  return r;
}

// Launches by route, counted where each launch succeeds: [0] forward, [1] backward.
std::atomic<int64_t> g_routes[2][kRoutes];

int counted(int dir, int route, int err) {
  if (err == 0) g_routes[dir][route].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// A kernel's dynamic shared memory limit raised to `bytes`, once per device (the call costs
// host time before every launch otherwise).
template <auto Kernel>
int smem_limit(int bytes) {
  static std::atomic<uint64_t> done{0};  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (bit & done.load(std::memory_order_relaxed)) return 0;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return (int)e;
}

template <typename TU, int G, int K, bool kBf16>
int fwd_launch(const float* dt, const TU* u, const float* Bm, const float* Cm, const float* A,
               const float* Dv, float* y, float* ckpt, int64_t Bn, int64_t S, int64_t d_in,
               int64_t n, cudaStream_t s) {
  const int64_t n_dblk = dblocks(d_in);
  constexpr int smem = (int)sizeof(float) * 2 * fwd_stage_floats<G, K>();
  const int e = smem_limit<ssm_fwd_kernel<TU, G, K, kBf16>>(smem);
  if (e != 0) return e;
  ssm_fwd_kernel<TU, G, K, kBf16><<<(unsigned int)(Bn * n_dblk), Lanes<G, K>::kThreads, smem,
                                    s>>>(dt, u, Bm, Cm, A, Dv, y, ckpt, (int)S, (int)d_in,
                                         (int)n, (int)n_dblk);
  return (int)cudaGetLastError();
}

template <typename TU, int G, int K, bool kBf16>
int bwd_launch(const float* dt, const TU* u, const float* Bm, const float* Cm, const float* A,
               const float* Dv, const float* gy, const float* ckpt, float* ddt, float* du,
               float* dB, float* dC, float* dA, float* dD, float* scratch, int64_t Bn, int64_t S,
               int64_t d_in, int64_t n, cudaStream_t s) {
  const int64_t n_dblk = dblocks(d_in);
  const int64_t mB = Bn * S * n;
  float* partB = scratch;
  float* partC = partB + n_dblk * mB;
  float* partA = partC + n_dblk * mB;
  float* partD = partA + Bn * d_in * n;
  constexpr int smem = (int)sizeof(float) * bwd_smem_floats<G, K>();
  const int e = smem_limit<ssm_bwd_kernel<TU, G, K, kBf16>>(smem);
  if (e != 0) return e;
  ssm_bwd_kernel<TU, G, K, kBf16><<<(unsigned int)(Bn * n_dblk), Lanes<G, K>::kThreads, smem,
                                    s>>>(dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, partB, partC,
                                         partA, partD, (int)Bn, (int)S, (int)d_in, (int)n,
                                         (int)n_dblk);
  int r = (int)cudaGetLastError();
  if (r != 0) return r;
  InOrder job = {{partB, partC, partA, partD}, {dB, dC, dA, dD},
                 {(int)n_dblk, (int)n_dblk, (int)Bn, (int)Bn}, {mB, mB, d_in * n, d_in},
                 {0}};
  for (int a = 0; a < 4; ++a)
    job.first_block[a + 1] = job.first_block[a] + (job.M[a] + kReduceThreads - 1) / kReduceThreads;
  ssm_reduce_kernel<<<(unsigned int)job.first_block[4], kReduceThreads, 0, s>>>(job);
  return (int)cudaGetLastError();
}

template <typename TU, bool kBf16>
int fwd_route(int route, const float* dt, const void* u, const float* Bm, const float* Cm,
              const float* A, const float* Dv, float* y, float* ckpt, int64_t Bn, int64_t S,
              int64_t d_in, int64_t n, cudaStream_t s) {
  const TU* uu = (const TU*)u;
  switch (route) {
#define REPRO_SSM_FWD(R, G, K) \
  case R:                      \
    return fwd_launch<TU, G, K, kBf16>(dt, uu, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n, s);
    REPRO_SSM_FWD(0, 1, 1)
    REPRO_SSM_FWD(1, 1, 2)
    REPRO_SSM_FWD(2, 1, 4)
    REPRO_SSM_FWD(3, 2, 4)
    REPRO_SSM_FWD(4, 4, 4)
    REPRO_SSM_FWD(5, 8, 4)
#undef REPRO_SSM_FWD
  }
  return -1;
}

template <typename TU, bool kBf16>
int bwd_route(int route, const float* dt, const void* u, const float* Bm, const float* Cm,
              const float* A, const float* Dv, const float* gy, const float* ckpt, float* ddt,
              float* du, float* dB, float* dC, float* dA, float* dD, float* scratch, int64_t Bn,
              int64_t S, int64_t d_in, int64_t n, cudaStream_t s) {
  const TU* uu = (const TU*)u;
  switch (route) {
#define REPRO_SSM_BWD(R, G, K)                                                              \
  case R:                                                                                   \
    return bwd_launch<TU, G, K, kBf16>(dt, uu, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB, dC, dA, \
                                       dD, scratch, Bn, S, d_in, n, s);
    REPRO_SSM_BWD(0, 1, 1)
    REPRO_SSM_BWD(1, 1, 2)
    REPRO_SSM_BWD(2, 1, 4)
    REPRO_SSM_BWD(3, 2, 4)
    REPRO_SSM_BWD(4, 4, 4)
    REPRO_SSM_BWD(5, 8, 4)
#undef REPRO_SSM_BWD
  }
  return -1;
}

bool shape_ok(int64_t Bn, int64_t S, int64_t d_in, int64_t n) {
  return Bn >= 1 && S >= 1 && d_in >= 1 && n >= 1 && n <= kMaxN && S < (1ll << 31) &&
         d_in < (1ll << 31) && Bn * dblocks(d_in) < (1ll << 31);
}

}  // namespace

// The plan of state n: out = {G, K, channels of a block, threads of a block, route}.  Returns
// 0, or -1 where n is out of range.
extern "C" int repro_ssm_scan_plan(int64_t n, int* out) {
  const int r = route_of(n);
  if (r < 0) return -1;
  out[0] = kRouteG[r];
  out[1] = kRouteK[r];
  out[2] = kD;
  out[3] = kD * kRouteG[r];
  out[4] = r;
  return 0;
}

// The steps between the forward's checkpoints (the checkpoint tensor is (B, ceil(S / this),
// d_in, P)).
extern "C" int repro_ssm_scan_ckpt_steps() { return kSub; }

// out[dir * 6 + route]: launches so far of each instantiation (dir 0 forward, 1 backward;
// routes as repro_ssm_scan_plan numbers them).
extern "C" void repro_ssm_scan_routes(int64_t* out) {
  for (int dir = 0; dir < 2; ++dir)
    for (int r = 0; r < kRoutes; ++r) out[dir * kRoutes + r] = g_routes[dir][r].load();
}

// u_dtype: 0 float32, 1 bfloat16; scan_bf16: 1 rounds a and bx to bfloat16.  dt, gy, y, ddt,
// du are contiguous (B, S, d_in) float32, u (B, S, d_in) of u_dtype, B and C (B, S, n) float32,
// A (d_in, n), D (d_in,), ckpt (B, ceil(S / 8), d_in, P) float32, 16-byte aligned; 1 <= n <=
// 32.  Returns the launches' cudaGetLastError() (0 = launched), or -1 for arguments out of
// range.
extern "C" int repro_ssm_scan_fwd(const float* dt, const void* u, const float* Bm,
                                  const float* Cm, const float* A, const float* Dv, float* y,
                                  float* ckpt, int64_t Bn, int64_t S, int64_t d_in, int64_t n,
                                  int u_dtype, int scan_bf16, void* stream) {
  const int route = route_of(n);
  if (!shape_ok(Bn, S, d_in, n) || route < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int err = -1;
  if (u_dtype == 0 && !scan_bf16)
    err = fwd_route<float, false>(route, dt, u, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n, s);
  else if (u_dtype == 0)
    err = fwd_route<float, true>(route, dt, u, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n, s);
  else if (u_dtype == 1 && !scan_bf16)
    err = fwd_route<unsigned short, false>(route, dt, u, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in,
                                           n, s);
  else if (u_dtype == 1)
    err = fwd_route<unsigned short, true>(route, dt, u, Bm, Cm, A, Dv, y, ckpt, Bn, S, d_in, n,
                                          s);
  return counted(0, route, err);
}

// As the forward; dB, dC (B, S, n), dA (d_in, n), dD (d_in,) float32, and scratch of
// 2 ceil(d_in / 64) B S n + B d_in n + B d_in floats (the partial sums of dB and dC over the
// channel blocks, of dA and dD over b).
extern "C" int repro_ssm_scan_bwd(const float* dt, const void* u, const float* Bm,
                                  const float* Cm, const float* A, const float* Dv,
                                  const float* gy, const float* ckpt, float* ddt, float* du,
                                  float* dB, float* dC, float* dA, float* dD, float* scratch,
                                  int64_t Bn, int64_t S, int64_t d_in, int64_t n, int u_dtype,
                                  int scan_bf16, void* stream) {
  const int route = route_of(n);
  if (!shape_ok(Bn, S, d_in, n) || route < 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int err = -1;
  if (u_dtype == 0 && !scan_bf16)
    err = bwd_route<float, false>(route, dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB, dC, dA,
                                  dD, scratch, Bn, S, d_in, n, s);
  else if (u_dtype == 0)
    err = bwd_route<float, true>(route, dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB, dC, dA,
                                 dD, scratch, Bn, S, d_in, n, s);
  else if (u_dtype == 1 && !scan_bf16)
    err = bwd_route<unsigned short, false>(route, dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB,
                                           dC, dA, dD, scratch, Bn, S, d_in, n, s);
  else if (u_dtype == 1)
    err = bwd_route<unsigned short, true>(route, dt, u, Bm, Cm, A, Dv, gy, ckpt, ddt, du, dB,
                                          dC, dA, dD, scratch, Bn, S, d_in, n, s);
  return counted(1, route, err);
}

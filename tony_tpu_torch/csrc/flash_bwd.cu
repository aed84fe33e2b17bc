// Flash attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces the JAX package's ops/attention.py `_bwd_kernel_resident` (fused
// dQ/dK/dV, whole sequence in VMEM), `_kv_sweep_kernel` (per kv block, sweep
// the q blocks for dK/dV, fused with dQ up to 8192 rows) and `_dq_kernel` (the
// split tier's dQ). The three TPU tiers are one function split by the TPU's
// on-chip memory size; here it is two kernels, because on this card a block
// cannot carry a dQ sum across other blocks without atomics:
//
// - flash_bwd_dq: one CTA per (batch*head, 128-row query tile). Q and dO stay
//   in shared memory; the CTA sweeps the key tiles with the forward's causal
//   and window bounds, the last q tiles (which sweep the most) first, and
//   keeps dQ in float32 registers. It runs first and also writes delta.
// - flash_bwd_dkdv: one CTA per (batch*head, 128-key tile). K, V stay in
//   shared memory; the CTA sweeps the q tiles from the causal diagonal down to
//   the window's upper bound (the TPU kv sweep's bounds) and keeps dK, dV in
//   float32 registers.
//
// No atomics, so dq, dk and dv are the same bits from run to run.
//
// What each tile computes (the TPU package's `_bwd_tile`), with the mask built
// from absolute indices counted from 0 for both Q and K (causal col <= row,
// window col > row - window, ragged col < Lk, and row < Lq):
//   p  = exp(scale * Q K^T - lse)      forced to 0 where masked, by a select
//   dV += p^T dO
//   dp = dO V^T
//   ds = p * (dp - delta)               delta = rowsum(dO * O) - g_lse
//   dK += scale * ds^T Q
//   dQ += scale * ds K
// A row with no visible key has lse = NEG_INF, so exp(s - lse) overflows to
// inf: multiplying by a 0/1 mask would give inf * 0 = NaN, so p is selected.
//
// What bounds it on this card: O(L^2 D) operations against O(L D) bytes, so
// operations on the tensor cores. The split recomputes S and dP in both
// kernels: 14 D flops a visible (q, k) pair against the function's 10 D.
//
// bf16 (the *_wgmma kernels, helpers in hopper.cuh): every product is a
// warpgroup MMA (wgmma m64nNk16, bf16 operands, float32 accumulators), the
// only way to the card's full tensor-core rate. A CTA is three warpgroups:
// two consumers, each owning 64 rows of the CTA's resident tile, and a
// producer whose one thread keeps a 3-stage ring of the swept tiles in
// flight by TMA (4-D tensor maps over the [B, H, L, D] strides, built on the
// host at each call and passed as __grid_constant__ parameters; rows past L
// arrive as zeros). Tiles land swizzled (128-byte spans, 64-byte at D = 32)
// and wgmma reads them in place, K-major or MN-major, so no operand is
// transposed or copied. Full and empty mbarriers hand each stage from the
// producer to the consumers and back; setmaxnreg gives the consumers 240
// registers a thread and the producer 24 (the launch bound is 168: 384
// threads, three warps on each of the SM's four register files). Nothing
// in these kernels may trap: a __trap() in a barrier wait made ptxas drop
// the setmaxnreg budgets, so the consumers ran at 168 registers, spilled
// their accumulators and had their wgmma serialized (ptxas's C7512).
// - dQ: S = Q K^T and dP = dO V^T (64 x 64 each: 64-key tiles, faster than
//   128 on the H100), as two wgmma groups, so P = exp2(S * scale * log2 e -
//   lse * log2 e) is computed while dP's products run; dS = P (dP - delta)
//   in the accumulators, rounded to bf16 in registers, where the
//   accumulator's layout is the A operand's: dQ += dS K with A from
//   registers and K read MN-major. The prologue computes delta =
//   rowsum(dO * O) - g_lse in float32 for the CTA's rows (dO from the
//   resident tile, O, bf16 or float32, read once from global memory), uses
//   it and writes it to a [B, H, Lq] buffer for the dK/dV kernel, launched
//   after it on the stream.
// - dK/dV: the keys are the M dimension. S^T = K Q^T and dP^T = V dO^T put
//   P^T and dS^T in the accumulators; rounded to bf16 they are the A
//   operands of dV += P^T dO (issued while dS^T is computed) and dK += dS^T
//   Q (dO and Q read MN-major). The producer warp also brings each q tile's
//   lse and delta (plain loads, 0 for rows past Lq). At D = 128 a consumer
//   thread holds 128 floats of dK/dV and 64 of S^T/dP^T: the 240 registers.
// The mask is applied only on the tiles at a boundary (the causal diagonal,
// the window's edge, the ragged ends of Lq and Lk); interior tiles take the
// exp2 alone. Outputs are staged as bf16 in the consumer's own rows of its
// resident tile and leave as 16-byte stores of whole rows. PERF.md has each
// kernel's time against its bound and SDPA's, and the variants measured
// slower and dropped: a cp.async producer instead of TMA, 128-key dQ tiles,
// and leaving a tile's dQ, or dV and dK, product running into the next tile
// (ptxas then waited on the accumulators itself, C7514).
//
// float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the products on the
// FP32 pipes (tensor-core TF32 would round the operands beyond the float32
// tolerance). 256 threads; thread (tr, tc) = (tid / 16, tid % 16) owns
// score entries (tr + 16 i, tc + 16 c) for i, c < 4, and accumulator entries
// (tr + 16 i, tc + 16 c) for c < D / 16. Tiles sit in shared memory in float32
// with an odd row stride (D + 1, 64 + 1), so column walks hit distinct banks;
// p and ds go through shared memory. Shared memory: 166 KB (dK/dV kernel) and
// 149 KB (dQ kernel) at D = 128, one CTA an SM. delta comes from the caller.

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int PS = BK + 1;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;  // dO
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int H, Lq, Lk;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long g_sb, g_sh, g_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  float scale;
  int causal;
  int window;  // 0 = none
};

// rows [r0, r0 + 64) of a [L, D] matrix with row stride sl into a float32
// tile of row stride D + 1; rows at or past `end` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long sl,
                                          int r0, int end) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < end ? to_f32(src[row * sl + c]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int row, int col, const BwdArgs& a) {
  return row < a.Lq && col < a.Lk && (!a.causal || col <= row) &&
         (a.window <= 0 || col > row - a.window);
}

// s = Q K^T and dp = dO V^T for the thread's 4 x 4 entries of one tile pair
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* gs, const float* ks,
                                       const float* vs, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int DS = D + 1;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(tr + 16 * i) * DS + d];
      gv[i] = gs[(tr + 16 * i) * DS + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kv[c] = ks[(tc + 16 * c) * DS + d];
      vv[c] = vs[(tc + 16 * c) * DS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(gv[i], vv[c], dp[i][c]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv_kernel(BwdArgs a) {
  constexpr int DS = D + 1;
  constexpr int DT = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;               // [BK][DS]
  float* vs = ks + BK * DS;       // [BK][DS]
  float* qs = vs + BK * DS;       // [BQ][DS]
  float* gs = qs + BQ * DS;       // [BQ][DS]  dO
  float* ps = gs + BQ * DS;       // [BQ][PS]  p
  float* dss = ps + BQ * PS;      // [BQ][PS]  ds
  float* lse_s = dss + BQ * PS;   // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* gg = static_cast<const T*>(a.g) + b * a.g_sb + h * a.g_sh;
  const float* lseg = a.lse + static_cast<long long>(bh) * a.Lq;
  const float* deltag = a.delta + static_cast<long long>(bh) * a.Lq;

  load_tile<T, D>(ks, kg, a.k_sl, k0, a.Lk);
  load_tile<T, D>(vs, vg, a.v_sl, k0, a.Lk);

  float dk[4][DT], dv[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DT; ++c) dk[i][c] = dv[i][c] = 0.f;

  // q tiles that can see this key tile: from the causal diagonal down; a
  // window also ends the sweep (rows past col + window - 1 see none of it)
  const int nq = (a.Lq + BQ - 1) / BQ;
  const int lo = a.causal ? k0 / BQ : 0;
  const int hi = a.window > 0 ? min(nq, (k0 + BK - 1 + a.window + BQ - 1) / BQ) : nq;

  for (int j = lo; j < hi; ++j) {
    const int q0 = j * BQ;
    __syncthreads();  // the previous tile's products are done with qs/gs/ps/dss
    load_tile<T, D>(qs, qg, a.q_sl, q0, a.Lq);
    load_tile<T, D>(gs, gg, a.g_sl, q0, a.Lq);
    if (tid < BQ) {
      const int row = q0 + tid;
      lse_s[tid] = row < a.Lq ? lseg[row] : 0.f;
      delta_s[tid] = row < a.Lq ? deltag[row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qs, gs, ks, vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const float lse_r = lse_s[r], delta_r = delta_s[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tc + 16 * c;
        const float p =
            visible(q0 + r, k0 + kc, a) ? expf(s[i][c] * a.scale - lse_r) : 0.f;
        ps[r * PS + kc] = p;
        dss[r * PS + kc] = p * (dp[i][c] - delta_r);
      }
    }
    __syncthreads();

    // dV[kr] += sum_r p[r][kr] dO[r];  dK[kr] += sum_r ds[r][kr] Q[r]
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4], gv[DT], qv[DT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * PS + tr + 16 * i];
        dsv[i] = dss[r * PS + tr + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        gv[c] = gs[r * DS + tc + 16 * c];
        qv[c] = qs[r * DS + tc + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
          dk[i][c] = fmaf(dsv[i], qv[c], dk[i][c]);
        }
    }
  }

  // every key row is written, zeros included (a key no query sees)
  T* dkg = static_cast<T*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  T* dvg = static_cast<T*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr + 16 * i;
    if (row >= a.Lk) continue;
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      dkg[row * a.dk_sl + tc + 16 * c] = from_f32<T>(dk[i][c] * a.scale);
      dvg[row * a.dv_sl + tc + 16 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_kernel(BwdArgs a) {
  constexpr int DS = D + 1;
  constexpr int DT = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][DS]
  float* gs = qs + BQ * DS;       // [BQ][DS]  dO
  float* ks = gs + BQ * DS;       // [BK][DS]
  float* vs = ks + BK * DS;       // [BK][DS]
  float* dss = vs + BK * DS;      // [BQ][PS]  ds

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  // causal: the last q tiles sweep the most key tiles, so they start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* gg = static_cast<const T*>(a.g) + b * a.g_sb + h * a.g_sh;

  load_tile<T, D>(qs, qg, a.q_sl, q0, a.Lq);
  load_tile<T, D>(gs, gg, a.g_sl, q0, a.Lq);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    const long long at = static_cast<long long>(bh) * a.Lq + row;
    lse_r[i] = row < a.Lq ? a.lse[at] : 0.f;
    delta_r[i] = row < a.Lq ? a.delta[at] : 0.f;
  }

  float dq[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DT; ++c) dq[i][c] = 0.f;

  // key tiles this q tile can see: the forward's causal hi and window lo
  const int nk = (a.Lk + BK - 1) / BK;
  const int hi = a.causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / BK : 0;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's ds K product is done with ks/dss
    load_tile<T, D>(ks, kg, a.k_sl, k0, a.Lk);
    load_tile<T, D>(vs, vg, a.v_sl, k0, a.Lk);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(qs, gs, ks, vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tc + 16 * c;
        const float p =
            visible(q0 + r, k0 + kc, a) ? expf(s[i][c] * a.scale - lse_r[i]) : 0.f;
        dss[r * PS + kc] = p * (dp[i][c] - delta_r[i]);
      }
    }
    __syncthreads();

    // dQ[r] += sum_kk ds[r][kk] K[kk]
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[DT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(tr + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DT; ++c) kv[c] = ks[kk * DS + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
  }

  // every query row is written, zeros included (a row that sees no key)
  T* dqg = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= a.Lq) continue;
#pragma unroll
    for (int c = 0; c < DT; ++c)
      dqg[row * a.dq_sl + tc + 16 * c] = from_f32<T>(dq[i][c] * a.scale);
  }
}

template <int D>
constexpr int dkdv_smem() {
  return (2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * PS + 2 * BQ) * sizeof(float);
}

template <int D>
constexpr int dq_smem() {
  return (2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * PS) * sizeof(float);
}

template <typename T, int D>
int launch_dkdv(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = dkdv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Lk + BK - 1) / BK, B * a.H);
  flash_bwd_dkdv_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Lq + BQ - 1) / BQ, B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on Hopper's tensor cores (see the note at the top)

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int HTHREADS = 3 * WG;         // two consumer warpgroups, then the producer's
constexpr int BR = 64;                   // rows of a consumer's tile and of a TMA box
constexpr int DQ_ROWS = 2 * BR;          // q rows of a dQ CTA
constexpr int DQ_KEYS = 64;              // keys of a dQ kernel's K/V tile
constexpr int DKV_KEYS = 2 * BR;         // keys of a dK/dV CTA
constexpr int DKV_ROWS = BR;             // q rows of a dK/dV kernel's Q/dO tile
constexpr int STAGES = 3;                // the ring of swept tiles
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

struct alignas(64) HopperArgs {
  CUtensorMap tq, tk, tv, tg;  // Q, K, V, dO (boxes of 64 rows of one span)
  const void* o;       // bf16, or float32 (ring attention's merged out)
  int o_f32;
  const float* lse;
  const float* g_lse;  // nullable
  float* delta;        // written by the dQ kernel, read by the dK/dV kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Lq, Lk;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  long long o_sb, o_sh, o_sl;
  float scale;
  int causal;
  int window;  // 0 = none
};

__device__ __forceinline__ bool sees(int row, int col, const HopperArgs& a) {
  return row < a.Lq && col < a.Lk && (!a.causal || col <= row) &&
         (a.window <= 0 || col > row - a.window);
}

// 2^x on the special-function unit, a denormal result flushed to 0 (a p that
// small adds nothing to a row's sum); faster than exp2f on the H100
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The consumer's 64 x N score tile in place, p = exp2(s * sl2 - lse2), with
// p selected to 0 where the pair is not visible (MASK: only on the tiles at
// a boundary). Accumulator entry (row i, column c) is the pair (query, key)
// that pair(i, c) gives; consts(i, c) gives its row's lse2 and delta.
template <bool MASK, int N, typename Consts, typename Pair>
__device__ __forceinline__ void probs(float (&s)[N / 2], float sl2, Consts consts, Pair pair,
                                      const HopperArgs& a) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lse2, dl;
        consts(i, j * 8 + 2 * t + e, lse2, dl);
        float& x = s[4 * j + 2 * i + e];
        const float p = exp2_ftz(fmaf(x, sl2, -lse2));
        if (MASK) {
          int qrow, key;
          pair(g + 8 * i, j * 8 + 2 * t + e, qrow, key);
          x = sees(qrow, key, a) ? p : 0.f;
        } else {
          x = p;
        }
      }
}

// ds = p * (dp - delta), into dp
template <int N, typename Consts>
__device__ __forceinline__ void grads(const float (&p)[N / 2], float (&dp)[N / 2],
                                      Consts consts) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lse2, dl;
        consts(i, j * 8 + 2 * t + e, lse2, dl);
        const int idx = 4 * j + 2 * i + e;
        dp[idx] = p[idx] * (dp[idx] - dl);
      }
}

template <int D>
constexpr int dq_wgmma_smem() {
  // Q and dO resident, K and V stages, delta of the CTA's rows, barriers,
  // and the slack that aligns the tiles to 1024 bytes
  return 2 * DQ_ROWS * D * 2 + 2 * STAGES * DQ_KEYS * D * 2 + DQ_ROWS * 4 +
         (1 + 2 * STAGES) * 8 + 1024;
}

template <int D>
constexpr int dkdv_wgmma_smem() {
  return 2 * DKV_KEYS * D * 2 + 2 * STAGES * DKV_ROWS * D * 2 + 2 * STAGES * DKV_ROWS * 4 +
         (1 + 2 * STAGES) * 8 + 1024;
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ HopperArgs a) {
  using T = SwTile<D>;
  constexpr int QT = DQ_ROWS * D * 2;  // bytes of the resident Q (and dO) tile
  constexpr int KT = DQ_KEYS * D * 2;  // bytes of a K (and V) stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t qs = base, gs = qs + QT, ks = gs + QT, vs = ks + STAGES * KT;
  float* delta_s = reinterpret_cast<float*>(sp + (vs + STAGES * KT - base));
  const uint32_t bar_res = vs + STAGES * KT + DQ_ROWS * 4;
  const uint32_t bar_full = bar_res + 8, bar_empty = bar_full + 8 * STAGES;

  // the warpgroup index broadcast from lane 0, so the compiler sees the
  // role branch below as warp-uniform (else setmaxnreg cannot take effect)
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const bool producer = wg == 2;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  // causal: the last q tiles sweep the most key tiles, so they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;
  // key tiles this q tile can see: the forward's causal hi and window lo
  const int nk = (a.Lk + DQ_KEYS - 1) / DQ_KEYS;
  const int hi = a.causal ? min(nk, (q0 + DQ_ROWS + DQ_KEYS - 1) / DQ_KEYS) : nk;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / DQ_KEYS : 0;
  const int n = max(hi - lo, 0);

  if (tid == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * WG / 32);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (producer) {  // the producer: Q and dO once, then the K/V ring
    warpgroup_regs_dec<PRODUCER_REGS>();
    const int ptid = tid - 2 * WG;
    if (ptid == 0) {
      mbar_arrive_expect_tx(bar_res, 2 * QT);
#pragma unroll
      for (int span = 0; span < T::SPANS; ++span)
#pragma unroll
        for (int rb = 0; rb < DQ_ROWS / BR; ++rb) {
          const uint32_t off = (span * DQ_ROWS + rb * BR) * T::ROW_BYTES;
          tma_load_4d(qs + off, &a.tq, bar_res, span * T::COLS, q0 + rb * BR, h, b);
          tma_load_4d(gs + off, &a.tg, bar_res, span * T::COLS, q0 + rb * BR, h, b);
        }
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, round = i / STAGES;
        if (round > 0) mbar_wait(bar_empty + 8 * st, (round - 1) & 1);
        const int k0 = (lo + i) * DQ_KEYS;
        mbar_arrive_expect_tx(bar_full + 8 * st, 2 * KT);
#pragma unroll
        for (int span = 0; span < T::SPANS; ++span)
#pragma unroll
          for (int rb = 0; rb < DQ_KEYS / BR; ++rb) {
            const uint32_t off = st * KT + (span * DQ_KEYS + rb * BR) * T::ROW_BYTES;
            tma_load_4d(ks + off, &a.tk, bar_full + 8 * st, span * T::COLS, k0 + rb * BR, h, b);
            tma_load_4d(vs + off, &a.tv, bar_full + 8 * st, span * T::COLS, k0 + rb * BR, h, b);
          }
      }
    }
  } else {  // consumer wg: q rows r0 .. r0 + 63
    warpgroup_regs_inc<CONSUMER_REGS>();
    const int ctid = tid % WG, warp = ctid / 32, g = lane / 4;
    const int r0 = q0 + wg * BR;
    mbar_wait(bar_res, 0);

    // delta = rowsum(dO * O) - g_lse, float32: two threads a row, half of D
    // each, dO from the resident tile and O (bf16 or float32) from global
    // memory
    {
      const int r = ctid / 2, half = ctid % 2, row = r0 + r;
      float acc = 0.f;
      if (row < a.Lq) {
        const long long at = b * a.o_sb + h * a.o_sh + row * a.o_sl;
#pragma unroll
        for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += 8) {
          float of[8];
          if (a.o_f32) {
            const float4* o4 =
                reinterpret_cast<const float4*>(static_cast<const float*>(a.o) + at + c);
            const float4 x = o4[0], y = o4[1];
            of[0] = x.x; of[1] = x.y; of[2] = x.z; of[3] = x.w;
            of[4] = y.x; of[5] = y.y; of[6] = y.z; of[7] = y.w;
          } else {
            const uint4 ov = *reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(a.o) + at + c);
            const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(o2[e]);
              of[2 * e] = f.x;
              of[2 * e + 1] = f.y;
            }
          }
          const uint4 gv = *reinterpret_cast<const uint4*>(
              sp + (gs - base) + T::template offset<DQ_ROWS>(wg * BR + r, c));
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 gf = __bfloat1622float2(g2[e]);
            acc = fmaf(gf.x, of[2 * e], acc);
            acc = fmaf(gf.y, of[2 * e + 1], acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (row < a.Lq && a.g_lse != nullptr)
        acc -= a.g_lse[static_cast<long long>(bh) * a.Lq + row];
      if (half == 0) {
        delta_s[wg * BR + r] = acc;
        if (row < a.Lq) a.delta[static_cast<long long>(bh) * a.Lq + row] = acc;
      }
    }
    named_sync(1 + wg, WG);

    // lse (log2 units) and delta of this thread's accumulator rows g, g + 8
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = warp * 16 + g + 8 * i, row = r0 + rl;
      lse2[i] = row < a.Lq ? a.lse[static_cast<long long>(bh) * a.Lq + row] * LOG2E : 0.f;
      dl[i] = delta_s[wg * BR + rl];
    }
    const auto row_consts = [&](int i, int, float& l2, float& d) {
      l2 = lse2[i];
      d = dl[i];
    };

    float dq[D / 2], s[DQ_KEYS / 2], dp[DQ_KEYS / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
#pragma unroll
    for (int x = 0; x < DQ_KEYS / 2; ++x) s[x] = dp[x] = 0.f;
    const float sl2 = a.scale * LOG2E;

    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      mbar_wait(bar_full + 8 * st, (i / STAGES) & 1);
      const int k0 = (lo + i) * DQ_KEYS;
      // a consumer none of whose rows sees a key of this tile skips it
      const bool skip = r0 >= a.Lq || (a.causal && k0 > r0 + BR - 1) ||
                        (a.window > 0 && k0 + DQ_KEYS - 1 <= r0 - a.window);
      if (!skip) {
        const uint32_t kst = ks + st * KT, vst = vs + st * KT;
        // S = Q K^T and dP = dO V^T, K-major operands from shared memory, as
        // two groups: P is computed while dP's products still run
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<DQ_KEYS>::template ss<0>(s, desc_kmajor<D, DQ_ROWS>(qs, wg * BR, kk),
                                         desc_kmajor<D, DQ_KEYS>(kst, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<DQ_KEYS>::template ss<0>(dp, desc_kmajor<D, DQ_ROWS>(gs, wg * BR, kk),
                                         desc_kmajor<D, DQ_KEYS>(vst, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        // the mask only where some pair of the tile is not visible
        const bool edge = r0 + BR > a.Lq || k0 + DQ_KEYS > a.Lk ||
                          (a.causal && k0 + DQ_KEYS - 1 > r0) ||
                          (a.window > 0 && k0 <= r0 + BR - 1 - a.window);
        const auto pair = [&](int rl, int c, int& qrow, int& key) {
          qrow = r0 + warp * 16 + rl;
          key = k0 + c;
        };
        if (edge)
          probs<true, DQ_KEYS>(s, sl2, row_consts, pair, a);
        else
          probs<false, DQ_KEYS>(s, sl2, row_consts, pair, a);
        wgmma_wait<0>();
        fence_regs(dp);
        grads<DQ_KEYS>(s, dp, row_consts);
        // dQ += dS K: dS from registers (bf16), K read MN-major
        uint32_t da[DQ_KEYS / 16][4];
#pragma unroll
        for (int kk = 0; kk < DQ_KEYS / 16; ++kk) acc_to_a(da[kk], dp, kk);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_KEYS / 16; ++kk)
          Wgmma<D>::template rs<1>(dq, da[kk], desc_mnmajor<D, DQ_KEYS>(kst, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // every query row is written, zeros included (a row that sees no key):
    // dQ * scale in bf16 into this consumer's rows of the Q tile (which only
    // its own products read), then 16-byte stores of whole rows
    const int t = lane % 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(
            sp + T::template offset<DQ_ROWS>(wg * BR + warp * 16 + g + 8 * i, 8 * j + 2 * t)) =
            pack_bf16(dq[4 * j + 2 * i] * a.scale, dq[4 * j + 2 * i + 1] * a.scale);
    named_sync(1 + wg, WG);
    __nv_bfloat16* dqg = a.dq + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
    for (int e = ctid; e < BR * D / 8; e += WG) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8, row = r0 + r;
      if (row < a.Lq)
        *reinterpret_cast<uint4*>(dqg + row * a.dq_sl + c) =
            *reinterpret_cast<const uint4*>(sp + T::template offset<DQ_ROWS>(wg * BR + r, c));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ HopperArgs a) {
  using T = SwTile<D>;
  constexpr int KT = DKV_KEYS * D * 2;  // bytes of the resident K (and V) tile
  constexpr int QT = DKV_ROWS * D * 2;  // bytes of a Q (and dO) stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), base = (raw + 1023) & ~1023u;
  unsigned char* sp = smem_raw + (base - raw);
  const uint32_t ks = base, vs = ks + KT, qs = vs + KT, gs = qs + STAGES * QT;
  float* lse_s = reinterpret_cast<float*>(sp + (gs + STAGES * QT - base));  // [STAGES][64]
  float* delta_s = lse_s + STAGES * DKV_ROWS;                               // [STAGES][64]
  const uint32_t bar_res = gs + STAGES * QT + 2 * STAGES * DKV_ROWS * 4;
  const uint32_t bar_full = bar_res + 8, bar_empty = bar_full + 8 * STAGES;

  // the warpgroup index broadcast from lane 0, so the compiler sees the
  // role branch below as warp-uniform (else setmaxnreg cannot take effect)
  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const bool producer = wg == 2;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * DKV_KEYS;
  // q tiles that can see this key tile: from the causal diagonal down; a
  // window also ends the sweep (rows past col + window - 1 see none of it)
  const int nq = (a.Lq + DKV_ROWS - 1) / DKV_ROWS;
  const int lo = a.causal ? k0 / DKV_ROWS : 0;
  const int hi = a.window > 0
                     ? min(nq, (k0 + DKV_KEYS - 1 + a.window + DKV_ROWS - 1) / DKV_ROWS)
                     : nq;
  const int n = max(hi - lo, 0);

  if (tid == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the producer warp's 32 arrivals, after its plain stores of lse and delta
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, 2 * WG / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (producer) {  // the producer: K and V once, then the Q/dO/lse/delta ring
    warpgroup_regs_dec<PRODUCER_REGS>();
    const int ptid = tid - 2 * WG;
    if (ptid == 0) {
      mbar_arrive_expect_tx(bar_res, 2 * KT);
#pragma unroll
      for (int span = 0; span < T::SPANS; ++span)
#pragma unroll
        for (int rb = 0; rb < DKV_KEYS / BR; ++rb) {
          const uint32_t off = (span * DKV_KEYS + rb * BR) * T::ROW_BYTES;
          tma_load_4d(ks + off, &a.tk, bar_res, span * T::COLS, k0 + rb * BR, h, b);
          tma_load_4d(vs + off, &a.tv, bar_res, span * T::COLS, k0 + rb * BR, h, b);
        }
    }
    if (ptid < 32) {
      const long long rows0 = static_cast<long long>(bh) * a.Lq;
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES, round = i / STAGES;
        if (round > 0) mbar_wait(bar_empty + 8 * st, (round - 1) & 1);
        const int q0 = (lo + i) * DKV_ROWS;
#pragma unroll
        for (int r = lane; r < DKV_ROWS; r += 32) {
          const int row = q0 + r;
          lse_s[st * DKV_ROWS + r] = row < a.Lq ? a.lse[rows0 + row] : 0.f;
          delta_s[st * DKV_ROWS + r] = row < a.Lq ? a.delta[rows0 + row] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(bar_full + 8 * st, 2 * QT);
#pragma unroll
          for (int span = 0; span < T::SPANS; ++span) {
            const uint32_t off = st * QT + span * DKV_ROWS * T::ROW_BYTES;
            tma_load_4d(qs + off, &a.tq, bar_full + 8 * st, span * T::COLS, q0, h, b);
            tma_load_4d(gs + off, &a.tg, bar_full + 8 * st, span * T::COLS, q0, h, b);
          }
        } else {
          mbar_arrive(bar_full + 8 * st);
        }
      }
    }
  } else {  // consumer wg: keys kw0 .. kw0 + 63
    warpgroup_regs_inc<CONSUMER_REGS>();
    const int ctid = tid % WG, warp = ctid / 32, g = lane / 4, t = lane % 4;
    const int kw0 = k0 + wg * BR;
    mbar_wait(bar_res, 0);

    float dk[D / 2], dv[D / 2], s[DKV_ROWS / 2], dp[DKV_ROWS / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
#pragma unroll
    for (int x = 0; x < DKV_ROWS / 2; ++x) s[x] = dp[x] = 0.f;
    const float sl2 = a.scale * LOG2E;

    for (int i = 0; i < n; ++i) {
      const int st = i % STAGES;
      mbar_wait(bar_full + 8 * st, (i / STAGES) & 1);
      const int q0 = (lo + i) * DKV_ROWS;
      // a consumer none of whose keys this tile's rows see skips it
      const bool skip = kw0 >= a.Lk || (a.causal && kw0 > q0 + DKV_ROWS - 1) ||
                        (a.window > 0 && q0 >= kw0 + BR - 1 + a.window);
      if (!skip) {
        const uint32_t qst = qs + st * QT, gst = gs + st * QT;
        // S^T = K Q^T and dP^T = V dO^T, K-major operands from shared memory,
        // as two groups; then dV += P^T dO runs while dS^T is computed
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<DKV_ROWS>::template ss<0>(s, desc_kmajor<D, DKV_KEYS>(ks, wg * BR, kk),
                                          desc_kmajor<D, DKV_ROWS>(qst, 0, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          Wgmma<DKV_ROWS>::template ss<0>(dp, desc_kmajor<D, DKV_KEYS>(vs, wg * BR, kk),
                                          desc_kmajor<D, DKV_ROWS>(gst, 0, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        // P^T: accumulator rows are keys, columns are q rows
        const float* lse_t = lse_s + st * DKV_ROWS;
        const float* delta_t = delta_s + st * DKV_ROWS;
        const auto col_consts = [&](int, int c, float& l2, float& d) {
          l2 = lse_t[c] * LOG2E;
          d = delta_t[c];
        };
        const bool edge = kw0 + BR > a.Lk || q0 + DKV_ROWS > a.Lq ||
                          (a.causal && kw0 + BR - 1 > q0) ||
                          (a.window > 0 && q0 + DKV_ROWS - 1 >= kw0 + a.window);
        const auto pair = [&](int rl, int c, int& qrow, int& key) {
          qrow = q0 + c;
          key = kw0 + warp * 16 + rl;
        };
        if (edge)
          probs<true, DKV_ROWS>(s, sl2, col_consts, pair, a);
        else
          probs<false, DKV_ROWS>(s, sl2, col_consts, pair, a);
        // dV += P^T dO: P^T from registers (bf16), dO read MN-major
        uint32_t pa[DKV_ROWS / 16][4], da[DKV_ROWS / 16][4];
#pragma unroll
        for (int kk = 0; kk < DKV_ROWS / 16; ++kk) acc_to_a(pa[kk], s, kk);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DKV_ROWS / 16; ++kk)
          Wgmma<D>::template rs<1>(dv, pa[kk], desc_mnmajor<D, DKV_ROWS>(gst, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed (groups complete in order)
        fence_regs(dp);
        grads<DKV_ROWS>(s, dp, col_consts);
        // dK += dS^T Q: dS^T from registers (bf16), Q read MN-major
#pragma unroll
        for (int kk = 0; kk < DKV_ROWS / 16; ++kk) acc_to_a(da[kk], dp, kk);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DKV_ROWS / 16; ++kk)
          Wgmma<D>::template rs<1>(dk, da[kk], desc_mnmajor<D, DKV_ROWS>(qst, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    // every key row is written, zeros included (a key no query sees): dK *
    // scale and dV in bf16 into this consumer's rows of the K and V tiles,
    // then 16-byte stores of whole rows
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t off =
            T::template offset<DKV_KEYS>(wg * BR + warp * 16 + g + 8 * i, 8 * j + 2 * t);
        *reinterpret_cast<uint32_t*>(sp + off) =
            pack_bf16(dk[4 * j + 2 * i] * a.scale, dk[4 * j + 2 * i + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(sp + (vs - base) + off) =
            pack_bf16(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    named_sync(1 + wg, WG);
    __nv_bfloat16* dkg = a.dk + b * a.dk_sb + h * a.dk_sh;
    __nv_bfloat16* dvg = a.dv + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
    for (int e = ctid; e < BR * D / 8; e += WG) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8, key = kw0 + r;
      if (key < a.Lk) {
        const uint32_t off = T::template offset<DKV_KEYS>(wg * BR + r, c);
        *reinterpret_cast<uint4*>(dkg + key * a.dk_sl + c) =
            *reinterpret_cast<const uint4*>(sp + off);
        *reinterpret_cast<uint4*>(dvg + key * a.dv_sl + c) =
            *reinterpret_cast<const uint4*>(sp + (vs - base) + off);
      }
    }
  }
}

// The bf16 kernels' arguments; builds the four tensor maps. strides: 24
// values, (batch, head, row) of q, k, v, g, dq, dk, dv, o. -> 0, or the
// cudaError_t to return.
int make_hopper_args(HopperArgs& a, const void* q, const void* k, const void* v, const void* g,
                     const void* o, int o_f32, const void* lse, const void* g_lse, void* delta,
                     void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk, int D,
                     const long long* st, float scale, int causal, int window) {
  a.o = o;
  a.o_f32 = o_f32;
  a.lse = static_cast<const float*>(lse);
  a.g_lse = static_cast<const float*>(g_lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.H = H; a.Lq = Lq; a.Lk = Lk;
  a.dq_sb = st[12]; a.dq_sh = st[13]; a.dq_sl = st[14];
  a.dk_sb = st[15]; a.dk_sh = st[16]; a.dk_sl = st[17];
  a.dv_sb = st[18]; a.dv_sh = st[19]; a.dv_sl = st[20];
  a.o_sb = st[21]; a.o_sh = st[22]; a.o_sl = st[23];
  a.scale = scale; a.causal = causal; a.window = window;
  if (tma_map_bhld(&a.tq, q, B, H, Lq, D, st[0], st[1], st[2]) ||
      tma_map_bhld(&a.tk, k, B, H, Lk, D, st[3], st[4], st[5]) ||
      tma_map_bhld(&a.tv, v, B, H, Lk, D, st[6], st[7], st[8]) ||
      tma_map_bhld(&a.tg, g, B, H, Lq, D, st[9], st[10], st[11]))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int D>
int launch_dq_wgmma(const HopperArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = dq_wgmma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H, (a.Lq + DQ_ROWS - 1) / DQ_ROWS);
  flash_bwd_dq_wgmma_kernel<D><<<grid, HTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv_wgmma(const HopperArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = dkdv_wgmma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H, (a.Lk + DKV_KEYS - 1) / DKV_KEYS);
  flash_bwd_dkdv_wgmma_kernel<D><<<grid, HTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* g,
                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                  int H, int Lq, int Lk, const long long* st, float scale, int causal,
                  int window) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.g = g;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.H = H; a.Lq = Lq; a.Lk = Lk;
  a.q_sb = st[0];  a.q_sh = st[1];  a.q_sl = st[2];
  a.k_sb = st[3];  a.k_sh = st[4];  a.k_sl = st[5];
  a.v_sb = st[6];  a.v_sh = st[7];  a.v_sl = st[8];
  a.g_sb = st[9];  a.g_sh = st[10]; a.g_sl = st[11];
  a.dq_sb = st[12]; a.dq_sh = st[13]; a.dq_sl = st[14];
  a.dk_sb = st[15]; a.dk_sh = st[16]; a.dk_sl = st[17];
  a.dv_sb = st[18]; a.dv_sh = st[19]; a.dv_sl = st[20];
  a.scale = scale; a.causal = causal; a.window = window;
  return a;
}

}  // namespace

// q, dq: [B, H, Lq, D]; k, v, dk, dv: [B, H, Lk, D]; g (dO), o: [B, H, Lq, D],
// D = 32, 64 or 128; each with any strides over (B, H, L) and unit stride
// over D. lse, delta, g_lse: contiguous [B, H, Lq] float32. strides: 24
// values, (batch, head, row) for q, k, v, g, dq, dk, dv, o in that order.
// dtype: 0 = float32 (the FP32 kernels; delta is an input, o and g_lse are
// not read), 1 = bf16 (the wgmma kernels, which need every pointer and
// stride 16-byte aligned; tony_flash_bwd_dq writes delta from o, bf16 or,
// with o_f32, float32, and g_lse, which may be null, and tony_flash_bwd_dkdv
// reads it, so the dQ kernel runs first). Each returns the cudaError_t of
// its launch (0 on success).
extern "C" int tony_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Lq, int Lk,
                                   int D, int dtype, const long long* strides,
                                   float scale, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* ptrs[6] = {q, k, v, g, dk, dv};
    if (!aligned16(ptrs, 6, strides, 21)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D != 32 && D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
    HopperArgs a;
    const int err = make_hopper_args(a, q, k, v, g, nullptr, 0, lse, nullptr,
                                     const_cast<void*>(delta), nullptr, dk, dv, B, H, Lq, Lk,
                                     D, strides, scale, causal, window);
    if (err != 0) return err;
    if (D == 128) return launch_dkdv_wgmma<128>(a, B, s);
    if (D == 64) return launch_dkdv_wgmma<64>(a, B, s);
    return launch_dkdv_wgmma<32>(a, B, s);
  }
  const BwdArgs a = make_args(q, k, v, g, lse, delta, nullptr, dk, dv, H, Lq, Lk,
                              strides, scale, causal, window);
  if (dtype == 0 && D == 128) return launch_dkdv<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch_dkdv<float, 64>(a, B, s);
  if (dtype == 0 && D == 32) return launch_dkdv<float, 32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tony_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* o, const void* g, const void* lse,
                                 const void* g_lse, void* delta, void* dq, int B, int H,
                                 int Lq, int Lk, int D, int dtype, int o_f32,
                                 const long long* strides, float scale, int causal, int window,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* ptrs[6] = {q, k, v, g, dq, o};
    if (!aligned16(ptrs, 6, strides, 21)) return static_cast<int>(cudaErrorMisalignedAddress);
    // O's strides in its own element size (4 floats or 8 bf16 to 16 bytes)
    const long long o_st[3] = {strides[21] * (o_f32 ? 2 : 1), strides[22] * (o_f32 ? 2 : 1),
                               strides[23] * (o_f32 ? 2 : 1)};
    if (!aligned16(ptrs, 0, o_st, 3)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D != 32 && D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
    HopperArgs a;
    const int err = make_hopper_args(a, q, k, v, g, o, o_f32, lse, g_lse, delta, dq, nullptr,
                                     nullptr, B, H, Lq, Lk, D, strides, scale, causal, window);
    if (err != 0) return err;
    if (D == 128) return launch_dq_wgmma<128>(a, B, s);
    if (D == 64) return launch_dq_wgmma<64>(a, B, s);
    return launch_dq_wgmma<32>(a, B, s);
  }
  const BwdArgs a = make_args(q, k, v, g, lse, delta, dq, nullptr, nullptr, H, Lq, Lk,
                              strides, scale, causal, window);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(a, B, s);
  if (dtype == 0 && D == 32) return launch_dq<float, 32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

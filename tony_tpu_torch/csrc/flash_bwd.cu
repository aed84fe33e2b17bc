// Flash attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces the JAX package's ops/attention.py `_bwd_kernel_resident` (fused
// dQ/dK/dV, whole sequence in VMEM), `_kv_sweep_kernel` (per kv block, sweep
// the q blocks for dK/dV, fused with dQ up to 8192 rows) and `_dq_kernel` (the
// split tier's dQ). The three TPU tiers are one function split by the TPU's
// on-chip memory size; here it is two kernels, because on this card a block
// cannot carry a dQ sum across other blocks without atomics:
//
// - flash_bwd_dkdv: one CTA per (batch*head, 64-row key tile). K, V stay in
//   shared memory; the CTA sweeps the q tiles from the causal diagonal down to
//   the window's upper bound (the TPU kv sweep's bounds) and keeps dK, dV in
//   float32 registers.
// - flash_bwd_dq: one CTA per (batch*head, 64-row query tile). Q and dO stay in
//   shared memory; the CTA sweeps the key tiles with the forward's causal and
//   window bounds, the last q tiles (which sweep the most) first, and keeps dQ
//   in float32 registers.
//
// No atomics, so the gradients are the same from run to run.
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
// bf16 (the *_mma kernels): every product runs on the tensor cores, as
// mma.sync m16n8k16 with bf16 operands and float32 accumulators; 4 warps a
// CTA, 16 rows of the CTA's resident tile a warp. Tiles are bf16 in shared
// memory with rows padded by 8 elements (ldmatrix reads free of bank
// conflicts); the swept tiles come in by cp.async, 16 bytes a thread (lse and
// delta 4 bytes), in two stages, so the next tile loads while this one
// computes (one __syncthreads a tile). p = exp2(s * scale * log2(e) -
// lse * log2(e)) is one FFMA and one exp2, selected to 0 where masked. Unlike
// the forward, the backward tests the mask on every entry: a mask-free path
// for the interior tiles cost registers here and was slower on the H100.
// - dK/dV: the keys are the M dimension. S^T = K Q^T and dP^T = V dO^T put
//   P^T and dS^T = P^T * (dP^T - delta) in the accumulator layout, whose C
//   fragments, rounded to bf16, are directly the A operands of dV += P^T dO
//   and dK += dS^T Q (dO and Q by ldmatrix.trans). No p or ds tile exists in
//   shared memory. This kernel is where registers run out: at D = 128 the
//   dK and dV accumulators are 128 floats a thread (16 keys x 128 dims
//   each). So the q tile is taken 32 rows at a time, one chunk after the
//   other (S^T and dP^T: 32 floats), and the global sources of the swept
//   tiles are recomputed at each prefetch instead of kept as 64-bit pointers:
//   ptxas then fits the D = 128 kernel in its 255 registers with no spill.
//   With the chunks unrolled, or the pointers kept, it spills; 16-row chunks
//   are slower. PERF.md has ptxas's report and each alternative's time on
//   the H100 (tony_tpu_torch/tools/kernel_variants.py).
// - dQ: S = Q K^T and dP = dO V^T as fragments (Q, dO the A operands, K, V
//   the B operands by plain ldmatrix); dS is repacked in registers as the A
//   operand of dQ += dS K, with K by ldmatrix.trans. No spill at D = 128.
// Shared memory: 103 KB (dK/dV) and 102 KB (dQ) at D = 128, two CTAs an SM.
//
// float32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel): the products on the
// FP32 pipes (tensor-core TF32 would round the operands beyond the float32
// tolerance). 256 threads; thread (tr, tc) = (tid / 16, tid % 16) owns
// score entries (tr + 16 i, tc + 16 c) for i, c < 4, and accumulator entries
// (tr + 16 i, tc + 16 c) for c < D / 16. Tiles sit in shared memory in float32
// with an odd row stride (D + 1, 64 + 1), so column walks hit distinct banks;
// p and ds go through shared memory. Shared memory: 166 KB (dK/dV kernel) and
// 149 KB (dQ kernel) at D = 128, one CTA an SM.

#include "common.cuh"
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

// ---- bf16 on the tensor cores (see the note at the top)

constexpr int MR = 64;          // rows of a resident tile and of a swept tile
constexpr int MTHREADS = 128;   // 4 warps, 16 resident rows each
constexpr int QC = 32;          // q rows of a dK/dV kernel's tile taken at a time
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int mma_dkdv_smem() { return 6 * MR * (D + 8) * 2 + 4 * MR * 4; }

template <int D>
constexpr int mma_dq_smem() { return 6 * MR * (D + 8) * 2; }

// P^T = exp2(S^T * sl2 - lse2) on the dK/dV kernel's fragment, in place: this
// lane holds keys key0 and key0 + 8 at q rows row0 + 8 n + {0, 1}, whose lse
// are lse_r[8 n + {0, 1}]. Entries a row does not see are selected to 0 (a
// row with no visible key has lse NEG_INF, so its exp2 overflows).
template <int NC>
__device__ __forceinline__ void p_from_scores(float (&s)[NC][4], const float* lse_r, float sl2,
                                              int key0, int row0, const BwdArgs& a) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = row0 + n * 8 + e;
      const float lse2 = lse_r[n * 8 + e] * LOG2E;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float& x = s[n][2 * hf + e];
        const float p = exp2f(fmaf(x, sl2, -lse2));
        x = visible(row, key0 + 8 * hf, a) ? p : 0.f;
      }
    }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, 2) flash_bwd_dkdv_mma_kernel(BwdArgs a) {
  constexpr int DP = D + 8;     // padded row stride of every tile (elements)
  constexpr int TILE = MR * DP;
  constexpr int KD = D / 16;    // k16 steps over the head dim
  constexpr int NO = D / 8;     // n8 tiles of a dK or dV row
  constexpr int NC = QC / 8;    // n8 tiles of q rows in a chunk
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [MR][DP]
  __nv_bfloat16* vs = ks + TILE;                                    // [MR][DP]
  __nv_bfloat16* qs = vs + TILE;                                    // [2][MR][DP]
  __nv_bfloat16* gs = qs + 2 * TILE;                                // [2][MR][DP] dO
  float* lse_s = reinterpret_cast<float*>(gs + 2 * TILE);           // [2][MR]
  float* delta_s = lse_s + 2 * MR;                                  // [2][MR]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.y * MR;
  const int kr0 = k0 + warp * 16;  // the warp's first key
  const int bh = blockIdx.x;

  // q tile j into stage st: Q and dO by 16-byte copies, lse and delta by
  // 4-byte ones (threads 0-63 and 64-127); rows past Lq read as 0. The
  // sources are recomputed from the kernel arguments at each call, so no
  // 64-bit pointer stays live (in registers) across the sweep.
  auto load_q = [&](int st, int j) {
    const int bhj = static_cast<int>(opaque(bh)), b = bhj / a.H, h = bhj % a.H;
    const int q0 = j * MR;
    cp_tile<MR, D, MTHREADS>(qs + st * TILE,
                             static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh,
                             a.q_sl, q0, a.Lq);
    cp_tile<MR, D, MTHREADS>(gs + st * TILE,
                             static_cast<const __nv_bfloat16*>(a.g) + b * a.g_sb + h * a.g_sh,
                             a.g_sl, q0, a.Lq);
    const int r = tid % MR, row = q0 + r;
    const float* src = (tid < MR ? a.lse : a.delta) + static_cast<long long>(bhj) * a.Lq;
    float* dst = (tid < MR ? lse_s : delta_s) + st * MR + r;
    cp_async4(smem_u32(dst), row < a.Lq ? src + row : src, row < a.Lq ? 4 : 0);
  };

  // q tiles that can see this key tile: from the causal diagonal down; a
  // window also ends the sweep (rows past col + window - 1 see none of it)
  const int nq = (a.Lq + MR - 1) / MR;
  const int lo = a.causal ? k0 / MR : 0;
  const int hi = a.window > 0 ? min(nq, (k0 + MR - 1 + a.window + MR - 1) / MR) : nq;

  {
    const int b = bh / a.H, h = bh % a.H;
    cp_tile<MR, D, MTHREADS>(ks, static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh,
                             a.k_sl, k0, a.Lk);
    cp_tile<MR, D, MTHREADS>(vs, static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh,
                             a.v_sl, k0, a.Lk);
  }
  if (lo < hi) load_q(0, lo);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const float sl2 = a.scale * LOG2E;
  // this lane's ldmatrix row addresses inside the tiles (elements)
  const int ka_off = (warp * 16 + a_row(lane)) * DP + a_col(lane);  // K, V as A
  const int qb_off = b_row(lane) * DP + b_col(lane);   // Q, dO as B, n = q rows
  const int qt_off = bt_row(lane) * DP + bt_col(lane);  // Q, dO as B, k = q rows

  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with stage st ^ 1
    if (j + 1 < hi) load_q(st ^ 1, j + 1);
    cp_async_commit();

    const int q0 = j * MR;
    // a warp none of whose keys this tile's rows see skips it
    if (kr0 >= a.Lk || (a.causal && kr0 > q0 + MR - 1) ||
        (a.window > 0 && q0 >= kr0 + 15 + a.window))
      continue;
    const uint32_t kbase = opaque(smem_u32(ks)), vbase = opaque(smem_u32(vs));
    const uint32_t qbase = opaque(smem_u32(qs + st * TILE));
    const uint32_t gbase = opaque(smem_u32(gs + st * TILE));
    const float* lse_t = lse_s + st * MR;
    const float* delta_t = delta_s + st * MR;

#pragma unroll 1  // chunk by chunk: unrolled, the chunks overlap and spill
    for (int c = 0; c < MR / QC; ++c) {  // QC q rows at a time
      const int c0 = c * QC;
      // S^T = K Q^T and dP^T = V dO^T: this lane holds keys g, g + 8 of the
      // warp at q rows c0 + 8 n + 2 t + {0, 1}
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, kbase + (ka_off + kk * 16) * 2);
        ldmatrix_x4(va, vbase + (ka_off + kk * 16) * 2);
#pragma unroll
        for (int np = 0; np < NC / 2; ++np) {
          uint32_t qb[4], gb[4];
          const int off = qb_off + (c0 + np * 16) * DP + kk * 16;
          ldmatrix_x4(qb, qbase + off * 2);
          mma_bf16(s[2 * np], ka, qb[0], qb[1]);
          mma_bf16(s[2 * np + 1], ka, qb[2], qb[3]);
          ldmatrix_x4(gb, gbase + off * 2);
          mma_bf16(dp[2 * np], va, gb[0], gb[1]);
          mma_bf16(dp[2 * np + 1], va, gb[2], gb[3]);
        }
      }
      // P^T, in place
      p_from_scores(s, lse_t + c0 + 2 * t, sl2, kr0 + g, q0 + c0 + 2 * t, a);
      // dV += P^T dO: P^T from registers (bf16), dO by ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < NC / 2; ++kq) {
        uint32_t pa[4];
        c_to_a(pa, s[2 * kq], s[2 * kq + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t gb[4];
          ldmatrix_x4_trans(gb, gbase + (qt_off + (c0 + kq * 16) * DP + np * 16) * 2);
          mma_bf16(dv[2 * np], pa, gb[0], gb[1]);
          mma_bf16(dv[2 * np + 1], pa, gb[2], gb[3]);
        }
      }
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = delta_t[c0 + n * 8 + 2 * t + e];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 2 * hf + e;
            dp[n][i] = s[n][i] * (dp[n][i] - dl);
          }
        }
      // dK += dS^T Q: dS^T from registers (bf16), Q by ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < NC / 2; ++kq) {
        uint32_t da[4];
        c_to_a(da, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int np = 0; np < NO / 2; ++np) {
          uint32_t qb[4];
          ldmatrix_x4_trans(qb, qbase + (qt_off + (c0 + kq * 16) * DP + np * 16) * 2);
          mma_bf16(dk[2 * np], da, qb[0], qb[1]);
          mma_bf16(dk[2 * np + 1], da, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // every key row is written, zeros included (a key no query sees)
  const int b = bh / a.H, h = bh % a.H;
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(a.dk) + b * a.dk_sb + h * a.dk_sh;
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(a.dv) + b * a.dv_sb + h * a.dv_sh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = kr0 + g + 8 * hf;
    if (key >= a.Lk) continue;
    __nv_bfloat16* dkr = dkg + key * a.dk_sl + 2 * t;
    __nv_bfloat16* dvr = dvg + key * a.dv_sl + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + n * 8) =
          pack_bf16(dk[n][2 * hf] * a.scale, dk[n][2 * hf + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvr + n * 8) = pack_bf16(dv[n][2 * hf], dv[n][2 * hf + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, 2) flash_bwd_dq_mma_kernel(BwdArgs a) {
  constexpr int DP = D + 8;     // padded row stride of every tile (elements)
  constexpr int TILE = MR * DP;
  constexpr int KD = D / 16;    // k16 steps over the head dim
  constexpr int NS = MR / 8;    // n8 tiles of a score row
  constexpr int NO = D / 8;     // n8 tiles of a dQ row
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [MR][DP]
  __nv_bfloat16* gs = qs + TILE;                                    // [MR][DP] dO
  __nv_bfloat16* ks = gs + TILE;                                    // [2][MR][DP]
  __nv_bfloat16* vs = ks + 2 * TILE;                                // [2][MR][DP]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last q tiles sweep the most key tiles, so they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MR;
  const int r0 = q0 + warp * 16;  // the warp's first q row
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const __nv_bfloat16* gg = static_cast<const __nv_bfloat16*>(a.g) + b * a.g_sb + h * a.g_sh;

  // key tiles this q tile can see: the forward's causal hi and window lo
  const int nk = (a.Lk + MR - 1) / MR;
  const int hi = a.causal ? min(nk, (q0 + MR + MR - 1) / MR) : nk;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / MR : 0;

  cp_tile<MR, D, MTHREADS>(qs, qg, a.q_sl, q0, a.Lq);
  cp_tile<MR, D, MTHREADS>(gs, gg, a.g_sl, q0, a.Lq);
  if (lo < hi) {
    cp_tile<MR, D, MTHREADS>(ks, kg, a.k_sl, lo * MR, a.Lk);
    cp_tile<MR, D, MTHREADS>(vs, vg, a.v_sl, lo * MR, a.Lk);
  }
  cp_async_commit();

  // lse (log2 units) and delta of this lane's rows g and g + 8
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf;
    const long long at = static_cast<long long>(bh) * a.Lq + row;
    lse2[hf] = row < a.Lq ? a.lse[at] * LOG2E : 0.f;
    dl[hf] = row < a.Lq ? a.delta[at] : 0.f;
  }

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const float sl2 = a.scale * LOG2E;
  // this lane's ldmatrix row addresses inside the tiles (elements)
  const int qa_off = (warp * 16 + a_row(lane)) * DP + a_col(lane);  // Q, dO as A
  const int kb_off = b_row(lane) * DP + b_col(lane);    // K, V as B, n = keys
  const int kt_off = bt_row(lane) * DP + bt_col(lane);  // K as B, k = keys

  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with stage st ^ 1
    if (j + 1 < hi) {
      cp_tile<MR, D, MTHREADS>(ks + (st ^ 1) * TILE, kg, a.k_sl, (j + 1) * MR, a.Lk);
      cp_tile<MR, D, MTHREADS>(vs + (st ^ 1) * TILE, vg, a.v_sl, (j + 1) * MR, a.Lk);
    }
    cp_async_commit();

    const int k0 = j * MR;
    // a warp none of whose rows sees a key of this tile skips it
    if (r0 >= a.Lq || (a.causal && k0 > r0 + 15) ||
        (a.window > 0 && k0 + MR - 1 <= r0 - a.window))
      continue;
    const uint32_t qbase = opaque(smem_u32(qs)), gbase = opaque(smem_u32(gs));
    const uint32_t kbase = opaque(smem_u32(ks + st * TILE));
    const uint32_t vbase = opaque(smem_u32(vs + st * TILE));

    // S = Q K^T and dP = dO V^T: this lane holds rows g, g + 8 of the warp
    // at keys 8 n + 2 t + {0, 1}
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], ga[4];
      ldmatrix_x4(qa, qbase + (qa_off + kk * 16) * 2);
      ldmatrix_x4(ga, gbase + (qa_off + kk * 16) * 2);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4], vb[4];
        const int off = kb_off + np * 16 * DP + kk * 16;
        ldmatrix_x4(kb, kbase + off * 2);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        ldmatrix_x4(vb, vbase + off * 2);
        mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
      }
    }
    // P, in place; masked entries select their p to 0
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + g + 8 * hf;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          const float p = exp2f(fmaf(x, sl2, -lse2[hf]));
          x = visible(row, k0 + n * 8 + 2 * t + e, a) ? p : 0.f;
        }
      }
    // dS = P (dP - delta), into s
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= dp[n][e] - dl[e / 2];
    // dQ += dS K: dS from registers (bf16), K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < MR / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kbase + (kt_off + kk * 16 * DP + np * 16) * 2);
        mma_bf16(dq[2 * np], da, kb[0], kb[1]);
        mma_bf16(dq[2 * np + 1], da, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();

  // every query row is written, zeros included (a row that sees no key)
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf;
    if (row >= a.Lq) continue;
    __nv_bfloat16* dqr = dqg + row * a.dq_sl + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dqr + n * 8) =
          pack_bf16(dq[n][2 * hf] * a.scale, dq[n][2 * hf + 1] * a.scale);
  }
}

template <int D>
int launch_dkdv_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = mma_dkdv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H, (a.Lk + MR - 1) / MR);
  flash_bwd_dkdv_mma_kernel<D><<<grid, MTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_mma(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = mma_dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H, (a.Lq + MR - 1) / MR);
  flash_bwd_dq_mma_kernel<D><<<grid, MTHREADS, smem, stream>>>(a);
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

// q, dq: [B, H, Lq, D]; k, v, dk, dv: [B, H, Lk, D]; g (dO): [B, H, Lq, D],
// D = 32, 64 or 128 (at D = 32 a padded bf16 row is 80 bytes, so every
// ldmatrix row address stays 16-byte aligned, and a 64-row tile is 256
// 16-byte cp.async chunks, two a thread); each with any strides over
// (B, H, L) and unit stride over D. lse, delta:
// contiguous [B, H, Lq] float32. strides: 21 values, (batch, head, row) for
// q, k, v, g, dq, dk, dv in that order. dtype: 0 = float32 (the FP32
// kernels), 1 = bf16 (the tensor-core kernels, which also need every bf16
// pointer and every stride 16-byte aligned).
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int tony_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Lq, int Lk,
                                   int D, int dtype, const long long* strides,
                                   float scale, int causal, int window, void* stream) {
  const BwdArgs a = make_args(q, k, v, g, lse, delta, nullptr, dk, dv, H, Lq, Lk,
                              strides, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* ptrs[6] = {q, k, v, g, dk, dv};
    if (!aligned16(ptrs, 6, strides, 21)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D == 128) return launch_dkdv_mma<128>(a, B, s);
    if (D == 64) return launch_dkdv_mma<64>(a, B, s);
    if (D == 32) return launch_dkdv_mma<32>(a, B, s);
  }
  if (dtype == 0 && D == 128) return launch_dkdv<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch_dkdv<float, 64>(a, B, s);
  if (dtype == 0 && D == 32) return launch_dkdv<float, 32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int tony_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, const void* delta,
                                 void* dq, int B, int H, int Lq, int Lk, int D,
                                 int dtype, const long long* strides, float scale,
                                 int causal, int window, void* stream) {
  const BwdArgs a = make_args(q, k, v, g, lse, delta, dq, nullptr, nullptr, H, Lq, Lk,
                              strides, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const void* ptrs[5] = {q, k, v, g, dq};
    if (!aligned16(ptrs, 5, strides, 21)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D == 128) return launch_dq_mma<128>(a, B, s);
    if (D == 64) return launch_dq_mma<64>(a, B, s);
    if (D == 32) return launch_dq_mma<32>(a, B, s);
  }
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(a, B, s);
  if (dtype == 0 && D == 32) return launch_dq<float, 32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

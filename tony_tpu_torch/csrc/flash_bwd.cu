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
//   window bounds and keeps dQ in float32 registers.
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
// operations. This first version runs every product on the FP32 pipes (FMA
// from shared memory), like flash_fwd.cu, not the tensor cores; the split
// also recomputes the scores and dO V^T in both kernels. Moving the products
// to mma/wgmma is later work.
//
// Layout of the work: 256 threads; thread (tr, tc) = (tid / 16, tid % 16) owns
// score entries (tr + 16 i, tc + 16 c) for i, c < 4, and accumulator entries
// (tr + 16 i, tc + 16 c) for c < D / 16. Tiles sit in shared memory in float32
// with an odd row stride (D + 1, 64 + 1), so column walks hit distinct banks.
// Shared memory: 166 KB (dK/dV kernel) and 149 KB (dQ kernel) at D = 128,
// above the 48 KB default, so each launch raises the dynamic limit first.

#include "common.cuh"

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

// q, dq: [B, H, Lq, D]; k, v, dk, dv: [B, H, Lk, D]; g (dO): [B, H, Lq, D];
// each with any strides over (B, H, L) and unit stride over D. lse, delta:
// contiguous [B, H, Lq] float32. strides: 21 values, (batch, head, row) for
// q, k, v, g, dq, dk, dv in that order. dtype: 0 = float32, 1 = bf16.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int tony_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* g, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int H, int Lq, int Lk,
                                   int D, int dtype, const long long* strides,
                                   float scale, int causal, int window, void* stream) {
  const BwdArgs a = make_args(q, k, v, g, lse, delta, nullptr, dk, dv, H, Lq, Lk,
                              strides, scale, causal, window);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return launch_dkdv<__nv_bfloat16, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch_dkdv<__nv_bfloat16, 64>(a, B, s);
  if (dtype == 0 && D == 128) return launch_dkdv<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch_dkdv<float, 64>(a, B, s);
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
  if (dtype == 1 && D == 128) return launch_dq<__nv_bfloat16, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch_dq<__nv_bfloat16, 64>(a, B, s);
  if (dtype == 0 && D == 128) return launch_dq<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch_dq<float, 64>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash attention forward for Hopper (sm_90a): out and per-row logsumexp.
//
// Replaces the JAX package's ops/attention.py `_fwd_kernel` (streaming tier) and
// `_fwd_kernel_resident` (VMEM-resident tier). The two TPU tiers are one
// function split by the TPU's on-chip memory size; here they are one kernel.
//
// What it computes, per (batch, head): O = softmax(scale * Q K^T + mask) V and
// lse = logsumexp of the masked scaled scores, with the mask built from
// absolute indices counted from 0 for both Q and K: causal (col <= row), an
// optional sliding window (col > row - window), and ragged K (col < Lk). A row
// with no valid column gets O = 0 and lse = NEG_INF, as the TPU kernel does.
//
// What bounds it on this card: at prefill lengths the work is O(L^2 D) flops
// against O(L D) bytes, so it is bound by operations. This first version runs
// the two products on the FP32 pipes (FMA from shared memory), not the tensor
// cores, so it sits far below the card's bf16 tensor-core peak; moving the
// products to mma/wgmma is later work.
//
// Design: one CTA of 256 threads per (batch*head, 64-row Q tile). The Q tile
// stays in shared memory; the K/V loop walks 64-row tiles, pruned per Q tile
// to [lo, hi) exactly as the TPU kernel prunes blocks (causal hi, window lo).
// Each thread owns a 4x4 patch of the score tile and a 4 x (D/16) patch of
// the output, with the SAME four rows in both, so the online-softmax state
// (m, l) and the rescale factor stay in registers; row max/sum reduce over the
// 16 lanes that share the rows. Scores, softmax and the output accumulator are
// float32 whatever the storage type. Masked scores are NEG_INF and their p is
// forced to 0 (exp(NEG_INF - NEG_INF) = 1 is the trap for a row whose first
// tiles hold no valid column). Shared memory: Q, K, V tiles in float32 with a
// padded row stride; P reuses the K tile once the scores are computed
// (about 99 KB at D = 128, above the 48 KB default, so the launch raises the
// dynamic shared-memory limit first).

#include "common.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int H, Lq, Lk;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  float scale;
  int causal;
  int window;  // 0 = none
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_kernel(FwdArgs a) {
  constexpr int DS = D + 1;   // padded stride: column reads hit distinct banks
  constexpr int PS = BK + 1;
  constexpr int DT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;           // [BQ][DS]
  float* ks = qs + BQ * DS;   // [BK][DS]
  float* vs = ks + BK * DS;   // [BK][D]
  float* ps = ks;             // [BQ][PS], aliases K after the score pass

  const int tid = threadIdx.x;
  const int tr = tid / 16;    // rows tr + 16 i
  const int tc = tid % 16;    // score cols tc + 16 j, output cols tc + 16 j
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int row = q0 + r;
    qs[r * DS + c] = row < a.Lq ? to_f32(qg[row * a.q_sl + c]) : 0.f;
  }

  const int nk = (a.Lk + BK - 1) / BK;
  const int hi = a.causal ? min(nk, (q0 + BQ + BK - 1) / BK) : nk;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / BK : 0;

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = TONY_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous tile's P.V (or the Q load) is done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int col = k0 + r;
      const bool in = col < a.Lk;
      ks[r * DS + c] = in ? to_f32(kg[col * a.k_sl + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vg[col * a.v_sl + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(tr + 16 * i) * DS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tc + 16 * c) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    // a tile every one of whose entries is visible needs no mask
    const bool full = (!a.causal || k0 + BK - 1 <= q0) &&
                      (a.window <= 0 || k0 >= q0 + BQ - a.window) &&
                      (k0 + BK <= a.Lk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      bool ok[4];
      float mx = TONY_NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tc + 16 * c;
        ok[c] = full || (col < a.Lk && (!a.causal || col <= row) &&
                         (a.window <= 0 || col > row - a.window));
        s[i][c] = ok[c] ? s[i][c] * a.scale : TONY_NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      mx = group_max(mx, 16);
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = ok[c] ? expf(s[i][c] - m_new) : 0.f;  // s now holds p
        rs += s[i][c];
      }
      rs = group_sum(rs, 16);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread has read K before P overwrites it
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) ps[(tr + 16 * i) * PS + tc + 16 * c] = s[i][c];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(tr + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DT; ++c) vv[c] = vs[kk * D + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= a.Lq) continue;
    const float ls = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < DT; ++c)
      og[row * a.o_sl + tc + 16 * c] = from_f32<T>(acc[i][c] / ls);
    if (tc == 0)
      a.lse[static_cast<long long>(bh) * a.Lq + row] =
          l[i] > 0.f ? m[i] + logf(ls) : TONY_NEG_INF;
  }
}

template <typename T, int D>
int launch(const FwdArgs& a, int B, cudaStream_t stream) {
  const int smem = (BQ * (D + 1) + BK * (D + 1) + BK * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Lq + BQ - 1) / BQ, B * a.H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [B, H, L, D] with any strides over (B, H, L) and unit stride
// over D; lse: contiguous [B, H, Lq] float32. dtype: 0 = float32, 1 = bf16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int tony_flash_fwd(const void* q, const void* k, const void* v, void* o,
                              void* lse, int B, int H, int Lq, int Lk, int D,
                              int dtype, long long q_sb, long long q_sh,
                              long long q_sl, long long k_sb, long long k_sh,
                              long long k_sl, long long v_sb, long long v_sh,
                              long long v_sl, long long o_sb, long long o_sh,
                              long long o_sl, float scale, int causal, int window,
                              void* stream) {
  FwdArgs a{q,    k,    v,    o,    static_cast<float*>(lse),
            H,    Lq,   Lk,   q_sb, q_sh,
            q_sl, k_sb, k_sh, k_sl, v_sb,
            v_sh, v_sl, o_sb, o_sh, o_sl,
            scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(a, B, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch<float, 64>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash attention forward for Hopper (sm_90a): out and per-row logsumexp.
//
// Replaces the JAX package's ops/attention.py `_fwd_kernel` (streaming tier) and
// `_fwd_kernel_resident` (VMEM-resident tier). The two TPU tiers are one
// function split by the TPU's on-chip memory size; here they are one kernel
// for each storage type.
//
// What it computes, per (batch, head): O = softmax(scale * Q K^T + mask) V and
// lse = logsumexp of the masked scaled scores, with the mask built from
// absolute indices counted from 0 for both Q and K: causal (col <= row), an
// optional sliding window (col > row - window), and ragged K (col < Lk). A row
// with no valid column gets O = 0 and lse = NEG_INF, as the TPU kernel does.
// Both kernels prune the key tiles of a q tile to [lo, hi) exactly as the TPU
// kernel prunes blocks (causal hi, window lo), skip the mask on tiles every
// entry of which is visible, and select a masked p to 0, never multiply it
// (exp(NEG_INF - NEG_INF) = 1 is the trap for a row whose first tiles hold no
// valid column).
//
// What bounds it on this card: at prefill lengths the work is O(L^2 D) flops
// against O(L D) bytes, so operations: the two products on the tensor cores.
//
// bf16 (flash_fwd_mma_kernel): the products run on the tensor cores, as
// mma.sync m16n8k16 with bf16 operands and float32 accumulators. One CTA of
// 4 warps per (batch*head, 128-row q tile), 32 rows a warp (two m16 slabs).
// Q sits in shared memory for the whole sweep; 32-key K/V tiles come in by
// cp.async, 16 bytes a thread, into two stages, so the next tile loads while
// this one computes (one __syncthreads a tile). Tiles are bf16 with rows
// padded by 8 elements, so every ldmatrix reads 8 rows on 32 distinct banks.
// S = Q K^T: Q as the A operand and K as the col-major B operand, both by
// plain ldmatrix. The online softmax runs on the S accumulator fragment:
// each thread holds rows g and g + 8 of each slab, the row max reduces over
// the quad's 4 lanes, and p = exp2(s * scale * log2(e) - max) is one FFMA and
// one exp2; the row sum stays per lane until the end. Only tiles that cross
// the causal diagonal, the window's edge or the ragged end evaluate the mask
// (a template flag): the interior tiles, most of the causal triangle, skip
// it. P is rounded to bf16 and repacked in registers as the A operand of
// P V (the C fragment of two n8 tiles is the A fragment of one k16 step); V
// is the B operand by ldmatrix.trans. So P never touches shared memory.
// The causal q tiles that sweep the most keys start first, and a warp whose
// 32 rows see no key of a tile skips it.
// Registers bound the design: at D = 128 the O accumulator is 128 floats a
// thread and the S fragment 32 (64 with 64-key tiles, which spill 152 bytes
// and run 13% slower on the H100). The kernel sits at the 255 limit, two
// CTAs an SM, with 36 bytes of spill at D = 128 and none at D = 64; the
// variant without the spill (the K/V sources recomputed at each prefetch)
// is slower on the H100, so the spill stays. PERF.md has ptxas's report and
// each alternative's time (tony_tpu_torch/tools/kernel_variants.py).
// Shared memory: 70 KB at D = 128 (Q 35 KB, two K/V stages 35 KB).
// D = 32 (a small draft model's heads) is the same kernel: a bf16 row is
// 64 bytes (4 16-byte chunks, so a 32-row K/V tile is one cp.async a
// thread), the padded row stride of 80 bytes keeps ldmatrix's 8 rows on
// distinct banks, Q K^T is 2 k16 steps and the O accumulator 16 floats.
//
// float32 (flash_fwd_kernel): the products on the FP32 pipes (tensor-core
// TF32 would round the operands beyond the float32 tolerance). One CTA of 256
// threads per (batch*head, 64-row Q tile); each thread owns a 4x4 patch of
// the score tile and a 4 x (D/16) patch of the output, with the same four
// rows in both, so the online-softmax state stays in registers; row max/sum
// reduce over the 16 lanes that share the rows. Q, K, V tiles sit in shared
// memory in float32 with a padded row stride; P reuses the K tile once the
// scores are computed (about 99 KB at D = 128); below D = 64 the K region
// is sized for P, which is then the larger of the two.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;

// floats of the f32 kernel's K region: the K tile [BK][D + 1], which P
// [BQ][BK + 1] reuses after the scores (P is the larger below D = 64)
template <int D>
__host__ __device__ constexpr int k_region() {
  return BK * (D + 1) > BQ * (BK + 1) ? BK * (D + 1) : BQ * (BK + 1);
}

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
  float* vs = ks + k_region<D>();  // [BK][D]
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
  const int smem = (BQ * (D + 1) + k_region<D>() + BK * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.Lq + BQ - 1) / BQ, B * a.H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 on the tensor cores (see the note at the top)

constexpr int MQ = 128;               // q rows a CTA
constexpr int MK = 32;                // keys a K/V tile
constexpr int MTHREADS = 128;         // 4 warps, 32 q rows each
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int mma_smem() { return (MQ + 4 * MK) * (D + 8) * 2; }

// One online-softmax step on a warp's S fragment: this lane holds, per slab
// sl, rows row0 + 16 sl and row0 + 16 sl + 8 at columns col0 + 8 n + {0, 1}.
// The running max m is in score units; p = exp2(s * sl2 - m * sl2) is one
// FFMA and one exp2. MASK: entries a row does not see are set to NEG_INF and
// their p is selected to 0; a tile with none (the interior of the causal
// triangle) skips that work. The lane's part of the row sum accumulates in l;
// the quad sums it once, at the end. On return s holds p.
template <bool MASK, int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[2][NS][4], float (&m)[2][2],
                                             float (&l)[2][2], float (&o)[2][NO][4], float sl2,
                                             int row0, int col0, const FwdArgs& a) {
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + sl * 16 + 8 * hf;
      float mx = TONY_NEG_INF;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[sl][n][2 * hf + e];
          if (MASK) {
            const int col = col0 + n * 8 + e;
            const bool ok = col < a.Lk && (!a.causal || col <= row) &&
                            (a.window <= 0 || col > row - a.window);
            x = ok ? x : TONY_NEG_INF;
          }
          mx = fmaxf(mx, x);
        }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[sl][hf], mx);
      const float corr = exp2f((m[sl][hf] - m_new) * sl2);
      const float shift = m_new * sl2;
      m[sl][hf] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[sl][n][2 * hf + e];  // becomes p
          const float p = exp2f(fmaf(x, sl2, -shift));
          x = MASK && x == TONY_NEG_INF ? 0.f : p;
          rs += x;
        }
      l[sl][hf] = l[sl][hf] * corr + rs;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[sl][n][2 * hf] *= corr;
        o[sl][n][2 * hf + 1] *= corr;
      }
    }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS, 2) flash_fwd_mma_kernel(FwdArgs a) {
  constexpr int DP = D + 8;   // padded row stride of every tile (elements)
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int NS = MK / 8;  // n8 tiles of a score row
  constexpr int NO = D / 8;   // n8 tiles of an output row
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [MQ][DP]
  __nv_bfloat16* ks = qs + MQ * DP;                                 // [2][MK][DP]
  __nv_bfloat16* vs = ks + 2 * MK * DP;                             // [2][MK][DP]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last q tiles sweep the most key tiles, so they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MQ;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int nk = (a.Lk + MK - 1) / MK;
  const int hi = a.causal ? min(nk, (q0 + MQ + MK - 1) / MK) : nk;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / MK : 0;

  cp_tile<MQ, D, MTHREADS>(qs, qg, a.q_sl, q0, a.Lq);
  if (lo < hi) {
    cp_tile<MK, D, MTHREADS>(ks, kg, a.k_sl, lo * MK, a.Lk);
    cp_tile<MK, D, MTHREADS>(vs, vg, a.v_sl, lo * MK, a.Lk);
  }
  cp_async_commit();

  const float sl2 = a.scale * LOG2E;
  const int w0 = q0 + warp * 32;  // the warp's first q row
  // per slab and row half (rows g, g + 8): running max in score units, and
  // this lane's part of the row sum (the quad sums it once, at the end)
  float m[2][2], l[2][2], o[2][NO][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[sl][hf] = TONY_NEG_INF;
      l[sl][hf] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[sl][n][e] = 0.f;
  }
  // this lane's ldmatrix row addresses inside the tiles (elements)
  const int qa_off = (warp * 32 + a_row(lane)) * DP + a_col(lane);
  const int kb_off = b_row(lane) * DP + b_col(lane);
  const int vb_off = bt_row(lane) * DP + bt_col(lane);

  for (int j = lo; j < hi; ++j) {
    const int st = (j - lo) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile j has landed; every warp is done with stage st ^ 1
    if (j + 1 < hi) {
      cp_tile<MK, D, MTHREADS>(ks + (st ^ 1) * MK * DP, kg, a.k_sl, (j + 1) * MK, a.Lk);
      cp_tile<MK, D, MTHREADS>(vs + (st ^ 1) * MK * DP, vg, a.v_sl, (j + 1) * MK, a.Lk);
    }
    cp_async_commit();

    const int k0 = j * MK;
    // a warp none of whose rows sees a key of this tile skips it
    if (w0 >= a.Lq || (a.causal && k0 > w0 + 31) ||
        (a.window > 0 && k0 + MK - 1 <= w0 - a.window))
      continue;
    // a tile every one of whose entries the warp's rows see needs no mask
    const bool full = (!a.causal || k0 + MK - 1 <= w0) &&
                      (a.window <= 0 || k0 > w0 + 31 - a.window) && (k0 + MK <= a.Lk);
    const uint32_t qbase = opaque(smem_u32(qs));
    const uint32_t kbase = opaque(smem_u32(ks + st * MK * DP));
    const uint32_t vbase = opaque(smem_u32(vs + st * MK * DP));

    // S = Q K^T for the warp's 32 rows and the tile's 64 keys
    float s[2][NS][4];
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[sl][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[2][4];
      ldmatrix_x4(qa[0], qbase + (qa_off + kk * 16) * 2);
      ldmatrix_x4(qa[1], qbase + (qa_off + 16 * DP + kk * 16) * 2);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kbase + (kb_off + np * 16 * DP + kk * 16) * 2);
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          mma_bf16(s[sl][2 * np], qa[sl], kb[0], kb[1]);
          mma_bf16(s[sl][2 * np + 1], qa[sl], kb[2], kb[3]);
        }
      }
    }

    // online softmax on the fragment (see softmax_step); tiles with masked
    // entries take the masked variant
    if (full)
      softmax_step<false>(s, m, l, o, sl2, w0 + g, k0 + 2 * t, a);
    else
      softmax_step<true>(s, m, l, o, sl2, w0 + g, k0 + 2 * t, a);

    // O += P V: P from registers (bf16), V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t pa[2][4];
      c_to_a(pa[0], s[0][2 * kk], s[0][2 * kk + 1]);
      c_to_a(pa[1], s[1][2 * kk], s[1][2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vbase + (vb_off + kk * 16 * DP + np * 16) * 2);
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          mma_bf16(o[sl][2 * np], pa[sl], vb[0], vb[1]);
          mma_bf16(o[sl][2 * np + 1], pa[sl], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lsum = quad_sum(l[sl][hf]);
      const int row = w0 + sl * 16 + g + 8 * hf;
      if (row >= a.Lq) continue;
      const float inv = lsum > 0.f ? 1.f / lsum : 1.f;
      __nv_bfloat16* orow = og + row * a.o_sl + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(o[sl][n][2 * hf] * inv, o[sl][n][2 * hf + 1] * inv);
      if (t == 0)
        a.lse[static_cast<long long>(bh) * a.Lq + row] =
            lsum > 0.f ? m[sl][hf] * a.scale + logf(lsum) : TONY_NEG_INF;
    }
}

template <int D>
int launch_mma(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * a.H, (a.Lq + MQ - 1) / MQ);
  flash_fwd_mma_kernel<D><<<grid, MTHREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [B, H, L, D] with any strides over (B, H, L) and unit stride
// over D; lse: contiguous [B, H, Lq] float32. dtype: 0 = float32 (the FP32
// kernel), 1 = bf16 (the tensor-core kernel, which also needs every pointer
// and every (B, H, L) stride 16-byte aligned). Returns the cudaError_t of the
// launch (0 on success).
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
  if (dtype == 1) {
    const long long st[12] = {q_sb, q_sh, q_sl, k_sb, k_sh, k_sl,
                              v_sb, v_sh, v_sl, o_sb, o_sh, o_sl};
    const void* ptrs[4] = {q, k, v, o};
    if (!aligned16(ptrs, 4, st, 12)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (D == 128) return launch_mma<128>(a, B, s);
    if (D == 64) return launch_mma<64>(a, B, s);
    if (D == 32) return launch_mma<32>(a, B, s);
  }
  if (dtype == 0 && D == 128) return launch<float, 128>(a, B, s);
  if (dtype == 0 && D == 64) return launch<float, 64>(a, B, s);
  if (dtype == 0 && D == 32) return launch<float, 32>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

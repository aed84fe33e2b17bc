// Split-KV flash decode for Hopper (sm_90a): attention of one new token per
// sequence against the KV cache.
//
// Replaces the JAX package's ops/decode_attention.py `_decode_kernel` (and its
// no-scale variant `_kernel_no_scale`).
//
// What it computes: for each (batch, kv head) and each of the `rep` query
// heads folded onto that kv head (GQA), softmax(scale * q K^T) V over the cache
// positions p with p <= length (and p > length - window with a sliding
// window). int8 caches carry per-position scales: K's scale multiplies the
// score after the dot product, V's scale multiplies p for the value sum only,
// never the softmax denominator (decode_attention.py:81-93). The sum of p V
// is float32.
//
// What bounds it on this card: bytes. Each step reads every valid cache
// position once (2 * D * elem bytes per position per kv head) and does about
// 4 * rep * D flops per position, far below the card's 295 flops per byte
// balance point. So the design is about reading the cache at full rate.
//
// Design: the TPU grid (B, kvH, blocks) walks a head's blocks in order on one
// core; at the flagship's batch 8 that is only 64 (b, kv head) pairs, half of
// the 132 SMs. So pass 1 splits the valid range [lo, length] into chunks, one
// CTA per (chunk, b * kvH), and reads only valid positions (the masked tail of
// the buffer is never read). Each CTA writes an unnormalised partial
// (m, l, acc); pass 2 (one CTA per (b, kv head)) combines the partials with
// weights exp(m_c - M), so an empty partial (m = NEG_INF, l = 0) weighs 0.
// In pass 1 each warp takes positions in turn; a lane reads D/32 contiguous
// elements of the K row (one vector load), the dot product reduces across the
// warp, and the scores of the chunk sit in shared memory. The softmax of the
// chunk runs per query row, then each thread accumulates p * V for its own
// output columns. The layer index of the full [Ly, B, kvH, M, D] stack is an
// offset on the base pointer (taken by the caller), so no layer is copied.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXREP = 8;

struct DecodeArgs {
  const void* q;        // [B, kvH, rep, D] contiguous
  const void* k;        // cache layer base, [B, kvH, M, D]
  const void* v;
  const __nv_bfloat16* ks;  // [B, kvH, M] scales, or null
  const __nv_bfloat16* vs;
  float* part_o;        // [B*kvH, n_chunks, rep, D]
  float* part_m;        // [B*kvH, n_chunks, rep]
  float* part_l;
  int kvH, rep, lo, length, chunk, n_chunks;
  long long c_sb, c_sh, c_sm;  // cache strides (elements); D stride 1
  long long s_sb, s_sh;        // scale strides; M stride 1
  float scale;
};

template <typename TC, int VPT>
struct alignas(sizeof(TC) * VPT) Vec {
  TC x[VPT];
};

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(THREADS) decode_partial_kernel(DecodeArgs a) {
  constexpr int VPT = D / 32;  // K elements per lane
  extern __shared__ float sc[];  // [rep][chunk] scores, then p
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.kvH, h = bh % a.kvH;
  const int start = a.lo + c * a.chunk;
  const int n = min(a.chunk, a.length + 1 - start);

  const TQ* qg = static_cast<const TQ*>(a.q) + static_cast<long long>(bh) * a.rep * D;
  const TC* kg = static_cast<const TC*>(a.k) + b * a.c_sb + h * a.c_sh;
  const TC* vg = static_cast<const TC*>(a.v) + b * a.c_sb + h * a.c_sh;
  const __nv_bfloat16* ksg = a.ks ? a.ks + b * a.s_sb + h * a.s_sh : nullptr;
  const __nv_bfloat16* vsg = a.vs ? a.vs + b * a.s_sb + h * a.s_sh : nullptr;

  float qr[MAXREP][VPT];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int e = 0; e < VPT; ++e)
      qr[r][e] = r < a.rep ? to_f32(qg[r * D + lane * VPT + e]) : 0.f;

  // scores of this chunk: s = (q . k) * scale (* k_scale)
  for (int i = warp; i < n; i += WARPS) {
    const int pos = start + i;
    const Vec<TC, VPT> kv =
        *reinterpret_cast<const Vec<TC, VPT>*>(kg + pos * a.c_sm + lane * VPT);
    const float kscale = ksg ? __bfloat162float(ksg[pos]) : 1.f;
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r >= a.rep) break;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VPT; ++e) dot = fmaf(qr[r][e], to_f32(kv.x[e]), dot);
      dot = group_sum(dot, 32);
      if (lane == 0) sc[r * a.chunk + i] = dot * a.scale * kscale;
    }
  }
  __syncthreads();

  // softmax of the chunk per query row (one warp per row); the denominator
  // sums the raw p, then p takes V's scale for the value sum
  float* pm = a.part_m + (static_cast<long long>(bh) * a.n_chunks + c) * a.rep;
  float* pl = a.part_l + (static_cast<long long>(bh) * a.n_chunks + c) * a.rep;
  for (int r = warp; r < a.rep; r += WARPS) {
    float* row = sc + r * a.chunk;
    float mx = TONY_NEG_INF;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, row[i]);
    mx = group_max(mx, 32);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(row[i] - mx);
      sum += p;
      row[i] = vsg ? p * __bfloat162float(vsg[start + i]) : p;
    }
    sum = group_sum(sum, 32);
    if (lane == 0) {
      pm[r] = mx;
      pl[r] = sum;
    }
  }
  __syncthreads();

  // acc[r][d] = sum_i p[r][i] * v[i][d]; thread = (column d, position phase g)
  constexpr int G = THREADS / D;
  const int d = tid % D, g = tid / D;
  float acc[MAXREP];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int i = g; i < n; i += G) {
    const float vv = to_f32(vg[(start + i) * a.c_sm + d]);
#pragma unroll
    for (int r = 0; r < MAXREP; ++r)
      if (r < a.rep) acc[r] = fmaf(sc[r * a.chunk + i], vv, acc[r]);
  }
  float* po = a.part_o + (static_cast<long long>(bh) * a.n_chunks + c) * a.rep * D;
  if (G == 1) {
#pragma unroll
    for (int r = 0; r < MAXREP; ++r)
      if (r < a.rep) po[r * D + d] = acc[r];
  } else {
    __syncthreads();  // every thread is done reading p; reuse sc for the sum
#pragma unroll
    for (int r = 0; r < MAXREP; ++r)
      if (r < a.rep) sc[(g * a.rep + r) * D + d] = acc[r];
    __syncthreads();
    if (g == 0) {
      for (int r = 0; r < a.rep; ++r) {
        float t = 0.f;
        for (int gg = 0; gg < G; ++gg) t += sc[(gg * a.rep + r) * D + d];
        po[r * D + d] = t;
      }
    }
  }
}

template <typename TQ, int D>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const float* part_o, const float* part_m, const float* part_l, void* out,
    int rep, int n_chunks) {
  const int bh = blockIdx.x;
  TQ* og = static_cast<TQ*>(out) + static_cast<long long>(bh) * rep * D;
  for (int e = threadIdx.x; e < rep * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const long long base = static_cast<long long>(bh) * n_chunks;
    float mx = TONY_NEG_INF;
    for (int c = 0; c < n_chunks; ++c) mx = fmaxf(mx, part_m[(base + c) * rep + r]);
    float l = 0.f, o = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float l_c = part_l[(base + c) * rep + r];
      // an empty partial has l_c = 0 and acc 0: it adds nothing even when
      // its weight is exp(0) = 1 (every partial empty)
      const float w = expf(part_m[(base + c) * rep + r] - mx);
      l += w * l_c;
      o += w * part_o[((base + c) * rep + r) * D + d];
    }
    og[r * D + d] = from_f32<TQ>(o / (l > 0.f ? l : 1.f));
  }
}

template <typename TQ, typename TC, int D>
int launch_partial(const DecodeArgs& a, int B, cudaStream_t stream) {
  const int smem_scores = a.rep * a.chunk;
  const int smem_sum = (THREADS / D) * a.rep * D;
  const int smem = (smem_scores > smem_sum ? smem_scores : smem_sum) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(a.n_chunks, B * a.kvH);
  decode_partial_kernel<TQ, TC, D><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, int D>
int launch_combine(const float* part_o, const float* part_m, const float* part_l,
                   void* out, int BH, int rep, int n_chunks, cudaStream_t stream) {
  decode_combine_kernel<TQ, D><<<BH, THREADS, 0, stream>>>(part_o, part_m, part_l,
                                                           out, rep, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pass 1. q: [B, kvH, rep, D] contiguous; k, v: the cache of one layer,
// [B, kvH, M, D] with unit D stride; ks, vs: [B, kvH, M] bf16 scales with unit
// M stride, or null for a native cache. Positions [lo, length] are read, in
// n_chunks chunks of `chunk`; each chunk writes its unnormalised partial to
// part_o [B*kvH, n_chunks, rep, D] and part_m, part_l [B*kvH, n_chunks, rep],
// all float32 and contiguous. q_dtype: 0 = float32, 1 = bf16; c_dtype:
// 0 = float32, 1 = bf16, 2 = int8. Returns the launch's cudaError_t.
extern "C" int tony_flash_decode_partial(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    void* part_o, void* part_m, void* part_l, int B, int kvH, int rep, int D,
    int q_dtype, int c_dtype, int lo, int length, int chunk, int n_chunks,
    long long c_sb, long long c_sh, long long c_sm, long long s_sb, long long s_sh,
    float scale, void* stream) {
  if (rep < 1 || rep > MAXREP) return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, k, v,
               static_cast<const __nv_bfloat16*>(ks),
               static_cast<const __nv_bfloat16*>(vs),
               static_cast<float*>(part_o), static_cast<float*>(part_m),
               static_cast<float*>(part_l),
               kvH, rep, lo, length, chunk, n_chunks,
               c_sb, c_sh, c_sm, s_sb, s_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TONY_DECODE_CASE(QD, CD, DIM, TQ, TC) \
  if (q_dtype == QD && c_dtype == CD && D == DIM) return launch_partial<TQ, TC, DIM>(a, B, s);
  TONY_DECODE_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  TONY_DECODE_CASE(1, 2, 128, __nv_bfloat16, int8_t)
  TONY_DECODE_CASE(0, 0, 128, float, float)
  TONY_DECODE_CASE(0, 2, 128, float, int8_t)
  TONY_DECODE_CASE(1, 1, 64, __nv_bfloat16, __nv_bfloat16)
  TONY_DECODE_CASE(1, 2, 64, __nv_bfloat16, int8_t)
  TONY_DECODE_CASE(0, 0, 64, float, float)
  TONY_DECODE_CASE(0, 2, 64, float, int8_t)
#undef TONY_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Pass 2: out [BH, rep, D] (q's dtype) = the lse-weighted sum of the BH rows'
// n_chunks partials, normalised. Returns the launch's cudaError_t.
extern "C" int tony_flash_decode_combine(const void* part_o, const void* part_m,
                                         const void* part_l, void* out, int BH,
                                         int rep, int D, int q_dtype, int n_chunks,
                                         void* stream) {
  if (rep < 1 || rep > MAXREP) return static_cast<int>(cudaErrorInvalidValue);
  const float* po = static_cast<const float*>(part_o);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1 && D == 128)
    return launch_combine<__nv_bfloat16, 128>(po, pm, pl, out, BH, rep, n_chunks, s);
  if (q_dtype == 1 && D == 64)
    return launch_combine<__nv_bfloat16, 64>(po, pm, pl, out, BH, rep, n_chunks, s);
  if (q_dtype == 0 && D == 128)
    return launch_combine<float, 128>(po, pm, pl, out, BH, rep, n_chunks, s);
  if (q_dtype == 0 && D == 64)
    return launch_combine<float, 64>(po, pm, pl, out, BH, rep, n_chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Flash decode for Hopper (sm_90a): attention of one new token per sequence
// against the KV cache, in one launch.
//
// Replaces the JAX package's ops/decode_attention.py `_decode_kernel` (and its
// no-scale variant `_kernel_no_scale`).
//
// What it computes: for each (batch, kv head) and each of the `rep` query
// heads folded onto that kv head (GQA), softmax(scale * q K^T) V over the cache
// positions p with lo <= p <= length (lo = length - window + 1 with a sliding
// window, else 0). int8 caches carry per-position scales: K's scale multiplies
// the score after the dot product, V's scale multiplies p for the value sum
// only, never the softmax denominator (decode_attention.py:81-93). The sum of
// p V keeps p in float32 (decode_attention.py:100-105), so it runs on the FMA
// pipes.
//
// What bounds it on this card: bytes. Each step reads every valid cache
// position once (2 * D * elem bytes per position per kv head) and does about
// 4 * rep * D flops per position, far below the card's 295 flops per byte.
// Reading HBM at full rate needs about 18 KB of reads in flight on every SM
// (3.35 TB/s times about 0.7 us of latency, over 132 SMs), K and V streamed
// together, and the bytes spread evenly over the SMs.
//
// Design:
// - Split: the valid range [lo, length] of each (b, kv head) is cut into
//   n_chunks chunks, one CTA each (grid n_chunks x B*kvH), two CTAs an SM up
//   to rep 2; the wrapper picks the split that evens the positions per SM
//   and fills one wave of CTAs (decode_attention.py `_split`), from the
//   tile and CTAs an SM that tony_flash_decode_geometry reports.
// - Ring: a CTA walks its chunk in tiles of TILE_BYTES of K and as many of V
//   (T positions: one contiguous run of the cache) through STAGES stages of
//   shared memory. Every thread copies its 16-byte pieces of the next tile
//   with cp.async while the block computes on the current one (one block
//   barrier a tile), so an SM keeps two CTAs' 32 KB tiles, 64 KB, in
//   flight: several times the 18 KB latency asks for. Only valid positions are
//   copied (the last tile of a chunk is cut to the positions left), so a
//   window's unaligned lo and a tail that ends mid-tile need no mask of the
//   copy. int8 scales (2 bytes a position, not 16-byte aligned at an
//   arbitrary lo) are read with plain loads, which thread 0's L2 prefetch at
//   issue time keeps short. The layer index of the full [Ly, B, kvH, M, D]
//   stack is an offset on the base pointer (taken by the caller), so no
//   layer is copied.
// - One pass, online softmax: a row of D elements is read by G = D / 8 lanes,
//   8 elements each (16 bytes of bf16), so a "group" of G lanes takes one
//   position at a time. Each group keeps its own float32 (m, l, acc) over the
//   positions it takes (t = group, group + NG, ... of every tile), updated
//   once per batch of up to PB positions; no score buffer, so the chunk's
//   length is unbounded. At the end the groups' states are merged in shared
//   memory into the chunk's partial (m, l, acc), which goes to the float32
//   scratch.
// - Combine in the same launch: after its partial is written, each CTA bumps
//   its (b, kv head)'s arrival counter; the last to arrive merges the
//   partials in chunk order (so the result does not depend on which CTA was
//   last), writes the output and resets the counter to 0 for the next launch.
// - Head dims 32, 64 and 128: at D = 32 a row is 4 lanes (64 groups a CTA),
//   a bf16 tile 256 positions, and the groups' merge (70 KB) is larger than
//   the ring (64 KB), so the launch asks for the merge's shared memory.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int TILE_BYTES = 16384;  // of K per stage, and as many of V
constexpr int PB = 4;              // positions a group takes per softmax update
constexpr int MAXREP = 8;

// ask L2 for the 128-byte line that holds p
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

struct DecodeArgs {
  const void* q;                 // [B, kvH, rep, D] contiguous
  const void* k;                 // cache layer base, [B, kvH, M, D], rows contiguous
  const void* v;
  const __nv_bfloat16* ks;       // [B, kvH, M] scales, or null
  const __nv_bfloat16* vs;
  void* out;                     // [B*kvH, rep, D] in q's dtype
  float* part_o;                 // [B*kvH, n_chunks, rep, D]
  float* part_m;                 // [B*kvH, n_chunks, rep]
  float* part_l;
  int* counters;                 // [B*kvH] arrivals, 0 between launches
  int kvH, rep, lo, length, chunk, n_chunks;
  long long c_sb, c_sh;          // cache strides (elements); M stride D, D stride 1
  long long s_sb, s_sh;          // scale strides; M stride 1
  float scale;
};

// The 8 elements lane `li` of a group holds: 16 contiguous bytes of a bf16
// row, 8 of an int8 row, and for float32 two 16-byte pieces, one in each
// half of the row (so every quarter-warp reads 128 contiguous bytes).
template <typename TC, int D>
__device__ __forceinline__ int col_of(int li, int e) {
  if constexpr (sizeof(TC) == 4) return (e / 4) * (D / 2) + li * 4 + e % 4;
  return li * 8 + e;
}

template <typename TC, int D>
__device__ __forceinline__ void load8(const TC* row, int li, float (&x)[8]) {
  if constexpr (sizeof(TC) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + li * 4);
    const float4 b = *reinterpret_cast<const float4*>(row + D / 2 + li * 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (sizeof(TC) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + li * 8);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is a 16-bit shift
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    // int8 -> f32 without the quarter-rate I2F: the byte, biased to
    // unsigned (xor 0x80), becomes the low mantissa byte of 2^23 (a byte
    // permute), and 2^23 + 128 comes off exactly
    const uint2 u = *reinterpret_cast<const uint2*>(row + li * 8);
    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4b000000u, 0x7440 + i % 4)) - 8388736.f;
  }
}

// Launch-wide constants of one instantiation.
template <typename TC, int D>
struct Shape {
  static constexpr int G = D / 8;                 // lanes per cache row
  static constexpr int NG = THREADS / G;          // groups per CTA
  static constexpr int T = TILE_BYTES / (D * static_cast<int>(sizeof(TC)));  // positions a tile
  static constexpr int PPG = T / NG;              // positions a group takes a tile
  static constexpr int NB = PPG < PB ? PPG : PB;  // positions per softmax update
  static_assert(PPG >= 1 && PPG % NB == 0, "tile too small for the block");
  static constexpr int RING = 2 * STAGES * TILE_BYTES;
  // the groups' states after the sweep: o [NG][MAXREP][D], m, l, w [NG][MAXREP]
  static constexpr int MERGE = (NG * MAXREP * D + 3 * NG * MAXREP) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

// CTAs an SM holds at once: two up to rep 2 (at most 128 registers a
// thread), so that one CTA's latency hides behind the other's work
template <int REP>
constexpr int ctas_per_sm() { return REP <= 2 ? 2 : 1; }

template <typename TQ, typename TC, int D, int REP>
__global__ void __launch_bounds__(THREADS, ctas_per_sm<REP>()) flash_decode_kernel(DecodeArgs a) {
  using S = Shape<TC, D>;
  constexpr int G = S::G, NG = S::NG, T = S::T, PPG = S::PPG, NB = S::NB;
  constexpr bool SCALED = sizeof(TC) == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  TC* ktiles = reinterpret_cast<TC*>(smem);        // [STAGES][T][D]
  TC* vtiles = ktiles + STAGES * T * D;
  __shared__ int last;  // this CTA is the last of its (b, kv head)

  const int tid = threadIdx.x, warp = tid / 32;
  const int gr = tid / G, li = tid % G;
  const int gr0 = warp * 32 / G;  // the warp's first group
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / a.kvH, h = bh % a.kvH;
  const int start = a.lo + c * a.chunk;
  const int n = max(0, min(a.chunk, a.length + 1 - start));
  const int ntiles = (n + T - 1) / T;
  const TC* kg = static_cast<const TC*>(a.k) + b * a.c_sb + h * a.c_sh +
                 static_cast<long long>(start) * D;
  const TC* vg = static_cast<const TC*>(a.v) + b * a.c_sb + h * a.c_sh +
                 static_cast<long long>(start) * D;
  const __nv_bfloat16* ksg = SCALED ? a.ks + b * a.s_sb + h * a.s_sh + start : nullptr;
  const __nv_bfloat16* vsg = SCALED ? a.vs + b * a.s_sb + h * a.s_sh + start : nullptr;

  // tile j: positions [j * T, j * T + cnt) of the chunk into stage j % STAGES
  auto issue = [&](int j) {
    const int st = j % STAGES, cnt = min(T, n - j * T);
    const uint32_t bytes = cnt * D * sizeof(TC);
    TC* kd = ktiles + st * T * D;
    TC* vd = vtiles + st * T * D;
    const TC* ksrc = kg + static_cast<long long>(j) * T * D;
    const TC* vsrc = vg + static_cast<long long>(j) * T * D;
    for (int i = tid; i < static_cast<int>(bytes / 16); i += THREADS) {
      cp_async16(smem_u32(kd) + 16 * i, reinterpret_cast<const char*>(ksrc) + 16 * i, 16);
      cp_async16(smem_u32(vd) + 16 * i, reinterpret_cast<const char*>(vsrc) + 16 * i, 16);
    }
    if (SCALED && tid == 0)
      for (int p = 0; p < cnt + 63; p += 64) {  // 64 scales a line; the last may straddle
        prefetch_l2(ksg + j * T + min(p, cnt - 1));
        prefetch_l2(vsg + j * T + min(p, cnt - 1));
      }
  };

  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    cp_async_commit();
  }

  // this lane's 8 columns of each query row (rows past rep are 0)
  const TQ* qg = static_cast<const TQ*>(a.q) + static_cast<long long>(bh) * a.rep * D;
  float q[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[r][e] = r < a.rep ? to_f32(qg[r * D + col_of<TC, D>(li, e)]) * a.scale : 0.f;

  float m[REP], l[REP], acc[REP][8];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = TONY_NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    const int cnt = min(T, n - j * T);
    float ksc[PPG], vsc[PPG];
    if constexpr (SCALED) {
#pragma unroll
      for (int i = 0; i < PPG; ++i) {
        const int t = min(gr + i * NG, cnt - 1);
        ksc[i] = __bfloat162float(ksg[j * T + t]);
        vsc[i] = __bfloat162float(vsg[j * T + t]);
      }
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j is in for all; every warp is done with tile j - 1
    if (j + STAGES - 1 < ntiles) issue(j + STAGES - 1);
    cp_async_commit();
    const TC* kt = ktiles + st * T * D;
    const TC* vt = vtiles + st * T * D;

#pragma unroll
    for (int i0 = 0; i0 < PPG; i0 += NB) {
      if (gr0 + i0 * NG >= cnt) break;  // warp-uniform: no group of the warp has a position left
      float s[NB][REP];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int t = min(gr + (i0 + i) * NG, cnt - 1);
        float x[8];
        load8<TC, D>(kt + t * D, li, x);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(q[r][e], x[e], dot);
          s[i][r] = dot;
        }
      }
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int r = 0; r < REP; ++r) s[i][r] = group_sum(s[i][r], G);
      float p[NB][REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const bool ok = gr + (i0 + i) * NG < cnt;
          if constexpr (SCALED) s[i][r] *= ksc[i0 + i];
          s[i][r] = ok ? s[i][r] : TONY_NEG_INF;
          mx = fmaxf(mx, s[i][r]);
        }
        const float corr = expf(m[r] - mx);
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const bool ok = gr + (i0 + i) * NG < cnt;
          const float pi = ok ? expf(s[i][r] - mx) : 0.f;
          l[r] += pi;
          if constexpr (SCALED) p[i][r] = pi * vsc[i0 + i];
          else p[i][r] = pi;
        }
        m[r] = mx;
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        if (gr + (i0 + i) * NG >= cnt) break;  // p is 0, but stale V may be NaN
        float x[8];
        load8<TC, D>(vt + (gr + (i0 + i) * NG) * D, li, x);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(p[i][r], x[e], acc[r][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the groups' states into the chunk's partial; the ring is free now
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem);  // [NG][MAXREP][D]
  float* mm = mo + NG * MAXREP * D;             // [NG][MAXREP]
  float* ml = mm + NG * MAXREP;
  float* mw = ml + NG * MAXREP;
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < 8; ++e) mo[(gr * MAXREP + r) * D + col_of<TC, D>(li, e)] = acc[r][e];
    if (li == 0) {
      mm[gr * MAXREP + r] = m[r];
      ml[gr * MAXREP + r] = l[r];
    }
  }
  __syncthreads();
  const long long prow = (static_cast<long long>(bh) * a.n_chunks + c) * a.rep;
  if (tid < a.rep) {
    // an empty group (m = NEG_INF, l = 0, acc = 0) weighs 0, or adds 0 when
    // the whole chunk is empty
    float mx = TONY_NEG_INF;
    for (int g = 0; g < NG; ++g) mx = fmaxf(mx, mm[g * MAXREP + tid]);
    float sum = 0.f;
    for (int g = 0; g < NG; ++g) {
      const float w = expf(mm[g * MAXREP + tid] - mx);
      mw[g * MAXREP + tid] = w;
      sum += w * ml[g * MAXREP + tid];
    }
    a.part_m[prow + tid] = mx;
    a.part_l[prow + tid] = sum;
  }
  __syncthreads();
  for (int e = tid; e < a.rep * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float o = 0.f;
    for (int g = 0; g < NG; ++g) o = fmaf(mw[g * MAXREP + r], mo[(g * MAXREP + r) * D + d], o);
    a.part_o[prow * D + e] = o;
  }

  // the last CTA of this (b, kv head) to finish combines the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counters[bh], 1) == a.n_chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long base = static_cast<long long>(bh) * a.n_chunks;
  TQ* og = static_cast<TQ*>(a.out) + static_cast<long long>(bh) * a.rep * D;
  for (int e = tid; e < a.rep * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float mx = TONY_NEG_INF;
    for (int cc = 0; cc < a.n_chunks; ++cc)
      mx = fmaxf(mx, __ldcg(a.part_m + (base + cc) * a.rep + r));
    float lsum = 0.f, o = 0.f;
    for (int cc = 0; cc < a.n_chunks; ++cc) {
      const float w = expf(__ldcg(a.part_m + (base + cc) * a.rep + r) - mx);
      lsum += w * __ldcg(a.part_l + (base + cc) * a.rep + r);
      o += w * __ldcg(a.part_o + ((base + cc) * a.rep + r) * D + d);
    }
    og[r * D + d] = from_f32<TQ>(o / (lsum > 0.f ? lsum : 1.f));
  }
  if (tid == 0) a.counters[bh] = 0;
}

template <typename TQ, typename TC, int D, int REP>
int launch(const DecodeArgs& a, int B, cudaStream_t stream) {
  auto kern = flash_decode_kernel<TQ, TC, D, REP>;
  constexpr int smem = Shape<TC, D>::SMEM;
  static bool attr_set = false;  // dynamic shared memory above 48 KB, once
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kern<<<dim3(a.n_chunks, B * a.kvH), THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TC, int D>
int launch_rep(const DecodeArgs& a, int B, cudaStream_t stream) {
  if (a.rep == 1) return launch<TQ, TC, D, 1>(a, B, stream);
  if (a.rep == 2) return launch<TQ, TC, D, 2>(a, B, stream);
  if (a.rep <= 4) return launch<TQ, TC, D, 4>(a, B, stream);
  return launch<TQ, TC, D, 8>(a, B, stream);
}

}  // namespace

// q: [B, kvH, rep, D] contiguous; k, v: the cache of one layer, [B, kvH, M,
// D] with rows of D contiguous elements one after another (M stride D) and
// 16-byte-aligned bases; ks, vs: [B, kvH, M] bf16 scales with unit M stride,
// or null for a native cache. Positions [lo, length] are read, in n_chunks
// chunks of `chunk`; each chunk's unnormalised partial goes to part_o [B*kvH,
// n_chunks, rep, D] and part_m, part_l [B*kvH, n_chunks, rep] (float32,
// contiguous), and out [B*kvH, rep, D] (q's dtype) gets their combine.
// counters: B*kvH ints, all 0, left 0. q_dtype: 0 = float32, 1 = bf16;
// c_dtype: 0 = float32, 1 = bf16, 2 = int8. Returns the launch's cudaError_t.
extern "C" int tony_flash_decode(
    const void* q, const void* k, const void* v, const void* ks, const void* vs, void* out,
    void* part_o, void* part_m, void* part_l, void* counters, int B, int kvH, int rep, int D,
    int q_dtype, int c_dtype, int lo, int length, int chunk, int n_chunks, long long c_sb,
    long long c_sh, long long c_sm, long long s_sb, long long s_sh, float scale, void* stream) {
  const void* bases[2] = {k, v};
  if (rep < 1 || rep > MAXREP || c_sm != D || n_chunks < 1 || chunk < 1 ||
      !aligned16(bases, 2, nullptr, 0) || (c_dtype == 2) != (ks != nullptr && vs != nullptr) ||
      counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, k, v,
               static_cast<const __nv_bfloat16*>(ks),
               static_cast<const __nv_bfloat16*>(vs),
               out,
               static_cast<float*>(part_o), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<int*>(counters),
               kvH, rep, lo, length, chunk, n_chunks,
               c_sb, c_sh, s_sb, s_sh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TONY_DECODE_CASE(QD, CD, DIM, TQ, TC) \
  if (q_dtype == QD && c_dtype == CD && D == DIM) return launch_rep<TQ, TC, DIM>(a, B, s);
  TONY_DECODE_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  TONY_DECODE_CASE(1, 2, 128, __nv_bfloat16, int8_t)
  TONY_DECODE_CASE(0, 0, 128, float, float)
  TONY_DECODE_CASE(0, 2, 128, float, int8_t)
  TONY_DECODE_CASE(1, 1, 64, __nv_bfloat16, __nv_bfloat16)
  TONY_DECODE_CASE(1, 2, 64, __nv_bfloat16, int8_t)
  TONY_DECODE_CASE(0, 0, 64, float, float)
  TONY_DECODE_CASE(0, 2, 64, float, int8_t)
  TONY_DECODE_CASE(1, 1, 32, __nv_bfloat16, __nv_bfloat16)
  TONY_DECODE_CASE(1, 2, 32, __nv_bfloat16, int8_t)
  TONY_DECODE_CASE(0, 0, 32, float, float)
  TONY_DECODE_CASE(0, 2, 32, float, int8_t)
#undef TONY_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split's inputs for the kernel that tony_flash_decode launches at head
// dim D, cache dtype c_dtype (as there) and rep query heads a kv head:
// geometry[0] = cache positions in one K (or V) tile of the ring,
// geometry[1] = CTAs an SM holds at once. Returns 0, or cudaErrorInvalidValue.
extern "C" int tony_flash_decode_geometry(int D, int c_dtype, int rep, int* geometry) {
  if ((D != 32 && D != 64 && D != 128) || c_dtype < 0 || c_dtype > 2 || rep < 1 || rep > MAXREP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = c_dtype == 0 ? 4 : c_dtype == 1 ? 2 : 1;
  geometry[0] = TILE_BYTES / (D * elem);
  geometry[1] = rep == 1 ? ctas_per_sm<1>() : rep == 2 ? ctas_per_sm<2>()
              : rep <= 4 ? ctas_per_sm<4>() : ctas_per_sm<8>();
  return 0;
}

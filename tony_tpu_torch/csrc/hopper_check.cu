// Each wgmma product the bf16 flash backward uses, alone, for the card's
// check against torch.matmul (python -m tony_tpu_torch.tools.kernel_variants
// products). Not part of the package's kernels: it is built by that tool
// only. One warpgroup; the tiles come by TMA through hopper.cuh's tensor
// maps, as the kernels' tiles do.
// - mode 0: C[64 x N] = A[64 x D] B[N x D]^T, A and B read K-major from
//   shared memory (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T);
// - mode 1: C[64 x D] = P[64 x N] B[N x D], P from registers in the
//   accumulator's layout rounded to bf16, B read MN-major (dQ += dS K,
//   dV += P^T dO, dK += dS^T Q).

#include "hopper.cuh"

namespace {

template <int D, int N, int MODE>
__global__ void __launch_bounds__(128, 1)
    hopper_product_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, const float* p, float* c) {
  using T = SwTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t at = base, bt = at + 64 * D * 2, bar = bt + N * D * 2;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, (MODE == 0 ? 64 * D * 2 : 0) + N * D * 2);
    for (int span = 0; span < T::SPANS; ++span) {
      if (MODE == 0) tma_load_4d(at + span * 64 * T::ROW_BYTES, &ta, bar, span * T::COLS, 0, 0, 0);
      for (int rb = 0; rb < N / 64; ++rb)
        tma_load_4d(bt + (span * N + rb * 64) * T::ROW_BYTES, &tb, bar, span * T::COLS, rb * 64,
                    0, 0);
    }
  }
  mbar_wait(bar, 0);
  constexpr int CN = MODE == 0 ? N : D;
  float acc[CN / 2];
#pragma unroll
  for (int x = 0; x < CN / 2; ++x) acc[x] = 0.f;
  if constexpr (MODE == 0) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<N>::template ss<0>(acc, desc_kmajor<D, 64>(at, 0, kk), desc_kmajor<D, N>(bt, 0, kk),
                               kk > 0);
  } else {
    float pv[N / 2];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          pv[4 * j + 2 * i + e] = p[(warp * 16 + g + 8 * i) * N + 8 * j + 2 * t + e];
    uint32_t a[N / 16][4];
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) acc_to_a(a[kk], pv, kk);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      Wgmma<D>::template rs<1>(acc, a[kk], desc_mnmajor<D, N>(bt, kk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int j = 0; j < CN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        c[(warp * 16 + g + 8 * i) * CN + 8 * j + 2 * t + e] = acc[4 * j + 2 * i + e];
}

template <int D, int N, int MODE>
int launch(const void* a, const void* b, const float* p, float* c, cudaStream_t s) {
  CUtensorMap ta, tb;
  if (tma_map_bhld(&ta, a, 1, 1, 64, D, 0, 0, D) || tma_map_bhld(&tb, b, 1, 1, N, D, 0, 0, D))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = 64 * D * 2 + N * D * 2 + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(hopper_product_kernel<D, N, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hopper_product_kernel<D, N, MODE><<<1, 128, smem, s>>>(ta, tb, p, c);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(int D, int N, const void* a, const void* b, const float* p, float* c,
             cudaStream_t s) {
  if (D == 32 && N == 64) return launch<32, 64, MODE>(a, b, p, c, s);
  if (D == 32 && N == 128) return launch<32, 128, MODE>(a, b, p, c, s);
  if (D == 64 && N == 64) return launch<64, 64, MODE>(a, b, p, c, s);
  if (D == 64 && N == 128) return launch<64, 128, MODE>(a, b, p, c, s);
  if (D == 128 && N == 64) return launch<128, 64, MODE>(a, b, p, c, s);
  if (D == 128 && N == 128) return launch<128, 128, MODE>(a, b, p, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a: [64, D] bf16 (mode 0), b: [N, D] bf16, p: [64, N] float32 (mode 1), all
// contiguous; c: [64, N] (mode 0) or [64, D] (mode 1) float32. D in {32, 64,
// 128}, N in {64, 128}. -> the cudaError_t of the launch.
extern "C" int tony_hopper_product_check(int mode, int D, int N, const void* a, const void* b,
                                         const void* p, void* c, void* stream) {
  const float* pf = static_cast<const float*>(p);
  float* cf = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? dispatch<0>(D, N, a, b, pf, cf, s) : dispatch<1>(D, N, a, b, pf, cf, s);
}

// Tensor-core fragment helpers for the bf16 attention kernels (sm_80 and up,
// built for sm_90a): cp.async copies into shared memory, ldmatrix loads of
// mma.sync operands, the m16n8k16 bf16 product with a float32 accumulator,
// and the quad reductions of a row in the accumulator layout.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register a bf16x2 with the lower column in its low half:
//   A (16 x 16, row-major): a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8,
//     cols 2t, 2t+1), a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8, ...)
//   B (16 x 8, k x n):      b[0] = (k 2t, 2t+1; n g), b[1] = (k 2t+8, 2t+9; n g)
//   C (16 x 8, float32):    c[0], c[1] = (row g, cols 2t, 2t+1),
//                           c[2], c[3] = (row g+8, cols 2t, 2t+1)
// So the C fragments of two adjacent n8 tiles, packed to bf16x2, are the A
// fragment of one k16 step (pack_bf16 below): a product's result feeds the
// next product from registers, with no trip through shared memory.
//
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of 8 x 8 matrix i, and
// every lane receives, in register i, row g of matrix i at columns 2t, 2t+1
// (with .trans: column g at rows 2t, 2t+1). The address helpers below give
// each lane its row for the three operand shapes the kernels use.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Host side: whether every pointer is 16-byte aligned and every stride (in
// bf16 elements) a multiple of 8, as the 16-byte cp.async copies need.
inline bool aligned16(const void* const* ptrs, int n_ptrs, const long long* strides,
                      int n_strides) {
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x, hidden from the compiler: a tile's base address taken through this in
// each iteration of a loop keeps the dozens of ldmatrix addresses derived
// from it from being hoisted out of the loop into registers that would stay
// live (and spill) across it; each is an add folded into the load instead.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// 16 bytes global -> shared, asynchronous; src_bytes < 16 fills the rest with
// zeros (0: nothing is read, the 16 bytes are zeros)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// 4 bytes global -> shared, asynchronous (one float of lse or delta)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b, one m16n8k16 product: bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> bf16x2 with lo in the low half, round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one k16 step from the C fragments of n8 tiles c0 (cols
// 0-7 of the step) and c1 (cols 8-15), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Max and sum over the 4 lanes of a quad: the lanes holding one row of a C
// fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The row and column (in elements, inside a 16 x 16 block of a row-major
// bf16 tile) whose address this lane gives to an ldmatrix.x4, for the three
// operand shapes:
// - a_row/a_col: the A fragment of the block (matrices: rows 0-7 and 8-15 at
//   cols 0-7, then at cols 8-15);
// - b_row/b_col: the B fragments of two n8 tiles, of a tile stored n-major
//   (rows = n, cols = k; matrices: n 0-7 x k 0-7, n 0-7 x k 8-15, n 8-15 x
//   k 0-7, n 8-15 x k 8-15), for plain ldmatrix;
// - bt_row/bt_col: the B fragments of two n8 tiles, of a tile stored k-major
//   (rows = k, cols = n; matrices: k 0-7 x n 0-7, k 8-15 x n 0-7, k 0-7 x
//   n 8-15, k 8-15 x n 8-15), for ldmatrix.trans.
// Registers 0-1 of a B load are the first n8 tile's fragment, 2-3 the second's.
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return (lane / 16) * 8; }
__device__ __forceinline__ int b_row(int lane) { return lane % 8 + (lane / 16) * 8; }
__device__ __forceinline__ int b_col(int lane) { return ((lane / 8) % 2) * 8; }
__device__ __forceinline__ int bt_row(int lane) { return lane % 8 + ((lane / 8) % 2) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane / 16) * 8; }

// Copy rows [r0, r0 + ROWS) of a [L, D] bf16 matrix with row stride `sl`
// (elements) into a shared tile of row stride D + 8, 16 bytes a thread per
// step; rows at or past `end` are zero-filled without a read. The source
// row stride and base must be 16-byte aligned (the entry points check).
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        long long sl, int r0, int end) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * CHUNKS % THREADS == 0, "the tile splits evenly over the threads");
  const uint32_t base = smem_u32(dst);
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CHUNKS, c = (e % CHUNKS) * 8;
    const int row = r0 + r;
    const bool in = row < end;
    const __nv_bfloat16* p = in ? src + row * sl + c : src;
    cp_async16(base + (r * (D + 8) + c) * 2, p, in ? 16 : 0);
  }
}

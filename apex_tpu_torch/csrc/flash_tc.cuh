// Tensor-core building blocks shared by the mma.sync flash kernels
// (flash_fwd_tc.cu, flash_bwd_tc.cu): cp.async copies into shared memory,
// ldmatrix fragment loads, the m16n8k16 bf16 product with fp32
// accumulators, and the 16-byte tile copy of one head's rows.
#pragma once

#include "flash_hm.cuh"

namespace apex_tpu_torch {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: one m16n8k16 product, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [r0, r0 + ROWS) of one head's [rows, d] slice into a ROWS x (DP + 8)
// shared tile by cp.async, THREADS threads sharing the 16-byte chunks
// (the last round partly); rows at or past `rows` and columns at or past d
// are zero-filled
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                long long s_row, int r0,
                                                int rows, int d) {
  constexpr int kChunks = DP / 8;
  constexpr int kLd = DP + 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (kTotal % THREADS != 0 && i >= kTotal) break;
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool ok = r0 + r < rows && c < d;
    const bf16* s = ok ? src + (long long)(r0 + r) * s_row + c : src;
    cp_async16(dst + r * kLd + c, s, ok);
  }
}

__host__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace tc
}  // namespace apex_tpu_torch

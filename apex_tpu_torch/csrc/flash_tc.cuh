// Tensor-core building blocks shared by the mma.sync flash kernels
// (flash_fwd_tc.cu, flash_bwd_tc.cu): cp.async copies into shared memory,
// ldmatrix fragment loads, the m16n8k16 product of 16-bit operands (bf16
// or fp16, the element type T) with fp32 accumulators, the packing of two
// fp32 values into one T pair, and the 16-byte tile copy of one head's
// rows. Copies and ldmatrix move 16-bit words whatever T is; only the
// product's type suffix and the rounding of the packing depend on it.
#pragma once

#include <cuda_fp16.h>

#include "flash_hm.cuh"

namespace apex_tpu_torch {
namespace tc {

using bf16 = __nv_bfloat16;
using f16 = __half;

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

// c += a b: one m16n8k16 product, T operands, fp32 accumulators
template <typename T>
__device__ __forceinline__ void mma16(float c[4], const uint32_t a[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<bf16>(float c[4], const uint32_t a[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<f16>(float c[4], const uint32_t a[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest T as one 32-bit pair (lo in the low half):
// an A fragment register, or two adjacent elements of a T row
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<bf16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<f16>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// rows [r0, r0 + ROWS) of one head's [rows, d] slice into a ROWS x (DP + 8)
// shared tile by cp.async, THREADS threads sharing the 16-byte chunks
// (the last round partly); rows at or past `rows` and columns at or past d
// are zero-filled
template <int DP, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                long long s_row, int r0,
                                                int rows, int d) {
  static_assert(sizeof(T) == 2, "16-bit elements, 8 to a chunk");
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
    const T* s = ok ? src + (long long)(r0 + r) * s_row + c : src;
    cp_async16(dst + r * kLd + c, s, ok);
  }
}

__host__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace tc
}  // namespace apex_tpu_torch

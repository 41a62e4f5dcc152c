// Shared device helpers for the apex_tpu_torch kernels: dtype codes,
// conversions to and from fp32, 16-byte vector loads and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace apex_tpu_torch {

// dtype codes shared with apex_tpu_torch/kernels/_build.py (DTYPE_CODES;
// kFloat16 only for the tensor-core flash kernels, TC_DTYPE_CODES, and
// the decode kernels, DECODE_DTYPE_CODES)
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// quantized-KV storage codes shared with _build.py (KV_KIND_CODES)
enum KvKind : int { kInt8 = 0, kFp8 = 1 };

// the one head width the lane-packed flash kernels are built for
// (GPT 355M: 1024 / 16)
constexpr int kHeadDim = 64;

// the finite "minus infinity" of the JAX kernels (_NEG): masked scores
// and the initial running max, so exp(m_prev - m_new) never sees inf-inf
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte vector
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// one 16-byte load of Vec<T>::N elements, widened to fp32; `src` must be
// 16-byte aligned (the wrappers check base pointers, and every offset
// the kernels form is a multiple of the vector width)
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_float<T>(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace apex_tpu_torch

// Multi-tensor Adam / AdamW over one flat group buffer.
//
// Replaces: apex_tpu/kernels/flat_ops.py:adam_flat (kernel body
// _adam_kernel), the one sweep over packed (param, grad, m, v) buffers
// that fused_adam(layout="flat") runs once per dtype group per step --
// apex's csrc/multi_tensor_adam.cu.
//
// What bounds it on an H100: memory. Per element it reads p, g, m, v and
// writes p, m, v: 28 bytes for fp32 params (22 for bf16) against about
// 20 flops, far below the card's ~295 flops per byte. At 355M parameters
// one sweep moves about 9.9 GB, so its floor is about 3 ms at 3.35 TB/s.
//
// What the design does about it: every byte is touched once. A
// grid-stride loop walks the buffer four elements at a time, so g, m, v
// (and fp32 p) move as 16-byte vectors (bf16 p as 8-byte ones), neighbour
// threads on neighbour addresses. The grid is capped at a few blocks per
// SM, enough to keep loads in flight. The eight scalars come from a
// device buffer, so a learning-rate schedule or the bias correction of a
// step count that lives on the device needs no host round trip; a device
// no-op flag (apex's noop_flag) makes an overflow step leave p, m and v
// untouched, again without the host. p, m and v are updated in place
// (with out_is_delta, p receives the update instead).
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;
constexpr int kV = 4;  // elements per thread per iteration

template <typename T> struct Pack4;
template <> struct Pack4<float> {
  __device__ __forceinline__ static void load(const float* src, float* d) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* dst, const float* s) {
    *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <> struct Pack4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* d) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kV; ++i) d[i] = __bfloat162float(e[i]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* dst,
                                               const float* s) {
    uint2 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kV; ++i) e[i] = __float2bfloat16(s[i]);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
};

// scalars: lr, b1, b2, eps, weight_decay, bias_correction1,
// bias_correction2, grad_scale -- the order of _adam_kernel's s_ref
template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_kernel(T* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v,
            const float* __restrict__ scalars,
            const int* __restrict__ noop, long long n_vec, int adam_w_mode,
            int out_is_delta, int grad_averaging) {
  if (noop != nullptr && *noop != 0) return;
  const float lr = scalars[0], b1 = scalars[1], b2 = scalars[2];
  const float eps = scalars[3], wd = scalars[4], bc1 = scalars[5];
  const float bc2 = scalars[6], gscale = scalars[7];
  const float m_coef = grad_averaging ? 1.0f - b1 : 1.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long o = i * kV;
    float pv[kV], gv[kV], mv[kV], vv[kV], ov[kV];
    Pack4<T>::load(p + o, pv);
    Pack4<float>::load(g + o, gv);
    Pack4<float>::load(m + o, mv);
    Pack4<float>::load(v + o, vv);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      float gr = gv[e] * gscale;
      if (!adam_w_mode) gr = gr + wd * pv[e];  // classic L2
      mv[e] = b1 * mv[e] + m_coef * gr;
      vv[e] = b2 * vv[e] + (1.0f - b2) * gr * gr;
      float upd = (mv[e] / bc1) / (sqrtf(vv[e] / bc2) + eps);
      if (adam_w_mode) upd = upd + wd * pv[e];  // decoupled decay
      ov[e] = out_is_delta ? -lr * upd : pv[e] - lr * upd;
    }
    Pack4<T>::store(p + o, ov);
    Pack4<float>::store(m + o, mv);
    Pack4<float>::store(v + o, vv);
  }
}

template <typename T>
cudaError_t launch(void* p, const void* g, void* m, void* v,
                   const void* scalars, const void* noop, long long n,
                   int adam_w_mode, int out_is_delta, int grad_averaging,
                   cudaStream_t stream) {
  const long long n_vec = n / kV;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kSms * kBlocksPerSm ? want
                                                      : kSms * kBlocksPerSm);
  adam_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(scalars), static_cast<const int*>(noop),
      n_vec, adam_w_mode, out_is_delta, grad_averaging);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// p [n] in `dtype`, g/m/v [n] fp32, scalars fp32 [8] on the device,
// noop int32 [1] on the device or null. n must be a positive multiple of
// 4 and every pointer 16-byte aligned (the wrapper checks both). Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a shape
// or dtype the kernel was not built for (nothing launched).
extern "C" int apex_tpu_torch_adam_flat(
    void* p, const void* g, void* m, void* v, const void* scalars,
    const void* noop, long long n, int adam_w_mode, int out_is_delta,
    int grad_averaging, int dtype, void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(p, g, m, v, scalars, noop, n, adam_w_mode,
                           out_is_delta, grad_averaging, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(p, g, m, v, scalars, noop, n,
                                   adam_w_mode, out_is_delta, grad_averaging,
                                   st);
    default:
      return cudaErrorInvalidValue;
  }
}

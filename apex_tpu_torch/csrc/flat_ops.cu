// Multi-tensor sweeps over flat group buffers: Adam / AdamW and the
// global L2 norm.
//
// Replaces: apex_tpu/kernels/flat_ops.py:adam_flat (kernel body
// _adam_kernel), the one sweep over packed (param, grad, m, v) buffers
// that fused_adam(layout="flat") runs once per dtype group per step --
// apex's csrc/multi_tensor_adam.cu -- and flat_ops.py:l2norm_flat (kernel
// body _sumsq_kernel), apex's multi_tensor_l2norm in its global mode.
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
// untouched, again without the host. p, m and v are updated in place;
// with out_is_delta the update -lr*upd goes to a separate fp32 buffer and
// p is only read (FusedLAMB's stage 1 needs the params afterwards), which
// is the JAX function's out_dtype=float32.
//
// The L2 norm reads each buffer once: 4 bytes an element in fp32 against
// two flops, so it too is bound by memory (335M fp32 elements: 1.34 GB,
// 0.40 ms at 3.35 TB/s). A fixed grid of blocks sums squares in fp32 over
// a grid-stride loop of 16-byte loads and writes one partial each; a
// second, one-block kernel sums the partials of each buffer in a fixed
// tree, adds the buffers in list order and takes the square root on the
// device. No atomics, and the grid depends on nothing but constants, so
// the norm is the same bit for bit from run to run, and no step waits on
// the host for it.
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
            float* __restrict__ delta, const float* __restrict__ scalars,
            const int* __restrict__ noop, long long n_vec, int adam_w_mode,
            int grad_averaging) {
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
      ov[e] = delta != nullptr ? -lr * upd : pv[e] - lr * upd;
    }
    if (delta != nullptr) {
      Pack4<float>::store(delta + o, ov);
    } else {
      Pack4<T>::store(p + o, ov);
    }
    Pack4<float>::store(m + o, mv);
    Pack4<float>::store(v + o, vv);
  }
}

template <typename T>
cudaError_t launch(void* p, const void* g, void* m, void* v, void* delta,
                   const void* scalars, const void* noop, long long n,
                   int adam_w_mode, int grad_averaging,
                   cudaStream_t stream) {
  const long long n_vec = n / kV;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kSms * kBlocksPerSm ? want
                                                      : kSms * kBlocksPerSm);
  adam_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(delta), static_cast<const float*>(scalars),
      static_cast<const int*>(noop), n_vec, adam_w_mode, grad_averaging);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// global L2 norm
// ---------------------------------------------------------------------------

constexpr int kL2Threads = 256;
constexpr int kL2Blocks = 4 * kSms;      // partials per buffer (fixed)
constexpr int kL2FinishThreads = 512;

// block-wide sum of one value per thread in a fixed tree: the same
// inputs give the same bits whatever the order the warps ran in
template <int kThreadsT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < 32) {
    total = threadIdx.x < kThreadsT / 32 ? red[threadIdx.x] : 0.f;
    total = warp_sum(total);
  }
  __syncthreads();
  return total;  // valid in thread 0
}

// pass 1: block b of kL2Blocks writes the fp32 sum of squares of the
// elements it strides over to partial[b]
template <typename T>
__global__ void __launch_bounds__(kL2Threads)
sumsq_kernel(const T* __restrict__ x, long long n, float* __restrict__ partial) {
  __shared__ float red[kL2Threads / 32];
  constexpr int N = Vec<T>::N;
  const long long n_vec = n / N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (long long i = t0; i < n_vec; i += stride) {
    float e[N];
    load_vec<T>(x + i * N, e);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += e[k] * e[k];
  }
  for (long long i = n_vec * N + t0; i < n; i += stride) {
    const float e = to_float<T>(x[i]);
    acc += e * e;
  }
  const float total = block_sum<kL2Threads>(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// pass 2, one block: each buffer's kL2Blocks partials summed in a fixed
// tree, the buffers added in list order, then the square root
__global__ void __launch_bounds__(kL2FinishThreads)
l2norm_finish_kernel(const float* __restrict__ partial, int groups,
                     float* __restrict__ out) {
  __shared__ float red[kL2FinishThreads / 32];
  float total = 0.f;
  for (int g = 0; g < groups; ++g) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < kL2Blocks; i += kL2FinishThreads)
      acc += partial[g * kL2Blocks + i];
    const float s = block_sum<kL2FinishThreads>(acc, red);
    if (threadIdx.x == 0) total += s;
  }
  if (threadIdx.x == 0) *out = sqrtf(total);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// p [n] in `dtype`, g/m/v [n] fp32, scalars fp32 [8] on the device,
// noop int32 [1] on the device or null; delta fp32 [n] or null. With
// delta, the update -lr*upd is written there and p is only read (on a
// no-op the kernel writes nothing: the wrapper hands it a zeroed delta);
// without, p is updated in place. n must be a positive multiple of 4 and
// every pointer 16-byte aligned (the wrapper checks both). Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a shape
// or dtype the kernel was not built for (nothing launched).
extern "C" int apex_tpu_torch_adam_flat(
    void* p, const void* g, void* m, void* v, void* delta,
    const void* scalars, const void* noop, long long n, int adam_w_mode,
    int grad_averaging, int dtype, void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(p, g, m, v, delta, scalars, noop, n, adam_w_mode,
                           grad_averaging, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(p, g, m, v, delta, scalars, noop, n,
                                   adam_w_mode, grad_averaging, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The number of fp32 partials each buffer needs in the workspace of
// apex_tpu_torch_l2norm_flat.
extern "C" int apex_tpu_torch_l2norm_blocks() { return kL2Blocks; }

// out fp32 [1] = sqrt(sum over the `groups` buffers, in list order, of
// the sum of squares of each). ptrs/ns/dtypes are host arrays of
// `groups` entries: device pointers (16-byte aligned), element counts
// and dtype codes. workspace is fp32 [groups * kL2Blocks] on the device.
// Launches one pass per buffer and one finishing pass.
extern "C" int apex_tpu_torch_l2norm_flat(
    const void* ptrs, const void* ns, const void* dtypes, int groups,
    void* workspace, void* out, void* stream) {
  if (groups <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* p = static_cast<const void* const*>(ptrs);
  const long long* n = static_cast<const long long*>(ns);
  const int* dt = static_cast<const int*>(dtypes);
  float* ws = static_cast<float*>(workspace);
  for (int g = 0; g < groups; ++g) {
    if (n[g] < 0) return cudaErrorInvalidValue;
    switch (dt[g]) {
      case kFloat32:
        sumsq_kernel<float><<<kL2Blocks, kL2Threads, 0, st>>>(
            static_cast<const float*>(p[g]), n[g], ws + g * kL2Blocks);
        break;
      case kBFloat16:
        sumsq_kernel<__nv_bfloat16><<<kL2Blocks, kL2Threads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(p[g]), n[g],
            ws + g * kL2Blocks);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  l2norm_finish_kernel<<<1, kL2FinishThreads, 0, st>>>(
      ws, groups, static_cast<float*>(out));
  return cudaGetLastError();
}

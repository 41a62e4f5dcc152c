// Fused softmax cross entropy with label smoothing, forward and backward.
//
// Replaces: apex_tpu/kernels/xentropy.py:_run_fwd (kernel body _fwd_kernel)
// and _run_bwd (kernel body _bwd_kernel) -- apex contrib's xentropy,
// SoftmaxCrossEntropyLoss. The forward keeps only the fp32 per-row
// log-sum-exp; the backward recomputes softmax = exp(x - lse) from the
// logits, so no [rows, vocab] softmax is ever stored.
//
//   loss[r] = lse - (1 - eps) * x[t] - eps * mean(x)   (eps > 0)
//   loss[r] = lse - x[t]                               (eps = 0)
//   dx[r, c] = (exp(x - lse) - (1 - eps) * [c == t] - eps / V) * g[r]
//
// with zero loss, and a zero gradient row, where t == ignore_index, and
// x[t] = 0 for a target outside [0, V) (the JAX kernel reads it from its
// zero-padded columns). The JAX kernel pads the vocab to 128 lanes and
// the rows to a block; nothing here is padded.
//
// What bounds it on an H100: memory. The forward reads each logit once
// and writes 8 bytes a row; the backward reads each logit and writes its
// gradient. At one CE chunk of the GPT-2 355M step (8192 x 50304 fp32,
// 1.648 GB) that is 0.49 ms forward and 0.98 ms backward at 3.35 TB/s,
// against about 3 flops and one exp per element (the exp on the SFUs).
//
// What the design does about it: one block per row, every logit touched
// once. A row is cut into a scalar head up to the first 16-byte boundary,
// a body of 16-byte vector loads (4 fp32 or 8 bf16, neighbour threads on
// neighbour addresses) and a scalar tail, so any vocab and any row
// alignment take the vector path for all but a few elements. The forward
// keeps, per thread, a running max and a sum rescaled whenever the max
// grows (one exp per element), and the plain sum of x for the smoothing
// term, in the same pass; the three are merged by warp shuffles and then
// through shared memory. x[t] is one load. Arithmetic is fp32 for fp32
// and bf16 logits; the gradient is stored in the logits' dtype.
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kXentThreads = 256;

// the running (max, rescaled sum) pair of an online softmax: merge b into
// a. kNeg (not -inf) is the empty max, so exp(kNeg - kNeg) is 1, not NaN
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2,
                                         float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void add_one(float x, float& m, float& s,
                                        float& sum) {
  if (x > m) {
    s = s * expf(m - x) + 1.0f;
    m = x;
  } else {
    s += expf(x - m);
  }
  sum += x;
}

// the row's elements [0, head) and [head + n_vec * N, V) are scalar, the
// rest 16-byte vectors
template <typename T>
__device__ __forceinline__ int head_of(const T* row, int V) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15u);
  const int head = mis ? (16 - mis) / (int)sizeof(T) : 0;
  return head < V ? head : V;
}

template <typename T>
__global__ void __launch_bounds__(kXentThreads)
xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ target,
                float* __restrict__ loss, float* __restrict__ lse_out,
                int V, float smoothing, float one_minus_s,
                int ignore_index) {
  constexpr int N = Vec<T>::N;
  const long long r = blockIdx.x;
  const T* row = x + r * (long long)V;
  const int head = head_of(row, V);
  const int n_vec = (V - head) / N;
  const int tail0 = head + n_vec * N;

  float m = kNeg, s = 0.f, sum = 0.f;
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    add_one(to_float<T>(row[i]), m, s, sum);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    float e[N];
    load_vec<T>(row + head + i * N, e);
#pragma unroll
    for (int k = 0; k < N; ++k) add_one(e[k], m, s, sum);
  }
  for (int i = tail0 + threadIdx.x; i < V; i += blockDim.x)
    add_one(to_float<T>(row[i]), m, s, sum);

  // warp merge, then the warps' partials through shared memory
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge_ms(m, s, m2, s2);
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  }
  __shared__ float red_m[kXentThreads / 32], red_s[kXentThreads / 32],
      red_sum[kXentThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
    red_sum[warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mt = red_m[0], st = red_s[0], sumt = red_sum[0];
    for (int w = 1; w < kXentThreads / 32; ++w) {
      merge_ms(mt, st, red_m[w], red_s[w]);
      sumt += red_sum[w];
    }
    const float lse = logf(st) + mt;
    const int t = target[r];
    const float pred = (t >= 0 && t < V) ? to_float<T>(row[t]) : 0.f;
    float l = lse - pred;
    if (smoothing > 0.f) {
      const float mean_x = sumt / (float)V;
      l = lse - one_minus_s * pred - smoothing * mean_x;
    }
    loss[r] = t == ignore_index ? 0.f : l;
    lse_out[r] = lse;
  }
}

__device__ __forceinline__ float grad_of(float x, int c, int t, float lse,
                                         float one_minus_s, float s_over_v,
                                         bool smooth, bool ignored) {
  float gr = expf(x - lse) - (c == t ? one_minus_s : 0.f);
  if (smooth) gr -= s_over_v;
  return ignored ? 0.f : gr;
}

template <typename T>
__global__ void __launch_bounds__(kXentThreads)
xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ target,
                const float* __restrict__ lse_in,
                const float* __restrict__ g_in, T* __restrict__ dx, int V,
                float smoothing, float one_minus_s, float s_over_v,
                int ignore_index) {
  constexpr int N = Vec<T>::N;
  const long long r = blockIdx.x;
  const T* row = x + r * (long long)V;
  T* drow = dx + r * (long long)V;
  const int head = head_of(row, V);
  // x and dx share one layout, so one head aligns both (the wrapper
  // hands two 16-byte aligned bases with the same row stride)
  const int n_vec = (V - head) / N;
  const int tail0 = head + n_vec * N;
  const int t = target[r];
  const float lse = lse_in[r], g = g_in[r];
  const bool smooth = smoothing > 0.f, ignored = t == ignore_index;

  for (int i = threadIdx.x; i < head; i += blockDim.x)
    drow[i] = from_float<T>(grad_of(to_float<T>(row[i]), i, t, lse,
                                    one_minus_s, s_over_v, smooth, ignored)
                            * g);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int c0 = head + i * N;
    float e[N];
    load_vec<T>(row + c0, e);
    alignas(16) T out[N];
#pragma unroll
    for (int k = 0; k < N; ++k)
      out[k] = from_float<T>(grad_of(e[k], c0 + k, t, lse, one_minus_s,
                                     s_over_v, smooth, ignored) * g);
    *reinterpret_cast<uint4*>(drow + c0) =
        *reinterpret_cast<const uint4*>(out);
  }
  for (int i = tail0 + threadIdx.x; i < V; i += blockDim.x)
    drow[i] = from_float<T>(grad_of(to_float<T>(row[i]), i, t, lse,
                                    one_minus_s, s_over_v, smooth, ignored)
                            * g);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// x [rows, V] in `dtype` (contiguous), target int32 [rows]; writes fp32
// loss [rows] and lse [rows]. smoothing, and one_minus_s = fp32(1 -
// smoothing) and the row's ignore_index, as the JAX kernel takes them.
// One block per row. Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a shape or dtype the kernel was not built for.
extern "C" int apex_tpu_torch_xentropy_fwd(
    const void* x, const void* target, void* loss, void* lse, int rows,
    int V, float smoothing, float one_minus_s, int ignore_index, int dtype,
    void* stream) {
  if (rows <= 0 || V <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(target);
  switch (dtype) {
    case kFloat32:
      xent_fwd_kernel<float><<<rows, kXentThreads, 0, st>>>(
          static_cast<const float*>(x), t, static_cast<float*>(loss),
          static_cast<float*>(lse), V, smoothing, one_minus_s, ignore_index);
      break;
    case kBFloat16:
      xent_fwd_kernel<__nv_bfloat16><<<rows, kXentThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), t, static_cast<float*>(loss),
          static_cast<float*>(lse), V, smoothing, one_minus_s, ignore_index);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dx [rows, V] in `dtype` from x [rows, V] (same dtype, same row stride,
// both bases 16-byte aligned), target int32 [rows], the forward's fp32
// lse [rows] and the fp32 upstream gradient g [rows]. s_over_v =
// fp32(smoothing / V).
extern "C" int apex_tpu_torch_xentropy_bwd(
    const void* x, const void* target, const void* lse, const void* g,
    void* dx, int rows, int V, float smoothing, float one_minus_s,
    float s_over_v, int ignore_index, int dtype, void* stream) {
  if (rows <= 0 || V <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(target);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  switch (dtype) {
    case kFloat32:
      xent_bwd_kernel<float><<<rows, kXentThreads, 0, st>>>(
          static_cast<const float*>(x), t, l, gg, static_cast<float*>(dx), V,
          smoothing, one_minus_s, s_over_v, ignore_index);
      break;
    case kBFloat16:
      xent_bwd_kernel<__nv_bfloat16><<<rows, kXentThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), t, l, gg,
          static_cast<__nv_bfloat16*>(dx), V, smoothing, one_minus_s,
          s_over_v, ignore_index);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

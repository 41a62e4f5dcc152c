// Fused scaled, masked softmax over the last dim, forward and backward:
// Megatron's scaled_masked_softmax and scaled_upper_triang_masked_softmax.
//
// Replaces: apex_tpu/kernels/softmax.py:_run_fwd (kernel body _fwd_kernel)
// and _run_bwd (kernel body _bwd_kernel) -- apex's
// csrc/megatron/scaled_masked_softmax*.cu and
// scaled_upper_triang_masked_softmax*.cu.
//
//   forward:  y = softmax(scale * x) over the row's valid entries, in fp32
//   backward: dx = scale * y * (dy - sum(y * dy)), in fp32
//
// An entry is invalid where the mask is nonzero, or where col > row when
// causal (square scores only). As in the JAX kernel, invalid entries
// count as -30000 in the row's max and as 0 in the sum, and the sum is
// clamped at 1e-30, so a row with every entry masked gives zeros. The
// mask is [nb / ratio, sq, sk] bytes, one batch of it shared by `ratio`
// consecutive score batches (the heads): JAX's ratio-tiled mask block
// i // h, so a [b, 1, 1, sk] padding mask is never copied h times. The
// JAX kernel pads sk to 128 lanes and sq to its row block; nothing here
// is padded, and any sk and sq are right.
//
// What bounds it on an H100: memory. The forward reads each score once
// (and a mask byte) and writes each probability; the backward reads y and
// dy and writes dx; a few flops and one exp an element. At the GPT-2
// 355M's unfused scores (16 x 16 heads x 1024 x 1024 bf16, 0.54 GB) that
// is 0.32 ms forward and 0.48 ms backward at 3.35 TB/s.
//
// What the design does about it: one warp a row, four rows a block, so
// every reduction is a warp shuffle and no block ever waits at a barrier.
// Neighbour lanes read neighbour elements. The forward caches the row's
// scaled, masked fp32 values in shared memory (8 KB a warp up to sk =
// 2048), so the scores are read from memory once: pass 1 takes the max,
// pass 2 the exps and their sum, pass 3 divides and stores. Longer rows
// re-read x and the mask in each pass instead. The backward reads y and
// dy twice, the second time mostly from L1. The product scale * x is
// rounded on its own (__fmul_rn), never contracted into the subtraction
// of the max. Arithmetic is fp32 for fp32 and bf16 I/O; the wrapper
// widens float16 to fp32 around the kernel, as the JAX function does.
#include "common.cuh"

#include <math_constants.h>

namespace apex_tpu_torch {
namespace {

constexpr int kSmWarps = 4;
constexpr int kSmThreads = kSmWarps * 32;
// the longest row whose fp32 values a warp keeps in shared memory
constexpr int kSmCacheCols = 2048;
// the JAX kernel's fill (_NEG) for invalid entries, in the max only
constexpr float kFill = -30000.0f;

struct Row {
  long long row;  // the row's index in [nb * sq)
  int r;          // its query index in [0, sq)
  bool live;
};

__device__ __forceinline__ Row row_of(long long rows, int sq) {
  Row out;
  out.row = (long long)blockIdx.x * kSmWarps + (threadIdx.x >> 5);
  out.live = out.row < rows;
  out.r = out.live ? (int)(out.row % sq) : 0;
  return out;
}

// scale * x[j], or -inf where the entry is invalid (exp gives 0 there)
template <typename T>
__device__ __forceinline__ float masked_value(const T* __restrict__ xr,
                                              const uint8_t* __restrict__ mr,
                                              int j, int last, float scale,
                                              bool& invalid) {
  const bool ok = j <= last && (mr == nullptr || mr[j] == 0);
  invalid |= !ok;
  return ok ? __fmul_rn(to_float<T>(xr[j]), scale) : -CUDART_INF_F;
}

template <typename T, bool kCached>
__global__ void __launch_bounds__(kSmThreads)
softmax_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   T* __restrict__ y, long long rows, int sq, int sk,
                   int mask_ratio, float scale, int causal) {
  extern __shared__ float cache[];
  const Row w = row_of(rows, sq);
  if (!w.live) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + w.row * sk;
  T* yr = y + w.row * sk;
  const uint8_t* mr = nullptr;
  if (mask != nullptr) {
    const long long b = w.row / sq;
    mr = mask + ((b / mask_ratio) * sq + w.r) * (long long)sk;
  }
  const int last = causal ? w.r : sk - 1;
  float* c = cache + (threadIdx.x >> 5) * (kCached ? sk : 0);

  // pass 1: the max over the valid values, and -30000 if any is invalid
  float m = -CUDART_INF_F;
  bool invalid = false;
  for (int j = lane; j < sk; j += 32) {
    const float v = masked_value(xr, mr, j, last, scale, invalid);
    if (kCached) c[j] = v;
    m = fmaxf(m, v);
  }
  m = warp_max(m);
  if (__any_sync(0xffffffffu, invalid)) m = fmaxf(m, kFill);

  // pass 2: the exps and their sum (invalid entries give exp(-inf) = 0)
  float sum = 0.f;
  for (int j = lane; j < sk; j += 32) {
    bool unused = false;
    const float v =
        kCached ? c[j] : masked_value(xr, mr, j, last, scale, unused);
    const float e = expf(v - m);
    if (kCached) c[j] = e;
    sum += e;
  }
  const float denom = fmaxf(warp_sum(sum), 1e-30f);

  // pass 3: normalise and store in T
  for (int j = lane; j < sk; j += 32) {
    float e;
    if (kCached) {
      e = c[j];
    } else {
      bool unused = false;
      e = expf(masked_value(xr, mr, j, last, scale, unused) - m);
    }
    yr[j] = from_float<T>(e / denom);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSmThreads)
softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                   T* __restrict__ dx, long long rows, int sk, float scale) {
  const Row w = row_of(rows, 1);
  if (!w.live) return;
  const int lane = threadIdx.x & 31;
  const T* yr = y + w.row * sk;
  const T* dyr = dy + w.row * sk;
  T* dxr = dx + w.row * sk;
  float inner = 0.f;
  for (int j = lane; j < sk; j += 32)
    inner += to_float<T>(yr[j]) * to_float<T>(dyr[j]);
  inner = warp_sum(inner);
  for (int j = lane; j < sk; j += 32) {
    const float yv = to_float<T>(yr[j]);
    dxr[j] = from_float<T>(__fmul_rn(scale, yv) * (to_float<T>(dyr[j]) - inner));
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* mask, void* y,
                       long long rows, int sq, int sk, int mask_ratio,
                       float scale, int causal, cudaStream_t st) {
  const long long blocks = (rows + kSmWarps - 1) / kSmWarps;
  const T* xp = static_cast<const T*>(x);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* yp = static_cast<T*>(y);
  if (sk <= kSmCacheCols) {
    const size_t smem = (size_t)kSmWarps * sk * sizeof(float);
    softmax_fwd_kernel<T, true><<<(unsigned)blocks, kSmThreads, smem, st>>>(
        xp, mp, yp, rows, sq, sk, mask_ratio, scale, causal);
  } else {
    softmax_fwd_kernel<T, false><<<(unsigned)blocks, kSmThreads, 0, st>>>(
        xp, mp, yp, rows, sq, sk, mask_ratio, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* y, const void* dy, void* dx,
                       long long rows, int sk, float scale, cudaStream_t st) {
  const long long blocks = (rows + kSmWarps - 1) / kSmWarps;
  softmax_bwd_kernel<T><<<(unsigned)blocks, kSmThreads, 0, st>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy),
      static_cast<T*>(dx), rows, sk, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// y [nb * sq, sk] = the scaled, masked softmax of x [nb * sq, sk], both in
// `dtype`, rows = nb * sq. mask is [nb / mask_ratio, sq, sk] bytes
// (nonzero = masked) or null; causal masks col > row (sq == sk, which the
// wrapper checks). No alignment is needed. Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a shape or dtype the kernel
// was not built for (nothing launched).
extern "C" int apex_tpu_torch_softmax_fwd(const void* x, const void* mask,
                                          void* y, long long rows, int sq,
                                          int sk, int mask_ratio, float scale,
                                          int causal, int dtype,
                                          void* stream) {
  if (rows <= 0 || sq <= 0 || sk <= 0 || rows % sq || mask_ratio <= 0 ||
      rows / kSmWarps >= 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_fwd<float>(x, mask, y, rows, sq, sk, mask_ratio, scale,
                               causal, st);
    case kBFloat16:
      return launch_fwd<__nv_bfloat16>(x, mask, y, rows, sq, sk, mask_ratio,
                                       scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// dx [rows, sk] = scale * y * (dy - sum(y * dy)) row by row, all three in
// `dtype`, the arithmetic in fp32.
extern "C" int apex_tpu_torch_softmax_bwd(const void* y, const void* dy,
                                          void* dx, long long rows, int sk,
                                          float scale, int dtype,
                                          void* stream) {
  if (rows <= 0 || sk <= 0 || rows / kSmWarps >= 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_bwd<float>(y, dy, dx, rows, sk, scale, st);
    case kBFloat16:
      return launch_bwd<__nv_bfloat16>(y, dy, dx, rows, sk, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

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
// The forward has two routes, chosen by the wrapper
// (kernels/softmax.py:fwd_route) from the dtype, sk and the pointers'
// alignment alone, and re-checked here:
//
// Route 1, softmax_fwd_rows_kernel<T, kChunks>, the row in registers:
// fp32 or bf16, sk a multiple of V = 16 / sizeof(T) (4 or 8) and at most
// kRowsMaxCols = 2048, x and y 16-byte aligned, the mask V-byte aligned.
// Lane l holds kChunks 16-byte vectors of the row, chunk c the columns
// [(32c + l) * V, +V), so one warp-wide load moves 512 contiguous bytes.
// x is loaded once (16-byte loads, a vector's mask bytes as one 8- or
// 4-byte load), kept in fp32 registers through the max, the exps and the
// sum, and y stored with 16-byte stores: no shared memory and no
// barrier. The loads and stores keep the default cache policy: with
// streaming hints (__ldcs, __stcs) the kernel measured 1-3% slower
// (PERF.md, PR 15). A causal row never loads or exponentiates a
// vector that starts past its diagonal, and stores it as a 16-byte zero;
// only the vector that straddles the diagonal is masked element by
// element. kChunks is the row's vector count rounded up to a power of
// two (vectors past sk are skipped), so 4 + 5 instances cover every sk
// up to the cap of 2048: at most 64 fp32 values a lane. Registers a
// thread (nvcc -Xptxas -v, sm_90a, -O3, CUDA 12.8), none spilling: bf16
// kChunks 1, 2, 4, 8: 30, 36, 53, 88; fp32 kChunks 1, 2, 4, 8, 16: 26,
// 29, 38, 56, 94.
//
// Route 0, softmax_fwd_kernel<T, kCached>, everything else: neighbour
// lanes read neighbour elements one at a time. It caches the row's
// scaled, masked fp32 values in shared memory (8 KB a warp up to sk =
// 2048), so the scores are read from memory once: pass 1 takes the max,
// pass 2 the exps and their sum, pass 3 divides and stores. Longer rows
// re-read x and the mask in each pass instead.
//
// Both routes round the product scale * x on its own (__fmul_rn), never
// contracted into the subtraction of the max, take expf (no fast math)
// and divide with IEEE division; each sums a row in a fixed order, so a
// row gives the same bits on every launch. The backward reads y and dy
// twice, the second time mostly from L1. Arithmetic is fp32 for fp32 and
// bf16 I/O; the wrapper widens float16 to fp32 around the kernel, as the
// JAX function does.
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

// ---------------------------------------------------------------------------
// route 1: the row in registers
// ---------------------------------------------------------------------------

// the longest row route 1 takes (kChunks * 32 * V columns at most)
constexpr int kRowsMaxCols = 2048;

// the V mask bytes of one vector (one 8- or 4-byte load), byte i in bits
// [8i, 8i + 8)
template <int V>
__device__ __forceinline__ unsigned long long mask_bytes(const uint8_t* p) {
  if constexpr (V == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return ((unsigned long long)w.y << 32) | w.x;
  } else {
    static_assert(V == 4, "a vector is 8 bf16 or 4 fp32 values");
    return *reinterpret_cast<const unsigned int*>(p);
  }
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kSmThreads)
softmax_fwd_rows_kernel(const T* __restrict__ x,
                        const uint8_t* __restrict__ mask, T* __restrict__ y,
                        long long rows, int sq, int sk, int mask_ratio,
                        float scale, int causal) {
  constexpr int V = Vec<T>::N;
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
  const int last = causal ? min(w.r, sk - 1) : sk - 1;

  // load the vectors that start at or before `last`, scaled and masked
  // (-inf where invalid), and take the max; a causal row short of sk has
  // invalid entries whether it loads them or not
  float v[kChunks][V];
  float m = -CUDART_INF_F;
  bool invalid = last < sk - 1;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (32 * c + lane) * V;
    if (col <= last) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + col);
      const T* e = reinterpret_cast<const T*>(&raw);
      const unsigned long long mb = mr != nullptr ? mask_bytes<V>(mr + col)
                                                  : 0ull;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const bool ok = col + i <= last && ((mb >> (8 * i)) & 0xffu) == 0;
        invalid |= !ok;
        v[c][i] = ok ? __fmul_rn(to_float<T>(e[i]), scale) : -CUDART_INF_F;
        m = fmaxf(m, v[c][i]);
      }
    }
  }
  m = warp_max(m);
  if (__any_sync(0xffffffffu, invalid)) m = fmaxf(m, kFill);

  // the exps and their sum, lane by lane in chunk order, then the warp's
  // butterfly: the same order on every launch
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (32 * c + lane) * V;
    if (col <= last) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[c][i] = expf(v[c][i] - m);
        sum += v[c][i];
      }
    }
  }
  const float denom = fmaxf(warp_sum(sum), 1e-30f);

  // normalise and store; a vector past the diagonal is a 16-byte zero
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = (32 * c + lane) * V;
    if (col >= sk) continue;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (col <= last) {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = from_float<T>(v[c][i] / denom);
    }
    *reinterpret_cast<uint4*>(yr + col) = raw;
  }
}

// route 1's launch: kChunks the row's vector count a lane, rounded up to
// a power of two, K the instance tried (1, 2, 4, ... up to the cap)
template <typename T, int K>
cudaError_t launch_fwd_rows(const T* x, const uint8_t* mask, T* y,
                            long long rows, int sq, int sk, int mask_ratio,
                            float scale, int causal, cudaStream_t st) {
  constexpr int kMax = kRowsMaxCols / (32 * Vec<T>::N);
  if constexpr (K < kMax) {
    if (sk > K * 32 * Vec<T>::N)
      return launch_fwd_rows<T, 2 * K>(x, mask, y, rows, sq, sk, mask_ratio,
                                       scale, causal, st);
  }
  const long long blocks = (rows + kSmWarps - 1) / kSmWarps;
  softmax_fwd_rows_kernel<T, K><<<(unsigned)blocks, kSmThreads, 0, st>>>(
      x, mask, y, rows, sq, sk, mask_ratio, scale, causal);
  return cudaGetLastError();
}

// whether route 1 takes these operands: the wrapper's fwd_route, again
template <typename T>
bool rows_route_ok(const void* x, const void* mask, const void* y, int sk) {
  constexpr int V = Vec<T>::N;
  return sk % V == 0 && sk <= kRowsMaxCols &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(mask) % V == 0;
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
                       float scale, int causal, int route, cudaStream_t st) {
  const long long blocks = (rows + kSmWarps - 1) / kSmWarps;
  const T* xp = static_cast<const T*>(x);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  T* yp = static_cast<T*>(y);
  if (route == 1) {
    if (!rows_route_ok<T>(x, mask, y, sk)) return cudaErrorInvalidValue;
    return launch_fwd_rows<T, 1>(xp, mp, yp, rows, sq, sk, mask_ratio, scale,
                                 causal, st);
  }
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
// wrapper checks). route 1 runs the row-in-registers kernel and needs sk
// a multiple of 16 / sizeof(dtype) and at most 2048, x and y 16-byte
// aligned and the mask aligned to 16 / sizeof(dtype) bytes; route 0 runs
// the general kernel and needs no alignment. Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for a shape, dtype or route the
// kernel was not built for (nothing launched: a route that cannot run is
// refused, never swapped for the other).
extern "C" int apex_tpu_torch_softmax_fwd(const void* x, const void* mask,
                                          void* y, long long rows, int sq,
                                          int sk, int mask_ratio, float scale,
                                          int causal, int dtype, int route,
                                          void* stream) {
  if (rows <= 0 || sq <= 0 || sk <= 0 || rows % sq || mask_ratio <= 0 ||
      rows / kSmWarps >= 0x7fffffffLL || (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_fwd<float>(x, mask, y, rows, sq, sk, mask_ratio, scale,
                               causal, route, st);
    case kBFloat16:
      return launch_fwd<__nv_bfloat16>(x, mask, y, rows, sq, sk, mask_ratio,
                                       scale, causal, route, st);
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

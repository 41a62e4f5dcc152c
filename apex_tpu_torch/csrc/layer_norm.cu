// LayerNorm / RMSNorm over the last axis, forward and backward.
//
// Replaces: apex_tpu/kernels/layer_norm.py:_fwd (kernel body _fwd_kernel)
// and :_bwd (kernel body _bwd_kernel), apex's fused_layer_norm_cuda. One
// pair of kernels serves both statistics: subtract_mean = 0 is RMSNorm.
//
// What bounds it on an H100: memory. The forward reads x and writes y (two
// bf16 bytes each an element) against about 8 flops; the backward reads x
// and dy and writes dx. At BERT-large's [16384, 1024] bf16 that is 67 MB
// forward (0.020 ms at 3.35 TB/s) and 101 MB backward (0.030 ms).
//
// What the design does about it. One warp owns one row: the row's two
// sums (the mean, then the squared deviations about it: the masked
// two-moment form of the JAX kernel, not Welford) are warp shuffles, and
// no block-wide barrier sits in the row loop. Loads and stores are 16-byte
// vectors when the width allows it (hidden a multiple of 8 for bf16, of 4
// for fp32), scalar otherwise, so any hidden size works (513 does). The
// row is read once from device memory; the later passes over it within
// the warp hit L1. Statistics and arithmetic are fp32 whatever the I/O
// type, and mean and rstd are saved in fp32 for the backward.
//
// The TPU backward sums dw and db by carrying one output block across a
// sequential grid. H100 blocks run in no order, so the backward is two
// deterministic passes without atomics: each block strides over a fixed
// set of rows, every lane accumulates its own columns' dy*xhat and dy in
// its warp's slice of shared memory (no other thread touches them), the
// block's warps are added in warp order and the block writes one fp32
// partial row to a workspace; a second kernel sums the partials of each
// column in a fixed order. The grid depends only on the row count, so dw
// and db are the same bit for bit from launch to launch.
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kLnWarps = 8;                 // rows in flight per block
constexpr int kLnThreads = kLnWarps * 32;
constexpr int kLnSms = 132;
constexpr int kLnFwdBlocks = 8 * kLnSms;    // cap of the forward grid
constexpr int kLnBwdBlocks = 2 * kLnSms;    // partial rows of the backward
constexpr int kColWarps = 8;                // row groups of the column pass
constexpr int kMaxBwdSmem = 232448;         // the H100's per-block limit

// K consecutive elements of S widened to fp32, in the widest loads the
// byte count allows (K * sizeof(S) is 16-aligned for the vector path)
template <typename S, int K>
__device__ __forceinline__ void load_n(const S* __restrict__ src, float* d) {
  if constexpr (K * sizeof(S) % 16 == 0) {
    constexpr int P = 16 / sizeof(S);
#pragma unroll
    for (int i = 0; i < K; i += P) load_vec<S>(src + i, d + i);
  } else if constexpr (K * sizeof(S) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int i = 0; i < K; ++i) d[i] = to_float<S>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) d[i] = to_float<S>(src[i]);
  }
}

template <typename S, int K>
__device__ __forceinline__ void store_n(S* __restrict__ dst, const float* s) {
  if constexpr (K * sizeof(S) % 16 == 0) {
    constexpr int P = 16 / sizeof(S);
#pragma unroll
    for (int i = 0; i < K; i += P) {
      uint4 raw;
      S* e = reinterpret_cast<S*>(&raw);
#pragma unroll
      for (int j = 0; j < P; ++j) e[j] = from_float<S>(s[i + j]);
      *reinterpret_cast<uint4*>(dst + i) = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) dst[i] = from_float<S>(s[i]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// KV: elements a lane moves per access (Vec<T>::N on the vector path, 1
// otherwise); hidden is a multiple of KV
template <typename T, typename W, int KV>
__global__ void __launch_bounds__(kLnThreads)
ln_fwd_kernel(const T* __restrict__ x, const W* __restrict__ w,
              const W* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int rows, int hidden, float eps, int subtract_mean) {
  const int lane = threadIdx.x & 31;
  const int step = 32 * KV;
  const float inv_h = 1.0f / hidden;
  for (int row = blockIdx.x * kLnWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kLnWarps) {
    const T* xr = x + (long long)row * hidden;
    float mu = 0.f;
    if (subtract_mean) {
      float s = 0.f;
      for (int c = lane * KV; c < hidden; c += step) {
        float e[KV];
        load_n<T, KV>(xr + c, e);
#pragma unroll
        for (int i = 0; i < KV; ++i) s += e[i];
      }
      mu = warp_sum(s) * inv_h;
    }
    float ss = 0.f;
    for (int c = lane * KV; c < hidden; c += step) {
      float e[KV];
      load_n<T, KV>(xr + c, e);
#pragma unroll
      for (int i = 0; i < KV; ++i) {
        const float d = e[i] - mu;
        ss += d * d;
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) * inv_h + eps);
    T* yr = y + (long long)row * hidden;
    for (int c = lane * KV; c < hidden; c += step) {
      float e[KV], wv[KV], bv[KV];
      load_n<T, KV>(xr + c, e);
      load_n<W, KV>(w + c, wv);
      load_n<W, KV>(b + c, bv);
#pragma unroll
      for (int i = 0; i < KV; ++i) e[i] = (e[i] - mu) * rstd * wv[i] + bv[i];
      store_n<T, KV>(yr + c, e);
    }
    if (lane == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// ---------------------------------------------------------------------------
// backward, pass 1: dx per row, and one block's column partials
// ---------------------------------------------------------------------------

// dynamic shared memory: kLnWarps x 2 x hidden fp32 (per warp: dw, db)
template <typename T, typename W, int KV>
__global__ void __launch_bounds__(kLnThreads)
ln_bwd_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ partial, int rows, int hidden,
                   int subtract_mean) {
  extern __shared__ float acc[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int step = 32 * KV;
  const float inv_h = 1.0f / hidden;
  float* dw_acc = acc + (2 * warp) * hidden;
  float* db_acc = dw_acc + hidden;
  // each lane zeroes, and later accumulates, only its own columns of its
  // warp's slice (the same lane * KV + k * step groups in both loops), so
  // no barrier is needed until the warps are added
  for (int c = lane * KV; c < hidden; c += step) {
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      dw_acc[c + i] = 0.f;
      db_acc[c + i] = 0.f;
    }
  }
  for (int row = blockIdx.x * kLnWarps + warp; row < rows;
       row += gridDim.x * kLnWarps) {
    const T* xr = x + (long long)row * hidden;
    const T* dyr = dy + (long long)row * hidden;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * KV; c < hidden; c += step) {
      float xe[KV], ge[KV], wv[KV];
      load_n<T, KV>(xr + c, xe);
      load_n<T, KV>(dyr + c, ge);
      load_n<W, KV>(w + c, wv);
#pragma unroll
      for (int i = 0; i < KV; ++i) {
        const float xhat = (xe[i] - mu) * rs;
        const float wdy = ge[i] * wv[i];
        s1 += wdy * xhat;
        s2 += wdy;
      }
    }
    const float c1 = warp_sum(s1) * inv_h;
    const float c2 = subtract_mean ? warp_sum(s2) * inv_h : 0.f;
    T* dxr = dx + (long long)row * hidden;
    for (int c = lane * KV; c < hidden; c += step) {
      float xe[KV], ge[KV], wv[KV], out[KV];
      load_n<T, KV>(xr + c, xe);
      load_n<T, KV>(dyr + c, ge);
      load_n<W, KV>(w + c, wv);
#pragma unroll
      for (int i = 0; i < KV; ++i) {
        const float xhat = (xe[i] - mu) * rs;
        out[i] = (ge[i] * wv[i] - xhat * c1 - c2) * rs;
        dw_acc[c + i] += ge[i] * xhat;
        db_acc[c + i] += ge[i];
      }
      store_n<T, KV>(dxr + c, out);
    }
  }
  __syncthreads();
  // the block's partial row: its warps added in warp order
  float* out = partial + (long long)blockIdx.x * 2 * hidden;
  for (int c = threadIdx.x; c < 2 * hidden; c += kLnThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kLnWarps; ++k) s += acc[2 * k * hidden + c];
    out[c] = s;
  }
}

// ---------------------------------------------------------------------------
// backward, pass 2: per column, the blocks' partials in a fixed order
// ---------------------------------------------------------------------------

// grid (ceil(hidden / 32), 2): blockIdx.y 0 sums dw, 1 sums db. Warp k
// adds partial rows k, k + kColWarps, ... of 32 neighbouring columns; the
// warps' sums are then added in warp order.
__global__ void __launch_bounds__(kColWarps * 32)
ln_bwd_cols_kernel(const float* __restrict__ partial, int nblk, int hidden,
                   float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float red[kColWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int which = blockIdx.y;
  float s = 0.f;
  if (col < hidden) {
    for (int j = warp; j < nblk; j += kColWarps)
      s += partial[((long long)j * 2 + which) * hidden + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < hidden) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kColWarps; ++k) t += red[k][lane];
    (which == 0 ? dw : db)[col] = t;
  }
}

// the backward's partial rows for `rows` rows (its workspace holds
// bwd_blocks(rows) x 2 x hidden fp32)
int bwd_blocks(int rows) {
  const int want = (rows + kLnWarps - 1) / kLnWarps;
  return want < kLnBwdBlocks ? want : kLnBwdBlocks;
}

template <typename T, typename W>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int rows, int hidden,
                       float eps, int subtract_mean, bool vec,
                       cudaStream_t st) {
  const int want = (rows + kLnWarps - 1) / kLnWarps;
  const int blocks = want < kLnFwdBlocks ? want : kLnFwdBlocks;
  auto args = [&](auto kernel) {
    kernel<<<blocks, kLnThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const W*>(b), static_cast<T*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), rows, hidden,
        eps, subtract_mean);
  };
  if (vec) {
    args(ln_fwd_kernel<T, W, Vec<T>::N>);
  } else {
    args(ln_fwd_kernel<T, W, 1>);
  }
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch_bwd(const void* x, const void* w, const void* mean,
                       const void* rstd, const void* dy, void* dx, void* dw,
                       void* db, void* workspace, int rows, int hidden,
                       int subtract_mean, bool vec, cudaStream_t st) {
  const int nblk = bwd_blocks(rows);
  const size_t smem = (size_t)kLnWarps * 2 * hidden * sizeof(float);
  // above 48 KB of dynamic shared memory a kernel must opt in: done once
  // per instantiation, at the first launch (never inside a graph capture
  // that replays it)
  static const cudaError_t opt_in = [] {
    for (auto k : {ln_bwd_rows_kernel<T, W, Vec<T>::N>,
                   ln_bwd_rows_kernel<T, W, 1>}) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxBwdSmem);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  if (opt_in != cudaSuccess) return opt_in;
  auto run = [&](auto kernel) -> cudaError_t {
    kernel<<<nblk, kLnThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(workspace), rows, hidden, subtract_mean);
    return cudaGetLastError();
  };
  const cudaError_t err = vec ? run(ln_bwd_rows_kernel<T, W, Vec<T>::N>)
                              : run(ln_bwd_rows_kernel<T, W, 1>);
  if (err != cudaSuccess) return err;
  dim3 grid((hidden + 31) / 32, 2);
  ln_bwd_cols_kernel<<<grid, kColWarps * 32, 0, st>>>(
      static_cast<const float*>(workspace), nblk, hidden,
      static_cast<float*>(dw), static_cast<float*>(db));
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

namespace {

// the 16-byte path needs hidden a multiple of the vector width and every
// base pointer 16-byte aligned (the wrapper checks alignment)
bool vector_ok(int hidden, int x_dtype) {
  return hidden % (x_dtype == kFloat32 ? 4 : 8) == 0;
}

// the largest hidden the backward's shared-memory accumulators allow
constexpr int kMaxBwdHidden = kMaxBwdSmem / (kLnWarps * 2 * 4);

}  // namespace

// x [rows, hidden] in x_dtype, w/b [hidden] in w_dtype, y like x, mean and
// rstd fp32 [rows]; contiguous, 16-byte aligned. Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a dtype
// or shape the kernels were not built for (nothing launched).
extern "C" int apex_tpu_torch_layer_norm_fwd(
    const void* x, const void* w, const void* b, void* y, void* mean,
    void* rstd, int rows, int hidden, float eps, int subtract_mean,
    int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || hidden <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_ok(hidden, x_dtype);
#define APEX_LN_FWD(T, W)                                                    \
  return launch_fwd<T, W>(x, w, b, y, mean, rstd, rows, hidden, eps,       \
                          subtract_mean, vec, st)
  if (x_dtype == kFloat32 && w_dtype == kFloat32) APEX_LN_FWD(float, float);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    APEX_LN_FWD(float, __nv_bfloat16);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    APEX_LN_FWD(__nv_bfloat16, float);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    APEX_LN_FWD(__nv_bfloat16, __nv_bfloat16);
#undef APEX_LN_FWD
  return cudaErrorInvalidValue;
}

// The number of partial rows the backward writes for `rows` rows: its
// workspace is that x 2 x hidden fp32.
extern "C" int apex_tpu_torch_layer_norm_bwd_blocks(int rows) {
  return rows > 0 ? bwd_blocks(rows) : 0;
}

// x, dy, dx [rows, hidden] in x_dtype; w [hidden] in w_dtype; mean/rstd
// fp32 [rows] from the forward; dw/db fp32 [hidden]; workspace fp32
// [layer_norm_bwd_blocks(rows), 2, hidden]. Two launches: the rows pass
// and the column pass.
extern "C" int apex_tpu_torch_layer_norm_bwd(
    const void* x, const void* w, const void* mean, const void* rstd,
    const void* dy, void* dx, void* dw, void* db, void* workspace, int rows,
    int hidden, int subtract_mean, int x_dtype, int w_dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden > kMaxBwdHidden)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_ok(hidden, x_dtype);
#define APEX_LN_BWD(T, W)                                                    \
  return launch_bwd<T, W>(x, w, mean, rstd, dy, dx, dw, db, workspace, rows, \
                          hidden, subtract_mean, vec, st)
  if (x_dtype == kFloat32 && w_dtype == kFloat32) APEX_LN_BWD(float, float);
  if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    APEX_LN_BWD(float, __nv_bfloat16);
  if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    APEX_LN_BWD(__nv_bfloat16, float);
  if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    APEX_LN_BWD(__nv_bfloat16, __nv_bfloat16);
#undef APEX_LN_BWD
  return cudaErrorInvalidValue;
}

// Block math shared by the head-major flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): tiles of 64 rows of one
// (batch * head) row of q [bh, sq, d] or k/v [bh, sk, d], widened to fp32
// in shared memory and zero-padded to the padded head width DP; the
// composed column mask of _valid_cols (apex_tpu/kernels/flash_attention.py
// :150); the 64 x 64 score product; and the _p_ds block math (:170).
//
// Every 64 x 64 tile product is split over 256 threads, each owning the
// 4 x 4 entries at rows ty + 16 i and columns tx + 16 j (ty, tx in
// [0, 16)). The 16 threads of one ty are 16 consecutive lanes of a warp,
// so a row's reductions are four xor shuffles within the half-warp. Tiles
// are stored at a padded row stride (DP + 1 floats, DP in {64, 80, 128}),
// which puts the sixteen rows one thread group reads in sixteen banks.
#pragma once

#include "common.cuh"

namespace apex_tpu_torch {
namespace hm {

constexpr int kB = 64;           // rows of a query tile and of a key tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdS = kB + 1;     // padded row stride of score tiles
constexpr int kSTile = kB * kLdS;

template <int DP>
struct Geo {
  static constexpr int kLd = DP + 1;       // padded row stride
  static constexpr int kTile = kB * kLd;   // floats of one head-row tile
  static constexpr int kDJ = DP / 16;      // head dims a thread owns
  static_assert(DP % 16 == 0 && DP <= 128, "padded head width");
};

// rows [r0, r0 + kB) of one [rows, d] matrix into a kB x (DP + 1) fp32
// tile. The rows are contiguous in the head-major layout, so the 64-row
// tile is one run of 64 * d elements: consecutive threads read
// consecutive elements. Rows at or past `rows` and columns at or past `d`
// become zeros.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int d) {
  for (int i = threadIdx.x; i < kB * DP; i += kThreads) {
    const int r = i / DP;
    const int c = i - r * DP;
    float x = 0.f;
    if (r0 + r < rows && c < d) x = to_float<T>(src[(size_t)(r0 + r) * d + c]);
    dst[r * Geo<DP>::kLd + c] = x;
  }
}

// per-row fp32 statistics (lse, delta) of rows [r0, r0 + kB): zeros past
// `rows`
__device__ __forceinline__ void load_stats(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int rows) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    dst[i] = r0 + i < rows ? src[r0 + i] : 0.f;
}

// segment ids of rows [r0, r0 + kB) of one batch row (-1 past `rows`, the
// JAX kernels' pad id); nothing when there are no segment ids
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ src,
                                         int r0, int rows) {
  if (src == nullptr) return;
  for (int i = threadIdx.x; i < kB; i += kThreads)
    dst[i] = r0 + i < rows ? src[r0 + i] : -1;
}

// The _valid_cols mask of one (query tile, key tile) pair, for this
// thread's entries: col < kv_end (the smaller of sk and the row's
// kv_length), the same segment id (when there are segment ids), causal
// col <= row, and rows past sq (padding, never stored) invalid.
struct Mask {
  int kv_end;      // min(sk, kv_length), at least 0
  int sq;
  int causal;
  bool segs;
  const int* seg_q;   // shared: this query tile's ids
  const int* seg_k;   // shared: this key tile's ids

  __device__ __forceinline__ bool valid(int q0, int k0, int lr, int lc) const {
    const int row = q0 + lr;
    const int col = k0 + lc;
    return row < sq && col < kv_end && (!causal || col <= row) &&
           (!segs || seg_q[lr] == seg_k[lc]);
  }
};

// the row's max (or sum) over the 16 threads that share a ty
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// a[r] . b[c] over the padded head width for this thread's 4 x 4 entries
template <int DP>
__device__ __forceinline__ void dot_tile(const float* as, const float* bs,
                                         int ty, int tx, float s[4][4]) {
  constexpr int LD = Geo<DP>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < DP; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * LD + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[(tx + 16 * j) * LD + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
  }
}

// The _p_ds block math for this thread's entries: S = Q K^T * scale,
// P = exp(S - lse) where valid (else 0), dP = dO V^T,
// dS = P * (dP - delta) * scale. P and dS stay in fp32.
template <int DP>
__device__ __forceinline__ void p_ds(const float* qs, const float* ks,
                                     const float* dos, const float* vs,
                                     const float* lse_s, const float* del_s,
                                     const Mask& mask, int q0, int k0,
                                     float scale, int ty, int tx,
                                     float p[4][4], float ds[4][4]) {
  float s[4][4], dp[4][4];
  dot_tile<DP>(qs, ks, ty, tx, s);
  dot_tile<DP>(dos, vs, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = mask.valid(q0, k0, lr, tx + 16 * j);
      p[i][j] = ok ? expf(s[i][j] * scale - lse_s[lr]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - del_s[lr]) * scale;
    }
  }
}

// the padded head width a head width runs at: 64, 80 or 128
__host__ __forceinline__ int padded_width(int d) {
  return d <= 64 ? 64 : d <= 80 ? 80 : 128;
}

// a kernel that needs more than 48 KB of dynamic shared memory must ask
// for it, once per instantiation (before any launch, so no CUDA-graph
// capture sees the call)
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace hm
}  // namespace apex_tpu_torch

// Flash-attention backward over the model layout [b, s, hidden].
//
// Replaces: apex_tpu/kernels/flash_attention.py:_run_bwd_bsh (kernel body
// _dqkv_kernel_bsh, block math _p_ds), the backward of the lane-packed
// forward that every training step runs once per layer, for fp32 and fp16
// (widened) inputs; bf16 takes the tensor-core kernel of flash_bwd_tc.cu
// (kernels/flash_attention.py:tc_route). Its bf16 instantiation stays
// for timing that kernel against this one on the same inputs.
//
// What bounds it on an H100: operations. Causal at b=16, s=1024, 16
// heads of 64 it does five s x s x 64 products over the lower triangle,
// about 8.6e10 flops, against about 0.24 GB of operands and gradients:
// 360 flops per byte, above the card's ~295, so the floor is the tensor
// cores' 0.087 ms.
//
// What the design does about it: this first version is right and simple,
// and leaves the tensor cores (mma/wgmma) and TMA to a later PR. All
// arithmetic is fp32 on the CUDA cores, with P and dS kept in fp32 (the
// JAX kernel rounds them to the input dtype before its four products).
// It is two deterministic passes, with no atomics:
//
// - dK/dV: one block per (batch, head, 64-key tile). K and V stay in
//   shared memory while the block walks the 64-row query tiles from the
//   diagonal down (_causal_skip), recomputing P = exp(S*scale - lse) and
//   dS = P * (dP - delta) * scale for each, and accumulating dV += P^T dO
//   and dK += dS^T Q in registers.
// - dQ: one block per (batch, head, 64-row query tile). Q and dO stay in
//   shared memory while the block walks the key tiles up to the
//   diagonal, recomputing dS and accumulating dQ += dS K.
//
// Every 64 x 64 product is split over 256 threads, each owning a 4 x 4
// set of entries at a stride of 16 rows and 16 columns, so one warp reads
// two rows of one operand (a broadcast) and sixteen consecutive rows of
// the other, whose padded stride (65 floats) puts them in sixteen banks.
// Head rows are read straight from the strided [b, s, hidden] layout at
// column head*D with 16-byte loads, widened to fp32. Rows past sq and
// keys past sk load zeros, are masked out of P (the _valid_cols rule) and
// are never stored.
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kB = 64;              // rows of a query tile and of a key tile
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kLd = kHeadDim + 1;   // padded row stride of head-row tiles
constexpr int kLdS = kB + 1;        // padded row stride of P / dS tiles
constexpr int kTile = kB * kLd;     // floats of one head-row tile
constexpr int kSTile = kB * kLdS;   // floats of one P / dS tile

// rows [r0, r0 + kB) of one head of a [b, s, hidden] tensor into a
// kB x kLd fp32 tile; rows at or past `rows` become zeros
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                          int rows, int hidden) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = kHeadDim / VEC;
  for (int i = threadIdx.x; i < kB * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * VEC;
    float t[VEC];
    if (r0 + r < rows) {
      load_vec<T>(src + (size_t)(r0 + r) * hidden + c, t);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * kLd + c + e] = t[e];
  }
}

// the per-row statistics of rows [r0, r0 + kB): zeros past `rows`
__device__ void load_stats(float* dst, const float* __restrict__ src, int r0,
                           int rows) {
  for (int i = threadIdx.x; i < kB; i += kThreads)
    dst[i] = r0 + i < rows ? src[r0 + i] : 0.f;
}

// dS (and P) of one (query tile, key tile) pair for this thread's 4 x 4
// entries: rows ty + 16 i, columns tx + 16 j. The _p_ds block math.
__device__ __forceinline__ void p_ds(const float* qs, const float* ks,
                                     const float* dos, const float* vs,
                                     const float* lse_s, const float* del_s,
                                     int q0, int k0, int sq, int sk,
                                     int causal, float scale, int ty, int tx,
                                     float p[4][4], float ds[4][4]) {
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < kHeadDim; ++e) {
    float a[4], o[4], bk[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * kLd + e];
      o[i] = dos[(ty + 16 * i) * kLd + e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bk[j] = ks[(tx + 16 * j) * kLd + e];
      bv[j] = vs[(tx + 16 * j) * kLd + e];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * bk[j];
        dp[i][j] += o[i] * bv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i;
    const int row = q0 + lr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      const bool valid = row < sq && col < sk && (!causal || col <= row);
      p[i][j] = valid ? expf(s[i][j] * scale - lse_s[lr]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - del_s[lr]) * scale;
    }
  }
}

// pass 1: dK and dV of one (batch, head, key tile)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int sk, int hidden,
                      int heads, float scale, int causal) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile;
  float* qs = vs + kTile;
  float* dos = qs + kTile;
  float* ps = dos + kTile;
  float* dss = ps + kSTile;
  float* lse_s = dss + kSTile;
  float* del_s = lse_s + kB;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.y * kB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t qoff = (size_t)b * sq * hidden + (size_t)h * kHeadDim;
  const size_t koff = (size_t)b * sk * hidden + (size_t)h * kHeadDim;
  const float* lse_b = lse + (size_t)bh * sq;
  const float* del_b = delta + (size_t)bh * sq;

  load_tile<T>(ks, k + koff, k0, sk, hidden);
  load_tile<T>(vs, v + koff, k0, sk, hidden);

  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  // causal: query tiles wholly above this key tile see none of its keys
  const int q_first = causal ? k0 : 0;
  for (int q0 = q_first; q0 < sq; q0 += kB) {
    __syncthreads();  // the previous tile's P / dS and Q / dO are consumed
    load_tile<T>(qs, q + qoff, q0, sq, hidden);
    load_tile<T>(dos, dout + qoff, q0, sq, hidden);
    load_stats(lse_s, lse_b, q0, sq);
    load_stats(del_s, del_b, q0, sq);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds(qs, ks, dos, vs, lse_s, del_s, q0, k0, sq, sk, causal, scale, ty,
         tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty + 16 * i) * kLdS + tx + 16 * j] = p[i][j];
        dss[(ty + 16 * i) * kLdS + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // this thread now owns keys ty + 16 i and head dims tx + 16 j
#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      float pc[4], dc[4], o[4], qq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pc[i] = ps[r * kLdS + ty + 16 * i];
        dc[i] = dss[r * kLdS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = dos[r * kLd + tx + 16 * j];
        qq[j] = qs[r * kLd + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dva[i][j] += pc[i] * o[j];
          dka[i][j] += dc[i] * qq[j];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    T* dkr = dk + koff + (size_t)key * hidden;
    T* dvr = dv + koff + (size_t)key * hidden;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dkr[tx + 16 * j] = from_float<T>(dka[i][j]);
      dvr[tx + 16 * j] = from_float<T>(dva[i][j]);
    }
  }
}

// pass 2: dQ of one (batch, head, query tile)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int sq, int sk, int hidden, int heads, float scale,
                    int causal) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile;
  float* ks = dos + kTile;
  float* vs = ks + kTile;
  float* dss = vs + kTile;
  float* lse_s = dss + kSTile;
  float* del_s = lse_s + kB;

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const size_t qoff = (size_t)b * sq * hidden + (size_t)h * kHeadDim;
  const size_t koff = (size_t)b * sk * hidden + (size_t)h * kHeadDim;

  load_tile<T>(qs, q + qoff, q0, sq, hidden);
  load_tile<T>(dos, dout + qoff, q0, sq, hidden);
  load_stats(lse_s, lse + (size_t)bh * sq, q0, sq);
  load_stats(del_s, delta + (size_t)bh * sq, q0, sq);

  float dqa[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;

  // causal: key tiles wholly above the diagonal of this query tile skip
  const int k_end = causal ? min(sk, q0 + kB) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous K / V / dS tiles are consumed
    load_tile<T>(ks, k + koff, k0, sk, hidden);
    load_tile<T>(vs, v + koff, k0, sk, hidden);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds(qs, ks, dos, vs, lse_s, del_s, q0, k0, sq, sk, causal, scale, ty,
         tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kLdS + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // this thread owns query rows ty + 16 i and head dims tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[c * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dqa[i][j] += a[i] * kk[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    T* dqr = dq + qoff + (size_t)row * hidden;
#pragma unroll
    for (int j = 0; j < 4; ++j) dqr[tx + 16 * j] = from_float<T>(dqa[i][j]);
  }
}

constexpr size_t kDkdvSmem =
    (4 * (size_t)kTile + 2 * (size_t)kSTile + 2 * kB) * sizeof(float);
constexpr size_t kDqSmem =
    (4 * (size_t)kTile + (size_t)kSTile + 2 * kB) * sizeof(float);

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int b, int sq, int sk,
                   int hidden, int heads, float scale, int causal,
                   cudaStream_t stream) {
  // above 48 KB a block's shared memory must be asked for explicitly
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDqSmem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel<T>
      <<<dim3(b * heads, (sk + kB - 1) / kB), kThreads, kDkdvSmem, stream>>>(
          qt, kt, vt, dot, ls, dl, static_cast<T*>(dk), static_cast<T*>(dv),
          sq, sk, hidden, heads, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T>
      <<<dim3(b * heads, (sq + kB - 1) / kB), kThreads, kDqSmem, stream>>>(
          qt, kt, vt, dot, ls, dl, static_cast<T*>(dq), sq, sk, hidden, heads,
          scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q/dout/dq [b, sq, hidden], k/v/dk/dv [b, sk, hidden] (dtype of q), lse
// and delta fp32 [b, heads, sq]. Returns cudaGetLastError() after the
// launches; cudaErrorInvalidValue for a dtype, head_dim or shape the
// kernels were not built for (nothing launched).
extern "C" int apex_tpu_torch_flash_bwd_bsh(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int sq, int sk, int hidden, int heads, float scale, int causal,
    int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      hidden != heads * kHeadDim || (causal && sq != sk))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk,
                           hidden, heads, scale, causal, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b,
                                   sq, sk, hidden, heads, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

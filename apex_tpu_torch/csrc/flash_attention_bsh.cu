// Causal flash-attention forward over the model layout [b, s, hidden].
//
// Replaces: apex_tpu/kernels/flash_attention.py:_run_fwd_bsh (kernel body
// _fwd_kernel_bsh), the lane-packed Pallas forward that bulk prefill runs
// (gpt._attention_ctx with attn_impl="flash").
//
// What bounds it on an H100: at the serving slice's shapes (b <= 4,
// s <= 64, hidden 1024, 16 heads of 64) one call moves at most ~2 MB and
// does at most ~70 MFLOP, which is about a microsecond of either bound.
// Nothing at that size saturates bandwidth or the tensor cores: the time
// is launch latency plus the serial work of one block.
//
// What the design does about it: it keeps the per-block serial chain
// short rather than chasing peak rates. One block owns (batch, head,
// 16-query tile), so a 64-token bucket at b=4 already puts 256 blocks on
// the card. Q/K/V are read straight from the strided [b, s, hidden]
// layout at column offset head*D (one 64-wide fp32 head row is 256
// contiguous bytes: 16-byte vector loads, coalesced) into shared memory. Each warp owns 4 query rows; for a 32-key chunk every
// lane scores one key (q from shared memory by broadcast, the K row
// from a stride-(D+1) tile, so no bank conflicts), the warp folds the
// chunk into the running fp32 (m, l, acc) with the update of
// _online_update (flash_attention.py:79), and each lane accumulates D/32
// output dims. Chunks and tiles entirely above the diagonal are skipped
// (_causal_skip); the causal and col < sk masks are _valid_cols
// (flash_attention.py:150). This kernel is the fp32 forward (float16 is
// widened to it); bf16 runs the tensor-core kernel of flash_fwd_tc.cu.
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kBQ = 16;                    // query rows per block
constexpr int kBK = 64;                    // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBQ / kWarps;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bsh_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int sq, int sk, int hidden,
                     int heads, float scale, int causal) {
  constexpr int DPL = D / 32;              // output dims per lane
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;             // vectors per head row
  __shared__ float qs[kBQ][D];
  __shared__ float ks[kBK][D + 1];         // +1: conflict-free key rows
  __shared__ float vs[kBK][D];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const T* qb = q + (size_t)b * sq * hidden + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * hidden + (size_t)h * D;
  const T* vb = v + (size_t)b * sk * hidden + (size_t)h * D;

  for (int i = tid; i < kBQ * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i - r * VPR) * VEC;
    float t[VEC];
    if (q0 + r < sq) {
      load_vec<T>(qb + (size_t)(q0 + r) * hidden + c, t);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) qs[r][c + e] = t[e];
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[rr][t] = 0.f;
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = tid; i < kBK * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = (i - r * VPR) * VEC;
      float tk[VEC], tv[VEC];
      if (k0 + r < sk) {
        load_vec<T>(kb + (size_t)(k0 + r) * hidden + c, tk);
        load_vec<T>(vb + (size_t)(k0 + r) * hidden + c, tv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) tk[e] = tv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[r][c + e] = tk[e];
        vs[r][c + e] = tv[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int lr = warp * kRowsPerWarp + rr;
      const int row = q0 + lr;
      if (row >= sq) continue;  // warp-uniform
#pragma unroll
      for (int c0 = 0; c0 < kBK; c0 += 32) {
        // whole chunk past the horizon or above the diagonal: skip
        if (k0 + c0 >= sk || (causal && k0 + c0 > row)) continue;
        const int col = k0 + c0 + lane;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < D; ++e) s += qs[lr][e] * ks[c0 + lane][e];
        const bool valid = col < sk && (!causal || col <= row);
        s = valid ? s * scale : kNeg;
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float corr = expf(m[rr] - m_new);
        const float p = valid ? expf(s - m_new) : 0.f;
        l[rr] = corr * l[rr] + warp_sum(p);
#pragma unroll
        for (int t = 0; t < DPL; ++t) acc[rr][t] *= corr;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
          for (int t = 0; t < DPL; ++t)
            acc[rr][t] += pj * vs[c0 + j][lane + 32 * t];
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = q0 + warp * kRowsPerWarp + rr;
    if (row >= sq) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
    T* orow = out + ((size_t)b * sq + row) * hidden + (size_t)h * D;
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      orow[lane + 32 * t] = from_float<T>(acc[rr][t] / lc);
    if (lane == 0) lse[(size_t)bh * sq + row] = m[rr] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int b, int sq, int sk, int hidden, int heads,
                   float scale, int causal, cudaStream_t stream) {
  const dim3 grid(b * heads, (sq + kBQ - 1) / kBQ);
  flash_fwd_bsh_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, hidden, heads, scale, causal);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// out [b, sq, hidden] (dtype of q), lse fp32 [b, heads, sq]. Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a
// dtype or head_dim the kernel was not built for (nothing launched). fp32
// only: bf16 runs the tensor-core kernel of flash_fwd_tc.cu.
extern "C" int apex_tpu_torch_flash_fwd_bsh(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int sq, int sk, int hidden, int heads, float scale, int causal,
    int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      hidden != heads * kHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, kHeadDim>(q, k, v, out, lse, b, sq, sk, hidden,
                                     heads, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* apex_tpu_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

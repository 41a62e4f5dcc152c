// Flash-decode for the KV-cache decode step: the one-column cache write
// and the split-horizon attention read.
//
// Replaces: apex_tpu/kernels/decode_attention.py:_write_column (kernel
// body _write_kernel) and _run_attn (kernel body _attn_kernel), the two
// Pallas kernels decode_attention composes on gpt._decode_attend's
// kernel branch.
//
// What bounds them on an H100: both are memory-bound. The write moves
// 2 x b x h x d elements each way. The read moves, per (batch, head)
// row, q plus the K and V rows of columns 0..pos[b]: at the slice's
// shapes (b 8, h 16, S 192, d 64, bf16) at most ~6 MB per layer, under
// 2 microseconds at 3.35 TB/s, against ~0.8 MFLOP. At that size the
// launch latency and one block's serial sweep, not bandwidth, set the
// time.
//
// What the design does about it:
// - The write is one launch for both caches: one block per batch row
//   copies its [h, d] K and V rows into column pos[b], in place. No
//   other cache byte is read or written (the aliased-output contract of
//   _write_column).
// - The read is one block per (batch, head) row; its 4 warps split the
//   horizon into 32-column chunks (chunk c goes to warp c % 4). In a
//   chunk every lane scores one column (its K row by 16-byte vector
//   loads, q from shared memory) and the warp folds the chunk into an
//   fp32 online softmax (m, l, acc). The warps then merge their
//   (m, l, acc) in shared memory, so no second kernel is needed.
// - Columns past pos[b] are never read: chunks past pos are skipped
//   (the j*bk <= pos skip of _attn_kernel), and inside the last chunk
//   only columns <= pos enter the score and the P.V product. Stale
//   cache bytes past pos (what a retired request or an uninitialised
//   buffer left, NaN included) therefore contribute exact zeros, which
//   is what decode_attention.py:297-301 guards against.
// - Scores are fp32 and scaled in fp32, as in _attn_kernel.
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kWriteThreads = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename T>
__global__ void __launch_bounds__(kWriteThreads)
write_column_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                    T* __restrict__ k_cache, T* __restrict__ v_cache,
                    const int* __restrict__ pos, int h, int S, int d) {
  const int b = blockIdx.x;
  const int p = pos[b];
  if (p < 0 || p >= S) return;  // never write outside the row's horizon
  const int n = h * d;
  for (int i = threadIdx.x; i < n; i += kWriteThreads) {
    const int hh = i / d;
    const int dd = i - hh * d;
    const size_t dst = (((size_t)b * h + hh) * S + p) * d + dd;
    k_cache[dst] = k_new[(size_t)b * n + i];
    v_cache[dst] = v_new[(size_t)b * n + i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache,
                   const int* __restrict__ pos, T* __restrict__ out, int h,
                   int S, float scale) {
  constexpr int DPL = D / 32;
  constexpr int VEC = Vec<T>::N;
  __shared__ float qs[D];
  __shared__ float ms[kWarps];
  __shared__ float ls[kWarps];
  __shared__ float accs[kWarps][D];

  const int r = blockIdx.x;  // batch * h + head
  const int b = r / h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int p = min(max(pos[b], 0), S - 1);

  const T* kr = k_cache + (size_t)r * S * D;
  const T* vr = v_cache + (size_t)r * S * D;
  for (int i = tid; i < D; i += kThreads) qs[i] = to_float<T>(q[(size_t)r * D + i]);
  __syncthreads();

  float m = kNeg, l = 0.f, acc[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) acc[t] = 0.f;

  const int n_chunks = p / 32 + 1;  // chunks holding columns 0..p
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int col = c * 32 + lane;
    const bool valid = col <= p;
    float s = kNeg;
    if (valid) {
      const T* krow = kr + (size_t)col * D;
      float dot = 0.f;
#pragma unroll
      for (int e0 = 0; e0 < D; e0 += VEC) {
        float t[VEC];
        load_vec<T>(krow + e0, t);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qs[e0 + e] * t[e];
      }
      s = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = expf(m - m_new);
    const float prob = valid ? expf(s - m_new) : 0.f;
    l = corr * l + warp_sum(prob);
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[t] *= corr;
    const int jn = min(32, p - c * 32 + 1);  // columns <= p in this chunk
    for (int j = 0; j < jn; ++j) {
      const float pj = __shfl_sync(0xffffffffu, prob, j);
      const T* vrow = vr + (size_t)(c * 32 + j) * D;
#pragma unroll
      for (int t = 0; t < DPL; ++t)
        acc[t] += pj * to_float<T>(vrow[lane + 32 * t]);
    }
    m = m_new;
  }

  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
#pragma unroll
  for (int t = 0; t < DPL; ++t) accs[warp][lane + 32 * t] = acc[t];
  __syncthreads();
  if (warp == 0) {
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w]);
    float lsum = 0.f, o[DPL];
#pragma unroll
    for (int t = 0; t < DPL; ++t) o[t] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that swept no chunk holds (kNeg, 0, 0): its factor is 0
      const float f = expf(ms[w] - mx);
      lsum += ls[w] * f;
#pragma unroll
      for (int t = 0; t < DPL; ++t) o[t] += accs[w][lane + 32 * t] * f;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int t = 0; t < DPL; ++t)
      out[(size_t)r * D + lane + 32 * t] = from_float<T>(o[t] * inv);
  }
}

template <typename T>
cudaError_t launch_write(const void* k_new, const void* v_new, void* k_cache,
                         void* v_cache, const void* pos, int b, int h, int S,
                         int d, cudaStream_t stream) {
  write_column_kernel<T><<<b, kWriteThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache),
      static_cast<const int*>(pos), h, S, d);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_attn(const void* q, const void* k_cache,
                        const void* v_cache, const void* pos, void* out,
                        int b, int h, int S, float scale,
                        cudaStream_t stream) {
  decode_attn_kernel<T, D><<<b * h, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int*>(pos),
      static_cast<T*>(out), h, S, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// k_cache/v_cache [b, h, S, d] gain k_new/v_new [b, h, d] at column
// pos[b] (int32 [b], device), in place.
extern "C" int apex_tpu_torch_decode_write_column(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* pos, int b, int h, int S, int d, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_write<float>(k_new, v_new, k_cache, v_cache, pos, b, h,
                                 S, d, st);
    case kBFloat16:
      return launch_write<__nv_bfloat16>(k_new, v_new, k_cache, v_cache, pos,
                                         b, h, S, d, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out [b, h, d] = softmax(scale * q . K[:, :pos+1]) . V[:, :pos+1] per
// (batch, head) row over caches [b, h, S, d].
extern "C" int apex_tpu_torch_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* pos,
    void* out, int b, int h, int S, int d, float scale, int dtype,
    void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || d != kHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_attn<float, kHeadDim>(q, k_cache, v_cache, pos, out, b,
                                          h, S, scale, st);
    case kBFloat16:
      return launch_attn<__nv_bfloat16, kHeadDim>(q, k_cache, v_cache, pos,
                                                  out, b, h, S, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

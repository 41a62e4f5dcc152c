// Flash-decode for the KV-cache decode step, over the contiguous cache
// and the paged pool: the column writes and the split-horizon read.
//
// Replaces, in apex_tpu/kernels/decode_attention.py:
// - _write_column (kernel body _write_kernel) and _run_attn (body
//   _attn_kernel), the two Pallas kernels decode_attention composes on
//   gpt._decode_attend's kernel branch;
// - cache_write_columns (body _write_cols_kernel), the speculative
//   verify forward's T-column write (gpt._decode_attend_multi);
// - paged_write_column (body _paged_write_kernel), paged_write_columns
//   (body _paged_write_cols_kernel) and paged_attention (body
//   _paged_attn_kernel), the same three jobs through a per-row block
//   table into a global page pool (gpt._paged_attend and
//   gpt._paged_attend_multi).
//
// What bounds them on an H100: all are memory-bound. A write moves
// 2 x b x T x h x d elements each way. The read moves, per (batch,
// head) row, q plus the K and V rows of columns 0..pos[b]: at the
// slice's shapes (b 8, h 16, horizon 192, d 64, bf16) at most ~6 MB
// per layer, under 2 microseconds at 3.35 TB/s, against ~0.8 MFLOP.
// At that size the launch latency and one block's serial sweep, not
// bandwidth, set the time.
//
// What the design does about it:
// - All four writes are one kernel (write_columns_kernel), one launch
//   for both planes: one block per (row, lane) copies its [h, d] K and
//   V slab into its column in place, in 16-byte units where the head
//   row allows. The contiguous cache is the case without a table, one
//   "page" of S columns a row; a one-column write is T = 1. No other cache byte is
//   read or written (the aliased-output contract of the Pallas
//   writes). The paged writes look the column's page up in the row's
//   table: (table[b, c / P], c % P).
// - The multi-column writes clamp a lane past the horizon onto the
//   last column, as the Pallas index maps do. The Pallas grid runs in
//   order, so of several lanes clamped onto that column the last one
//   wins; here the blocks run in parallel, so only the row's last lane
//   writes the clamped column and the result is the same, every run.
//   The one-column writes never write outside the row's horizon.
// - The read is one block per (batch, head) row; its 4 warps split the
//   horizon into 32-column chunks (chunk c goes to warp c % 4). In a
//   chunk every lane scores one column (its K row by 16-byte vector
//   loads, q from shared memory) and the warp folds the chunk into an
//   fp32 online softmax (m, l, acc). The warps then merge their
//   (m, l, acc) in shared memory in warp order, so no second kernel is
//   needed. The contiguous and the paged read are ONE sweep
//   (attend_row) that differs only in where column c lives: the same
//   bytes in the same order give the same bits, so paged decode
//   equals contiguous decode bit for bit.
// - Columns past pos[b] are never read: chunks past pos are skipped
//   (the j*bk <= pos skip of _attn_kernel), and inside the last chunk
//   only columns <= pos enter the score and the P.V product. Stale
//   bytes past pos (what a retired request or an uninitialised buffer
//   left, NaN included; a recycled page; the sink page) therefore
//   contribute exact zeros, which is what decode_attention.py:297-301
//   guards against.
// - Scores are fp32 and scaled in fp32, as in _attn_kernel.
#include "common.cuh"

namespace apex_tpu_torch {
namespace {

constexpr int kWriteThreads = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Where a multi-column write lands: the contiguous cache [b, h, S, d]
// (table == nullptr, P == S) or the paged pool [num_pages, h, P, d]
// under table [b, mp]; in units U of the head row (units per row).
struct ColumnDst {
  const int* table;
  int h, P, mp, units;

  __device__ __forceinline__ size_t offset(int b, int hh, int c) const {
    if (table == nullptr)
      return (((size_t)b * h + hh) * P + c) * units;
    const int page = table[(size_t)b * mp + c / P];
    return (((size_t)page * h + hh) * P + c % P) * units;
  }
};

// One block per (row b, lane j): new[b, :, j, :] ([b, h, T, d]) lands in
// logical column pos[b] + j of both planes. clamp: a lane past the
// horizon smax lands on smax - 1, and only the row's last lane writes
// that column (the last writer of the Pallas grid); otherwise a column
// outside [0, smax) is not written.
template <typename U>
__global__ void __launch_bounds__(kWriteThreads)
write_columns_kernel(const U* __restrict__ k_new, const U* __restrict__ v_new,
                     U* __restrict__ k_dst, U* __restrict__ v_dst,
                     const int* __restrict__ pos, ColumnDst dst, int T,
                     int smax, bool clamp) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  int c = pos[b] + j;
  if (c < 0) return;
  if (clamp) {
    if (c >= smax - 1) {
      if (j != T - 1) return;
      c = smax - 1;
    }
  } else if (c >= smax) {
    return;
  }
  const int n = dst.h * dst.units;
  for (int i = threadIdx.x; i < n; i += kWriteThreads) {
    const int hh = i / dst.units;
    const int u = i - hh * dst.units;
    const size_t o = dst.offset(b, hh, c) + u;
    const size_t src = (((size_t)b * dst.h + hh) * T + j) * dst.units + u;
    k_dst[o] = k_new[src];
    v_dst[o] = v_new[src];
  }
}

// Element offset of column c's [d] row inside one (batch, head) row of
// the contiguous cache: the row base is k_cache + r * S * D.
template <int D>
struct ContiguousCols {
  __device__ __forceinline__ size_t operator()(int c) const {
    return (size_t)c * D;
  }
};

// ... and of the paged pool: the base is the pool itself, and column c
// lives in page table[b, c / P] at offset c % P of head `head`.
template <int D>
struct PagedCols {
  const int* row_table;
  int head, h, P;

  __device__ __forceinline__ size_t operator()(int c) const {
    const int page = row_table[c / P];
    return (((size_t)page * h + head) * P + c % P) * D;
  }
};

// THE split-horizon sweep of one (batch, head) row: q [D] attends over
// columns 0..p, column c's K and V rows at kb + col(c) and vb + col(c).
template <typename T, int D, typename Cols>
__device__ __forceinline__ void attend_row(const T* __restrict__ qr,
                                           const T* __restrict__ kb,
                                           const T* __restrict__ vb,
                                           const Cols& col, int p,
                                           float scale,
                                           T* __restrict__ outr) {
  constexpr int DPL = D / 32;
  constexpr int VEC = Vec<T>::N;
  __shared__ float qs[D];
  __shared__ float ms[kWarps];
  __shared__ float ls[kWarps];
  __shared__ float accs[kWarps][D];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < D; i += kThreads) qs[i] = to_float<T>(qr[i]);
  __syncthreads();

  float m = kNeg, l = 0.f, acc[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) acc[t] = 0.f;

  const int n_chunks = p / 32 + 1;  // chunks holding columns 0..p
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int cc = c * 32 + lane;
    const bool valid = cc <= p;
    float s = kNeg;
    if (valid) {
      const T* krow = kb + col(cc);
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
      const T* vrow = vb + col(c * 32 + j);
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
      outr[lane + 32 * t] = from_float<T>(o[t] * inv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache,
                   const int* __restrict__ pos, T* __restrict__ out, int h,
                   int S, float scale) {
  const int r = blockIdx.x;  // batch * h + head
  const int p = min(max(pos[r / h], 0), S - 1);
  attend_row<T, D>(q + (size_t)r * D, k_cache + (size_t)r * S * D,
                   v_cache + (size_t)r * S * D, ContiguousCols<D>{}, p,
                   scale, out + (size_t)r * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ table, const int* __restrict__ pos,
                  T* __restrict__ out, int h, int P, int mp, float scale) {
  const int r = blockIdx.x;  // batch * h + head
  const int b = r / h;
  const int p = min(max(pos[b], 0), mp * P - 1);
  const PagedCols<D> col{table + (size_t)b * mp, r - b * h, h, P};
  attend_row<T, D>(q + (size_t)r * D, k_pool, v_pool, col, p, scale,
                   out + (size_t)r * D);
}

template <typename U>
cudaError_t launch_write_cols_unit(const void* k_new, const void* v_new,
                                   void* k_dst, void* v_dst, const void* pos,
                                   const void* table, int b, int h, int T,
                                   int P, int mp, int row_bytes, int smax,
                                   bool clamp, cudaStream_t stream) {
  const ColumnDst dst{static_cast<const int*>(table), h, P, mp,
                      row_bytes / (int)sizeof(U)};
  write_columns_kernel<U><<<dim3(b, T), kWriteThreads, 0, stream>>>(
      static_cast<const U*>(k_new), static_cast<const U*>(v_new),
      static_cast<U*>(k_dst), static_cast<U*>(v_dst),
      static_cast<const int*>(pos), dst, T, smax, clamp);
  return cudaGetLastError();
}

// the widest copy unit the head row's bytes divide into
cudaError_t launch_write_cols(const void* k_new, const void* v_new,
                              void* k_dst, void* v_dst, const void* pos,
                              const void* table, int b, int h, int T, int P,
                              int mp, int d, int dtype, int smax, bool clamp,
                              cudaStream_t stream) {
  int elem;
  switch (dtype) {
    case kFloat32: elem = 4; break;
    case kBFloat16: elem = 2; break;
    default: return cudaErrorInvalidValue;
  }
  const int row_bytes = d * elem;
  if (row_bytes % 16 == 0)
    return launch_write_cols_unit<uint4>(k_new, v_new, k_dst, v_dst, pos,
                                         table, b, h, T, P, mp, row_bytes,
                                         smax, clamp, stream);
  if (row_bytes % 4 == 0)
    return launch_write_cols_unit<uint32_t>(k_new, v_new, k_dst, v_dst, pos,
                                            table, b, h, T, P, mp,
                                            row_bytes, smax, clamp, stream);
  return launch_write_cols_unit<uint16_t>(k_new, v_new, k_dst, v_dst, pos,
                                          table, b, h, T, P, mp, row_bytes,
                                          smax, clamp, stream);
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

template <typename T, int D>
cudaError_t launch_paged_attn(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* pos, void* out, int b, int h,
                              int P, int mp, float scale,
                              cudaStream_t stream) {
  paged_attn_kernel<T, D><<<b * h, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), h, P, mp, scale);
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
  return launch_write_cols(k_new, v_new, k_cache, v_cache, pos, nullptr, b,
                           h, 1, S, 1, d, dtype, S, false,
                           static_cast<cudaStream_t>(stream));
}

// k_cache/v_cache [b, h, S, d] gain k_new/v_new [b, h, T, d] at columns
// pos[b] + j, lanes past the horizon clamped onto column S - 1, in place.
extern "C" int apex_tpu_torch_cache_write_columns(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* pos, int b, int h, int T, int S, int d, int dtype,
    void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || S <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_cache, v_cache, pos, nullptr, b,
                           h, T, S, 1, d, dtype, S, true,
                           static_cast<cudaStream_t>(stream));
}

// the pools [num_pages, h, P, d] gain k_new/v_new [b, h, d] at logical
// column pos[b] of row b's table [b, mp]: page table[b, pos / P], offset
// pos % P, in place.
extern "C" int apex_tpu_torch_paged_write_column(
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const void* table, const void* pos, int b, int h, int P, int mp, int d,
    int dtype, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_pool, v_pool, pos, table, b, h, 1,
                           P, mp, d, dtype, mp * P, false,
                           static_cast<cudaStream_t>(stream));
}

// the pools gain k_new/v_new [b, h, T, d] at logical columns pos[b] + j,
// lanes past the horizon mp * P clamped onto its last column, in place.
extern "C" int apex_tpu_torch_paged_write_columns(
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const void* table, const void* pos, int b, int h, int T, int P, int mp,
    int d, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_pool, v_pool, pos, table, b, h, T,
                           P, mp, d, dtype, mp * P, true,
                           static_cast<cudaStream_t>(stream));
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

// The same read through row b's table [b, mp] over the pools
// [num_pages, h, P, d]: logical column c is page table[b, c / P], offset
// c % P.
extern "C" int apex_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, int b, int h, int P, int mp, int d,
    float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || d != kHeadDim)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_paged_attn<float, kHeadDim>(q, k_pool, v_pool, table,
                                                pos, out, b, h, P, mp,
                                                scale, st);
    case kBFloat16:
      return launch_paged_attn<__nv_bfloat16, kHeadDim>(
          q, k_pool, v_pool, table, pos, out, b, h, P, mp, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

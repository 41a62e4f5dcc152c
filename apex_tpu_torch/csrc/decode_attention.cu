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
//   gpt._paged_attend_multi);
// - the six over the quantized cache (int8 or fp8 e4m3 data with one
//   fp32 scale per head row and column): _write_column_quant,
//   cache_write_columns_quant, paged_write_column_quant and
//   paged_write_columns_quant (bodies _write_kernel_quant,
//   _write_cols_kernel_quant, _paged_write_kernel_quant,
//   _paged_write_cols_kernel_quant) are write_columns_quant_kernel, and
//   _run_attn_quant and paged_attention_quantized (bodies
//   _attn_kernel_quant, _paged_attn_kernel_quant) are
//   decode_attn_quant_kernel and paged_attn_quant_kernel.
//
// What bounds them on an H100: all are memory-bound. A write moves
// 2 x b x T x h x d elements each way. The read moves, per (batch,
// head) row, q plus the K and V rows of columns 0..pos[b]: at GPT
// 355M's serving shapes (b 8, h 16, horizon 192, d 64, bf16) at most
// ~6 MB per layer, at the 2.7B's (h 32, d 80, horizon 1024) ~84 MB,
// against 4 x d flops per column and head. At the small size the
// launch latency and one block's serial sweep, not bandwidth, set the
// time.
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
//   loads where the row's bytes allow, else element by element; q from
//   shared memory) and the warp folds the chunk into an fp32 online
//   softmax (m, l, acc), loading the chunk's V rows kVAhead at a time
//   before summing them, in column order. The warps then merge their
//   (m, l, acc) in shared memory in warp order, so no second kernel is
//   needed. The contiguous and the paged read are ONE sweep (attend_row)
//   that differs only in where column c lives: the same bytes in the
//   same order give the same bits, so paged decode equals contiguous
//   decode bit for bit.
// - Any head width d from 1 to kMaxHeadDim (128, the head-major flash
//   kernels' cap): the sweep is built for the padded width DP, d rounded
//   up to 32, 64, 96 or 128, and lane t of a warp owns dims t + 32 i
//   (i < DP / 32) of the P.V accumulator. Rows are d elements apart in
//   memory (the real d, at run time); q's padded dims are zeros in
//   shared memory, a lane's dims at or past d are never loaded or
//   stored, and the score's dot product runs over the d real dims only.
// - fp32, bf16 and fp16 rows, each widened to fp32 in registers (the
//   wrappers pass fp16 as it is).
// - Columns past pos[b] are never read: chunks past pos are skipped
//   (the j*bk <= pos skip of _attn_kernel), and inside the last chunk
//   only columns <= pos enter the score and the P.V product. Stale
//   bytes past pos (what a retired request or an uninitialised buffer
//   left, NaN included; a recycled page; the sink page) therefore
//   contribute exact zeros, which is what decode_attention.py:297-301
//   guards against.
// - Scores are fp32 and scaled in fp32, as in _attn_kernel.
// - The quantized writes keep write_columns_kernel's grid, addressing
//   and clamp; each warp quantizes whole head rows in registers (absmax
//   by a warp reduction, then the one quantizer, KvQuant) and stores a
//   byte a value and one fp32 scale a row, so a write moves ~1/2 (bf16
//   in) of the bytes it would store unquantized. The quantized reads are
//   attend_row with a dequantizing load: a column's int8 or fp8 row
//   widens to fp32 in registers and its two scales fold into the score
//   and the probability, so the sweep reads ~(d + 4) / (2 d) of the
//   bf16 cache's bytes.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace apex_tpu_torch {

// the quantized cache's storage types, widened to fp32 exactly
template <> __device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_float<__nv_fp8_e4m3>(
    __nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
// fp16 rows: widened exactly, the output rounded to nearest even
template <> __device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

namespace {

constexpr int kWriteThreads = 256;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// the widest head the reads take (_build.HM_MAX_HEAD_DIM)
constexpr int kMaxHeadDim = 128;
// V rows a warp of the read loads ahead of summing them: the loads'
// latencies overlap instead of adding up column by column
constexpr int kVAhead = 8;

// A type as a value, for the dispatchers below
template <typename T> struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the rows' dtype code: fp32, bf16 or fp16
template <typename F> cudaError_t with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kFloat32: return f(Tag<float>{});
    case kBFloat16: return f(Tag<__nv_bfloat16>{});
    case kFloat16: return f(Tag<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(Tag<S>{}) for the quantized storage kind: int8 or fp8 e4m3
template <typename F> cudaError_t with_kind(int kind, F&& f) {
  switch (kind) {
    case kInt8: return f(Tag<int8_t>{});
    case kFp8: return f(Tag<__nv_fp8_e4m3>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, DP>{}) for the padded width DP of head
// width d: d rounded up to 32, 64, 96 or 128; refused past kMaxHeadDim
template <typename F> cudaError_t with_padded_dim(int d, F&& f) {
  if (d <= 0 || d > kMaxHeadDim) return cudaErrorInvalidValue;
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// Where a multi-column write lands: the contiguous cache [b, h, S, d]
// (table == nullptr, P == S) or the paged pool [num_pages, h, P, d]
// under table [b, mp]; in units U of the head row (units per row).
struct ColumnDst {
  const int* table;
  int h, P, mp, units;

  // the (row or page, head, column) cell: its scale's index in a scale
  // plane, and its data row's in units of `units`
  __device__ __forceinline__ size_t cell(int b, int hh, int c) const {
    if (table == nullptr) return ((size_t)b * h + hh) * P + c;
    const int page = table[(size_t)b * mp + c / P];
    return ((size_t)page * h + hh) * P + c % P;
  }

  __device__ __forceinline__ size_t offset(int b, int hh, int c) const {
    return cell(b, hh, c) * units;
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

// THE KV quantizer of one value, bit for bit quantize_kv_rows (JAX and
// the port's plain version): y = x / scale by a true IEEE division (this
// file is built without --use_fast_math); int8 rounds half to even and
// clips to +-127, fp8 clips to +-448 and converts to e4m3 to nearest
// even. kRecip is the double 1 / qmax rounded once to fp32.
template <typename Q> struct KvQuant;
template <> struct KvQuant<int8_t> {
  static constexpr float kMax = 127.f;
  static constexpr float kRecip = static_cast<float>(1.0 / 127.0);
  __device__ __forceinline__ static int8_t store(float y) {
    const float r = fminf(fmaxf(rintf(y), -kMax), kMax);
    return static_cast<int8_t>(__float2int_rn(r));
  }
};
template <> struct KvQuant<__nv_fp8_e4m3> {
  static constexpr float kMax = 448.f;
  static constexpr float kRecip = static_cast<float>(1.0 / 448.0);
  __device__ __forceinline__ static __nv_fp8_e4m3 store(float y) {
    __nv_fp8_e4m3 out;
    out.__x = __nv_cvt_float_to_fp8(fminf(fmaxf(y, -kMax), kMax),
                                    __NV_SATFINITE, __NV_E4M3);
    return out;
  }
};

// the floor of a row's absmax, fp32(1e-12) as JAX rounds it
constexpr float kAmaxFloor = static_cast<float>(1e-12);

// write_columns_kernel's grid, addressing and clamp over the quantized
// planes: one block per (row b, lane j); each warp takes whole head rows
// of new[b, :, j, :] (K rows, then V rows), reduces |x| to the row's
// absmax with a warp reduction, and stores the quantized row into the
// data plane (dst.units == d) and its scale into the scale plane at the
// same cell. Rows 9, 11, 14 and 16 of the kernel table.
template <typename In, typename Q>
__global__ void __launch_bounds__(kWriteThreads)
write_columns_quant_kernel(const In* __restrict__ k_new,
                           const In* __restrict__ v_new,
                           Q* __restrict__ k_q, float* __restrict__ k_s,
                           Q* __restrict__ v_q, float* __restrict__ v_s,
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
  const int d = dst.units;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < 2 * dst.h; r += kWriteThreads / 32) {
    const bool is_v = r >= dst.h;
    const int hh = is_v ? r - dst.h : r;
    const In* src =
        (is_v ? v_new : k_new) + (((size_t)b * dst.h + hh) * T + j) * d;
    float amax = 0.f;
    for (int e = lane; e < d; e += 32)
      amax = fmaxf(amax, fabsf(to_float<In>(src[e])));
    amax = warp_max(amax);
    const float scale = fmaxf(amax, kAmaxFloor) * KvQuant<Q>::kRecip;
    const size_t cell = dst.cell(b, hh, c);
    Q* row = (is_v ? v_q : k_q) + cell * d;
    for (int e = lane; e < d; e += 32)
      row[e] = KvQuant<Q>::store(__fdiv_rn(to_float<In>(src[e]), scale));
    if (lane == 0) (is_v ? v_s : k_s)[cell] = scale;
  }
}

// Cell of column c inside one (batch, head) row of the contiguous cache
// (the data row starts d elements per cell further, the scale at the
// cell): the row bases are k_cache + r * S * d and k_scale + r * S.
struct ContiguousCols {
  __device__ __forceinline__ size_t operator()(int c) const {
    return (size_t)c;
  }
};

// ... and of the paged pool: the bases are the pools themselves, and
// column c lives in page table[b, c / P] at offset c % P of head `head`.
struct PagedCols {
  const int* row_table;
  int head, h, P;

  __device__ __forceinline__ size_t operator()(int c) const {
    const int page = row_table[c / P];
    return ((size_t)page * h + head) * P + c % P;
  }
};

// THE split-horizon sweep of one (batch, head) row: q [d] attends over
// columns 0..p; column c's K and V rows are at kb + col(c) * d and
// vb + col(c) * d, in the storage type S. DP is d rounded up to a
// multiple of 32: lane t of a warp owns dims t + 32 i of the P.V
// accumulator, those at or past d idle. With kQuant, S is int8 or fp8
// and column c's fp32 scales are ksb[col(c)] and vsb[col(c)]: the K
// scale folds into the score, (q . k_int) * s_k * scale, and the V scale
// into the probability, (p * s_v) . v_int, as _attn_kernel_quant does. A
// column past p is never loaded, its scales included.
template <typename T, typename S, int DP, bool kQuant, typename Cols>
__device__ __forceinline__ void attend_row(const T* __restrict__ qr,
                                           const S* __restrict__ kb,
                                           const float* __restrict__ ksb,
                                           const S* __restrict__ vb,
                                           const float* __restrict__ vsb,
                                           const Cols& col, int p, int d,
                                           float scale,
                                           T* __restrict__ outr) {
  static_assert(DP % 32 == 0 && DP <= kMaxHeadDim, "padded head width");
  constexpr int DPL = DP / 32;
  constexpr int VEC = Vec<S>::N;
  __shared__ float qs[DP];
  __shared__ float ms[kWarps];
  __shared__ float ls[kWarps];
  __shared__ float accs[kWarps][DP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // every K row starts on a 16-byte boundary (the wrappers check the
  // bases) exactly when d is a multiple of the vector width
  const bool vec = d % VEC == 0;

  for (int i = tid; i < DP; i += kThreads)
    qs[i] = i < d ? to_float<T>(qr[i]) : 0.f;
  __syncthreads();

  float m = kNeg, l = 0.f, acc[DPL];
#pragma unroll
  for (int t = 0; t < DPL; ++t) acc[t] = 0.f;

  const int n_chunks = p / 32 + 1;  // chunks holding columns 0..p
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int cc = c * 32 + lane;
    const bool valid = cc <= p;
    float s = kNeg;
    size_t cell = 0;
    if (valid) {
      cell = col(cc);
      const S* krow = kb + cell * d;
      float dot = 0.f;
      if (vec) {
#pragma unroll
        for (int e0 = 0; e0 < DP; e0 += VEC) {
          if (e0 < d) {
            float t[VEC];
            load_vec<S>(krow + e0, t);
#pragma unroll
            for (int e = 0; e < VEC; ++e) dot += qs[e0 + e] * t[e];
          }
        }
      } else {
        for (int e = 0; e < d; ++e) dot += qs[e] * to_float<S>(krow[e]);
      }
      s = kQuant ? dot * ksb[cell] * scale : dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = expf(m - m_new);
    const float prob = valid ? expf(s - m_new) : 0.f;
    l = corr * l + warp_sum(prob);
    // the weight of this lane's V row: the probability, times its scale
    const float pv = (kQuant && valid) ? prob * vsb[cell] : prob;
#pragma unroll
    for (int t = 0; t < DPL; ++t) acc[t] *= corr;
    const int jn = min(32, p - c * 32 + 1);  // columns <= p in this chunk
    for (int j0 = 0; j0 < jn; j0 += kVAhead) {
      // kVAhead V rows loaded before any is summed (a step past jn
      // re-reads the chunk's last column and adds nothing), then folded
      // in column order; a lane's dims at or past d hold zeros
      float v[kVAhead][DPL];
#pragma unroll
      for (int u = 0; u < kVAhead; ++u) {
        const S* vrow = vb + col(c * 32 + min(j0 + u, jn - 1)) * d;
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          v[u][t] = lane + 32 * t < d ? to_float<S>(vrow[lane + 32 * t])
                                      : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kVAhead; ++u) {
        const float pj = __shfl_sync(0xffffffffu, pv, (j0 + u) & 31);
        if (j0 + u < jn) {
#pragma unroll
          for (int t = 0; t < DPL; ++t) acc[t] += pj * v[u][t];
        }
      }
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
      if (lane + 32 * t < d) outr[lane + 32 * t] = from_float<T>(o[t] * inv);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache,
                   const int* __restrict__ pos, T* __restrict__ out, int h,
                   int S, int d, float scale) {
  const int r = blockIdx.x;  // batch * h + head
  const int p = min(max(pos[r / h], 0), S - 1);
  attend_row<T, T, DP, false>(q + (size_t)r * d, k_cache + (size_t)r * S * d,
                              nullptr, v_cache + (size_t)r * S * d, nullptr,
                              ContiguousCols{}, p, d, scale,
                              out + (size_t)r * d);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ table, const int* __restrict__ pos,
                  T* __restrict__ out, int h, int P, int mp, int d,
                  float scale) {
  const int r = blockIdx.x;  // batch * h + head
  const int b = r / h;
  const int p = min(max(pos[b], 0), mp * P - 1);
  const PagedCols col{table + (size_t)b * mp, r - b * h, h, P};
  attend_row<T, T, DP, false>(q + (size_t)r * d, k_pool, nullptr, v_pool,
                              nullptr, col, p, d, scale, out + (size_t)r * d);
}

// The quantized reads (rows 12 and 18): attend_row over int8 or fp8
// storage with the per-column scales; the paged kernel is the contiguous
// one with only the column's address changed.
template <typename T, typename S, int DP>
__global__ void __launch_bounds__(kThreads)
decode_attn_quant_kernel(const T* __restrict__ q, const S* __restrict__ k_q,
                         const float* __restrict__ k_s,
                         const S* __restrict__ v_q,
                         const float* __restrict__ v_s,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int h, int sk, int d, float scale) {
  const int r = blockIdx.x;  // batch * h + head
  const int p = min(max(pos[r / h], 0), sk - 1);
  attend_row<T, S, DP, true>(q + (size_t)r * d, k_q + (size_t)r * sk * d,
                             k_s + (size_t)r * sk, v_q + (size_t)r * sk * d,
                             v_s + (size_t)r * sk, ContiguousCols{}, p, d,
                             scale, out + (size_t)r * d);
}

template <typename T, typename S, int DP>
__global__ void __launch_bounds__(kThreads)
paged_attn_quant_kernel(const T* __restrict__ q, const S* __restrict__ k_q,
                        const float* __restrict__ k_s,
                        const S* __restrict__ v_q,
                        const float* __restrict__ v_s,
                        const int* __restrict__ table,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int h, int P, int mp, int d, float scale) {
  const int r = blockIdx.x;  // batch * h + head
  const int b = r / h;
  const int p = min(max(pos[b], 0), mp * P - 1);
  const PagedCols col{table + (size_t)b * mp, r - b * h, h, P};
  attend_row<T, S, DP, true>(q + (size_t)r * d, k_q, k_s, v_q, v_s, col, p,
                             d, scale, out + (size_t)r * d);
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
  return with_dtype(dtype, [&](auto tag) {
    const int row_bytes = d * (int)sizeof(typename decltype(tag)::type);
    if (row_bytes % 16 == 0)
      return launch_write_cols_unit<uint4>(k_new, v_new, k_dst, v_dst, pos,
                                           table, b, h, T, P, mp, row_bytes,
                                           smax, clamp, stream);
    if (row_bytes % 4 == 0)
      return launch_write_cols_unit<uint32_t>(k_new, v_new, k_dst, v_dst,
                                              pos, table, b, h, T, P, mp,
                                              row_bytes, smax, clamp,
                                              stream);
    return launch_write_cols_unit<uint16_t>(k_new, v_new, k_dst, v_dst, pos,
                                            table, b, h, T, P, mp, row_bytes,
                                            smax, clamp, stream);
  });
}

// the plain reads: table == nullptr is the contiguous cache [b, h, S, d],
// otherwise the pools [num_pages, h, P, d] under table [b, mp]
cudaError_t launch_attn(const void* q, const void* k, const void* v,
                        const void* table, const void* pos, void* out, int b,
                        int h, int S, int P, int mp, int d, float scale,
                        int dtype, cudaStream_t stream) {
  return with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return with_padded_dim(d, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      const T* qt = static_cast<const T*>(q);
      const T* kt = static_cast<const T*>(k);
      const T* vt = static_cast<const T*>(v);
      const int* pt = static_cast<const int*>(pos);
      T* ot = static_cast<T*>(out);
      if (table == nullptr)
        decode_attn_kernel<T, DP><<<b * h, kThreads, 0, stream>>>(
            qt, kt, vt, pt, ot, h, S, d, scale);
      else
        paged_attn_kernel<T, DP><<<b * h, kThreads, 0, stream>>>(
            qt, kt, vt, static_cast<const int*>(table), pt, ot, h, P, mp, d,
            scale);
      return cudaGetLastError();
    });
  });
}

// the input rows' dtype times the storage kind
cudaError_t launch_write_quant(const void* k_new, const void* v_new,
                               void* k_q, void* k_s, void* v_q, void* v_s,
                               const void* pos, const void* table, int b,
                               int h, int T, int P, int mp, int d, int dtype,
                               int kind, int smax, bool clamp,
                               cudaStream_t stream) {
  return with_dtype(dtype, [&](auto in_tag) {
    using In = typename decltype(in_tag)::type;
    return with_kind(kind, [&](auto q_tag) {
      using Q = typename decltype(q_tag)::type;
      const ColumnDst dst{static_cast<const int*>(table), h, P, mp, d};
      write_columns_quant_kernel<In, Q>
          <<<dim3(b, T), kWriteThreads, 0, stream>>>(
              static_cast<const In*>(k_new), static_cast<const In*>(v_new),
              static_cast<Q*>(k_q), static_cast<float*>(k_s),
              static_cast<Q*>(v_q), static_cast<float*>(v_s),
              static_cast<const int*>(pos), dst, T, smax, clamp);
      return cudaGetLastError();
    });
  });
}

// q's dtype times the storage kind times the padded head width;
// table == nullptr is the contiguous cache [b, h, sk, d], otherwise the
// pools under table [b, mp]
cudaError_t launch_attn_quant(const void* q, const void* k_q, const void* k_s,
                              const void* v_q, const void* v_s,
                              const void* table, const void* pos, void* out,
                              int b, int h, int sk, int P, int mp, int d,
                              float scale, int dtype, int kind,
                              cudaStream_t stream) {
  return with_dtype(dtype, [&](auto t_tag) {
    using T = typename decltype(t_tag)::type;
    return with_kind(kind, [&](auto s_tag) {
      using S = typename decltype(s_tag)::type;
      return with_padded_dim(d, [&](auto dp) {
        constexpr int DP = decltype(dp)::value;
        const T* qt = static_cast<const T*>(q);
        const S* kq = static_cast<const S*>(k_q);
        const S* vq = static_cast<const S*>(v_q);
        const float* ks = static_cast<const float*>(k_s);
        const float* vs = static_cast<const float*>(v_s);
        const int* pt = static_cast<const int*>(pos);
        T* ot = static_cast<T*>(out);
        if (table == nullptr)
          decode_attn_quant_kernel<T, S, DP><<<b * h, kThreads, 0, stream>>>(
              qt, kq, ks, vq, vs, pt, ot, h, sk, d, scale);
        else
          paged_attn_quant_kernel<T, S, DP><<<b * h, kThreads, 0, stream>>>(
              qt, kq, ks, vq, vs, static_cast<const int*>(table), pt, ot, h,
              P, mp, d, scale);
        return cudaGetLastError();
      });
    });
  });
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
// (batch, head) row over caches [b, h, S, d], 1 <= d <= 128.
extern "C" int apex_tpu_torch_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* pos,
    void* out, int b, int h, int S, int d, float scale, int dtype,
    void* stream) {
  if (b <= 0 || h <= 0 || S <= 0) return cudaErrorInvalidValue;
  return launch_attn(q, k_cache, v_cache, nullptr, pos, out, b, h, S, 1, 1,
                     d, scale, dtype, static_cast<cudaStream_t>(stream));
}

// The same read through row b's table [b, mp] over the pools
// [num_pages, h, P, d]: logical column c is page table[b, c / P], offset
// c % P.
extern "C" int apex_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, int b, int h, int P, int mp, int d,
    float scale, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0) return cudaErrorInvalidValue;
  return launch_attn(q, k_pool, v_pool, table, pos, out, b, h, 0, P, mp, d,
                     scale, dtype, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// the quantized cache: data planes int8 or fp8 e4m3 (kind) beside fp32
// scale planes; the new rows (and q) are fp32, bf16 or fp16 (dtype)
// ---------------------------------------------------------------------------

// k_q/v_q [b, h, S, d] and k_s/v_s [b, h, S] gain k_new/v_new [b, h, d]
// quantized at column pos[b], in place.
extern "C" int apex_tpu_torch_decode_write_column_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* pos, int b, int h, int S, int d, int dtype,
    int kind, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || d <= 0) return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, nullptr,
                            b, h, 1, S, 1, d, dtype, kind, S, false,
                            static_cast<cudaStream_t>(stream));
}

// ... k_new/v_new [b, h, T, d] at columns pos[b] + j, lanes past the
// horizon clamped onto column S - 1, in place.
extern "C" int apex_tpu_torch_cache_write_columns_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* pos, int b, int h, int T, int S, int d, int dtype,
    int kind, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || S <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, nullptr,
                            b, h, T, S, 1, d, dtype, kind, S, true,
                            static_cast<cudaStream_t>(stream));
}

// the pools [num_pages, h, P, d] / [num_pages, h, P] gain k_new/v_new
// [b, h, d] quantized at logical column pos[b] of row b's table [b, mp].
extern "C" int apex_tpu_torch_paged_write_column_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* table, const void* pos, int b, int h, int P,
    int mp, int d, int dtype, int kind, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, table, b,
                            h, 1, P, mp, d, dtype, kind, mp * P, false,
                            static_cast<cudaStream_t>(stream));
}

// ... k_new/v_new [b, h, T, d] at logical columns pos[b] + j, lanes past
// the horizon mp * P clamped onto its last column, in place.
extern "C" int apex_tpu_torch_paged_write_columns_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* table, const void* pos, int b, int h, int T,
    int P, int mp, int d, int dtype, int kind, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, table, b,
                            h, T, P, mp, d, dtype, kind, mp * P, true,
                            static_cast<cudaStream_t>(stream));
}

// out [b, h, d]: q attends over columns 0..pos[b] of the quantized cache
// k_q/v_q [b, h, S, d] with scales k_s/v_s [b, h, S], 1 <= d <= 128.
extern "C" int apex_tpu_torch_decode_attention_quant(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* pos, void* out, int b, int h, int S, int d,
    float scale, int dtype, int kind, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0) return cudaErrorInvalidValue;
  return launch_attn_quant(q, k_q, k_s, v_q, v_s, nullptr, pos, out, b, h, S,
                           1, 1, d, scale, dtype, kind,
                           static_cast<cudaStream_t>(stream));
}

// The same read through row b's table [b, mp] over the quantized pools.
extern "C" int apex_tpu_torch_paged_attention_quant(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* table, const void* pos, void* out, int b,
    int h, int P, int mp, int d, float scale, int dtype, int kind,
    void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0) return cudaErrorInvalidValue;
  return launch_attn_quant(q, k_q, k_s, v_q, v_s, table, pos, out, b, h, 0, P,
                           mp, d, scale, dtype, kind,
                           static_cast<cudaStream_t>(stream));
}

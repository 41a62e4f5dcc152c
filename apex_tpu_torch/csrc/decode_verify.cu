// The speculative verify's attention of one layer in one launch, over the
// contiguous cache and the paged pool.
//
// Replaces, on the verify's main path (gpt._decode_attend_multi and
// gpt._paged_attend_multi over compute-dtype caches, the kernel impl):
// - cache_write_columns (apex_tpu/kernels/decode_attention.py, body
//   _write_cols_kernel) and paged_write_columns (body
//   _paged_write_cols_kernel), rows 8 and 15 of the kernel table, which
//   stay in decode_attention.cu as the counterparts of JAX's functions;
// - the verify's materialised read that follows them (the scores
//   expression of apex_tpu/models/gpt.py's _decode_attend_multi), on the
//   paged side after a gather of both pools.
//
// Why one launch: the verify writes T = spec_k + 1 columns a row and
// attends T query rows, row i over columns 0..pos + i. A T-column write
// is a launch's fixed cost (~2 us on an H100 for ~0.00007 ms of bytes),
// and the read after it was an eager chain of a dozen launches over a
// materialised [b, h, T, S] score tensor.
//
// What the design does about it:
// - decode_verify_split_kernel<T, DP, R, kPaged> is decode_attention.cu's
//   split read with R (4 or 8, at least T) query rows: the split geometry
//   of the single read (read_splits) over the last row's horizon; a
//   block's K and V rows staged once a sub-tile, by the same cp.async
//   ring, for all its query rows; each query row its own (m, l, acc) in
//   every warp and its own split merge, in the single read's order, with
//   the roundings pinned as that read pins them, so row i is the single
//   read at pos + i bit for bit. T, DP and R are template values: T the
//   rows' and q's type (fp32, bf16 or fp16), DP the head width padded to
//   32, 64, 96 or 128, R kVerifyShortRows or kVerifyMaxRows.
// - A block's new columns are the tail of its columns, at most T of
//   them, so they lie in its last two sub-tiles: staged from k_new/v_new
//   in place of the cache's
//   cells and, after the loop, stored from those ring slots, as the fused
//   decode launch stores its one column; lane T - 1 lands on the
//   horizon's last column once lanes pass it (the multi-column write's
//   clamp). No block reads a cell the launch writes.
// - The warps' and the splits' partial accumulators, T times the single
//   read's, live in the dynamic shared memory (as static arrays they pass
//   the 48 KB a block may hold without opting in at T = 8, d 128).
#include "decode_common.cuh"

namespace apex_tpu_torch {

// One verify launch's arguments (see launch_verify)
struct VerifyArgs {
  const void* q;
  const void* k_new;
  const void* v_new;
  const void* k;
  const void* v;
  const void* table;
  const void* pos;
  void* out;
  int b, h, t_rows, horizon, P, mp, d;
  float scale;
  int dtype, split_cols, n_splits;
  cudaStream_t stream;
};

namespace {

// The speculative verify's lane for logical column c of a row whose T
// lanes land at pw .. pw + T - 1: lane c - pw, and the horizon's last
// column lane T - 1 once a lane reaches it (write_columns_kernel's clamp:
// of the lanes at or past horizon - 1 only the last writes, there).
__device__ __forceinline__ int verify_lane(int c, int pw, int t_rows,
                                           int horizon) {
  return c == horizon - 1 && pw + t_rows - 1 >= horizon - 1 ? t_rows - 1
                                                           : c - pw;
}

// (the verify) the new rows of columns [c, c + n) of one (batch, head)
// row into the ring slots ks/vs by the read's cp.async units (in the
// caller's commit group), column cc from lane verify_lane(cc) of kn/vn,
// the row's T lanes [T, d]; out of line, as stage_row
template <int N>
__device__ __noinline__ void stage_lanes(char* ks, char* vs, const char* kn,
                                         const char* vn, int c, int n, int pw,
                                         int t_rows, int horizon,
                                         int row_bytes) {
  const int units = row_bytes / N;
  for (int i = threadIdx.x; i < n * units; i += kSplitThreads) {
    const int col = i / units;
    const int u = i - col * units;
    const size_t src =
        (size_t)verify_lane(c + col, pw, t_rows, horizon) * row_bytes +
        (size_t)u * N;
    copy_unit<N>(ks + col * row_bytes + u * N, kn + src);
    copy_unit<N>(vs + col * row_bytes + u * N, vn + src);
  }
}

// The speculative verify in one launch, rows 8 and 15's writes inside
// the split read: per (batch, head) row, the T new K/V rows k_new/v_new
// [b, h, T, d] land in columns pos[b] .. pos[b] + T - 1 (the clamp of
// write_columns_kernel: the horizon's last column takes lane T - 1 once
// a lane reaches it), and query row i of q [b, h, T, d] attends columns
// 0 .. last(i) = min(max(pos[b] + i, 0), horizon - 1) of the written
// cache into out [b, h, T, d]. decode_read_split_kernel's geometry and
// order for each query row: the block of split s covers columns [s *
// split_cols, ...) up to the last row's last(T - 1); each query row keeps
// its own (m, l, acc) in every warp, scores and sums its columns in the
// single read's order, leaves a column past last(i) as that read leaves
// a column past pos (never scored or summed: a sub-tile past it is
// skipped, one that ends in it sees the column invalid), and the split-0
// block merges, for row i, only the splits that start at or before
// last(i), in split order. So row i is bit for bit the single read
// (rows 10 and 17) at position pos[b] + i over the written cache. The
// new columns of a block are the tail of its columns, at most T of them
// (T <= kVerifyMaxRows), so they lie in its last two sub-tiles: they are
// staged from k_new/v_new by the same cp.async units in place of the
// cache's cells and, after the loop, stored from those ring slots (which
// no copy overwrites after the last sub-tile) into the cache cells; no
// block of the launch reads a cell it writes. R (4 or 8) bounds T, the
// query rows held in registers. The dynamic shared memory holds the ring,
// then the warps' (acc) [kSplitWarps][T][DP], then the split-0 block's
// pushed (acc) [n_splits][T][DP], then (kPaged) the split's page
// numbers.
template <typename T, int DP, int R, bool kPaged>
__global__ void __launch_bounds__(kSplitThreads)
decode_verify_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const T* __restrict__ k_new,
                           const T* __restrict__ v_new,
                           const int* __restrict__ table,
                           const int* __restrict__ pos, T* __restrict__ out,
                           int h, int horizon, int P, int mp, int d,
                           int t_rows, float scale, int split_cols,
                           int n_splits, int unit) {
  static_assert(DP % 32 == 0 && DP <= kMaxHeadDim, "padded head width");
  static_assert(R >= 1 && R <= kVerifyMaxRows, "query rows");
  static_assert(kReadRing == 2 && kVerifyMaxRows <= kSubCols + 1,
                "the new columns lie in the last two sub-tiles, which the "
                "ring still holds after the loop");
  constexpr int DPL = DP / 32;
  constexpr int VEC = Vec<T>::N;
  namespace cg = cooperative_groups;
  extern __shared__ uint4 dyn_smem[];
  __shared__ __align__(16) float qs[R][DP];
  __shared__ float wm[kSplitWarps][R], wl[kSplitWarps][R];
  __shared__ float pm[kMaxSplits][R], pl[kMaxSplits][R];
  __shared__ uint64_t pushed;

  cg::cluster_group cluster = cg::this_cluster();
  const int s = (int)cluster.block_rank();
  const int r = blockIdx.x / n_splits;  // batch * h + head
  const int b = r / h;
  const int head = r - b * h;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pw = pos[b];
  // the single read's clamp of query row i's position
  const auto last = [&](int i) { return min(max(pw + i, 0), horizon - 1); };
  const int pmax = last(t_rows - 1);
  const int c0 = s * split_cols;
  if (c0 > pmax) return;  // no query row reads this split
  const int c1 = min(c0 + split_cols, pmax + 1);
  // the block's new columns, [put0, c1): the row's lanes land in
  // [min(max(pw, 0), horizon - 1), pmax] (none when every lane lies
  // before column 0)
  const int put0 =
      pw + t_rows - 1 < 0
          ? c1
          : min(max(c0, min(max(pw, 0), horizon - 1)), c1);
  const int n_live = pmax / split_cols + 1;
  if (s == 0 && tid == 0 && n_live > 1)
    mbar_init(&pushed, kSplitThreads * (n_live - 1));
  cluster_arrive_relaxed();
  const int row_bytes = d * (int)sizeof(T);
  const int tile_bytes = kSubCols * row_bytes;
  char* ring = reinterpret_cast<char*>(dyn_smem);
  float* wacc = reinterpret_cast<float*>(ring + kReadRing * 2 * tile_bytes);
  float* pacc = wacc + kSplitWarps * t_rows * DP;
  int* pages = reinterpret_cast<int*>(pacc + n_splits * t_rows * DP);
  const char* kb = reinterpret_cast<const char*>(k);
  const char* vb = reinterpret_cast<const char*>(v);
  const int page0 = c0 / P;
  if constexpr (kPaged) {
    const int n_pages = (c1 - 1) / P - page0 + 1;
    for (int i = tid; i < n_pages; i += kSplitThreads)
      pages[i] = table[(size_t)b * mp + page0 + i];
    __syncthreads();
  }
  const int n_sub = (c1 - c0 + kSubCols - 1) / kSubCols;
  const char* knb =
      reinterpret_cast<const char*>(k_new) + (size_t)r * t_rows * row_bytes;
  const char* vnb =
      reinterpret_cast<const char*>(v_new) + (size_t)r * t_rows * row_bytes;
  // sub-tile t's copies into ring stage t % kReadRing: its cached columns
  // from the cache, its new ones (from put0 on) from the new rows
  auto stage = [&](int t) {
    const int c = c0 + t * kSubCols;
    const int nc = min(kSubCols, c1 - c);
    const int cached = min(max(put0 - c, 0), nc);
    char* ks = ring + (t % kReadRing) * 2 * tile_bytes;
    char* vs = ks + tile_bytes;
    with_unit<T>(unit, [&](auto n) {
      constexpr int N = decltype(n)::value;
      if (cached > 0) {
        if constexpr (kPaged)
          stage_pages<N>(ks, vs, kb, vb, pages, page0, head, h, P, c, cached,
                         row_bytes);
        else
          stage_run<N>(ks, vs, kb, vb, (size_t)r * horizon, c, cached,
                       row_bytes);
      }
      if (cached < nc)
        stage_lanes<N>(ks + cached * row_bytes, vs + cached * row_bytes, knb,
                       vnb, c + cached, nc - cached, pw, t_rows, horizon,
                       row_bytes);
    });
  };
  stage(0);
  cp_async_commit();
  // the query rows land while the first copies are in flight
  for (int i = tid; i < R * DP; i += kSplitThreads) {
    const int row = i / DP;
    const int e = i - row * DP;
    qs[row][e] = row < t_rows && e < d
                     ? to_float<T>(q[((size_t)r * t_rows + row) * d + e])
                     : 0.f;
  }

  // as the single read: four lanes score column j of the warp's 8, dims
  // in 16-byte vectors qtr, qtr + 4, ... where the rows allow
  const int j = warp * kColsPerWarp + (lane >> 2);
  const int qtr = lane & 3;
  const bool vec = row_bytes % 16 == 0;
  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int a = 0; a < DPL; ++a) acc[i][a] = 0.f;
  }
  for (int t = 0; t < n_sub; ++t) {
    if (t + 1 < n_sub) stage(t + 1);
    cp_async_commit();
    cp_async_wait<kReadRing - 1>();  // sub-tile t has landed
    __syncthreads();
    const char* ks = ring + (t % kReadRing) * 2 * tile_bytes;
    const T* kt = reinterpret_cast<const T*>(ks);
    const T* vt = reinterpret_cast<const T*>(ks + tile_bytes);
    const int c = c0 + t * kSubCols;
    const int nc = min(kSubCols, c1 - c);
    // query row i's columns of this sub-tile (block-uniform; 0 once the
    // row's own split has ended, where the single read stops)
    int nci[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      nci[i] = i < t_rows
                   ? max(0, min(kSubCols,
                                min(c0 + split_cols, last(i) + 1) - c))
                   : 0;
    // every query row's part of column j's dot product, each summed in
    // the single read's order
    float dot[R];
#pragma unroll
    for (int i = 0; i < R; ++i) dot[i] = 0.f;
    if (j < nc) {
      const T* kr = kt + j * d;
      if (vec) {
        for (int e0 = qtr * VEC; e0 < d; e0 += 4 * VEC) {
          float x[VEC];
          load_vec<T>(kr + e0, x);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot[i] = __fmaf_rn(qs[i][e0 + e], x[e], dot[i]);
        }
      } else {
        for (int e = qtr; e < d; e += 4) {
          const float x = to_float<T>(kr[e]);
#pragma unroll
          for (int i = 0; i < R; ++i) dot[i] = __fmaf_rn(qs[i][e], x, dot[i]);
        }
      }
    }
    float prob[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      prob[i] = 0.f;
      if (nci[i] == 0) continue;
      float dt = dot[i];
      dt += __shfl_xor_sync(0xffffffffu, dt, 1);
      dt += __shfl_xor_sync(0xffffffffu, dt, 2);
      const bool valid = j < nci[i];
      const float sc = valid ? __fmul_rn(dt, scale) : kNeg;
      const float m_new = fmaxf(m[i], warp_max(sc));
      const float corr = expf(m[i] - m_new);
      prob[i] = valid ? expf(sc - m_new) : 0.f;
      l[i] = __fadd_rn(__fmul_rn(corr, l[i]),
                       warp_sum(qtr == 0 ? prob[i] : 0.f));
#pragma unroll
      for (int a = 0; a < DPL; ++a) acc[i][a] = __fmul_rn(acc[i][a], corr);
      m[i] = m_new;
    }
    // each V row read once for every query row that takes its column,
    // each row's sum in column order
#pragma unroll
    for (int u = 0; u < kColsPerWarp; ++u) {
      const int col = warp * kColsPerWarp + u;
      if (col < nc) {  // warp-uniform
        const T* vr = vt + col * d;
        float vv[DPL];
#pragma unroll
        for (int a = 0; a < DPL; ++a)
          vv[a] = lane + 32 * a < d ? to_float<T>(vr[lane + 32 * a]) : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (col < nci[i]) {
            const float pj = __shfl_sync(0xffffffffu, prob[i], 4 * u);
#pragma unroll
            for (int a = 0; a < DPL; ++a)
              if (lane + 32 * a < d) acc[i][a] = __fmaf_rn(pj, vv[a], acc[i][a]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }
  // the new rows, from the ring slots they were staged into, into their
  // cache cells (the contiguous cell, or the page the block loaded)
  if (put0 < c1) {
    with_unit<T>(unit, [&](auto n) {
      for (int col = put0; col < c1; ++col) {
        const int ti = (col - c0) / kSubCols;
        const char* slot = ring + (ti % kReadRing) * 2 * tile_bytes +
                           (col - c0 - ti * kSubCols) * row_bytes;
        size_t cell = (size_t)r * horizon + col;
        if constexpr (kPaged)
          cell = ((size_t)pages[col / P - page0] * h + head) * P + col % P;
        const size_t o = cell * row_bytes;
        store_row<decltype(n)::value>(const_cast<char*>(kb) + o,
                                      const_cast<char*>(vb) + o, slot,
                                      slot + tile_bytes, row_bytes);
      }
    });
  }

  // every query row's warps merged in warp order and pushed into slot s
  // of the split-0 block's arrays, as the single read does for its row
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      wm[warp][i] = m[i];
      wl[warp][i] = l[i];
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < t_rows)
#pragma unroll
      for (int a = 0; a < DPL; ++a)
        wacc[(warp * t_rows + i) * DP + lane + 32 * a] = acc[i][a];
  __syncthreads();
  cluster_wait();
  for (int x = tid; x < t_rows * DP; x += kSplitThreads) {
    const int i = x / DP;
    const int e = x - i * DP;
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, wm[w][i]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = expf(wm[w][i] - mx);
      lsum = __fmaf_rn(wl[w][i], f, lsum);
      o = __fmaf_rn(wacc[(w * t_rows + i) * DP + e], f, o);
    }
    const auto slot0 = [&](float* y) {
      return s == 0 ? y : cluster.map_shared_rank(y, 0);
    };
    *slot0(&pacc[(s * t_rows + i) * DP + e]) = o;
    if (e == 0) {
      *slot0(&pm[s][i]) = mx;
      *slot0(&pl[s][i]) = lsum;
    }
  }
  if (s != 0) {
    mbar_arrive_remote(&pushed, 0);
    return;
  }

  // the split-0 block: row i's splits up to the one holding last(i),
  // merged in split order
  __syncthreads();
  if (n_live > 1) mbar_wait_phase0(&pushed);
  for (int x = tid; x < t_rows * d; x += kSplitThreads) {
    const int i = x / d;
    const int e = x - i * d;
    const int n_row = last(i) / split_cols + 1;
    float mx = kNeg;
    for (int sp = 0; sp < n_row; ++sp) mx = fmaxf(mx, pm[sp][i]);
    float lsum = 0.f, o = 0.f;
    for (int sp = 0; sp < n_row; ++sp) {
      const float f = expf(pm[sp][i] - mx);
      lsum = __fmaf_rn(pl[sp][i], f, lsum);
      o = __fmaf_rn(pacc[(sp * t_rows + i) * DP + e], f, o);
    }
    out[((size_t)r * t_rows + i) * d + e] =
        from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

// one launch of the verify: as launch_read_split, for the T-row kernel
template <typename T, int DP, int R, bool kPaged>
cudaError_t launch_verify_split(const void* q, const void* k, const void* v,
                                const void* k_new, const void* v_new,
                                const void* table, const void* pos, void* out,
                                int n_rows, int h, int horizon, int P, int mp,
                                int d, int t_rows, float scale,
                                int split_cols, int n_splits, int unit,
                                size_t smem, cudaStream_t stream) {
  auto kernel = decode_verify_split_kernel<T, DP, R, kPaged>;
  static size_t granted = 0;
  const cudaError_t grant = allow_dynamic_smem(kernel, smem, &granted);
  if (grant != cudaSuccess) return grant;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_splits * (unsigned)n_rows);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), h, horizon, P, mp,
      d, t_rows, scale, split_cols, n_splits, unit);
  const cudaError_t last = cudaGetLastError();  // clears what it left
  return err != cudaSuccess ? err : last;
}

// the verify for one layout (kPaged: the pools under a table) and one
// row bound R, every dtype and padded head width
template <bool kPaged, int R>
cudaError_t launch_verify_rows(const VerifyArgs& a) {
  return with_dtype(a.dtype, [&](auto t_tag) {
    using T = typename decltype(t_tag)::type;
    return with_padded_dim(a.d, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      const int row_bytes = a.d * (int)sizeof(T);
      const int unit = row_bytes % 16 == 0  ? 16
                       : row_bytes % 8 == 0 ? 8
                       : row_bytes % 4 == 0 ? 4
                                            : 2;
      size_t smem = (size_t)kReadRing * 2 * kSubCols * row_bytes +
                    sizeof(float) * (kSplitWarps + a.n_splits) * a.t_rows *
                        DP;
      if (kPaged) smem += sizeof(int) * ((a.split_cols + a.P - 1) / a.P + 1);
      return launch_verify_split<T, DP, R, kPaged>(
          a.q, a.k, a.v, a.k_new, a.v_new, a.table, a.pos, a.out, a.b * a.h,
          a.h, a.horizon, a.P, a.mp, a.d, a.t_rows, a.scale, a.split_cols,
          a.n_splits, unit, smem, a.stream);
    });
  });
}

}  // namespace

// The verify of one layout and row bound. The four are compiled one a
// source, so that nvcc builds them side by side: the contiguous cache at
// kVerifyShortRows here, the others in decode_verify_rows8.cu,
// decode_verify_paged.cu and decode_verify_paged_rows8.cu, which include
// this file with APEX_TPU_TORCH_VERIFY_PART defined.
cudaError_t verify_contiguous_short(const VerifyArgs& a);
cudaError_t verify_contiguous_max(const VerifyArgs& a);
cudaError_t verify_paged_short(const VerifyArgs& a);
cudaError_t verify_paged_max(const VerifyArgs& a);

}  // namespace apex_tpu_torch

#ifndef APEX_TPU_TORCH_VERIFY_PART
namespace apex_tpu_torch {

cudaError_t verify_contiguous_short(const VerifyArgs& a) {
  return launch_verify_rows<false, kVerifyShortRows>(a);
}

namespace {

// the verify over the contiguous cache (table == nullptr, horizon S) or
// the pools (horizon mp * P): the split geometry as launch_attn's, 1 <=
// t_rows <= kVerifyMaxRows query rows a (batch, head) row, the kernel
// built for at most kVerifyShortRows of them or for kVerifyMaxRows
cudaError_t launch_verify(const void* q, const void* k_new,
                          const void* v_new, void* k, void* v,
                          const void* table, const void* pos, void* out,
                          int b, int h, int t_rows, int horizon, int P,
                          int mp, int d, float scale, int dtype,
                          int split_cols, int n_splits,
                          cudaStream_t stream) {
  if (split_cols <= 0 || split_cols % kSubCols != 0 || n_splits < 1 ||
      n_splits > kMaxSplits ||
      (long long)n_splits * split_cols < horizon ||
      (long long)(n_splits - 1) * split_cols >= horizon || t_rows < 1 ||
      t_rows > kVerifyMaxRows || k_new == nullptr || v_new == nullptr)
    return cudaErrorInvalidValue;
  const VerifyArgs a{q, k_new, v_new, k, v, table, pos, out, b, h, t_rows,
                     horizon, P, mp, d, scale, dtype, split_cols, n_splits,
                     stream};
  const bool is_short = t_rows <= kVerifyShortRows;
  if (table == nullptr)
    return is_short ? verify_contiguous_short(a) : verify_contiguous_max(a);
  return is_short ? verify_paged_short(a) : verify_paged_max(a);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// The speculative verify's write and read of one layer in ONE launch:
// k_new/v_new [b, h, T, d] land in columns pos[b] + j of k_cache/v_cache
// [b, h, S, d] in place, lanes past the horizon clamped onto column S - 1
// (apex_tpu_torch_cache_write_columns), and out [b, h, T, d] attends query
// row i of q [b, h, T, d] over columns 0..min(pos[b] + i, S - 1) of the
// written cache, bit for bit apex_tpu_torch_decode_attention at pos[b] +
// i; 1 <= T <= 8, the split geometry read_splits(S, d).
extern "C" int apex_tpu_torch_decode_verify_attention(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* pos, void* out, int b, int h, int T, int S,
    int d, float scale, int dtype, int split_cols, int n_splits,
    void* stream) {
  if (b <= 0 || h <= 0 || S <= 0) return cudaErrorInvalidValue;
  return launch_verify(q, k_new, v_new, k_cache, v_cache, nullptr, pos, out,
                       b, h, T, S, 1, 1, d, scale, dtype, split_cols,
                       n_splits, static_cast<cudaStream_t>(stream));
}

// The same through row b's table [b, mp] over the pools [num_pages, h, P,
// d]: lanes past the horizon mp * P clamped onto its last column, as
// apex_tpu_torch_paged_write_columns then the paged read at each pos[b] +
// i; the split geometry read_splits(mp * P, d).
extern "C" int apex_tpu_torch_paged_verify_attention(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* table, const void* pos, void* out, int b,
    int h, int T, int P, int mp, int d, float scale, int dtype,
    int split_cols, int n_splits, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0) return cudaErrorInvalidValue;
  return launch_verify(q, k_new, v_new, k_pool, v_pool, table, pos, out, b,
                       h, T, mp * P, P, mp, d, scale, dtype, split_cols,
                       n_splits, static_cast<cudaStream_t>(stream));
}
#endif  // APEX_TPU_TORCH_VERIFY_PART

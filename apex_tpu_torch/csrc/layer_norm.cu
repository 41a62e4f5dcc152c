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
// set of rows and writes one fp32 partial row (its dw, then its db) to a
// workspace, and a second kernel sums the partials of each column in a
// fixed order. The grid depends only on the shape, so dw and db are the
// same bit for bit from launch to launch. Two routes, picked on the host
// by kernels/layer_norm.py:bwd_route from hidden and x's dtype alone:
//
// - Route 1, hidden = NC x 32 x KV for NC in 1, 2, 4, 8 (KV = 8 bf16 or
//   4 fp32 values in a 16-byte vector: BERT-large's 1024 is NC 4 in bf16
//   and 8 in fp32). ln_bwd_reg_kernel: the columns a lane owns (lane * KV
//   + k * 32 * KV) are the same in every row, so its dw and db partials
//   stay in registers across every row its warp takes, and the chunk
//   count is a template argument: all of a row's x and dy loads are
//   issued before the first sum, and the dx pass reads the row from
//   registers. Blocks of kRegWarps warps, held by their launch bounds to
//   kRegBlocksPerSm an SM (kRegBlocksPerSmWide where a lane owns more than
//   kRegLaneCols columns), as many blocks as fit the card at once. dx
//   keeps route 0's arithmetic element for element (the same per-lane
//   order of the two row sums, the same warp_sum, w reloaded for the dx
//   pass by a load the compiler cannot merge with the first, so that
//   w * dy is a fresh product there as in route 0), so it is route 0's
//   bit for bit. At the end each warp stores its partials to its slice of
//   shared memory and the block adds the slices in warp order. The column
//   pass, ln_bwd_fold_kernel, spreads the columns over 2 x hidden /
//   kFoldCols blocks; a block's threads split the partial rows and keep
//   kFoldUnroll 16-byte loads in flight each, and their sums are folded
//   by a fixed tree.
// - Route 0, every other shape (hidden up to kMaxBwdHidden; the ragged
//   [37, 513] fp32 case). ln_bwd_rows_kernel: every lane accumulates its
//   columns' dy*xhat and dy in its warp's slice of shared memory, the
//   block's warps are added in warp order into its partial row, and
//   ln_bwd_cols_kernel sums each column's partials.
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
// route 1 (ln_bwd_reg_kernel): warps a block, the largest chunk count
// instantiated (1, 2, 4 and 8 are), blocks an SM (launch bounds) while a
// lane owns at most kRegLaneCols columns, and past that
constexpr int kRegWarps = 4;
constexpr int kRegThreads = kRegWarps * 32;
constexpr int kRegMaxChunks = 8;
constexpr int kRegLaneCols = 32;
constexpr int kRegBlocksPerSm = 3;
constexpr int kRegBlocksPerSmWide = 2;
// route 1's column pass (ln_bwd_fold_kernel): threads and [dw | db]
// columns a block, 16-byte loads a thread in flight
constexpr int kFoldThreads = 256;
constexpr int kFoldCols = 32;
constexpr int kFoldUnroll = 4;

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

// ---------------------------------------------------------------------------
// backward, route 1, pass 1: the row and the column partials in registers
// ---------------------------------------------------------------------------

// one 16-byte vector's Vec<T>::N values widened to fp32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* d) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) d[i] = to_float<T>(e[i]);
}

// K consecutive elements of W (16-byte aligned, K * sizeof(W) 8, 16 or 32
// bytes) widened to fp32 by loads the compiler may not merge with an
// earlier load of the same address (asm volatile), so the products formed
// from them are fresh ones
template <typename W, int K>
__device__ __forceinline__ void load_n_fresh(const W* __restrict__ src,
                                             float* d) {
  constexpr int kBytes = K * (int)sizeof(W);
  static_assert(kBytes == 8 || kBytes % 16 == 0, "w chunk of 8 or 16k B");
  if constexpr (kBytes == 8) {
    uint2 raw;
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(raw.x), "=r"(raw.y)
                 : "l"(src));
    const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int i = 0; i < K; ++i) d[i] = to_float<W>(e[i]);
  } else {
    constexpr int P = 16 / sizeof(W);
#pragma unroll
    for (int v = 0; v < K; v += P) {
      uint4 raw;
      asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(raw.x), "=r"(raw.y), "=r"(raw.z), "=r"(raw.w)
                   : "l"(src + v));
      const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
      for (int i = 0; i < P; ++i) d[v + i] = to_float<W>(e[i]);
    }
  }
}

// the blocks an SM route 1's launch bounds hold an instantiation to
template <typename T, int NC>
constexpr int kRegBlocks = NC * Vec<T>::N <= kRegLaneCols
                               ? kRegBlocksPerSm
                               : kRegBlocksPerSmWide;

// hidden = NC * 32 * KV. Lane l of a warp owns columns l * KV + k * 32 *
// KV + i (k < NC, i < KV) of every row its warp takes. Dynamic shared
// memory: kRegWarps x 2 x hidden fp32, used once, after the row loop.
template <typename T, typename W, int NC>
__global__ void __launch_bounds__(kRegThreads, kRegBlocks<T, NC>)
ln_bwd_reg_kernel(const T* __restrict__ x, const W* __restrict__ w,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ partial, int rows,
                  int subtract_mean) {
  constexpr int KV = Vec<T>::N;
  constexpr int H = NC * 32 * KV;
  extern __shared__ float4 fold4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_h = 1.0f / H;
  float dwa[NC][KV], dba[NC][KV];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      dwa[k][i] = 0.f;
      dba[k][i] = 0.f;
    }
  }
  for (int row = blockIdx.x * kRegWarps + warp; row < rows;
       row += gridDim.x * kRegWarps) {
    const T* xr = x + (long long)row * H;
    const T* dyr = dy + (long long)row * H;
    // the whole row's loads first
    uint4 xraw[NC], graw[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane * KV + k * 32 * KV;
      xraw[k] = *reinterpret_cast<const uint4*>(xr + c);
      graw[k] = *reinterpret_cast<const uint4*>(dyr + c);
    }
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      float xe[KV], ge[KV], wv[KV];
      unpack<T>(xraw[k], xe);
      unpack<T>(graw[k], ge);
      load_n<W, KV>(w + lane * KV + k * 32 * KV, wv);
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
    T* dxr = dx + (long long)row * H;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = lane * KV + k * 32 * KV;
      float xe[KV], ge[KV], wv[KV], out[KV];
      unpack<T>(xraw[k], xe);
      unpack<T>(graw[k], ge);
      load_n_fresh<W, KV>(w + c, wv);
#pragma unroll
      for (int i = 0; i < KV; ++i) {
        const float xhat = (xe[i] - mu) * rs;
        out[i] = (ge[i] * wv[i] - xhat * c1 - c2) * rs;
        dwa[k][i] += ge[i] * xhat;
        dba[k][i] += ge[i];
      }
      store_n<T, KV>(dxr + c, out);
    }
  }
  // the block's partial row: each warp's slice, then the slices added in
  // warp order
  float* mine = reinterpret_cast<float*>(fold4) + warp * 2 * H;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int c = lane * KV + k * 32 * KV;
#pragma unroll
    for (int i = 0; i < KV; i += 4) {
      *reinterpret_cast<float4*>(mine + c + i) =
          make_float4(dwa[k][i], dwa[k][i + 1], dwa[k][i + 2], dwa[k][i + 3]);
      *reinterpret_cast<float4*>(mine + H + c + i) =
          make_float4(dba[k][i], dba[k][i + 1], dba[k][i + 2], dba[k][i + 3]);
    }
  }
  __syncthreads();
  constexpr int kRow4 = 2 * H / 4;
  float4* out = reinterpret_cast<float4*>(partial) + (long long)blockIdx.x *
                                                         kRow4;
  for (int c4 = threadIdx.x; c4 < kRow4; c4 += kRegThreads) {
    float4 s = fold4[c4];
#pragma unroll
    for (int k = 1; k < kRegWarps; ++k) {
      const float4 t = fold4[k * kRow4 + c4];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    out[c4] = s;
  }
}

// ---------------------------------------------------------------------------
// backward, route 1, pass 2: per column, the blocks' partials in a fixed
// order, spread over the card
// ---------------------------------------------------------------------------

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// grid 2 * hidden / kFoldCols (hidden a multiple of 128): block x sums
// columns [x * kFoldCols, (x + 1) * kFoldCols) of the partial rows [nblk,
// 2 * hidden] (dw's columns, then db's). Thread (r, g) takes the 4
// columns of group g and partial rows r, r + kSplits, ... in order, with
// kFoldUnroll 16-byte loads in flight; the kSplits sums of a group are
// then folded by a fixed tree.
__global__ void __launch_bounds__(kFoldThreads)
ln_bwd_fold_kernel(const float* __restrict__ partial, int nblk, int hidden,
                   float* __restrict__ dw, float* __restrict__ db) {
  constexpr int kGroups = kFoldCols / 4;
  constexpr int kSplits = kFoldThreads / kGroups;
  __shared__ float4 red[kSplits][kGroups];
  const int g = threadIdx.x % kGroups;
  const int r = threadIdx.x / kGroups;
  const int col = blockIdx.x * kFoldCols + 4 * g;
  const long long row4 = 2 * hidden / 4;
  const float4* src = reinterpret_cast<const float4*>(partial + col);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  int j = r;
  for (; j + (kFoldUnroll - 1) * kSplits < nblk; j += kFoldUnroll * kSplits) {
    float4 v[kFoldUnroll];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      v[u] = src[(long long)(j + u * kSplits) * row4];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u) add4(s, v[u]);
  }
  for (; j < nblk; j += kSplits) add4(s, src[(long long)j * row4]);
  red[r][g] = s;
  __syncthreads();
#pragma unroll
  for (int half = kSplits / 2; half > 0; half >>= 1) {
    if (r < half) add4(red[r][g], red[r + half][g]);
    __syncthreads();
  }
  if (r == 0) {
    float* dst = col < hidden ? dw + col : db + (col - hidden);
    *reinterpret_cast<float4*>(dst) = red[0][g];
  }
}

// the backward's partial rows for `rows` rows on route 0 (its workspace
// holds bwd_blocks(rows) x 2 x hidden fp32)
int bwd_blocks(int rows) {
  const int want = (rows + kLnWarps - 1) / kLnWarps;
  return want < kLnBwdBlocks ? want : kLnBwdBlocks;
}

// route 1's chunk count for hidden in x_dtype: NC with hidden = NC * 32 *
// KV and NC a power of two up to kRegMaxChunks, or 0 (route 0's shape)
int reg_chunks(int hidden, int x_dtype) {
  const int kv = x_dtype == kFloat32 ? 4 : 8;
  if (hidden <= 0 || hidden % (32 * kv) != 0) return 0;
  const int nc = hidden / (32 * kv);
  return nc <= kRegMaxChunks && (nc & (nc - 1)) == 0 ? nc : 0;
}

// route 1's partial rows: one block per kRegWarps rows, at most as many
// blocks as its launch bounds keep on the card at once (a lane owns
// hidden / 32 columns)
int reg_blocks(int rows, int hidden) {
  const int per_sm = hidden / 32 <= kRegLaneCols ? kRegBlocksPerSm
                                                 : kRegBlocksPerSmWide;
  const int want = (rows + kRegWarps - 1) / kRegWarps;
  return want < per_sm * kLnSms ? want : per_sm * kLnSms;
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

// route 1 at NC chunks: the register kernel on nblk = reg_blocks(rows,
// hidden) blocks, then the column pass
template <typename T, typename W, int NC>
cudaError_t launch_bwd_reg(const void* x, const void* w, const void* mean,
                           const void* rstd, const void* dy, void* dx,
                           void* dw, void* db, void* workspace, int rows,
                           int subtract_mean, int nblk, cudaStream_t st) {
  constexpr int H = NC * 32 * Vec<T>::N;
  constexpr int kSmem = kRegWarps * 2 * H * (int)sizeof(float);
  // the opt-in above 48 KB, once per instantiation at its first launch
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      ln_bwd_reg_kernel<T, W, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  ln_bwd_reg_kernel<T, W, NC><<<nblk, kRegThreads, kSmem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(workspace), rows, subtract_mean);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_fold_kernel<<<2 * H / kFoldCols, kFoldThreads, 0, st>>>(
      static_cast<const float*>(workspace), nblk, H, static_cast<float*>(dw),
      static_cast<float*>(db));
  return cudaGetLastError();
}

// the backward on `route` (the entry has checked the route and nblk)
template <typename T, typename W>
cudaError_t launch_bwd_route(const void* x, const void* w, const void* mean,
                             const void* rstd, const void* dy, void* dx,
                             void* dw, void* db, void* workspace, int rows,
                             int hidden, int subtract_mean, int route,
                             int nblk, bool vec, cudaStream_t st) {
  if (route == 0)
    return launch_bwd<T, W>(x, w, mean, rstd, dy, dx, dw, db, workspace,
                            rows, hidden, subtract_mean, vec, st);
#define APEX_LN_REG(NC)                                                      \
  return launch_bwd_reg<T, W, NC>(x, w, mean, rstd, dy, dx, dw, db,         \
                                  workspace, rows, subtract_mean, nblk, st)
  switch (hidden / (32 * Vec<T>::N)) {
    case 1: APEX_LN_REG(1);
    case 2: APEX_LN_REG(2);
    case 4: APEX_LN_REG(4);
    case 8: APEX_LN_REG(8);
    default: return cudaErrorInvalidValue;
  }
#undef APEX_LN_REG
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

// x, dy, dx [rows, hidden] in x_dtype; w [hidden] in w_dtype; mean/rstd
// fp32 [rows] from the forward; dw/db fp32 [hidden]; workspace fp32
// [nblk, 2, hidden]. route 1 (ln_bwd_reg_kernel, then ln_bwd_fold_kernel)
// takes hidden = NC x 32 x KV for NC in 1, 2, 4, 8 with nblk =
// reg_blocks(rows, hidden); route 0 (ln_bwd_rows_kernel, then
// ln_bwd_cols_kernel) any hidden up to kMaxBwdHidden with nblk =
// bwd_blocks(rows) (kernels/layer_norm.py:bwd_geometry). Two launches.
// Returns cudaErrorInvalidValue, launching nothing, for a route, nblk,
// dtype or shape other than these.
extern "C" int apex_tpu_torch_layer_norm_bwd(
    const void* x, const void* w, const void* mean, const void* rstd,
    const void* dy, void* dx, void* dw, void* db, void* workspace, int rows,
    int hidden, int subtract_mean, int x_dtype, int w_dtype, int route,
    int nblk, void* stream) {
  if (rows <= 0 || hidden <= 0) return cudaErrorInvalidValue;
  if (route == 0) {
    if (hidden > kMaxBwdHidden || nblk != bwd_blocks(rows))
      return cudaErrorInvalidValue;
  } else if (route == 1) {
    if (reg_chunks(hidden, x_dtype) == 0 || nblk != reg_blocks(rows, hidden))
      return cudaErrorInvalidValue;
  } else {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = vector_ok(hidden, x_dtype);
#define APEX_LN_BWD(T, W)                                                    \
  return launch_bwd_route<T, W>(x, w, mean, rstd, dy, dx, dw, db,           \
                                workspace, rows, hidden, subtract_mean,     \
                                route, nblk, vec, st)
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

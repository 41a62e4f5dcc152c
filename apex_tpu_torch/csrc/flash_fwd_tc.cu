// Tensor-core flash-attention forward, bf16 and fp16 (one body, templated
// on the element type T), for both layouts the port runs: the model layout
// [b, s, hidden] (heads of 64 side by side along hidden) and the
// head-major layout [bh, s, d] with any d <= 128 that is a multiple of 8,
// kv lengths, segment ids and n_rep.
//
// Replaces two TPU kernels for bf16 and fp16 inputs:
//   apex_tpu/kernels/flash_attention.py:_run_fwd_bsh (the pallas_call at
//   :1005, kernel body _fwd_kernel_bsh :841), and
//   apex_tpu/kernels/flash_attention.py:_run_fwd (the pallas_call at :393,
//   kernel body _fwd_kernel :95).
// fp32 and fp16 at a head width that is not a multiple of 8 (widened to
// fp32 by the wrappers) stay on flash_attention_bsh.cu and
// flash_attention.cu; kernels/flash_attention.py:tc_route picks. The JAX
// kernels see fp16 widened to fp32 (widen_f16), so P stays fp32 there;
// here an fp16 P is rounded to fp16 for P V, as a bf16 P is to bf16.
//
// What bounds it on an H100: bytes, just. At the GPT-2 355M step (b=16,
// 16 heads of 64, s=1024, causal) one call reads q, k, v and writes out
// (134 MB) and lse (1 MB): 0.040 ms at 3.35 TB/s, against 0.035 ms for
// its 3.4e10 causal FLOP at 989 TFLOP/s (the same dense rate in bf16 and
// fp16); at the 2.7B step (b=8, 32 heads of 80) 0.050 ms of bytes against
// 0.043 ms of FLOP.
//
// What the design does about it (FlashAttention-2's forward on mma.sync):
// - Element (batch, head, row, col) of q/k/v/out is at
//   base + batch*s_b + head*s_h + row*s_row + col, so one body serves both
//   layouts. A block of 4 warps owns one (batch*head, query tile); each
//   warp owns MT m16 row tiles of it. Causal calls and d > 80 take 64-row
//   tiles (MT = 1: less work above the diagonal), the rest 128-row tiles
//   (MT = 2: each K/V fragment read from shared memory feeds two row
//   tiles); launch_rows says why. Causal query tiles are launched
//   most-work-first (reversed blockIdx.y), so the tail is short.
// - Q is copied to shared memory once; each warp reads its rows as mma
//   A-fragments by ldmatrix at every key tile. Holding them in registers
//   instead measured slower at every shape but d = 128 causal: it cost
//   occupancy (DP 80 at 190 registers, two blocks an SM). K/V tiles of 64
//   keys stream through a 2-stage ring in shared memory, filled by 16-byte
//   cp.async.cg: the next tile's copy is issued before the current tile
//   is computed on, so copy and compute overlap. Rows are DP+8 elements
//   apart (DP the padded head width, 64, 80 or 128), which puts the 8 rows
//   of every ldmatrix phase in 32 distinct banks. Head columns past d and
//   rows past the tile's end are zero-filled by cp.async's src-size,
//   never read from memory.
// - S = Q K^T with mma.sync m16n8k16 (T in, fp32 accumulate), K as the
//   col-major B operand straight from ldmatrix. The scale is folded with
//   log2(e) into one multiply, so exp is exp2f. Masks are _valid_cols
//   (:150): col < kv_end, equal segment ids, causal col <= row, with the
//   finite -1e30 fill; tiles that need no mask skip the per-element test.
//   Key tiles wholly above the diagonal or past kv_end are not visited
//   (_causal_skip, :144).
// - Online softmax in registers, as _online_update (:79): each row's max
//   and sum over a quad of lanes (shuffles 1 and 2); l is summed from fp32
//   p; p is then rounded to T in registers as the mma A-fragments of
//   P V (JAX's p.astype(v.dtype), :90, for bf16; in fp16, 3 mantissa bits
//   finer than bf16, p <= 1 cannot overflow and p below 2^-25 rounds to
//   0). P never touches shared memory. V is the row-major B operand
//   through ldmatrix.trans.
// - Epilogue: out = acc / max(l, 1e-30) to T, staged through the warp's
//   own Q rows in shared memory and written in 16-byte stores; lse = m +
//   log(max(l, 1e-30)), so a row with every column masked ends with out = 0
//   and lse = -1e30 + log(1e-30), as _finish (:133-137).
// Rows past sq (the last tile's padding) are computed on zeros and never
// stored.
#include "flash_tc.cuh"

namespace apex_tpu_torch {
namespace {

using namespace tc;

constexpr int kBK = 64;               // keys of a K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  float* lse;           // [bh, sq]
  const int* lens;      // [bh] or null
  const int* seg_q;     // [bh / n_rep, sq] or null
  const int* seg_k;     // [bh / n_rep, sk] or null
  long long q_sb;       // batch stride of q and out (elements)
  long long k_sb;       // batch stride of k and v
  long long s_h;        // head stride
  long long s_row;      // row stride
  int heads;            // blockIdx.x = batch * heads + head
  int sq, sk, d, n_rep;
  float scale_log2;     // scale * log2(e)
  int causal;
};

// DP: padded head width; MT: m16 row tiles a warp owns (the block holds
// 64 * MT query rows)
template <int DP, int MT>
struct Tc {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head width");
  static constexpr int kBQ = 16 * MT * kWarps;  // query rows of a block
  static constexpr int kLd = DP + 8;            // smem row stride (elements)
  static constexpr int kChunks = DP / 8;        // 16-byte chunks of a row
  static constexpr int kQTile = kBQ * kLd;      // elements of the Q tile
  static constexpr int kKTile = kBK * kLd;      // elements of a K or V tile
  static constexpr int kKSteps = DP / 16;       // k16 steps of Q K^T
  static constexpr int kNTiles = DP / 8;        // n8 tiles of P V
  // Q, two stages of (K, V), two stages of key segment ids, query ids
  static constexpr size_t kSmem =
      ((size_t)kQTile + 4 * (size_t)kKTile) * sizeof(uint16_t) +
      2 * kBK * sizeof(int) + kBQ * sizeof(int);
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T, int DP, int MT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
flash_fwd_tc_kernel(const Params<T> p) {
  using G = Tc<DP, MT>;
  constexpr int kBQ = G::kBQ;
  constexpr int kWRows = 16 * MT;           // query rows of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + G::kQTile;                // 2 stages
  T* vs = ks + 2 * G::kKTile;            // 2 stages
  int* segk_s = reinterpret_cast<int*>(vs + 2 * G::kKTile);  // 2 x kBK
  int* segq_s = segk_s + 2 * kBK;                            // kBQ

  const int bh = blockIdx.x;
  const int n_qt = gridDim.y;
  // causal: the last query tiles have the most key tiles; launch them first
  const int qt = p.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;       // mma group: rows g and g + 8
  const int tig = lane & 3;      // thread in group: columns 2 tig, 2 tig + 1

  const int batch = bh / p.heads;
  const int head = bh - batch * p.heads;
  const long long q_off = batch * p.q_sb + head * p.s_h;
  const long long k_off = batch * p.k_sb + head * p.s_h;
  const T* qb = p.q + q_off;
  const T* kb = p.k + k_off;
  const T* vb = p.v + k_off;

  const int kv_end = p.lens ? max(0, min(p.sk, p.lens[bh])) : p.sk;
  const bool segs = p.seg_q != nullptr;
  const int bseg = bh / p.n_rep;
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_end = p.causal ? min(kv_end, q_last + 1) : kv_end;
  const int n_kt = (k_end + kBK - 1) / kBK;

  // prologue: Q, then K/V tile 0 (two commit groups)
  load_tile_async<DP, kBQ, kThreads>(qs, qb, p.s_row, q0, p.sq, p.d);
  cp_async_commit();
  if (segs && tid < kBQ)
    segq_s[tid] = q0 + tid < p.sq ? p.seg_q[(long long)bseg * p.sq + q0 + tid]
                                  : -1;
  if (n_kt > 0) {
    load_tile_async<DP, kBK, kThreads>(ks, kb, p.s_row, 0, kv_end, p.d);
    load_tile_async<DP, kBK, kThreads>(vs, vb, p.s_row, 0, kv_end, p.d);
    if (segs && tid < kBK)
      segk_s[tid] = tid < p.sk ? p.seg_k[(long long)bseg * p.sk + tid] : -1;
  }
  cp_async_commit();
  cp_async_wait<1>();            // Q has landed
  __syncthreads();

  // ldmatrix x4 lane offsets of an A operand (16 rows x 16 columns):
  // (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15),
  // (rows 8-15, cols 8-15)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_c = (lane >> 4) * 8;
  const int w_row = warp * kWRows;          // this warp's first tile row

  // this thread's rows: q0 + w_row + 16 mt + g (+ 8)
  int sgq[MT][2];
  float m[MT][2], l[MT][2];
  float o[MT][G::kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sgq[mt][h] = segs ? segq_s[w_row + mt * 16 + g + 8 * h] : 0;
      m[mt][h] = kNeg;               // running max, log2 units
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < G::kNTiles; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1;
    const int k0 = t * kBK;
    // issue tile t + 1 into the other stage (its readers finished at the
    // barrier that closed iteration t - 1), then wait for tile t
    if (t + 1 < n_kt) {
      const int nst = st ^ 1;
      load_tile_async<DP, kBK, kThreads>(ks + nst * G::kKTile, kb, p.s_row,
                                         k0 + kBK, kv_end, p.d);
      load_tile_async<DP, kBK, kThreads>(vs + nst * G::kKTile, vb, p.s_row,
                                         k0 + kBK, kv_end, p.d);
      if (segs && tid < kBK) {
        const int c = k0 + kBK + tid;
        segk_s[nst * kBK + tid] =
            c < p.sk ? p.seg_k[(long long)bseg * p.sk + c] : -1;
      }
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const T* kt = ks + st * G::kKTile;
    const T* vt = vs + st * G::kKTile;
    const int* sk_t = segk_s + st * kBK;

    // S = Q K^T: per m16 tile, 16 rows x 64 keys in 8 n8 tiles
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    {
      // x4: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
      // (keys 8-15, d 8-15) of a 16-key pair of n8 tiles
      const int kr = (lane & 7) + (lane >> 4) * 8;
      const int kc = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < G::kKSteps; ++kk) {
        // this warp's query rows as A-fragments, re-read from the Q tile
        uint32_t qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(qa[mt],
                      qs + (w_row + mt * 16 + a_r) * G::kLd + kk * 16 + a_c);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (jp * 16 + kr) * G::kLd + kk * 16 + kc);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16<T>(s[mt][2 * jp], qa[mt], b[0], b[1]);
            mma16<T>(s[mt][2 * jp + 1], qa[mt], b[2], b[3]);
          }
        }
      }
    }

    // scale (log2 units) and mask; a warp whose rows all lie at or past
    // the tile's keys (and before kv_end) skips the per-element test
    const bool need_mask = segs || k0 + kBK > kv_end ||
                           (p.causal && k0 + kBK - 1 > q0 + w_row);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] *= p.scale_log2;
    if (need_mask) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lc = j * 8 + tig * 2 + (e & 1);
            const int col = k0 + lc;
            const int row = q0 + w_row + mt * 16 + g + (e >> 1) * 8;
            bool ok = col < kv_end && (!p.causal || col <= row);
            if (segs) ok = ok && sgq[mt][e >> 1] == sk_t[lc];
            if (!ok) s[mt][j][e] = kNeg;
          }
        }
      }
    }

    // online softmax: row max over the quad, rescale, p = exp2(s - m)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        corr[h] = exp2f(m[mt][h] - mx[h]);
        m[mt][h] = mx[h];
      }
      if (need_mask) {
        // a masked entry is kNeg; p must be 0 there even when the whole
        // row so far is masked (m = kNeg, where exp2(s - m) would be 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = s[mt][j][e];
            s[mt][j][e] = x == kNeg ? 0.f : exp2f(x - mx[e >> 1]);
          }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] = exp2f(s[mt][j][e] - mx[e >> 1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rs[0] += s[mt][j][0] + s[mt][j][1];
        rs[1] += s[mt][j][2] + s[mt][j][3];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[mt][h] = corr[h] * l[mt][h] + quad_sum(rs[h]);
#pragma unroll
      for (int j = 0; j < G::kNTiles; ++j) {
        o[mt][j][0] *= corr[0];
        o[mt][j][1] *= corr[0];
        o[mt][j][2] *= corr[1];
        o[mt][j][3] *= corr[1];
      }
    }

    // O += P V: P's fp32 fragments rounded to T A-fragments in place
    {
      // x4.trans: (keys 0-7, d 0-7), (keys 8-15, d 0-7), (keys 0-7, d 8-15),
      // (keys 8-15, d 8-15) of a 16-key step and a pair of n8 tiles
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          a[mt][0] = pack2<T>(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          a[mt][1] = pack2<T>(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          a[mt][2] = pack2<T>(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          a[mt][3] = pack2<T>(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int jp = 0; jp < G::kNTiles / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vt + (kk * 16 + a_r) * G::kLd + jp * 16 + a_c);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma16<T>(o[mt][2 * jp], a[mt], b[0], b[1]);
            mma16<T>(o[mt][2 * jp + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();   // every warp is done with stage st
  }
  cp_async_wait<0>();

  // epilogue: out through this warp's own rows of the Q tile (no other
  // warp reads them)
  T* ow = qs + w_row * G::kLd;
  float* lb = p.lse + (long long)bh * p.sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lc = fmaxf(l[mt][h], 1e-30f);
      const float inv = 1.f / lc;
      const int r = mt * 16 + g + 8 * h;
#pragma unroll
      for (int j = 0; j < G::kNTiles; ++j)
        *reinterpret_cast<uint32_t*>(ow + r * G::kLd + j * 8 + tig * 2) =
            pack2<T>(o[mt][j][2 * h] * inv, o[mt][j][2 * h + 1] * inv);
      // m is in log2 units; a row with every column masked keeps kNeg
      const int row = q0 + w_row + r;
      if (tig == 0 && row < p.sq)
        lb[row] = (m[mt][h] == kNeg ? kNeg : m[mt][h] * kLn2) + logf(lc);
    }
  }
  __syncwarp();
  T* ob = p.out + q_off;
  static_assert(kWRows * G::kChunks % 32 == 0, "whole chunks a lane");
#pragma unroll
  for (int it = 0; it < kWRows * G::kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / G::kChunks;
    const int c = (i - r * G::kChunks) * 8;
    const int row = q0 + w_row + r;
    if (row < p.sq && c < p.d)
      *reinterpret_cast<uint4*>(ob + (long long)row * p.s_row + c) =
          *reinterpret_cast<const uint4*>(ow + r * G::kLd + c);
  }
}

template <typename T, int DP, int MT, int MINB = 1>
cudaError_t launch_cfg(const Params<T>& p, int bh, cudaStream_t stream) {
  using G = Tc<DP, MT>;
  static bool smem_ok = false;
  const cudaError_t err = hm::allow_smem(
      flash_fwd_tc_kernel<T, DP, MT, MINB>, G::kSmem, &smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + G::kBQ - 1) / G::kBQ);
  flash_fwd_tc_kernel<T, DP, MT, MINB>
      <<<grid, kThreads, G::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// Causal: 64-row query tiles, which do less work above the diagonal, with
// the registers held to three blocks an SM where shared memory allows it
// (DP 64 and 80; 128 fits two). Non-causal: 128-row tiles, where each K/V
// fragment read from shared memory feeds two m16 tiles, up to DP 80: at
// 128 their accumulators do not fit 255 registers (ptxas spills).
template <typename T, int DP>
cudaError_t launch_rows(const Params<T>& p, int bh, cudaStream_t stream) {
  if constexpr (DP == 128) {
    return launch_cfg<T, DP, 1, 2>(p, bh, stream);
  } else {
    if (p.causal) return launch_cfg<T, DP, 1, 3>(p, bh, stream);
    return launch_cfg<T, DP, 2>(p, bh, stream);
  }
}

template <typename T>
cudaError_t launch_dp(const Params<T>& p, int bh, cudaStream_t stream) {
  switch (hm::padded_width(p.d)) {
    case 64:
      return launch_rows<T, 64>(p, bh, stream);
    case 80:
      return launch_rows<T, 80>(p, bh, stream);
    default:
      return launch_rows<T, 128>(p, bh, stream);
  }
}

// The model layout's call: q [b, sq, hidden], k/v [b, sk, hidden] with
// heads of kHeadDim side by side along hidden
template <typename T>
cudaError_t launch_bsh(const void* q, const void* k, const void* v, void* out,
                       void* lse, int b, int sq, int sk, int hidden,
                       int heads, float scale, int causal,
                       cudaStream_t stream) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = (long long)sq * hidden;
  p.k_sb = (long long)sk * hidden;
  p.s_h = kHeadDim;
  p.s_row = hidden;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = kHeadDim;
  p.n_rep = 1;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return launch_dp(p, b * heads, stream);
}

// The head-major call: q [bh, sq, d], k/v [bh, sk, d]
template <typename T>
cudaError_t launch_hm(const void* q, const void* k, const void* v,
                      const void* lens, const void* seg_q, const void* seg_k,
                      void* out, void* lse, int bh, int n_rep, int sq, int sk,
                      int d, float scale, int causal, cudaStream_t stream) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.lse = static_cast<float*>(lse);
  p.lens = static_cast<const int*>(lens);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.q_sb = (long long)sq * d;
  p.k_sb = (long long)sk * d;
  p.s_h = 0;
  p.s_row = d;
  p.heads = 1;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.n_rep = n_rep;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return launch_dp(p, bh, stream);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q [b, sq, hidden], k/v [b, sk, hidden] with heads of kHeadDim side by
// side along hidden, of dtype code `dtype` (kBFloat16 or kFloat16); out
// [b, sq, hidden] in q's dtype, lse fp32 [b, heads, sq]. Every pointer
// 16-byte aligned. Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for anything the kernel does not take (nothing
// launched).
extern "C" int apex_tpu_torch_flash_fwd_bsh_tc(
    const void* q, const void* k, const void* v, void* out, void* lse, int b,
    int sq, int sk, int hidden, int heads, float scale, int causal,
    int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || heads <= 0 ||
      hidden != heads * kHeadDim || (causal && sq != sk) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBFloat16:
      return launch_bsh<bf16>(q, k, v, out, lse, b, sq, sk, hidden, heads,
                              scale, causal, st);
    case kFloat16:
      return launch_bsh<f16>(q, k, v, out, lse, b, sq, sk, hidden, heads,
                             scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// q [bh, sq, d], k/v [bh, sk, d] of dtype code `dtype` (kBFloat16 or
// kFloat16), d <= 128 and a multiple of 8; out [bh, sq, d] in q's dtype,
// lse fp32 [bh, sq]. lens: int32 [bh] kv lengths or null; seg_q/seg_k:
// int32 [bh / n_rep, sq] / [bh / n_rep, sk] segment ids or null (both or
// neither). q, k, v and out 16-byte aligned. Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for anything the kernel does not
// take (nothing launched).
extern "C" int apex_tpu_torch_flash_fwd_hm_tc(
    const void* q, const void* k, const void* v, const void* lens,
    const void* seg_q, const void* seg_k, void* out, void* lse, int bh,
    int n_rep, int sq, int sk, int d, float scale, int causal, int dtype,
    void* stream) {
  if (bh <= 0 || n_rep <= 0 || bh % n_rep || sq <= 0 || sk <= 0 || d <= 0 ||
      d > 128 || d % 8 || (causal && sq != sk) ||
      ((seg_q == nullptr) != (seg_k == nullptr)) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBFloat16:
      return launch_hm<bf16>(q, k, v, lens, seg_q, seg_k, out, lse, bh, n_rep,
                             sq, sk, d, scale, causal, st);
    case kFloat16:
      return launch_hm<f16>(q, k, v, lens, seg_q, seg_k, out, lse, bh, n_rep,
                            sq, sk, d, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Tensor-core flash-attention backward, bf16 and fp16 (one body, templated
// on the element type T), for both layouts the port runs: the model layout
// [b, s, hidden] (heads of 64 side by side along hidden) and the
// head-major layout [bh, s, d] with any d <= 128 that is a multiple of 8,
// kv lengths, segment ids and n_rep.
//
// Replaces three TPU kernels for bf16 and fp16 inputs:
//   apex_tpu/kernels/flash_attention.py:_run_bwd_bsh (the pallas_call at
//   :1060, kernel body _dqkv_kernel_bsh :890),
//   apex_tpu/kernels/flash_attention.py:_run_bwd, fused (the pallas_call
//   at :514, kernel body _dqkv_kernel :272), and
//   apex_tpu/kernels/flash_attention.py:_run_bwd, split dK/dV (the
//   pallas_call at :569, kernel body _dkv_kernel :237): the same body
//   with the dQ share compiled out (DQ false), beside the split dQ sweep
//   of flash_bwd_dq_tc.cu.
// fp32 and head widths that are not a multiple of 8 (fp16 there widened
// to fp32 by the wrappers) stay on flash_attention_bsh_bwd.cu and
// flash_attention_bwd.cu; kernels/flash_attention.py:tc_route picks.
//
// What bounds it on an H100: at the GPT-2 355M step (b=16, 16 heads of
// 64, s=1024, causal) operations: five s x s x 64 products over the causal
// half, 8.6e10 FLOP, 0.087 ms at 989 TFLOP/s, against 0.064 ms for its
// bytes. At the 2.7B step (b=8, 32 heads of 80, fp32 gradients) bytes:
// 421 MB, 0.126 ms.
//
// What the design does about it (FlashAttention-2's backward on
// mma.sync m16n8k16, T in, fp32 accumulate):
// - Element (batch, head, row, col) of q/k/v/do and of the gradients is at
//   base + batch*s_b + head*s_h + row*s_row + col; lse and delta at
//   bh*sq + row. One body serves both layouts.
// - A block of WARPS (8) warps owns one (batch*head, key tile of 16*WARPS
//   keys); each warp owns 16 keys. K and V of the tile are copied to
//   shared memory once. The block walks the query tiles of BQ rows, from
//   the diagonal down when causal (_causal_skip, :144); key tiles past
//   kv_end do no work and write zeros. Q, dO, lse, delta and the query
//   segment ids stream through a 2-stage cp.async ring: the next tile's
//   copy is issued before the current one is computed on. Causal key
//   tiles are launched most-work-first (key tile 0 sees every query), and
//   a warp whose 16 keys all lie past a query tile's last row skips it.
// - Per query tile, in each warp's registers: S^T = K Q^T and dP^T = V
//   dO^T (K and V as A operands, Q and dO as col-major B operands straight
//   from ldmatrix); P^T = exp2(S^T scale log2e - lse log2e) under the
//   _valid_cols mask (:150; lse and delta belong to the query, so here to
//   the column), masked entries set to 0 before the exp2 can overflow;
//   dS^T = P^T (dP^T - delta) scale. P^T and dS^T are rounded to T, as
//   JAX's _p_ds does for bf16 (:188-189), and packed straight into A
//   fragments for dV += P^T dO and dK += dS^T Q (dO and Q through
//   ldmatrix.trans). The dK and dV sums stay in fp32 registers for the
//   whole sweep. JAX widens fp16 to fp32 (widen_f16), so its P and dS stay
//   fp32 there; in fp16 here a dS past 65504 rounds to inf, which an fp32
//   dS never does, and amp then skips the step and backs off. At BERT's
//   shape, with do at the largest power-of-two scale fp16 holds, the
//   largest |dS| is 3936, 16.6x under that (chip_smoke.py phase 21's
//   range check on an NVIDIA H100 80GB HBM3), so dS is not rescaled.
// - dQ += dS K needs dS untransposed: each warp writes its T dS^T rows
//   to one shared tile, the block meets at a barrier, and the warps split
//   the BQ x d dQ tile (A = dS by ldmatrix.trans of dS^T, B = K by
//   ldmatrix.trans) and add their partials with fp32 atomics (two adjacent
//   columns at a time) into an fp32 [rows, d] accumulator with q's strides,
//   zeroed by the entry. The order of those adds changes from launch to
//   launch, so dQ may differ in its last bits between launches.
// - Rows past sq are masked out of P explicitly and never add to dQ; keys
//   past kv_end are masked; head columns past d are zero-filled by
//   cp.async's src-size and never stored.
// - Epilogue: dK and dV in the op's gradient dtype (OutT: T for the model
//   layout, fp32 for the head-major one).
//
// The split dK/dV sweep (DQ false; the head-major layout only). What
// bounds it: at the 2.7B step bytes, q, k, v and do read once, dk and dv
// written in fp32, lse and delta (338 MB, 0.101 ms), against four s x s x
// 80 products over the causal half (8.6e10 FLOP, 0.087 ms). What the
// design does about it: the fused body less everything dQ costs — no dS^T
// tile in shared memory, no barrier for it, no atomics and no zeroing of
// a dq buffer — so one barrier an iteration guards the Q / dO ring. dK
// and dV are summed in fp32 registers by one warp each, in one fixed
// order, so the same inputs give the same bits at every launch; its tiles
// are its own (launch_dkdv), measured without dQ's atomics to amortise.
#include "flash_tc.cuh"

namespace apex_tpu_torch {
namespace {

using namespace tc;

constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;     // [bh, sq]
  const float* delta;   // [bh, sq]
  const int* lens;      // [bh] or null
  const int* seg_q;     // [bh / n_rep, sq] or null
  const int* seg_k;     // [bh / n_rep, sk] or null
  float* dq;            // fp32 accumulator, q's strides, zeroed
  void* dk;             // OutT, k's strides
  void* dv;
  long long q_sb;       // batch stride of q, do and dq (elements)
  long long k_sb;       // batch stride of k, v, dk and dv
  long long s_h;        // head stride
  long long s_row;      // row stride
  int heads;            // blockIdx.x = batch * heads + head
  int sq, sk, d, n_rep;
  float scale;
  float scale_log2;     // scale * log2(e)
  int causal;
};

// DP: padded head width; BQ: query rows of a tile; WARPS: warps of a block,
// 16 keys each; DQ: with the dQ share (the fused sweep) or without it (the
// split dK/dV sweep)
template <int DP, int BQ, int WARPS, bool DQ = true>
struct Bw {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head width");
  static_assert(BQ % 16 == 0, "whole m16 tiles of queries");
  static constexpr int kBK = 16 * WARPS;        // keys of a block
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kLd = DP + 8;            // smem row stride (elements)
  static constexpr int kLdS = BQ + 8;           // dS^T row stride (elements)
  static constexpr int kKTile = kBK * kLd;      // elements of the K or V tile
  static constexpr int kQTile = BQ * kLd;       // elements of a Q or dO tile
  static constexpr int kKSteps = DP / 16;       // k16 steps over d
  static constexpr int kQN = BQ / 8;            // n8 tiles of S^T
  static constexpr int kDN = DP / 8;            // n8 tiles of dK, dV
  // dQ: the BQ x DP tile as kQM m16 tiles of queries, each split over
  // kParts warps by pairs of n8 tiles of d
  static constexpr int kQM = BQ / 16;
  static_assert(!DQ || WARPS % kQM == 0, "every warp gets a share of dQ");
  static constexpr int kParts = DQ ? WARPS / kQM : 1;
  static constexpr int kPairs = DP / 16;
  static constexpr int kPairsPer = (kPairs + kParts - 1) / kParts;
  // K, V, two stages of (Q, dO), dS^T (with DQ); two stages of (lse,
  // delta); key segment ids, two stages of query ids
  static constexpr size_t kSmem =
      (2 * (size_t)kKTile + 4 * (size_t)kQTile +
       (DQ ? (size_t)kBK * kLdS : 0)) *
          sizeof(uint16_t) +
      4 * BQ * sizeof(float) + (kBK + 2 * BQ) * sizeof(int);
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<bf16>(a, b);
}
template <>
__device__ __forceinline__ void store2<f16>(f16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<f16>(a, b);
}

// dst[0..1] += (a, b) in global memory, one vector atomic
__device__ __forceinline__ void atomic_add2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

template <typename T, int DP, int BQ, int WARPS, typename OutT, int MINB,
          bool DQ>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_bwd_tc_kernel(const Params<T> p) {
  using G = Bw<DP, BQ, WARPS, DQ>;
  constexpr int kBK = G::kBK;
  constexpr int kThreads = G::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + G::kKTile;
  T* qs = vs + G::kKTile;                 // 2 stages
  T* dos = qs + 2 * G::kQTile;            // 2 stages
  T* dst = dos + 2 * G::kQTile;           // dS^T, kBK x kLdS (DQ only)
  float* lse_s =
      reinterpret_cast<float*>(dst + (DQ ? kBK * G::kLdS : 0));  // 2 x BQ
  float* del_s = lse_s + 2 * BQ;                                 // 2 x BQ
  int* segk_s = reinterpret_cast<int*>(del_s + 2 * BQ);          // kBK
  int* segq_s = segk_s + kBK;                                    // 2 x BQ

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
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
  const T* dob = p.dout + q_off;
  const float* lse_b = p.lse + (long long)bh * p.sq;
  const float* del_b = p.delta + (long long)bh * p.sq;

  const int kv_end = p.lens ? max(0, min(p.sk, p.lens[bh])) : p.sk;
  const bool segs = p.seg_q != nullptr;
  const int bseg = bh / p.n_rep;
  const int* segq_b = segs ? p.seg_q + (long long)bseg * p.sq : nullptr;
  const int* segk_b = segs ? p.seg_k + (long long)bseg * p.sk : nullptr;
  const int kw0 = k0 + warp * 16;           // this warp's first key

  // ldmatrix x4 lane offsets: a_r / a_c for an A operand (16 rows x 16
  // columns) and for a row-major B operand read with .trans; b_r / b_c for
  // a col-major B operand (16 n-rows x 16 k-columns) read without .trans
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_c = (lane >> 4) * 8;
  const int b_r = (lane & 7) + (lane >> 4) * 8;
  const int b_c = ((lane >> 3) & 1) * 8;

  float dka[G::kDN][4], dva[G::kDN][4];
#pragma unroll
  for (int j = 0; j < G::kDN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  // Q, dO and the per-query operands of the tile at q0 into stage st
  auto load_q = [&](int st, int q0) {
    load_tile_async<DP, BQ, kThreads>(qs + st * G::kQTile, qb, p.s_row, q0,
                                      p.sq, p.d);
    load_tile_async<DP, BQ, kThreads>(dos + st * G::kQTile, dob, p.s_row, q0,
                                      p.sq, p.d);
    if (tid < BQ) {
      const int r = q0 + tid;
      const bool ok = r < p.sq;
      cp_async4(lse_s + st * BQ + tid, ok ? lse_b + r : lse_b, ok);
      cp_async4(del_s + st * BQ + tid, ok ? del_b + r : del_b, ok);
      if (segs) cp_async4(segq_s + st * BQ + tid, ok ? segq_b + r : segq_b,
                          ok);
    }
  };

  if (k0 < kv_end) {
    // causal: query tiles wholly above this key tile see none of its keys
    const int q_first = p.causal ? (k0 / BQ) * BQ : 0;
    const int n_qt = (p.sq - q_first + BQ - 1) / BQ;

    // prologue: K, V and the key ids with the first query tile, one group
    load_tile_async<DP, kBK, kThreads>(ks, p.k + k_off, p.s_row, k0, kv_end,
                                       p.d);
    load_tile_async<DP, kBK, kThreads>(vs, p.v + k_off, p.s_row, k0, kv_end,
                                       p.d);
    if (segs && tid < kBK) {
      const bool ok = k0 + tid < p.sk;
      cp_async4(segk_s + tid, ok ? segk_b + k0 + tid : segk_b, ok);
    }
    load_q(0, q_first);
    cp_async_commit();

    for (int t = 0; t < n_qt; ++t) {
      const int st = t & 1;
      const int q0 = q_first + t * BQ;
      if constexpr (DQ) {
        // issue tile t + 1 into the other stage (its readers finished at
        // the second barrier of iteration t - 1), then wait for tile t
        if (t + 1 < n_qt) load_q(st ^ 1, q0 + BQ);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
      } else {
        // one barrier an iteration: wait for tile t, meet (every warp is
        // then done with tile t - 1's stage), and issue tile t + 1 into
        // that stage, to land while tile t is computed on
        cp_async_wait<0>();
        __syncthreads();
        if (t + 1 < n_qt) load_q(st ^ 1, q0 + BQ);
        cp_async_commit();
      }

      const T* qt = qs + st * G::kQTile;
      const T* dot = dos + st * G::kQTile;
      const float* ls = lse_s + st * BQ;
      const float* dl = del_s + st * BQ;
      const int* sgq = segq_s + st * BQ;

      // a warp whose keys are all masked for this tile (past kv_end, or
      // causal and past every query of it) only writes zeros of dS^T
      const bool live = kw0 < kv_end && !(p.causal && kw0 > q0 + BQ - 1);
      if (live) {
        float s[G::kQN][4], dp[G::kQN][4];
#pragma unroll
        for (int j = 0; j < G::kQN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries
#pragma unroll
        for (int kk = 0; kk < G::kKSteps; ++kk) {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, ks + (warp * 16 + a_r) * G::kLd + kk * 16 + a_c);
          ldmatrix_x4(va, vs + (warp * 16 + a_r) * G::kLd + kk * 16 + a_c);
#pragma unroll
          for (int jp = 0; jp < G::kQN / 2; ++jp) {
            uint32_t b[4];
            ldmatrix_x4(b, qt + (jp * 16 + b_r) * G::kLd + kk * 16 + b_c);
            mma16<T>(s[2 * jp], ka, b[0], b[1]);
            mma16<T>(s[2 * jp + 1], ka, b[2], b[3]);
            ldmatrix_x4(b, dot + (jp * 16 + b_r) * G::kLd + kk * 16 + b_c);
            mma16<T>(dp[2 * jp], va, b[0], b[1]);
            mma16<T>(dp[2 * jp + 1], va, b[2], b[3]);
          }
        }

        // P^T and dS^T in place of S^T and dP^T; the per-element mask only
        // where some entry of the warp's block can be masked
        const bool need_mask = segs || q0 + BQ > p.sq || kw0 + 16 > kv_end ||
                               (p.causal && kw0 + 15 > q0);
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < G::kQN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int lc = j * 8 + tig * 2 + (e & 1);
              const int query = q0 + lc;
              const int key = kw0 + g + (e >> 1) * 8;
              bool ok = query < p.sq && key < kv_end &&
                        (!p.causal || key <= query);
              if (segs) ok = ok && sgq[lc] == segk_s[key - k0];
              const float pv =
                  ok ? exp2f(fmaf(s[j][e], p.scale_log2, -ls[lc] * kLog2e))
                     : 0.f;
              s[j][e] = pv;
              dp[j][e] = pv * (dp[j][e] - dl[lc]) * p.scale;
            }
        } else {
#pragma unroll
          for (int j = 0; j < G::kQN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int lc = j * 8 + tig * 2 + (e & 1);
              const float pv =
                  exp2f(fmaf(s[j][e], p.scale_log2, -ls[lc] * kLog2e));
              s[j][e] = pv;
              dp[j][e] = pv * (dp[j][e] - dl[lc]) * p.scale;
            }
        }

        // P^T and dS^T rounded to T as A fragments, 16 queries a step;
        // dV += P^T dO, dK += dS^T Q
#pragma unroll
        for (int kk = 0; kk < G::kQN / 2; ++kk) {
          uint32_t pa[4], da[4];
          pa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
          da[0] = pack2<T>(dp[2 * kk][0], dp[2 * kk][1]);
          da[1] = pack2<T>(dp[2 * kk][2], dp[2 * kk][3]);
          da[2] = pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          da[3] = pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
          if constexpr (DQ) {
            // this warp's rows of dS^T for the dQ product
            T* w0 = dst + (warp * 16 + g) * G::kLdS + kk * 16 + tig * 2;
            T* w8 = w0 + 8 * G::kLdS;
            *reinterpret_cast<uint32_t*>(w0) = da[0];
            *reinterpret_cast<uint32_t*>(w8) = da[1];
            *reinterpret_cast<uint32_t*>(w0 + 8) = da[2];
            *reinterpret_cast<uint32_t*>(w8 + 8) = da[3];
          }
#pragma unroll
          for (int jp = 0; jp < DP / 16; ++jp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, dot + (kk * 16 + a_r) * G::kLd + jp * 16 +
                                     a_c);
            mma16<T>(dva[2 * jp], pa, b[0], b[1]);
            mma16<T>(dva[2 * jp + 1], pa, b[2], b[3]);
            ldmatrix_x4_trans(b, qt + (kk * 16 + a_r) * G::kLd + jp * 16 +
                                     a_c);
            mma16<T>(dka[2 * jp], da, b[0], b[1]);
            mma16<T>(dka[2 * jp + 1], da, b[2], b[3]);
          }
        }
      } else if constexpr (DQ) {
#pragma unroll
        for (int kk = 0; kk < G::kQN / 2; ++kk) {
          T* w0 = dst + (warp * 16 + g) * G::kLdS + kk * 16 + tig * 2;
          T* w8 = w0 + 8 * G::kLdS;
          *reinterpret_cast<uint32_t*>(w0) = 0u;
          *reinterpret_cast<uint32_t*>(w8) = 0u;
          *reinterpret_cast<uint32_t*>(w0 + 8) = 0u;
          *reinterpret_cast<uint32_t*>(w8 + 8) = 0u;
        }
      }
      if constexpr (!DQ) continue;   // the split dK/dV sweep: no dQ share
      __syncthreads();   // dS^T is whole; every warp is done with stage st

      // dQ += dS K over this warp's share: query rows mq*16.. of the tile,
      // n8 pairs [lo, hi) of d. Rows past sq, and causal rows above every
      // key of the block, get nothing.
      const int mq = warp % G::kQM;
      const int lo = (warp / G::kQM) * G::kPairsPer;
      const int hi = min(G::kPairs, lo + G::kPairsPer);
      const int r0 = q0 + mq * 16;
      if (r0 < p.sq && !(p.causal && r0 + 15 < k0)) {
        float acc[2 * G::kPairsPer][4];
#pragma unroll
        for (int i = 0; i < 2 * G::kPairsPer; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
        // x4.trans of dS^T (keys x queries): A = dS, (queries 0-7, keys
        // 0-7), (queries 8-15, keys 0-7), (queries 0-7, keys 8-15),
        // (queries 8-15, keys 8-15)
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, dst + (kk * 16 + b_r) * G::kLdS + mq * 16 +
                                   b_c);
#pragma unroll
          for (int i = 0; i < G::kPairsPer; ++i) {
            const int jp = lo + i;
            if (jp < hi) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, ks + (kk * 16 + a_r) * G::kLd + jp * 16 +
                                       a_c);
              mma16<T>(acc[2 * i], a, b[0], b[1]);
              mma16<T>(acc[2 * i + 1], a, b[2], b[3]);
            }
          }
        }
        float* dqb = p.dq + q_off;
#pragma unroll
        for (int i = 0; i < G::kPairsPer; ++i) {
          const int jp = lo + i;
          if (jp >= hi) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + g + 8 * h;
            if (row >= p.sq) continue;
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const int col = jp * 16 + n * 8 + tig * 2;
              if (col < p.d)
                atomic_add2(dqb + (long long)row * p.s_row + col,
                            acc[2 * i + n][2 * h], acc[2 * i + n][2 * h + 1]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  // epilogue: this warp's 16 keys of dK and dV (zeros past kv_end)
  OutT* dkb = static_cast<OutT*>(p.dk) + k_off;
  OutT* dvb = static_cast<OutT*>(p.dv) + k_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + g + 8 * h;
    if (key >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < G::kDN; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < p.d) {
        const long long o = (long long)key * p.s_row + col;
        store2<OutT>(dkb + o, dka[j][2 * h], dka[j][2 * h + 1]);
        store2<OutT>(dvb + o, dva[j][2 * h], dva[j][2 * h + 1]);
      }
    }
  }
}

template <typename T, int DP, int BQ, int WARPS, typename OutT, int MINB,
          bool DQ = true>
cudaError_t launch_cfg(const Params<T>& p, int bh, cudaStream_t stream) {
  using G = Bw<DP, BQ, WARPS, DQ>;
  static bool smem_ok = false;
  const cudaError_t err = hm::allow_smem(
      flash_bwd_tc_kernel<T, DP, BQ, WARPS, OutT, MINB, DQ>, G::kSmem,
      &smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sk + G::kBK - 1) / G::kBK);
  flash_bwd_tc_kernel<T, DP, BQ, WARPS, OutT, MINB, DQ>
      <<<grid, G::kThreads, G::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// 128-key blocks of 8 warps: each Q / dO tile copied to shared memory, and
// each dQ atomic, then serves twice the keys of a 64-key block of 4 warps,
// which ran 1.2-1.5x slower at every width. The query tile and the
// register cap by measurement, sides in turns (PERF.md; NVIDIA H100 80GB
// HBM3, 700.00 W): DP 64 32-row tiles at 128 registers, two blocks an SM
// (0.52 ms at the GPT step, against 0.65 at 64 rows and 246 registers);
// DP 80 64-row tiles, one block (32 rows at a 128-register cap spill 120
// bytes); DP 128 32-row tiles, one block (the dK / dV sums alone take 128
// registers).
template <typename T, typename OutT>
cudaError_t launch_dp(const Params<T>& p, int bh, cudaStream_t stream) {
  switch (hm::padded_width(p.d)) {
    case 64:
      return launch_cfg<T, 64, 32, 8, OutT, 2>(p, bh, stream);
    case 80:
      return launch_cfg<T, 80, 64, 8, OutT, 1>(p, bh, stream);
    default:
      return launch_cfg<T, 128, 32, 8, OutT, 1>(p, bh, stream);
  }
}

// The split dK/dV sweep's tiles (DQ off): with no dQ atomics to share,
// 64-key blocks of 4 warps beat the fused kernel's 128-key blocks at every
// width. By measurement at b=8, 32 heads, s=1024, causal, bf16 (PERF.md;
// NVIDIA H100 80GB HBM3, 700.00 W): DP 64 32-row query tiles, three blocks
// an SM (166 registers); DP 80 64-row tiles, two blocks (246 registers;
// 0.42 ms at the 2.7B's attention against 0.48 on the fused kernel's
// tiles); DP 128 64-row tiles, one block (255 registers, 20 bytes
// spilled, and still faster than 32-row tiles at 241). The tiles change
// no sum: each warp adds its 16 keys' products over 16-query steps in
// ascending order whatever BQ is, and a step with no valid pair adds
// exact zeros, so dK and dV equal the fused kernel's bit for bit.
template <typename T>
cudaError_t launch_dkdv(const Params<T>& p, int bh, cudaStream_t stream) {
  switch (hm::padded_width(p.d)) {
    case 64:
      return launch_cfg<T, 64, 32, 4, float, 3, false>(p, bh, stream);
    case 80:
      return launch_cfg<T, 80, 64, 4, float, 2, false>(p, bh, stream);
    default:
      return launch_cfg<T, 128, 64, 4, float, 1, false>(p, bh, stream);
  }
}

// The model layout's call: q/dout [b, sq, hidden], k/v [b, sk, hidden]
// with heads of kHeadDim side by side; dq an fp32 sum, dk/dv in T
template <typename T>
cudaError_t launch_bsh(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int b, int sq, int sk,
                       int hidden, int heads, float scale, int causal,
                       cudaStream_t stream) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = dk;
  p.dv = dv;
  p.q_sb = (long long)sq * hidden;
  p.k_sb = (long long)sk * hidden;
  p.s_h = kHeadDim;
  p.s_row = hidden;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = kHeadDim;
  p.n_rep = 1;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return launch_dp<T, T>(p, b * heads, stream);
}

// The head-major call: q/dout [bh, sq, d], k/v [bh, sk, d]; fp32
// gradients; with dq null the split dK/dV sweep
template <typename T>
cudaError_t launch_hm(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* lens, const void* seg_q, const void* seg_k,
                      void* dq, void* dk, void* dv, int bh, int n_rep, int sq,
                      int sk, int d, float scale, int causal,
                      cudaStream_t stream) {
  Params<T> p{};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.lens = static_cast<const int*>(lens);
  p.seg_q = static_cast<const int*>(seg_q);
  p.seg_k = static_cast<const int*>(seg_k);
  p.dq = static_cast<float*>(dq);
  p.dk = dk;
  p.dv = dv;
  p.q_sb = (long long)sq * d;
  p.k_sb = (long long)sk * d;
  p.s_h = 0;
  p.s_row = d;
  p.heads = 1;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.n_rep = n_rep;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return dq ? launch_dp<T, float>(p, bh, stream)
            : launch_dkdv<T>(p, bh, stream);
}

// what the head-major tensor-core entries take (their argument list is
// the one of flash_attention_bwd.cu's entries)
bool hm_args_ok(const void* q, const void* k, const void* v,
                const void* dout, const void* seg_q, const void* seg_k,
                int bh, int n_rep, int sq, int sk, int d, int causal,
                int dtype) {
  return (dtype == kBFloat16 || dtype == kFloat16) && bh > 0 && n_rep > 0 &&
         bh % n_rep == 0 && sq > 0 && sk > 0 && d > 0 && d <= 128 &&
         d % 8 == 0 && !(causal && sq != sk) &&
         (seg_q == nullptr) == (seg_k == nullptr) && aligned16(q) &&
         aligned16(k) && aligned16(v) && aligned16(dout);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q/dout [b, sq, hidden], k/v [b, sk, hidden] with heads of kHeadDim side
// by side along hidden, of dtype code `dtype` (kBFloat16 or kFloat16); lse
// and delta fp32 [b, heads, sq]. Writes dq as an fp32 [b, sq, hidden] sum
// (zeroed here first) and dk/dv [b, sk, hidden] in q's dtype. Every
// pointer 16-byte aligned. Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for anything the kernel does not take (nothing
// launched).
extern "C" int apex_tpu_torch_flash_bwd_bsh_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int b,
    int sq, int sk, int hidden, int heads, float scale, int causal,
    int dtype, void* stream) {
  if ((dtype != kBFloat16 && dtype != kFloat16) || b <= 0 || sq <= 0 ||
      sk <= 0 || heads <= 0 || hidden != heads * kHeadDim ||
      (causal && sq != sk) || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(dout) || !aligned16(dq) || !aligned16(dk) ||
      !aligned16(dv))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(dq, 0, (size_t)b * sq * hidden * sizeof(float), st);
  if (err != cudaSuccess) return err;
  return dtype == kFloat16
             ? launch_bsh<f16>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq,
                               sk, hidden, heads, scale, causal, st)
             : launch_bsh<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq,
                                sk, hidden, heads, scale, causal, st);
}

// The argument list of the head-major backward entries
// (flash_attention_bwd.cu): q/dout [bh, sq, d], k/v [bh, sk, d] of dtype
// code `dtype` (kBFloat16 or kFloat16), d <= 128 and a multiple of 8; lse
// and delta fp32 [bh, sq]; lens int32 [bh] or null; seg_q/seg_k int32
// [bh / n_rep, sq] / [bh / n_rep, sk] or null (both or neither); fp32
// gradients dq [bh, sq, d] (zeroed here first), dk/dv [bh, sk, d]. q, k, v
// and dout 16-byte aligned. Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for anything the kernel does not take (nothing
// launched).
extern "C" int apex_tpu_torch_flash_bwd_hm_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lens, const void* seg_q,
    const void* seg_k, void* dq, void* dk, void* dv, int bh, int n_rep,
    int sq, int sk, int d, float scale, int causal, int dtype, void* stream) {
  if (!hm_args_ok(q, k, v, dout, seg_q, seg_k, bh, n_rep, sq, sk, d, causal,
                  dtype) ||
      dq == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(dq, 0, (size_t)bh * sq * d * sizeof(float), st);
  if (err != cudaSuccess) return err;
  return dtype == kFloat16
             ? launch_hm<f16>(q, k, v, dout, lse, delta, lens, seg_q, seg_k,
                              dq, dk, dv, bh, n_rep, sq, sk, d, scale, causal,
                              st)
             : launch_hm<bf16>(q, k, v, dout, lse, delta, lens, seg_q, seg_k,
                               dq, dk, dv, bh, n_rep, sq, sk, d, scale,
                               causal, st);
}

// The split dK/dV sweep on the same argument list: writes dk and dv
// (fp32 [bh, sk, d]) alone, each by one block in a fixed order, so the
// same inputs give the same bits at every launch; dq is ignored.
extern "C" int apex_tpu_torch_flash_bwd_hm_dkdv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lens, const void* seg_q,
    const void* seg_k, void* dq, void* dk, void* dv, int bh, int n_rep,
    int sq, int sk, int d, float scale, int causal, int dtype, void* stream) {
  (void)dq;
  if (!hm_args_ok(q, k, v, dout, seg_q, seg_k, bh, n_rep, sq, sk, d, causal,
                  dtype))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kFloat16
             ? launch_hm<f16>(q, k, v, dout, lse, delta, lens, seg_q, seg_k,
                              nullptr, dk, dv, bh, n_rep, sq, sk, d, scale,
                              causal, st)
             : launch_hm<bf16>(q, k, v, dout, lse, delta, lens, seg_q, seg_k,
                               nullptr, dk, dv, bh, n_rep, sq, sk, d, scale,
                               causal, st);
}

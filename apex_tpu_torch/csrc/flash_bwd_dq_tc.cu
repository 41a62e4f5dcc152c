// Tensor-core split dQ sweep of the head-major flash-attention backward,
// bf16 and fp16 (one body, templated on the element type T): q/do [bh, sq,
// d], k/v [bh, sk, d] with any d <= 128 that is a multiple of 8, kv
// lengths, segment ids and n_rep; dq fp32 [bh, sq, d].
//
// Replaces, for bf16 and fp16 inputs,
//   apex_tpu/kernels/flash_attention.py:_run_bwd, split dQ (the pallas_call
//   at :547, kernel body _dq_kernel :207),
// which runs under APEX_TPU_FLASH_BWD=split, and by default once the fused
// sweep's fp32 dQ accumulator passes 4 MiB (s > 8192 at d <= 128). The
// split dK/dV sweep beside it is flash_bwd_tc.cu's kernel without its dQ
// share. fp32 and head widths that are not a multiple of 8 (fp16 there
// widened to fp32 by the wrappers) stay on flash_attention_bwd.cu;
// kernels/flash_attention.py:tc_route picks.
//
// What bounds it on an H100: at the 2.7B step (b=8, 32 heads of 80,
// s=1024, causal) bytes: q, k, v and do read once, dq written in fp32, lse
// and delta (254 MB, 0.076 ms at 3.35 TB/s), against three s x s x 80
// products over the causal half (6.5e10 FLOP, 0.066 ms at 989 TFLOP/s).
//
// What the design does about it (the forward's skeleton, flash_fwd_tc.cu,
// with FlashAttention-2's dQ loop; mma.sync m16n8k16, T in, fp32
// accumulate):
// - A block of 4 warps owns one (bh, query tile of 64 rows); each warp
//   owns 16 rows. Q and dO of the tile are copied to shared memory once
//   and read as A fragments by ldmatrix at every key tile; lse and delta
//   sit in registers, one value per row a thread owns (rows g and g + 8).
//   Causal query tiles are launched most-work-first (reversed blockIdx.y).
// - K and V tiles of 64 keys (32 at d > 80, launch_dp) stream through a
//   2-stage cp.async ring, up to the diagonal when causal and up to kv_end
//   under lens (_causal_skip, :144): the next tile's copy is issued right
//   after the one barrier of an iteration, so it lands while the current
//   tile is computed on. Rows
//   are DP + 8 elements apart, so the 8 rows of every ldmatrix phase fall
//   in 32 distinct banks; head columns past d and keys past kv_end are
//   zero-filled by cp.async's src-size.
// - Per key tile, in each warp's registers: S = Q K^T and dP = dO V^T (K
//   and V as col-major B operands straight from ldmatrix); P = exp2(S
//   scale log2e - lse log2e) under the _valid_cols mask (:150), masked
//   entries 0 before the exp2 can overflow. lse is given, so there is no
//   online softmax. dS = P (dP - delta) scale is rounded to T, as JAX's
//   _p_ds does for bf16 (:188-189), and packed straight from the
//   accumulators into A fragments, as the forward packs P; dQ += dS K with
//   K as the row-major B operand through ldmatrix.trans, as the forward
//   reads V. JAX widens fp16 (widen_f16), so there its dS stays fp32.
// - dQ stays in fp32 registers for the whole sweep and is stored once: no
//   atomics, no zeroing, and the sums run in one fixed order, so the same
//   inputs give the same bits at every launch.
// - Rows past sq see zero Q and dO (dS 0) and are never stored.
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
  float* dq;            // [bh, sq, d]
  int sq, sk, d, n_rep;
  float scale;
  float scale_log2;     // scale * log2(e)
  int causal;
};

// DP: padded head width; WARPS: warps of a block, 16 query rows each; BK:
// keys of a K/V tile
template <int DP, int WARPS, int BK>
struct Dq {
  static_assert(DP % 16 == 0 && DP <= 128, "padded head width");
  static_assert(BK % 16 == 0, "whole k16 steps of keys");
  static constexpr int kBQ = 16 * WARPS;        // query rows of a block
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kLd = DP + 8;            // smem row stride (elements)
  static constexpr int kQTile = kBQ * kLd;      // elements of the Q or dO tile
  static constexpr int kKTile = BK * kLd;       // elements of a K or V tile
  static constexpr int kKSteps = DP / 16;       // k16 steps of Q K^T
  static constexpr int kKN = BK / 8;            // n8 tiles of S
  static constexpr int kDN = DP / 8;            // n8 tiles of dQ
  // Q, dO, two stages of (K, V), two stages of key segment ids
  static constexpr size_t kSmem =
      (2 * (size_t)kQTile + 4 * (size_t)kKTile) * sizeof(uint16_t) +
      2 * BK * sizeof(int);
};

template <typename T, int DP, int WARPS, int BK, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
flash_bwd_dq_tc_kernel(const Params<T> p) {
  using G = Dq<DP, WARPS, BK>;
  constexpr int kBQ = G::kBQ;
  constexpr int kThreads = G::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + G::kQTile;
  T* ks = dos + G::kQTile;               // 2 stages
  T* vs = ks + 2 * G::kKTile;            // 2 stages
  int* segk_s = reinterpret_cast<int*>(vs + 2 * G::kKTile);  // 2 x BK

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

  const long long q_off = (long long)bh * p.sq * p.d;
  const long long k_off = (long long)bh * p.sk * p.d;
  const T* kb = p.k + k_off;
  const T* vb = p.v + k_off;

  const int kv_end = p.lens ? max(0, min(p.sk, p.lens[bh])) : p.sk;
  const bool segs = p.seg_q != nullptr;
  const int bseg = bh / p.n_rep;
  const int* segk_b = segs ? p.seg_k + (long long)bseg * p.sk : nullptr;
  const int q_last = min(q0 + kBQ, p.sq) - 1;
  const int k_end = p.causal ? min(kv_end, q_last + 1) : kv_end;
  const int n_kt = (k_end + BK - 1) / BK;
  const int w_row = warp * 16;              // this warp's first tile row

  // this thread's rows q0 + w_row + g (+ 8): lse in log2 units, delta and
  // the segment id (zeros and -1 past sq)
  float lse2[2], dl[2];
  int sgq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + w_row + g + 8 * h;
    const bool ok = row < p.sq;
    const long long r = (long long)bh * p.sq + row;
    lse2[h] = ok ? p.lse[r] * kLog2e : 0.f;
    dl[h] = ok ? p.delta[r] : 0.f;
    sgq[h] = segs && ok ? p.seg_q[(long long)bseg * p.sq + row] : -1;
  }

  // K, V and the key ids of the tile at k0 into stage st
  auto load_k = [&](int st, int k0) {
    load_tile_async<DP, BK, kThreads>(ks + st * G::kKTile, kb, p.d, k0,
                                      kv_end, p.d);
    load_tile_async<DP, BK, kThreads>(vs + st * G::kKTile, vb, p.d, k0,
                                      kv_end, p.d);
    if (segs && tid < BK) {
      const int c = k0 + tid;
      segk_s[st * BK + tid] = c < p.sk ? segk_b[c] : -1;
    }
  };

  // prologue: Q, dO and K/V tile 0, one group
  load_tile_async<DP, kBQ, kThreads>(qs, p.q + q_off, p.d, q0, p.sq, p.d);
  load_tile_async<DP, kBQ, kThreads>(dos, p.dout + q_off, p.d, q0, p.sq,
                                     p.d);
  if (n_kt > 0) load_k(0, 0);
  cp_async_commit();

  // ldmatrix x4 lane offsets: a_r / a_c for an A operand (16 rows x 16
  // columns) and for a row-major B operand read with .trans; b_r / b_c for
  // a col-major B operand (16 n-rows x 16 k-columns) read without .trans
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_c = (lane >> 4) * 8;
  const int b_r = (lane & 7) + (lane >> 4) * 8;
  const int b_c = ((lane >> 3) & 1) * 8;

  float acc[G::kDN][4];
#pragma unroll
  for (int j = 0; j < G::kDN; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int st = t & 1;
    const int k0 = t * BK;
    // wait for tile t, meet (every warp is then done with tile t - 1's
    // stage, and the key ids stored for tile t are visible), and issue
    // tile t + 1 into that stage, to land while tile t is computed on
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_kt) load_k(st ^ 1, k0 + BK);
    cp_async_commit();

    const T* kt = ks + st * G::kKTile;
    const T* vt = vs + st * G::kKTile;
    const int* sk_t = segk_s + st * BK;

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys
    float s[G::kKN][4], dp[G::kKN][4];
#pragma unroll
    for (int j = 0; j < G::kKN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < G::kKSteps; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qs + (w_row + a_r) * G::kLd + kk * 16 + a_c);
      ldmatrix_x4(da, dos + (w_row + a_r) * G::kLd + kk * 16 + a_c);
#pragma unroll
      for (int jp = 0; jp < G::kKN / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (jp * 16 + b_r) * G::kLd + kk * 16 + b_c);
        mma16<T>(s[2 * jp], qa, b[0], b[1]);
        mma16<T>(s[2 * jp + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, vt + (jp * 16 + b_r) * G::kLd + kk * 16 + b_c);
        mma16<T>(dp[2 * jp], da, b[0], b[1]);
        mma16<T>(dp[2 * jp + 1], da, b[2], b[3]);
      }
    }

    // dS in place of dP; the per-element mask only where some entry of the
    // warp's 16 x BK block can be masked
    const bool need_mask = segs || k0 + BK > kv_end ||
                           (p.causal && k0 + BK - 1 > q0 + w_row);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < G::kKN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lc = j * 8 + tig * 2 + (e & 1);
          const int h = e >> 1;
          const int key = k0 + lc;
          const int row = q0 + w_row + g + 8 * h;
          bool ok = key < kv_end && (!p.causal || key <= row);
          if (segs) ok = ok && sgq[h] == sk_t[lc];
          const float pv =
              ok ? exp2f(fmaf(s[j][e], p.scale_log2, -lse2[h])) : 0.f;
          dp[j][e] = pv * (dp[j][e] - dl[h]) * p.scale;
        }
    } else {
#pragma unroll
      for (int j = 0; j < G::kKN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float pv = exp2f(fmaf(s[j][e], p.scale_log2, -lse2[h]));
          dp[j][e] = pv * (dp[j][e] - dl[h]) * p.scale;
        }
    }

    // dQ += dS K: dS rounded to T as A fragments, 16 keys a step; K as the
    // row-major B operand by ldmatrix.trans, (keys 0-7, d 0-7), (keys 8-15,
    // d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 8-15)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(dp[2 * kk][0], dp[2 * kk][1]);
      a[1] = pack2<T>(dp[2 * kk][2], dp[2 * kk][3]);
      a[2] = pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      a[3] = pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < G::kDN / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, kt + (kk * 16 + a_r) * G::kLd + jp * 16 + a_c);
        mma16<T>(acc[2 * jp], a, b[0], b[1]);
        mma16<T>(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: this thread's rows of dQ, two adjacent fp32 columns a store
  float* dqb = p.dq + q_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + w_row + g + 8 * h;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < G::kDN; ++j) {
      const int col = j * 8 + tig * 2;
      if (col < p.d)
        *reinterpret_cast<float2*>(dqb + (long long)row * p.d + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

template <typename T, int DP, int WARPS, int BK, int MINB>
cudaError_t launch_cfg(const Params<T>& p, int bh, cudaStream_t stream) {
  using G = Dq<DP, WARPS, BK>;
  static bool smem_ok = false;
  const cudaError_t err = hm::allow_smem(
      flash_bwd_dq_tc_kernel<T, DP, WARPS, BK, MINB>, G::kSmem, &smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (p.sq + G::kBQ - 1) / G::kBQ);
  flash_bwd_dq_tc_kernel<T, DP, WARPS, BK, MINB>
      <<<grid, G::kThreads, G::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// 64-row query tiles of 4 warps. By measurement at b=8, 32 heads,
// s=1024, causal, bf16 (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W): DP 64
// and 80 64-key tiles, three blocks an SM (168 registers; 128-row tiles
// of 8 warps and 32-key tiles ran no faster); DP 128 32-key tiles, three
// blocks (166 registers; 0.46 ms against 0.50 for 64-key tiles at 244).
template <typename T>
cudaError_t launch_dp(const Params<T>& p, int bh, cudaStream_t stream) {
  switch (hm::padded_width(p.d)) {
    case 64:
      return launch_cfg<T, 64, 4, 64, 3>(p, bh, stream);
    case 80:
      return launch_cfg<T, 80, 4, 64, 3>(p, bh, stream);
    default:
      return launch_cfg<T, 128, 4, 32, 3>(p, bh, stream);
  }
}

template <typename T>
cudaError_t launch_hm(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* lens, const void* seg_q, const void* seg_k,
                      void* dq, int bh, int n_rep, int sq, int sk, int d,
                      float scale, int causal, cudaStream_t stream) {
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
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.n_rep = n_rep;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return launch_dp(p, bh, stream);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// The split dQ sweep on the argument list of the head-major backward
// entries (flash_attention_bwd.cu): q/dout [bh, sq, d], k/v [bh, sk, d] of
// dtype code `dtype` (kBFloat16 or kFloat16), d <= 128 and a multiple of
// 8; lse and delta fp32 [bh, sq]; lens int32 [bh] or null; seg_q/seg_k
// int32 [bh / n_rep, sq] / [bh / n_rep, sk] or null (both or neither).
// Writes dq, fp32 [bh, sq, d], every entry once; dk and dv are ignored. q,
// k, v, dout and dq 16-byte aligned. Returns cudaGetLastError() after the
// launch; cudaErrorInvalidValue for anything the kernel does not take
// (nothing launched).
extern "C" int apex_tpu_torch_flash_bwd_hm_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lens, const void* seg_q,
    const void* seg_k, void* dq, void* dk, void* dv, int bh, int n_rep,
    int sq, int sk, int d, float scale, int causal, int dtype, void* stream) {
  (void)dk;
  (void)dv;
  if ((dtype != kBFloat16 && dtype != kFloat16) || bh <= 0 || n_rep <= 0 ||
      bh % n_rep || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || d % 8 ||
      (causal && sq != sk) || ((seg_q == nullptr) != (seg_k == nullptr)) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) ||
      !aligned16(dq))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == kFloat16
             ? launch_hm<f16>(q, k, v, dout, lse, delta, lens, seg_q, seg_k,
                              dq, bh, n_rep, sq, sk, d, scale, causal, st)
             : launch_hm<bf16>(q, k, v, dout, lse, delta, lens, seg_q, seg_k,
                               dq, bh, n_rep, sq, sk, d, scale, causal, st);
}

// Flash-attention forward over the head-major layout q [bh, sq, d],
// k/v [bh, sk, d] (bh = batch * heads), any head width d <= 128.
//
// Replaces: apex_tpu/kernels/flash_attention.py:_run_fwd (kernel body
// _fwd_kernel), the forward of `flash_attention` / `flash_attention_with_lse`,
// which GPT runs on every layer where the lane-packed kernel does not take
// the geometry (Megatron-GPT 2.7B: 32 heads of 80).
//
// What bounds it on an H100: at the 2.7B step's shape (b=8, 32 heads,
// s=1024, d=80, bf16, causal) it reads q, k, v and writes out (168 MB) and
// lse (1 MB): 0.050 ms at 3.35 TB/s; its two products over the causal
// half, 4.3e10 flops, are 0.043 ms on the tensor cores. So bytes, barely.
//
// What the design does about it: this is the CUDA-core forward, right and
// simple: all arithmetic is fp32 on the CUDA cores, which makes it
// compute-bound on them, far from either bound. It runs fp32 (and float16,
// widened) and the bf16 calls the tensor-core kernel of flash_fwd_tc.cu
// does not take (a head width that is not a multiple of 8;
// kernels/flash_attention.py:tc_route). One block of 256 threads owns one
// (bh, 64-row query tile). Q stays in shared memory while 64-key K/V tiles
// stream through it; each thread scores its 4 x 4 entries of the 64 x 64
// tile, the row max and sum are four shuffles over the 16 threads of a row,
// and the running (m, l, acc) follow _online_update (:79): masked scores
// are the finite -1e30, masked probabilities 0, so a row with every column
// masked ends with out = 0 and lse = -1e30 + log(1e-30), as _finish
// (:133-137). Key tiles wholly above the diagonal (_causal_skip :144) or
// past the row's kv_length are skipped: they would add nothing. Head
// widths are padded to 64, 80 or 128 in shared memory (zeros, never
// stored), so d = 64 and d = 80 run at their own width.
#include "flash_hm.cuh"

namespace apex_tpu_torch {
namespace {

using hm::kB;
using hm::kLdS;
using hm::kSTile;
using hm::kThreads;

template <int DP>
constexpr size_t fwd_smem() {
  return (3 * (size_t)hm::Geo<DP>::kTile + kSTile) * sizeof(float) +
         2 * kB * sizeof(int);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_hm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    const int* __restrict__ seg_q,
                    const int* __restrict__ seg_k, T* __restrict__ out,
                    float* __restrict__ lse, int sq, int sk, int d, int n_rep,
                    float scale, int causal) {
  using G = hm::Geo<DP>;
  constexpr int LD = G::kLd;
  constexpr int DJ = G::kDJ;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + G::kTile;
  float* vs = ks + G::kTile;
  float* ps = vs + G::kTile;
  int* segq_s = reinterpret_cast<int*>(ps + kSTile);
  int* segk_s = segq_s + kB;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int bseg = bh / n_rep;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)bh * sk * d;
  const T* vb = v + (size_t)bh * sk * d;

  hm::Mask mask;
  mask.kv_end = lens ? max(0, min(sk, lens[bh])) : sk;
  mask.sq = sq;
  mask.causal = causal;
  mask.segs = seg_q != nullptr;
  mask.seg_q = segq_s;
  mask.seg_k = segk_s;

  hm::load_tile<T, DP>(qs, qb, q0, sq, d);
  hm::load_seg(segq_s, seg_q ? seg_q + (size_t)bseg * sq : nullptr, q0, sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + kB, sq) - 1;
  const int k_end = causal ? min(mask.kv_end, q_last + 1) : mask.kv_end;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous tile is consumed (and Q is written)
    hm::load_tile<T, DP>(ks, kb, k0, sk, d);
    hm::load_tile<T, DP>(vs, vb, k0, sk, d);
    hm::load_seg(segk_s, seg_k ? seg_k + (size_t)bseg * sk : nullptr, k0, sk);
    __syncthreads();
    float s[4][4];
    hm::dot_tile<DP>(qs, ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ty + 16 * i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = mask.valid(q0, k0, lr, tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], hm::row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        ps[lr * kLdS + tx + 16 * j] = p;
      }
      l[i] = corr * l[i] + hm::row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    // acc += P V: this thread owns rows ty + 16 i and dims tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float pc[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pc[i] = ps[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pc[i] * vv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[c] = from_float<T>(acc[i][j] / lc);
    }
    if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(lc);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, const int* seg_q, const int* seg_k,
                   void* out, void* lse, int bh, int n_rep, int sq, int sk,
                   int d, float scale, int causal, cudaStream_t stream) {
  static bool smem_ok = false;
  const cudaError_t err = hm::allow_smem(flash_fwd_hm_kernel<T, DP>,
                                         fwd_smem<DP>(), &smem_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + kB - 1) / kB);
  flash_fwd_hm_kernel<T, DP><<<grid, kThreads, fwd_smem<DP>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lens, seg_q, seg_k, static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, d, n_rep, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dp(const void* q, const void* k, const void* v,
                      const int* lens, const int* seg_q, const int* seg_k,
                      void* out, void* lse, int bh, int n_rep, int sq, int sk,
                      int d, float scale, int causal, cudaStream_t stream) {
  switch (hm::padded_width(d)) {
    case 64:
      return launch<T, 64>(q, k, v, lens, seg_q, seg_k, out, lse, bh, n_rep,
                           sq, sk, d, scale, causal, stream);
    case 80:
      return launch<T, 80>(q, k, v, lens, seg_q, seg_k, out, lse, bh, n_rep,
                           sq, sk, d, scale, causal, stream);
    default:
      return launch<T, 128>(q, k, v, lens, seg_q, seg_k, out, lse, bh, n_rep,
                            sq, sk, d, scale, causal, stream);
  }
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// q [bh, sq, d], k/v [bh, sk, d] (dtype code `dtype`), out [bh, sq, d] in
// q's dtype, lse fp32 [bh, sq]. lens: int32 [bh] kv lengths or null;
// seg_q/seg_k: int32 [bh / n_rep, sq] / [bh / n_rep, sk] segment ids or
// null (both or neither). Returns cudaGetLastError() after the launch;
// cudaErrorInvalidValue for a shape, head width or dtype the kernel does
// not take (nothing launched).
extern "C" int apex_tpu_torch_flash_fwd_hm(
    const void* q, const void* k, const void* v, const void* lens,
    const void* seg_q, const void* seg_k, void* out, void* lse, int bh,
    int n_rep, int sq, int sk, int d, float scale, int causal, int dtype,
    void* stream) {
  if (bh <= 0 || n_rep <= 0 || bh % n_rep || sq <= 0 || sk <= 0 || d <= 0 ||
      d > 128 || (causal && sq != sk) || ((seg_q == nullptr) != (seg_k == nullptr)))
    return cudaErrorInvalidValue;
  const int* ln = static_cast<const int*>(lens);
  const int* sgq = static_cast<const int*>(seg_q);
  const int* sgk = static_cast<const int*>(seg_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_dp<float>(q, k, v, ln, sgq, sgk, out, lse, bh, n_rep, sq,
                              sk, d, scale, causal, st);
    case kBFloat16:
      return launch_dp<__nv_bfloat16>(q, k, v, ln, sgq, sgk, out, lse, bh,
                                      n_rep, sq, sk, d, scale, causal, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Flash-attention backward over the head-major layout q/do [bh, sq, d],
// k/v [bh, sk, d], any head width d <= 128: the fused single sweep and
// the split dQ and dK/dV sweeps.
//
// Replaces, in apex_tpu/kernels/flash_attention.py:_run_bwd:
// - the fused backward (pallas_call :514, kernel body _dqkv_kernel :272),
//   which runs while the full-length dQ accumulator fits the 4 MiB budget
//   (APEX_TPU_FLASH_BWD=auto|fused): every GPT layer of the 2.7B step;
// - the split dQ sweep (:547, _dq_kernel :207) and dK/dV sweep (:569,
//   _dkv_kernel :237), for longer sequences or APEX_TPU_FLASH_BWD=split.
// All three recompute P and dS with the _p_ds block math (:170) under the
// _valid_cols mask (:150); see flash_hm.cuh. All three run fp32, fp16
// (widened) and bf16 at a head width that is not a multiple of 8; other
// bf16 and fp16 calls take the tensor-core kernels of flash_bwd_tc.cu
// (fused, and split dK/dV) and flash_bwd_dq_tc.cu (split dQ)
// (kernels/flash_attention.py:tc_route).
//
// What bounds them on an H100: at the 2.7B step's shape (b=8, 32 heads,
// s=1024, d=80, bf16, causal) the five products over the causal half are
// 1.07e11 flops, 0.109 ms on the tensor cores, against 296 MB of operands
// and gradients (0.088 ms): operations.
//
// What the design does about it: like the forward, a first version that
// is right and simple, fp32 on the CUDA cores (the tensor-core kernels
// took over bf16 and fp16 at widths in multiples of 8), P and dS kept in
// fp32 where the JAX kernel rounds them to the input dtype. The TPU's grid runs in order and carries sums across
// grid steps in VMEM; here blocks run in parallel, so:
// - fused: one block per (bh, 64-key tile). K and V stay in shared memory
//   while the block walks the query tiles from the diagonal down; dK and
//   dV accumulate in registers, and each tile's dQ share dS K is added
//   with fp32 atomicAdd into a [bh, sq, d] buffer the launch zeroes first.
//   The order of those adds changes between launches, so dQ may differ
//   in its last bits from one launch to the next; dK and dV do not.
// - split dK/dV: the same block without the dQ share; deterministic.
// - split dQ: one block per (bh, 64-row query tile); Q and dO stay in
//   shared memory while the block walks the key tiles up to the diagonal,
//   accumulating dQ += dS K in registers; deterministic, no atomics.
// Key tiles past the row's kv_length are skipped (their P is 0): the
// dK/dV blocks of such tiles write zeros. Gradients are written in fp32;
// the wrapper casts them to the input dtype.
#include "flash_hm.cuh"

namespace apex_tpu_torch {
namespace {

using hm::kB;
using hm::kLdS;
using hm::kSTile;
using hm::kThreads;

template <int DP>
constexpr size_t kv_smem() {
  return (4 * (size_t)hm::Geo<DP>::kTile + 2 * (size_t)kSTile + 2 * kB) *
             sizeof(float) +
         2 * kB * sizeof(int);
}

template <int DP>
constexpr size_t dq_smem() {
  return (4 * (size_t)hm::Geo<DP>::kTile + (size_t)kSTile + 2 * kB) *
             sizeof(float) +
         2 * kB * sizeof(int);
}

struct Args {
  const int* lens;
  const int* seg_q;
  const int* seg_k;
  const float* lse;
  const float* delta;
  int sq, sk, d, n_rep, causal;
  float scale;
};

__device__ __forceinline__ hm::Mask make_mask(const Args& a, int bh,
                                              const int* segq_s,
                                              const int* segk_s) {
  hm::Mask m;
  m.kv_end = a.lens ? max(0, min(a.sk, a.lens[bh])) : a.sk;
  m.sq = a.sq;
  m.causal = a.causal;
  m.segs = a.seg_q != nullptr;
  m.seg_q = segq_s;
  m.seg_k = segk_s;
  return m;
}

// dK and dV of one (bh, key tile); with FUSED also this tile's share of
// dQ, added atomically
template <typename T, int DP, bool FUSED>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_hm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       Args a, float* __restrict__ dq,
                       float* __restrict__ dk, float* __restrict__ dv) {
  using G = hm::Geo<DP>;
  constexpr int LD = G::kLd;
  constexpr int DJ = G::kDJ;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + G::kTile;
  float* qs = vs + G::kTile;
  float* dos = qs + G::kTile;
  float* ps = dos + G::kTile;
  float* dss = ps + kSTile;
  float* lse_s = dss + kSTile;
  float* del_s = lse_s + kB;
  int* segq_s = reinterpret_cast<int*>(del_s + kB);
  int* segk_s = segq_s + kB;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int sq = a.sq, sk = a.sk, d = a.d;
  const int bseg = bh / a.n_rep;
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const hm::Mask mask = make_mask(a, bh, segq_s, segk_s);

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  if (k0 < mask.kv_end) {
    hm::load_tile<T, DP>(ks, k + koff, k0, sk, d);
    hm::load_tile<T, DP>(vs, v + koff, k0, sk, d);
    hm::load_seg(segk_s, a.seg_k ? a.seg_k + (size_t)bseg * sk : nullptr, k0,
                 sk);
    // causal: query tiles wholly above this key tile see none of its keys
    const int q_first = a.causal ? k0 : 0;
    for (int q0 = q_first; q0 < sq; q0 += kB) {
      __syncthreads();  // the previous tile's P / dS and Q / dO are consumed
      hm::load_tile<T, DP>(qs, q + qoff, q0, sq, d);
      hm::load_tile<T, DP>(dos, dout + qoff, q0, sq, d);
      hm::load_stats(lse_s, a.lse + (size_t)bh * sq, q0, sq);
      hm::load_stats(del_s, a.delta + (size_t)bh * sq, q0, sq);
      hm::load_seg(segq_s, a.seg_q ? a.seg_q + (size_t)bseg * sq : nullptr,
                   q0, sq);
      __syncthreads();
      float p[4][4], ds[4][4];
      hm::p_ds<DP>(qs, ks, dos, vs, lse_s, del_s, mask, q0, k0, a.scale, ty,
                   tx, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * kLdS + tx + 16 * j] = p[i][j];
          dss[(ty + 16 * i) * kLdS + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this thread owns keys ty + 16 i and
      // head dims tx + 16 j
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        float pc[4], dc[4], o[DJ], qq[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = ps[r * kLdS + ty + 16 * i];
          dc[i] = dss[r * kLdS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = dos[r * LD + tx + 16 * j];
          qq[j] = qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dva[i][j] += pc[i] * o[j];
            dka[i][j] += dc[i] * qq[j];
          }
      }
      if (FUSED) {
        // this tile's dQ share dS K: this thread owns query rows ty + 16 i
        // and head dims tx + 16 j
        float dqa[4][DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;
#pragma unroll 2
        for (int c = 0; c < kB; ++c) {
          float dc[4], kk[DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) dc[i] = dss[(ty + 16 * i) * kLdS + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) kk[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) dqa[i][j] += dc[i] * kk[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty + 16 * i;
          if (row >= sq) continue;
          float* dqr = dq + qoff + (size_t)row * d;
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            const int c = tx + 16 * j;
            if (c < d) atomicAdd(dqr + c, dqa[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    float* dkr = dk + koff + (size_t)key * d;
    float* dvr = dv + koff + (size_t)key * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) {
        dkr[c] = dka[i][j];
        dvr[c] = dva[i][j];
      }
    }
  }
}

// dQ of one (bh, query tile)
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_hm_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       Args a, float* __restrict__ dq) {
  using G = hm::Geo<DP>;
  constexpr int LD = G::kLd;
  constexpr int DJ = G::kDJ;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + G::kTile;
  float* ks = dos + G::kTile;
  float* vs = ks + G::kTile;
  float* dss = vs + G::kTile;
  float* lse_s = dss + kSTile;
  float* del_s = lse_s + kB;
  int* segq_s = reinterpret_cast<int*>(del_s + kB);
  int* segk_s = segq_s + kB;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kB;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int sq = a.sq, sk = a.sk, d = a.d;
  const int bseg = bh / a.n_rep;
  const size_t qoff = (size_t)bh * sq * d;
  const size_t koff = (size_t)bh * sk * d;
  const hm::Mask mask = make_mask(a, bh, segq_s, segk_s);

  hm::load_tile<T, DP>(qs, q + qoff, q0, sq, d);
  hm::load_tile<T, DP>(dos, dout + qoff, q0, sq, d);
  hm::load_stats(lse_s, a.lse + (size_t)bh * sq, q0, sq);
  hm::load_stats(del_s, a.delta + (size_t)bh * sq, q0, sq);
  hm::load_seg(segq_s, a.seg_q ? a.seg_q + (size_t)bseg * sq : nullptr, q0,
               sq);

  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;

  // causal: key tiles wholly above this query tile's diagonal are skipped
  const int k_end = a.causal ? min(mask.kv_end, q0 + kB) : mask.kv_end;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();  // the previous K / V / dS tiles are consumed
    hm::load_tile<T, DP>(ks, k + koff, k0, sk, d);
    hm::load_tile<T, DP>(vs, v + koff, k0, sk, d);
    hm::load_seg(segk_s, a.seg_k ? a.seg_k + (size_t)bseg * sk : nullptr, k0,
                 sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    hm::p_ds<DP>(qs, ks, dos, vs, lse_s, del_s, mask, q0, k0, a.scale, ty, tx,
                 p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kLdS + tx + 16 * j] = ds[i][j];
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kB; ++c) {
      float dc[4], kk[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dc[i] = dss[(ty + 16 * i) * kLdS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] += dc[i] * kk[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* dqr = dq + qoff + (size_t)row * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = tx + 16 * j;
      if (c < d) dqr[c] = dqa[i][j];
    }
  }
}

enum Mode : int { kFused = 0, kDq = 1, kDkdv = 2 };

template <typename T, int DP>
cudaError_t launch(int mode, const void* q, const void* k, const void* v,
                   const void* dout, const Args& a, int bh, void* dq,
                   void* dk, void* dv, cudaStream_t stream) {
  static bool fused_ok = false, kv_ok = false, dq_ok = false;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaError_t err;
  if (mode == kDq) {
    err = hm::allow_smem(flash_bwd_dq_hm_kernel<T, DP>, dq_smem<DP>(),
                         &dq_ok);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_hm_kernel<T, DP>
        <<<dim3(bh, (a.sq + kB - 1) / kB), kThreads, dq_smem<DP>(), stream>>>(
            qt, kt, vt, dot, a, dqf);
    return cudaGetLastError();
  }
  const dim3 grid(bh, (a.sk + kB - 1) / kB);
  if (mode == kFused) {
    err = hm::allow_smem(flash_bwd_kv_hm_kernel<T, DP, true>, kv_smem<DP>(),
                         &fused_ok);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(dq, 0, (size_t)bh * a.sq * a.d * sizeof(float),
                          stream);
    if (err != cudaSuccess) return err;
    flash_bwd_kv_hm_kernel<T, DP, true>
        <<<grid, kThreads, kv_smem<DP>(), stream>>>(qt, kt, vt, dot, a, dqf,
                                                    dkf, dvf);
    return cudaGetLastError();
  }
  err = hm::allow_smem(flash_bwd_kv_hm_kernel<T, DP, false>, kv_smem<DP>(),
                       &kv_ok);
  if (err != cudaSuccess) return err;
  flash_bwd_kv_hm_kernel<T, DP, false>
      <<<grid, kThreads, kv_smem<DP>(), stream>>>(qt, kt, vt, dot, a, nullptr,
                                                  dkf, dvf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dp(int mode, const void* q, const void* k, const void* v,
                      const void* dout, const Args& a, int bh, void* dq,
                      void* dk, void* dv, cudaStream_t stream) {
  switch (hm::padded_width(a.d)) {
    case 64:
      return launch<T, 64>(mode, q, k, v, dout, a, bh, dq, dk, dv, stream);
    case 80:
      return launch<T, 80>(mode, q, k, v, dout, a, bh, dq, dk, dv, stream);
    default:
      return launch<T, 128>(mode, q, k, v, dout, a, bh, dq, dk, dv, stream);
  }
}

int bwd_entry(int mode, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* lens, const void* seg_q, const void* seg_k,
              void* dq, void* dk, void* dv, int bh, int n_rep, int sq, int sk,
              int d, float scale, int causal, int dtype, void* stream) {
  if (bh <= 0 || n_rep <= 0 || bh % n_rep || sq <= 0 || sk <= 0 || d <= 0 ||
      d > 128 || (causal && sq != sk) ||
      ((seg_q == nullptr) != (seg_k == nullptr)))
    return cudaErrorInvalidValue;
  Args a;
  a.lens = static_cast<const int*>(lens);
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.sq = sq;
  a.sk = sk;
  a.d = d;
  a.n_rep = n_rep;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_dp<float>(mode, q, k, v, dout, a, bh, dq, dk, dv, st);
    case kBFloat16:
      return launch_dp<__nv_bfloat16>(mode, q, k, v, dout, a, bh, dq, dk, dv,
                                      st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// The three backward entries share one argument list: q/dout [bh, sq, d],
// k/v [bh, sk, d] (dtype code `dtype`), lse and delta fp32 [bh, sq], lens
// int32 [bh] or null, seg_q/seg_k int32 [bh / n_rep, sq] / [bh / n_rep,
// sk] or null, and fp32 gradients dq [bh, sq, d], dk/dv [bh, sk, d] (an
// entry ignores the ones it does not write). Each returns
// cudaGetLastError() after its launch; cudaErrorInvalidValue for a shape,
// head width or dtype the kernels do not take (nothing launched).

// the fused single sweep: zeroes dq, then dq, dk and dv in one launch
extern "C" int apex_tpu_torch_flash_bwd_hm_fused(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lens, const void* seg_q,
    const void* seg_k, void* dq, void* dk, void* dv, int bh, int n_rep,
    int sq, int sk, int d, float scale, int causal, int dtype, void* stream) {
  return bwd_entry(kFused, q, k, v, dout, lse, delta, lens, seg_q, seg_k, dq,
                   dk, dv, bh, n_rep, sq, sk, d, scale, causal, dtype, stream);
}

// the split dQ sweep
extern "C" int apex_tpu_torch_flash_bwd_hm_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lens, const void* seg_q,
    const void* seg_k, void* dq, void* dk, void* dv, int bh, int n_rep,
    int sq, int sk, int d, float scale, int causal, int dtype, void* stream) {
  return bwd_entry(kDq, q, k, v, dout, lse, delta, lens, seg_q, seg_k, dq, dk,
                   dv, bh, n_rep, sq, sk, d, scale, causal, dtype, stream);
}

// the split dK/dV sweep
extern "C" int apex_tpu_torch_flash_bwd_hm_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* lens, const void* seg_q,
    const void* seg_k, void* dq, void* dk, void* dv, int bh, int n_rep,
    int sq, int sk, int d, float scale, int causal, int dtype, void* stream) {
  return bwd_entry(kDkdv, q, k, v, dout, lse, delta, lens, seg_q, seg_k, dq,
                   dk, dv, bh, n_rep, sq, sk, d, scale, causal, dtype, stream);
}

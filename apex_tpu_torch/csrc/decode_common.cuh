// Shared pieces of the decode kernels, csrc/decode_attention.cu (the
// column writes and the split reads) and csrc/decode_verify.cu (the
// speculative verify's launch): fp16 and the quantized storage types
// widened to fp32, the split read's geometry, the dtype and head-width
// dispatchers, the global -> shared copies that stage a split's rows, the
// cluster's synchronisation, the store of new rows from the ring and the
// opt-in for dynamic shared memory. Everything but the conversions lies in
// an anonymous namespace: each source compiles its own copy.
#pragma once

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <type_traits>

#include "common.cuh"

namespace apex_tpu_torch {

// the quantized cache's storage types, widened to fp32 exactly. int8
// goes around the conversion unit (a quarter of the FMA rate): the bits
// 0x4B400000 + x are the float 1.5 * 2^23 + x, an add away from x
template <> __device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return __int_as_float(0x4B400000 + static_cast<int>(x)) - 12582912.f;
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

// the widest head the reads take (_build.HM_MAX_HEAD_DIM)
constexpr int kMaxHeadDim = 128;
// The split read: a block of kSplitWarps warps a (row, split); a
// sub-tile of kSubCols columns (kColsPerWarp a warp), kReadRing of them
// staged in shared memory at once; at most kMaxSplits splits a row (the
// largest portable cluster; _build.READ_MAX_SPLITS)
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSubCols = 32;
constexpr int kColsPerWarp = kSubCols / kSplitWarps;
constexpr int kReadRing = 2;
constexpr int kMaxSplits = 8;
// the speculative verify's launch: the most query rows (T = spec_k + 1) a
// (batch, head) row, and the smaller bound of the two it is built for
// (_build.VERIFY_MAX_ROWS, VERIFY_SHORT_ROWS)
constexpr int kVerifyMaxRows = 8;
constexpr int kVerifyShortRows = 4;

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

// f(std::integral_constant<int, DP>{}) for the padded width DP of head
// width d: d rounded up to 32, 64, 96 or 128; refused past kMaxHeadDim
template <typename F> cudaError_t with_padded_dim(int d, F&& f) {
  if (d <= 0 || d > kMaxHeadDim) return cudaErrorInvalidValue;
  if (d <= 32) return f(std::integral_constant<int, 32>{});
  if (d <= 64) return f(std::integral_constant<int, 64>{});
  if (d <= 96) return f(std::integral_constant<int, 96>{});
  return f(std::integral_constant<int, 128>{});
}

// global -> shared copies of N bytes: cp.async for 16 (.cg, around L1),
// 8 and 4 (.ca); two bytes and one by a plain load and store
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void copy_unit(char* dst, const char* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (N == 8 || N == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N)
                 : "memory");
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster's synchronisation: its barrier split into arrive and wait
// (every thread of every block that has not exited), and an mbarrier in
// one block's shared memory that the other blocks' threads arrive on
// remotely, each releasing its own earlier writes at cluster scope.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)),
      "r"(count)
      : "memory");
}

// arrive on `bar` (an address in this block's shared memory) as it lies
// in the shared memory of cluster block `rank`
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n\t}\n" ::
          "r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// wait until phase 0 of `bar` completes, acquiring what the arrivals
// released
__device__ __forceinline__ void mbar_wait_phase0(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "0;\n\t"
      "@!done bra WAIT;\n\t}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Stage the K and V rows of columns [c, c + nc) of one (batch, head) row
// into the dense tiles ks and vs (rows of row_bytes), in N-byte units,
// one address for both planes. The contiguous cache holds them as one
// run from cell row0 + c, which the block copies with neighbouring
// threads on neighbouring units ...
template <int N>
__device__ __forceinline__ void stage_run(char* ks, char* vs,
                                          const char* kb, const char* vb,
                                          size_t row0, int c, int nc,
                                          int row_bytes) {
  const size_t src = (row0 + c) * row_bytes;
  const int n = nc * row_bytes / N;
  for (int i = threadIdx.x; i < n; i += kSplitThreads) {
    copy_unit<N>(ks + i * N, kb + src + (size_t)i * N);
    copy_unit<N>(vs + i * N, vb + src + (size_t)i * N);
  }
}

// ... and the paged pool [num_pages, h, P, d] holds them as one run a
// page (numbers from `pages`, the split's table entries from page0 on, in
// shared memory): the block's threads form 1, 2 or 4 groups by how many
// pages the columns touch, group g copies the runs of pages g, g +
// groups, ..., its threads on neighbouring units.
template <int N>
__device__ __forceinline__ void stage_pages(char* ks, char* vs,
                                            const char* kb, const char* vb,
                                            const int* pages, int page0,
                                            int head, int h, int P, int c,
                                            int nc, int row_bytes) {
  const int first = c / P;
  const int last = (c + nc - 1) / P;
  const int groups = last - first >= 3 ? 4 : last > first ? 2 : 1;
  const int size = kSplitThreads / groups;
  const int g = threadIdx.x / size;
  for (int pg = first + g; pg <= last; pg += groups) {
    const int lo = max(c, pg * P);
    const int hi = min(c + nc, (pg + 1) * P);
    const size_t src =
        (((size_t)pages[pg - page0] * h + head) * P + (lo - pg * P)) *
        row_bytes;
    const int dst = (lo - c) * row_bytes;
    const int n = (hi - lo) * row_bytes / N;
    for (int i = threadIdx.x - g * size; i < n; i += size) {
      copy_unit<N>(ks + dst + i * N, kb + src + (size_t)i * N);
      copy_unit<N>(vs + dst + i * N, vb + src + (size_t)i * N);
    }
  }
}

// a copy unit of N bytes as one value, for the fused launch's store of
// the new rows into the cache
template <int N> struct UnitOf;
template <> struct UnitOf<16> { using type = uint4; };
template <> struct UnitOf<8> { using type = uint2; };
template <> struct UnitOf<4> { using type = uint32_t; };
template <> struct UnitOf<2> { using type = uint16_t; };
template <> struct UnitOf<1> { using type = uint8_t; };

// One head row of row_bytes bytes from kn/vn (the ring slots the row was
// staged into) into the cache cells kd/vd, in N-byte units, neighbouring
// threads on neighbouring units: the store of the new rows after a read's
// loop, out of line (see stage_row in decode_attention.cu).
template <int N>
__device__ __noinline__ void store_row(char* kd, char* vd, const char* kn,
                                       const char* vn, int row_bytes) {
  using U = typename UnitOf<N>::type;
  for (int i = threadIdx.x; i < row_bytes / N; i += kSplitThreads) {
    reinterpret_cast<U*>(kd)[i] = reinterpret_cast<const U*>(kn)[i];
    reinterpret_cast<U*>(vd)[i] = reinterpret_cast<const U*>(vn)[i];
  }
}

// f(std::integral_constant<int, N>{}) for a copy unit of N = 16, 8, 4 or
// 2 bytes, or 1 for rows of one-byte S (int8 or fp8 at an odd d)
template <typename S, typename F>
__device__ __forceinline__ void with_unit(int unit, F&& f) {
  switch (unit) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default:
      if constexpr (sizeof(S) == 1) {
        if (unit == 1) return f(std::integral_constant<int, 1>{});
      }
      return f(std::integral_constant<int, 2>{});
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory. A block holds
// 48 KB of shared memory, static and dynamic together, without asking;
// past that the kernel opts in, once per instantiation and size (granted,
// the caller's record for the instantiation: 0 at first, then the most
// dynamic bytes it may take).
template <typename K>
cudaError_t allow_dynamic_smem(K* kernel, size_t smem, size_t* granted) {
  if (*granted == 0) {
    cudaFuncAttributes attr = {};
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *granted = attr.sharedSizeBytes < 48 * 1024
                   ? 48 * 1024 - attr.sharedSizeBytes
                   : 1;
  }
  if (smem > *granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *granted = smem;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace apex_tpu_torch

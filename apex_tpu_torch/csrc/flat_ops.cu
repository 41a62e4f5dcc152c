// Multi-tensor sweeps over flat group buffers: Adam / AdamW, SGD with
// momentum, Adagrad, the global L2 norm, and amp's scale and axpby.
//
// Replaces: apex_tpu/kernels/flat_ops.py:adam_flat (kernel body
// _adam_kernel), the one sweep over packed (param, grad, m, v) buffers
// that fused_adam(layout="flat") runs once per dtype group per step --
// apex's csrc/multi_tensor_adam.cu -- and flat_ops.py:l2norm_flat (kernel
// body _sumsq_kernel), apex's multi_tensor_l2norm in its global mode.
//
// What bounds it on an H100: memory. Per element it reads p, g, m, v and
// writes p, m, v: 28 bytes for fp32 params (22 for bf16) against about
// 20 flops, far below the card's ~295 flops per byte. At 355M parameters
// one sweep moves about 9.9 GB, so its floor is about 3 ms at 3.35 TB/s.
//
// What the design does about it: every byte is touched once. A
// grid-stride loop walks the buffer four elements at a time, so g, m, v
// (and fp32 p) move as 16-byte vectors (bf16 p as 8-byte ones), neighbour
// threads on neighbour addresses. The grid is capped at a few blocks per
// SM, enough to keep loads in flight. The eight scalars come from a
// device buffer, so a learning-rate schedule or the bias correction of a
// step count that lives on the device needs no host round trip; a device
// no-op flag (apex's noop_flag) makes an overflow step leave p, m and v
// untouched, again without the host. p, m and v are updated in place;
// with out_is_delta the update -lr*upd goes to a separate fp32 buffer and
// p is only read (FusedLAMB's stage 1 needs the params afterwards), which
// is the JAX function's out_dtype=float32.
//
// SGD (replaces flat_ops.py:sgd_flat, kernel body _sgd_kernel, apex's
// csrc/multi_tensor_sgd_kernel.cu, which fused_sgd(layout="flat") runs
// once per dtype group per step): momentum, dampening, Nesterov, weight
// decay folded into the gradient, a gradient scale and the delta mode.
// Per element it reads p, g, m and writes p, m: 20 bytes for fp32 params
// against about 8 flops, so it too is bound by memory (ResNet-50's 25.6M
// parameters: 0.51 GB, 0.15 ms at 3.35 TB/s). The same one grid-stride
// sweep of 16-byte vectors as Adam's, with its device scalars and no-op
// flag.
//
// The L2 norm reads each buffer once: 4 bytes an element in fp32 against
// two flops, so it too is bound by memory (335M fp32 elements: 1.34 GB,
// 0.40 ms at 3.35 TB/s). A fixed grid of blocks sums squares in fp32 over
// a grid-stride loop of 16-byte loads and writes one partial each; a
// second, one-block kernel sums the partials of each buffer in a fixed
// tree, adds the buffers in list order and takes the square root on the
// device. No atomics, and the grid depends on nothing but constants, so
// the norm is the same bit for bit from run to run, and no step waits on
// the host for it.
//
// Adagrad (replaces flat_ops.py:adagrad_flat, kernel body _adagrad_kernel,
// apex's csrc/multi_tensor_adagrad.cu, which fused_adagrad(layout="flat")
// runs once per dtype group per step): g' = g * gscale + wd * p, h += g'^2,
// p -= lr * g' / (sqrt(h) + eps), in JAX's order of operations. Per
// element it reads p, g, h and writes p, h: 20 bytes for fp32 params
// against about 8 flops and a square root, so it is bound by memory (the
// 355M's 354.9M-element group: 7.1 GB, 2.12 ms at 3.35 TB/s). The same
// grid-stride sweep of 16-byte vectors as SGD's, with its four device
// scalars, the no-op flag and the delta mode. No --use_fast_math: sqrtf
// and the division stay IEEE.
//
// Scale and axpby (replace flat_ops.py:scale_flat and axpby_flat, kernel
// bodies _scale_kernel and _axpby_kernel, apex's multi_tensor_scale and
// multi_tensor_axpby): out = x * s, and out = a * x + b * y, into a new
// buffer, with a found-inf flag. They read 4 (8) and write 4 bytes per
// fp32 element against one (three) flops: bound by memory (8N and 12N
// bytes, 0.85 and 1.27 ms for the 355M group). Scale flags a non-finite
// INPUT, axpby a non-finite fp32 RESULT, taken before it is narrowed to
// the output dtype: the JAX kernels' two rules. The products and the sum
// are rounded one at a time (__fmul_rn, __fadd_rn), never contracted to
// an FMA, so the result is bit for bit the plain version's. Each block
// ORs its threads' findings (__syncthreads_or) and one thread stores 1 to
// the caller's zeroed int32 flag, which the wrapper reads on the device:
// no step waits on the host. Scale runs the grid-stride sweep above.
// Axpby is a stream of its own: a thread owns kAxpbyU groups of E
// elements a tile (E = 4 when x, y and out are all fp32, else 8, so a
// bf16 operand moves as 16-byte vectors of 8 and an fp32 one as two
// float4s), issues every load of the tile before its first store, and
// loads and stores with the streaming hints (__ldcs, __stcs: every byte
// is touched once). The grid is one tile a block, as PyTorch's
// elementwise kernels are launched: on the 355M's fp32 group it measured
// 4% faster than a persistent grid sized by the occupancy query (PERF.md,
// PR 15). A group that runs past n (n is a multiple of 4, not of 8) is
// cut to its first 4 elements by a guard in the same kernel.
#include "common.cuh"

#include <type_traits>

namespace apex_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;
constexpr int kV = 4;  // elements per thread per iteration

// the grid of a grid-stride sweep over n_vec 4-element vectors: one
// thread a vector, capped at kBlocksPerSm blocks per SM
inline int sweep_blocks(long long n_vec) {
  const long long want = (n_vec + kThreads - 1) / kThreads;
  return (int)(want < kSms * kBlocksPerSm ? want : kSms * kBlocksPerSm);
}

template <typename T> struct Pack4;
template <> struct Pack4<float> {
  __device__ __forceinline__ static void load(const float* src, float* d) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* dst, const float* s) {
    *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <> struct Pack4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* d) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kV; ++i) d[i] = __bfloat162float(e[i]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* dst,
                                               const float* s) {
    uint2 raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kV; ++i) e[i] = __float2bfloat16(s[i]);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
};

// scalars: lr, b1, b2, eps, weight_decay, bias_correction1,
// bias_correction2, grad_scale -- the order of _adam_kernel's s_ref
template <typename T>
__global__ void __launch_bounds__(kThreads)
adam_kernel(T* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v,
            float* __restrict__ delta, const float* __restrict__ scalars,
            const int* __restrict__ noop, long long n_vec, int adam_w_mode,
            int grad_averaging) {
  if (noop != nullptr && *noop != 0) return;
  const float lr = scalars[0], b1 = scalars[1], b2 = scalars[2];
  const float eps = scalars[3], wd = scalars[4], bc1 = scalars[5];
  const float bc2 = scalars[6], gscale = scalars[7];
  const float m_coef = grad_averaging ? 1.0f - b1 : 1.0f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long o = i * kV;
    float pv[kV], gv[kV], mv[kV], vv[kV], ov[kV];
    Pack4<T>::load(p + o, pv);
    Pack4<float>::load(g + o, gv);
    Pack4<float>::load(m + o, mv);
    Pack4<float>::load(v + o, vv);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      float gr = gv[e] * gscale;
      if (!adam_w_mode) gr = gr + wd * pv[e];  // classic L2
      mv[e] = b1 * mv[e] + m_coef * gr;
      vv[e] = b2 * vv[e] + (1.0f - b2) * gr * gr;
      float upd = (mv[e] / bc1) / (sqrtf(vv[e] / bc2) + eps);
      if (adam_w_mode) upd = upd + wd * pv[e];  // decoupled decay
      ov[e] = delta != nullptr ? -lr * upd : pv[e] - lr * upd;
    }
    if (delta != nullptr) {
      Pack4<float>::store(delta + o, ov);
    } else {
      Pack4<T>::store(p + o, ov);
    }
    Pack4<float>::store(m + o, mv);
    Pack4<float>::store(v + o, vv);
  }
}

template <typename T>
cudaError_t launch(void* p, const void* g, void* m, void* v, void* delta,
                   const void* scalars, const void* noop, long long n,
                   int adam_w_mode, int grad_averaging,
                   cudaStream_t stream) {
  const long long n_vec = n / kV;
  adam_kernel<T><<<sweep_blocks(n_vec), kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<float*>(delta), static_cast<const float*>(scalars),
      static_cast<const int*>(noop), n_vec, adam_w_mode, grad_averaging);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SGD with momentum
// ---------------------------------------------------------------------------

// scalars: lr, momentum, dampening, weight_decay, grad_scale -- the order
// of _sgd_kernel's s_ref. The caller zeroes dampening on the first step
// (the momentum buffer starts as the raw gradient, as in torch and apex).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(T* __restrict__ p, const float* __restrict__ g,
           float* __restrict__ m, float* __restrict__ delta,
           const float* __restrict__ scalars, const int* __restrict__ noop,
           long long n_vec, int nesterov) {
  if (noop != nullptr && *noop != 0) return;
  const float lr = scalars[0], momentum = scalars[1];
  const float dampening = scalars[2], wd = scalars[3], gscale = scalars[4];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long o = i * kV;
    float pv[kV], gv[kV], mv[kV], ov[kV];
    Pack4<T>::load(p + o, pv);
    Pack4<float>::load(g + o, gv);
    Pack4<float>::load(m + o, mv);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float gr = gv[e] * gscale + wd * pv[e];
      mv[e] = momentum * mv[e] + (1.0f - dampening) * gr;
      const float upd = nesterov ? gr + momentum * mv[e] : mv[e];
      ov[e] = delta != nullptr ? -lr * upd : pv[e] - lr * upd;
    }
    if (delta != nullptr) {
      Pack4<float>::store(delta + o, ov);
    } else {
      Pack4<T>::store(p + o, ov);
    }
    Pack4<float>::store(m + o, mv);
  }
}

template <typename T>
cudaError_t launch_sgd(void* p, const void* g, void* m, void* delta,
                       const void* scalars, const void* noop, long long n,
                       int nesterov, cudaStream_t stream) {
  const long long n_vec = n / kV;
  sgd_kernel<T><<<sweep_blocks(n_vec), kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(delta),
      static_cast<const float*>(scalars), static_cast<const int*>(noop),
      n_vec, nesterov);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Adagrad
// ---------------------------------------------------------------------------

// scalars: lr, eps, weight_decay, grad_scale -- the order of
// _adagrad_kernel's s_ref
template <typename T>
__global__ void __launch_bounds__(kThreads)
adagrad_kernel(T* __restrict__ p, const float* __restrict__ g,
               float* __restrict__ h, float* __restrict__ delta,
               const float* __restrict__ scalars, const int* __restrict__ noop,
               long long n_vec) {
  if (noop != nullptr && *noop != 0) return;
  const float lr = scalars[0], eps = scalars[1];
  const float wd = scalars[2], gscale = scalars[3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long o = i * kV;
    float pv[kV], gv[kV], hv[kV], ov[kV];
    Pack4<T>::load(p + o, pv);
    Pack4<float>::load(g + o, gv);
    Pack4<float>::load(h + o, hv);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float gr = gv[e] * gscale + wd * pv[e];
      hv[e] = hv[e] + gr * gr;
      const float upd = lr * gr / (sqrtf(hv[e]) + eps);
      ov[e] = delta != nullptr ? -upd : pv[e] - upd;
    }
    if (delta != nullptr) {
      Pack4<float>::store(delta + o, ov);
    } else {
      Pack4<T>::store(p + o, ov);
    }
    Pack4<float>::store(h + o, hv);
  }
}

template <typename T>
cudaError_t launch_adagrad(void* p, const void* g, void* h, void* delta,
                           const void* scalars, const void* noop,
                           long long n, cudaStream_t stream) {
  const long long n_vec = n / kV;
  adagrad_kernel<T><<<sweep_blocks(n_vec), kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const float*>(g),
      static_cast<float*>(h), static_cast<float*>(delta),
      static_cast<const float*>(scalars), static_cast<const int*>(noop),
      n_vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// scale and axpby, with the found-inf flag
// ---------------------------------------------------------------------------

__device__ __forceinline__ void raise_flag(bool bad, int* flag) {
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = 1;
}

// out = x * s; the flag is raised by a non-finite input
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* __restrict__ x, T* __restrict__ out,
             const float* __restrict__ scalar, int* __restrict__ flag,
             long long n_vec) {
  const float s = *scalar;
  bool bad = false;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long o = i * kV;
    float xv[kV], ov[kV];
    Pack4<T>::load(x + o, xv);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      bad |= !isfinite(xv[e]);
      ov[e] = __fmul_rn(xv[e], s);
    }
    Pack4<T>::store(out + o, ov);
  }
  raise_flag(bad, flag);
}

// E elements of T at a 16-byte aligned address, moved with the
// streaming hints: fp32 as one (E = 4) or two (E = 8) float4s, bf16 as
// one 8-byte (E = 4, a group's tail) or 16-byte (E = 8) vector
template <typename T, int E> struct Stream;
template <int E> struct Stream<float, E> {
  static_assert(E == 4 || E == 8, "groups of 4 or 8");
  __device__ __forceinline__ static void load(const float* src, float* d) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(src) + k);
      d[4 * k] = v.x; d[4 * k + 1] = v.y; d[4 * k + 2] = v.z;
      d[4 * k + 3] = v.w;
    }
  }
  __device__ __forceinline__ static void store(float* dst, const float* s) {
#pragma unroll
    for (int k = 0; k < E / 4; ++k)
      __stcs(reinterpret_cast<float4*>(dst) + k,
             make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2],
                         s[4 * k + 3]));
  }
};
template <int E> struct Stream<__nv_bfloat16, E> {
  static_assert(E == 4 || E == 8, "groups of 4 or 8");
  // 8 bytes (E = 4) or 16 (E = 8)
  using Raw = typename std::conditional<E == 8, uint4, uint2>::type;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* d) {
    const Raw raw = __ldcs(reinterpret_cast<const Raw*>(src));
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) d[i] = __bfloat162float(e[i]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* dst,
                                               const float* s) {
    Raw raw;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = __float2bfloat16(s[i]);
    __stcs(reinterpret_cast<Raw*>(dst), raw);
  }
};

// axpby's group: 4 elements when every operand is fp32 (one float4
// each), else 8 (one 16-byte vector of each bf16 operand)
template <typename TX, typename TY, typename TO> struct AxpbyGroup {
  static constexpr int E = std::is_same<TX, float>::value &&
                                   std::is_same<TY, float>::value &&
                                   std::is_same<TO, float>::value
                               ? 4
                               : 8;
};
// groups a thread owns a tile
constexpr int kAxpbyU = 4;

// out = a * x + b * y in fp32, stored in TO; the flag is raised by a
// non-finite fp32 result, before the narrowing. Tile t holds U * E *
// kThreads elements, and thread i owns its groups u * kThreads + i (u <
// U), so a warp's loads of one u are contiguous. The loop runs once a
// block on the one-tile-a-block grid, and strides on a smaller grid.
template <typename TX, typename TY, typename TO, int U>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
             TO* __restrict__ out, const float* __restrict__ scalars,
             int* __restrict__ flag, long long n) {
  constexpr int E = AxpbyGroup<TX, TY, TO>::E;
  const float a = scalars[0], b = scalars[1];
  bool bad = false;
  const long long tile = (long long)U * E * kThreads;
  for (long long t0 = (long long)blockIdx.x * tile; t0 < n;
       t0 += (long long)gridDim.x * tile) {
    float xv[U][E] = {}, yv[U][E] = {};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long o = t0 + ((long long)u * kThreads + threadIdx.x) * E;
      if (o + E <= n) {
        Stream<TX, E>::load(x + o, xv[u]);
        Stream<TY, E>::load(y + o, yv[u]);
      } else if (E == 8 && o < n) {  // n % 8 == 4: the last 4 elements
        Stream<TX, 4>::load(x + o, xv[u]);
        Stream<TY, 4>::load(y + o, yv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long o = t0 + ((long long)u * kThreads + threadIdx.x) * E;
      const int live = o + E <= n ? E : (o < n ? 4 : 0);
      float ov[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        ov[e] = __fadd_rn(__fmul_rn(a, xv[u][e]), __fmul_rn(b, yv[u][e]));
        bad |= e < live && !isfinite(ov[e]);
      }
      if (live == E) {
        Stream<TO, E>::store(out + o, ov);
      } else if (E == 8 && live == 4) {
        Stream<TO, 4>::store(out + o, ov);
      }
    }
  }
  raise_flag(bad, flag);
}

template <typename TX, typename TY, typename TO>
cudaError_t launch_axpby(const void* x, const void* y, void* out,
                         const void* scalars, void* flag, long long n,
                         cudaStream_t stream) {
  constexpr long long tile =
      (long long)kAxpbyU * AxpbyGroup<TX, TY, TO>::E * kThreads;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  axpby_kernel<TX, TY, TO, kAxpbyU>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TY*>(y),
          static_cast<TO*>(out), static_cast<const float*>(scalars),
          static_cast<int*>(flag), n);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t axpby_out(int out_dtype, const void* x, const void* y, void* out,
                      const void* scalars, void* flag, long long n,
                      cudaStream_t st) {
  switch (out_dtype) {
    case kFloat32:
      return launch_axpby<TX, TY, float>(x, y, out, scalars, flag, n, st);
    case kBFloat16:
      return launch_axpby<TX, TY, __nv_bfloat16>(x, y, out, scalars, flag, n,
                                                 st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t axpby_y(int y_dtype, int out_dtype, const void* x, const void* y,
                    void* out, const void* scalars, void* flag, long long n,
                    cudaStream_t st) {
  switch (y_dtype) {
    case kFloat32:
      return axpby_out<TX, float>(out_dtype, x, y, out, scalars, flag, n, st);
    case kBFloat16:
      return axpby_out<TX, __nv_bfloat16>(out_dtype, x, y, out, scalars, flag,
                                          n, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// global L2 norm
// ---------------------------------------------------------------------------

constexpr int kL2Threads = 256;
constexpr int kL2Blocks = 4 * kSms;      // partials per buffer (fixed)
constexpr int kL2FinishThreads = 512;

// block-wide sum of one value per thread in a fixed tree: the same
// inputs give the same bits whatever the order the warps ran in
template <int kThreadsT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < 32) {
    total = threadIdx.x < kThreadsT / 32 ? red[threadIdx.x] : 0.f;
    total = warp_sum(total);
  }
  __syncthreads();
  return total;  // valid in thread 0
}

// pass 1: block b of kL2Blocks writes the fp32 sum of squares of the
// elements it strides over to partial[b]
template <typename T>
__global__ void __launch_bounds__(kL2Threads)
sumsq_kernel(const T* __restrict__ x, long long n, float* __restrict__ partial) {
  __shared__ float red[kL2Threads / 32];
  constexpr int N = Vec<T>::N;
  const long long n_vec = n / N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
  for (long long i = t0; i < n_vec; i += stride) {
    float e[N];
    load_vec<T>(x + i * N, e);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += e[k] * e[k];
  }
  for (long long i = n_vec * N + t0; i < n; i += stride) {
    const float e = to_float<T>(x[i]);
    acc += e * e;
  }
  const float total = block_sum<kL2Threads>(acc, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// pass 2, one block: each buffer's kL2Blocks partials summed in a fixed
// tree, the buffers added in list order, then the square root
__global__ void __launch_bounds__(kL2FinishThreads)
l2norm_finish_kernel(const float* __restrict__ partial, int groups,
                     float* __restrict__ out) {
  __shared__ float red[kL2FinishThreads / 32];
  float total = 0.f;
  for (int g = 0; g < groups; ++g) {
    float acc = 0.f;
    for (int i = threadIdx.x; i < kL2Blocks; i += kL2FinishThreads)
      acc += partial[g * kL2Blocks + i];
    const float s = block_sum<kL2FinishThreads>(acc, red);
    if (threadIdx.x == 0) total += s;
  }
  if (threadIdx.x == 0) *out = sqrtf(total);
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// p [n] in `dtype`, g/m/v [n] fp32, scalars fp32 [8] on the device,
// noop int32 [1] on the device or null; delta fp32 [n] or null. With
// delta, the update -lr*upd is written there and p is only read (on a
// no-op the kernel writes nothing: the wrapper hands it a zeroed delta);
// without, p is updated in place. n must be a positive multiple of 4 and
// every pointer 16-byte aligned (the wrapper checks both). Returns
// cudaGetLastError() after the launch; cudaErrorInvalidValue for a shape
// or dtype the kernel was not built for (nothing launched).
extern "C" int apex_tpu_torch_adam_flat(
    void* p, const void* g, void* m, void* v, void* delta,
    const void* scalars, const void* noop, long long n, int adam_w_mode,
    int grad_averaging, int dtype, void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(p, g, m, v, delta, scalars, noop, n, adam_w_mode,
                           grad_averaging, st);
    case kBFloat16:
      return launch<__nv_bfloat16>(p, g, m, v, delta, scalars, noop, n,
                                   adam_w_mode, grad_averaging, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// p [n] in `dtype`, g/m [n] fp32, scalars fp32 [5] on the device (lr,
// momentum, dampening, weight_decay, grad_scale), noop int32 [1] on the
// device or null; delta fp32 [n] or null, as for apex_tpu_torch_adam_flat:
// with delta the update -lr*upd goes there and p is only read. n must be
// a positive multiple of 4 and every pointer 16-byte aligned.
extern "C" int apex_tpu_torch_sgd_flat(
    void* p, const void* g, void* m, void* delta, const void* scalars,
    const void* noop, long long n, int nesterov, int dtype, void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_sgd<float>(p, g, m, delta, scalars, noop, n, nesterov,
                               st);
    case kBFloat16:
      return launch_sgd<__nv_bfloat16>(p, g, m, delta, scalars, noop, n,
                                       nesterov, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// p [n] in `dtype`, g/h [n] fp32, scalars fp32 [4] on the device (lr, eps,
// weight_decay, grad_scale), noop int32 [1] on the device or null; delta
// fp32 [n] or null, as for apex_tpu_torch_adam_flat: with delta the update
// -lr*g'/(sqrt(h)+eps) goes there and p is only read. n must be a positive
// multiple of 4 and every pointer 16-byte aligned.
extern "C" int apex_tpu_torch_adagrad_flat(
    void* p, const void* g, void* h, void* delta, const void* scalars,
    const void* noop, long long n, int dtype, void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch_adagrad<float>(p, g, h, delta, scalars, noop, n, st);
    case kBFloat16:
      return launch_adagrad<__nv_bfloat16>(p, g, h, delta, scalars, noop, n,
                                           st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out [n] = x [n] * scalar[0], both in `dtype`; scalar fp32 [1] and flag
// int32 [1] on the device. Stores 1 to *flag when an input is not finite
// and leaves it as it was otherwise (the caller zeroes it). n must be a
// positive multiple of 4 and every pointer 16-byte aligned.
extern "C" int apex_tpu_torch_scale_flat(const void* x, void* out,
                                         const void* scalar, void* flag,
                                         long long n, int dtype,
                                         void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_vec = n / kV;
  switch (dtype) {
    case kFloat32:
      scale_kernel<float><<<sweep_blocks(n_vec), kThreads, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(out),
          static_cast<const float*>(scalar), static_cast<int*>(flag), n_vec);
      break;
    case kBFloat16:
      scale_kernel<__nv_bfloat16><<<sweep_blocks(n_vec), kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<__nv_bfloat16*>(out), static_cast<const float*>(scalar),
          static_cast<int*>(flag), n_vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out [n] (out_dtype) = scalars[0] * x [n] (x_dtype) + scalars[1] * y [n]
// (y_dtype), in fp32; scalars fp32 [2] and flag int32 [1] on the device.
// Stores 1 to *flag when an fp32 result is not finite. n must be a
// positive multiple of 4 and every pointer 16-byte aligned.
extern "C" int apex_tpu_torch_axpby_flat(const void* x, const void* y,
                                         void* out, const void* scalars,
                                         void* flag, long long n, int x_dtype,
                                         int y_dtype, int out_dtype,
                                         void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kFloat32:
      return axpby_y<float>(y_dtype, out_dtype, x, y, out, scalars, flag, n,
                            st);
    case kBFloat16:
      return axpby_y<__nv_bfloat16>(y_dtype, out_dtype, x, y, out, scalars,
                                    flag, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The number of fp32 partials each buffer needs in the workspace of
// apex_tpu_torch_l2norm_flat.
extern "C" int apex_tpu_torch_l2norm_blocks() { return kL2Blocks; }

// out fp32 [1] = sqrt(sum over the `groups` buffers, in list order, of
// the sum of squares of each). ptrs/ns/dtypes are host arrays of
// `groups` entries: device pointers (16-byte aligned), element counts
// and dtype codes. workspace is fp32 [groups * kL2Blocks] on the device.
// Launches one pass per buffer and one finishing pass.
extern "C" int apex_tpu_torch_l2norm_flat(
    const void* ptrs, const void* ns, const void* dtypes, int groups,
    void* workspace, void* out, void* stream) {
  if (groups <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const* p = static_cast<const void* const*>(ptrs);
  const long long* n = static_cast<const long long*>(ns);
  const int* dt = static_cast<const int*>(dtypes);
  float* ws = static_cast<float*>(workspace);
  for (int g = 0; g < groups; ++g) {
    if (n[g] < 0) return cudaErrorInvalidValue;
    switch (dt[g]) {
      case kFloat32:
        sumsq_kernel<float><<<kL2Blocks, kL2Threads, 0, st>>>(
            static_cast<const float*>(p[g]), n[g], ws + g * kL2Blocks);
        break;
      case kBFloat16:
        sumsq_kernel<__nv_bfloat16><<<kL2Blocks, kL2Threads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(p[g]), n[g],
            ws + g * kL2Blocks);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  l2norm_finish_kernel<<<1, kL2FinishThreads, 0, st>>>(
      ws, groups, static_cast<float*>(out));
  return cudaGetLastError();
}

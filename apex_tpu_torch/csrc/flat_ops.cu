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
// 0.40 ms at 3.35 TB/s). At that rate a card must keep about 2 MB of
// loads in flight, so l2norm_kernel keeps kL2U independent 16-byte loads
// a thread in flight (bf16 as 8 values, fp32 as 4), each into its own
// fp32 accumulator, with the streaming hint (__ldcs), at kL2BlocksPerSm
// blocks of 256 an SM: 8.6 MB in flight on 132 SMs. (On the BERT-large
// group 4 blocks an SM measured 0.3% faster than 8, and one tile a block
// 20% slower, its last block folding 81,840 partials; PERF.md, section
// 6.)
// A block owns a contiguous range of a buffer, whose bounds the wrapper
// computes from n and the dtype alone (kernels/flat_ops.py:
// l2norm_geometry), so every launch sums in the same order and gives the
// same bits; the tails (n not a multiple of the vector, a range that ends
// mid-tile) are summed in the same kernel. One launch a call: the buffers
// of a launch (up to kL2MaxBuffers) are passed by value, as apex's
// multi_tensor_apply passes its TensorListMetadata; each block writes its
// partial to its own workspace slot, and the last block to arrive (a
// fence, then a ticket taken with an atomic) sums each buffer's partials
// in a fixed tree, adds the buffers in list order and takes an IEEE
// square root. The C entry zeroes the ticket before each launch (a 4-byte
// cudaMemsetAsync, which a CUDA graph replays too), as the wrapper's
// workspace comes fresh from the caching allocator. No step waits on the
// host for the norm.
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
// the caller's zeroed flag (int32 for scale; for axpby a bool, which the
// wrapper returns as found_inf as it is), read on the device: no step
// waits on the host. Scale runs the grid-stride sweep above. Axpby's a
// and b come by value when the caller has them as numbers, or from a
// device buffer.
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

template <typename F>
__device__ __forceinline__ void raise_flag(bool bad, F* flag) {
  if (__syncthreads_or(bad) && threadIdx.x == 0) *flag = F(1);
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

// a and b: from the device buffer `dev` ([a, b] fp32) when it is not
// null, else the values passed with it
struct AxpbyScalars {
  const float* dev;
  float a, b;
};

// out = a * x + b * y in fp32, stored in TO; the flag is raised by a
// non-finite fp32 result, before the narrowing. Tile t holds U * E *
// kThreads elements, and thread i owns its groups u * kThreads + i (u <
// U), so a warp's loads of one u are contiguous. The loop runs once a
// block on the one-tile-a-block grid, and strides on a smaller grid.
template <typename TX, typename TY, typename TO, int U>
__global__ void __launch_bounds__(kThreads)
axpby_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
             TO* __restrict__ out, const AxpbyScalars s,
             bool* __restrict__ flag, long long n) {
  constexpr int E = AxpbyGroup<TX, TY, TO>::E;
  const float a = s.dev != nullptr ? s.dev[0] : s.a;
  const float b = s.dev != nullptr ? s.dev[1] : s.b;
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
                         const AxpbyScalars& s, void* flag, long long n,
                         cudaStream_t stream) {
  constexpr long long tile =
      (long long)kAxpbyU * AxpbyGroup<TX, TY, TO>::E * kThreads;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  axpby_kernel<TX, TY, TO, kAxpbyU>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TY*>(y),
          static_cast<TO*>(out), s, static_cast<bool*>(flag), n);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t axpby_out(int out_dtype, const void* x, const void* y, void* out,
                      const AxpbyScalars& s, void* flag, long long n,
                      cudaStream_t st) {
  switch (out_dtype) {
    case kFloat32:
      return launch_axpby<TX, TY, float>(x, y, out, s, flag, n, st);
    case kBFloat16:
      return launch_axpby<TX, TY, __nv_bfloat16>(x, y, out, s, flag, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename TX>
cudaError_t axpby_y(int y_dtype, int out_dtype, const void* x, const void* y,
                    void* out, const AxpbyScalars& s, void* flag, long long n,
                    cudaStream_t st) {
  switch (y_dtype) {
    case kFloat32:
      return axpby_out<TX, float>(out_dtype, x, y, out, s, flag, n, st);
    case kBFloat16:
      return axpby_out<TX, __nv_bfloat16>(out_dtype, x, y, out, s, flag, n,
                                          st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// global L2 norm
// ---------------------------------------------------------------------------

// shared with kernels/_build.py (L2NORM_THREADS, L2NORM_UNROLL,
// L2NORM_MAX_BLOCKS, L2NORM_MAX_BUFFERS), whose l2norm_geometry lays out
// the blocks: a tile is kL2U 16-byte vectors of each of kL2Threads
// threads, and a block sums a whole number of tiles (the last block of a
// buffer: up to n)
constexpr int kL2Threads = 256;
constexpr int kL2U = 4;
constexpr int kL2BlocksPerSm = 4;  // 64 KB of loads in flight an SM
constexpr int kL2MaxBuffers = 32;

// elements of one tile of T
template <typename T> __host__ __device__ constexpr long long l2_tile() {
  return (long long)kL2U * Vec<T>::N * kL2Threads;
}

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

// The buffers of one launch, passed by value: buffer k (fp32 or bf16,
// dtype[k]) is summed by the blocks [first_block[k], first_block[k + 1]),
// block j of them taking the elements [j * chunk[k], min((j + 1) *
// chunk[k], n[k])). `first` is the index in the call of the launch's
// first buffer, `total` the call's count of buffers: the launch with
// first + groups == total finishes.
struct L2Args {
  const void* ptr[kL2MaxBuffers];
  long long n[kL2MaxBuffers];
  long long chunk[kL2MaxBuffers];
  int first_block[kL2MaxBuffers + 1];
  int dtype[kL2MaxBuffers];
  int groups, first, total;
};

// load_vec with the streaming hint: every byte is read once
template <typename T>
__device__ __forceinline__ void load_vec_stream(const T* __restrict__ src,
                                                float* dst) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) dst[i] = to_float<T>(e[i]);
}

// this thread's fp32 sum of squares over the block's range [lo, hi) of x:
// kL2U 16-byte loads in flight a tile, each into its own accumulator,
// folded in a fixed order; then the range's last, partial tile as whole
// vectors and single elements. One pointer walks the tiles, and the
// loads of a tile sit at constant offsets from it, so the loop holds
// few registers beside its kL2U vectors.
template <typename T>
__device__ __forceinline__ float range_sumsq(const T* __restrict__ x,
                                             long long lo, long long hi) {
  constexpr int N = Vec<T>::N;
  constexpr long long kTile = l2_tile<T>();
  float acc[kL2U];
#pragma unroll
  for (int u = 0; u < kL2U; ++u) acc[u] = 0.f;
  const int tiles = (int)((hi - lo) / kTile);
  const T* p = x + lo + threadIdx.x * N;
  for (int t = 0; t < tiles; ++t, p += kTile) {
    float e[kL2U][N];
#pragma unroll
    for (int u = 0; u < kL2U; ++u)
      load_vec_stream<T>(p + u * kL2Threads * N, e[u]);
#pragma unroll
    for (int u = 0; u < kL2U; ++u)
#pragma unroll
      for (int k = 0; k < N; ++k) acc[u] = fmaf(e[u][k], e[u][k], acc[u]);
  }
  const long long rest = lo + tiles * kTile;
  const long long v_end = rest + (hi - rest) / N * N;
  for (long long i = rest + threadIdx.x * N; i < v_end;
       i += (long long)kL2Threads * N) {
    float e[N];
    load_vec<T>(x + i, e);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[0] = fmaf(e[k], e[k], acc[0]);
  }
  for (long long i = v_end + threadIdx.x; i < hi; i += kL2Threads) {
    const float e = to_float<T>(x[i]);
    acc[0] = fmaf(e, e, acc[0]);
  }
  float s = acc[0];
#pragma unroll
  for (int u = 1; u < kL2U; ++u) s += acc[u];
  return s;
}

// ws (fp32 words): [0] the ticket (a uint32, zero at launch), [1, 1 +
// total) each buffer's sum of squares, then one partial a block of the
// launch. The last block to arrive sums each buffer's partials, and on
// the call's last launch adds the buffers in list order into *out.
__global__ void __launch_bounds__(kL2Threads, kL2BlocksPerSm)
l2norm_kernel(const L2Args a, float* __restrict__ ws,
              float* __restrict__ out) {
  __shared__ float red[kL2Threads / 32];
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws);
  float* sums = ws + 1;
  float* partial = ws + 1 + a.total;
  int k = 0;
  while ((int)blockIdx.x >= a.first_block[k + 1]) ++k;
  const long long lo = (long long)(blockIdx.x - a.first_block[k]) *
                       a.chunk[k];
  const long long hi = lo + a.chunk[k] < a.n[k] ? lo + a.chunk[k] : a.n[k];
  const float s =
      a.dtype[k] == kFloat32
          ? range_sumsq(static_cast<const float*>(a.ptr[k]), lo, hi)
          : range_sumsq(static_cast<const __nv_bfloat16*>(a.ptr[k]), lo, hi);
  const float block_total = block_sum<kL2Threads>(s, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = block_total;
    __threadfence();  // the partial is seen before the ticket moves
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int g = 0; g < a.groups; ++g) {
    float acc = 0.f;
    for (int i = a.first_block[g] + threadIdx.x; i < a.first_block[g + 1];
         i += kL2Threads)
      acc += __ldcg(partial + i);
    const float sg = block_sum<kL2Threads>(acc, red);
    if (threadIdx.x == 0) sums[a.first + g] = sg;
  }
  if (threadIdx.x == 0 && a.first + a.groups == a.total) {
    float total = 0.f;
    for (int g = 0; g < a.total; ++g) total += __ldcg(sums + g);
    *out = sqrtf(total);
  }
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

// out [n] (out_dtype) = a * x [n] (x_dtype) + b * y [n] (y_dtype), in
// fp32, where a and b are scalars[0] and scalars[1] (fp32 [2] on the
// device) or, when scalars is null, the values a and b passed here. flag
// is a bool [1] on the device: stores true when an fp32 result is not
// finite. n must be a positive multiple of 4 and every pointer 16-byte
// aligned.
extern "C" int apex_tpu_torch_axpby_flat(const void* x, const void* y,
                                         void* out, const void* scalars,
                                         float a, float b, void* flag,
                                         long long n, int x_dtype,
                                         int y_dtype, int out_dtype,
                                         void* stream) {
  if (n <= 0 || n % kV) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AxpbyScalars s{static_cast<const float*>(scalars), a, b};
  switch (x_dtype) {
    case kFloat32:
      return axpby_y<float>(y_dtype, out_dtype, x, y, out, s, flag, n, st);
    case kBFloat16:
      return axpby_y<__nv_bfloat16>(y_dtype, out_dtype, x, y, out, s, flag,
                                    n, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out fp32 [1] = sqrt(sum over the call's `total` buffers, in list order,
// of the sum of squares of each), from the launch of the call's last
// buffers; this launch takes the call's buffers [first, first + groups).
// ptrs/ns/dtypes/blocks/chunks are host arrays of `groups` entries:
// device pointers (16-byte aligned), element counts, dtype codes, blocks
// a buffer and elements a block (kernels/flat_ops.py:l2norm_geometry).
// workspace is fp32 [1 + total + the launch's blocks] on the device; its
// first word is zeroed here. cudaErrorInvalidValue (nothing launched) for
// a dtype, a count of buffers or a geometry the kernel was not built for.
extern "C" int apex_tpu_torch_l2norm_flat(
    const void* ptrs, const void* ns, const void* dtypes, const void* blocks,
    const void* chunks, int groups, int first, int total, void* workspace,
    void* out, void* stream) {
  if (groups <= 0 || groups > kL2MaxBuffers || first < 0 ||
      first + groups > total)
    return cudaErrorInvalidValue;
  const void* const* p = static_cast<const void* const*>(ptrs);
  const long long* n = static_cast<const long long*>(ns);
  const int* dt = static_cast<const int*>(dtypes);
  const int* nb = static_cast<const int*>(blocks);
  const long long* ch = static_cast<const long long*>(chunks);
  L2Args a{};
  a.groups = groups;
  a.first = first;
  a.total = total;
  long long grid = 0;
  for (int g = 0; g < groups; ++g) {
    long long tile;
    switch (dt[g]) {
      case kFloat32: tile = l2_tile<float>(); break;
      case kBFloat16: tile = l2_tile<__nv_bfloat16>(); break;
      default: return cudaErrorInvalidValue;
    }
    // whole tiles a block, every block's range non-empty (one empty block
    // for an empty buffer), and n covered
    const bool tiles = ch[g] > 0 && ch[g] % tile == 0 &&
                       ch[g] / tile <= 0x7fffffffLL;
    const bool fits = n[g] == 0 ? nb[g] == 1
                                : nb[g] >= 1 && (nb[g] - 1) * ch[g] < n[g] &&
                                      nb[g] * ch[g] >= n[g];
    if (n[g] < 0 || !tiles || !fits) return cudaErrorInvalidValue;
    a.ptr[g] = p[g];
    a.n[g] = n[g];
    a.chunk[g] = ch[g];
    a.dtype[g] = dt[g];
    a.first_block[g] = (int)grid;
    grid += nb[g];
    if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  }
  a.first_block[groups] = (int)grid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  cudaError_t err = cudaMemsetAsync(ws, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  l2norm_kernel<<<(unsigned)grid, kL2Threads, 0, st>>>(
      a, ws, static_cast<float*>(out));
  return cudaGetLastError();
}

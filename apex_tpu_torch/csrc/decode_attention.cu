// Flash-decode for the KV-cache decode step, over the contiguous cache
// and the paged pool: the column writes and the split-horizon read.
//
// Replaces, in apex_tpu/kernels/decode_attention.py:
// - _write_column (kernel body _write_kernel) and _run_attn (body
//   _attn_kernel), the two Pallas kernels decode_attention composes on
//   gpt._decode_attend's kernel branch;
// - cache_write_columns (body _write_cols_kernel), the speculative
//   verify forward's T-column write (gpt._decode_attend_multi; on the
//   verify's main path it runs inside the launch of decode_verify.cu);
// - paged_write_column (body _paged_write_kernel), paged_write_columns
//   (body _paged_write_cols_kernel) and paged_attention (body
//   _paged_attn_kernel), the same three jobs through a per-row block
//   table into a global page pool (gpt._paged_attend and
//   gpt._paged_attend_multi);
// - on the decode step's main path, the single-column write and the read
//   of one layer (decode_attention's _write_column + _run_attn, and
//   gpt._paged_attend's paged_write_column + paged_attention) as ONE
//   launch of the read, which stores the new column itself (the entries
//   apex_tpu_torch_decode_attention_write and
//   apex_tpu_torch_paged_attention_write; the stand-alone write and read
//   entries stay, the counterparts of JAX's public functions);
// - the six over the quantized cache (int8 or fp8 e4m3 data with one
//   fp32 scale per head row and column): _write_column_quant,
//   cache_write_columns_quant, paged_write_column_quant and
//   paged_write_columns_quant (bodies _write_kernel_quant,
//   _write_cols_kernel_quant, _paged_write_kernel_quant,
//   _paged_write_cols_kernel_quant) are write_columns_quant_kernel, and
//   _run_attn_quant and paged_attention_quantized (bodies
//   _attn_kernel_quant, _paged_attn_kernel_quant) are the quantized
//   instantiations of the one split read, decode_read_split_kernel.
//
// What bounds them on an H100: all are memory-bound. A write moves
// 2 x b x T x h x d elements each way. A read moves, per (batch, head)
// row, q plus the K and V rows of columns 0..pos[b] (and, quantized, a
// byte a value and two fp32 scales a column): at GPT 355M's serving
// shapes (b 8, h 16, horizon 192, d 64, bf16) at most ~6 MB per layer,
// at the 2.7B's (h 32, d 80, horizon 1024) ~84 MB (int8: ~44 MB),
// against 4 x d flops per column and head: about one flop a byte (two
// quantized), far under the ~295 flops a byte at which Hopper's tensor
// cores, not its memory, would be the limit. So the four reads (rows 10,
// 12, 17 and 18) keep their math in fp32 on the CUDA cores: every config
// of the repo is multi-head with one query row per (batch, head), no
// group of query heads shares a K row, and an mma.sync would waste 15 of
// its 16 rows. What a read has to do is keep enough bytes in flight on
// every SM.
//
// What the design does about it:
// - All four writes are one kernel (write_columns_kernel), one launch
//   for both planes: one block per (row, lane) copies its [h, d] K and
//   V slab into its column in place, in 16-byte units where the head
//   row allows. The contiguous cache is the case without a table, one
//   "page" of S columns a row; a one-column write is T = 1. No other cache byte is
//   read or written (the aliased-output contract of the Pallas
//   writes). The paged writes look the column's page up in the row's
//   table: (table[b, c / P], c % P).
// - The multi-column writes clamp a lane past the horizon onto the
//   last column, as the Pallas index maps do. The Pallas grid runs in
//   order, so of several lanes clamped onto that column the last one
//   wins; here the blocks run in parallel, so only the row's last lane
//   writes the clamped column and the result is the same, every run.
//   The one-column writes never write outside the row's horizon.
// - The four reads are one kernel, decode_read_split_kernel<T, S, DP,
//   kPaged>: q and the output are T (fp32, bf16 or fp16), the rows are
//   stored and staged as S (T for rows 10 and 17; int8 or fp8 e4m3 for
//   rows 12 and 18, whose fp32 scale planes are staged beside them), and
//   kPaged picks the pools. Each (batch, head) row's horizon is split
//   over a thread-block cluster. The Pallas kernels walk the horizon as
//   a sequential grid axis with (m, l, acc) carried in VMEM; here split
//   s of n covers logical columns [s L, (s + 1) L), with L a multiple of
//   32 and n <= 8 taken from the horizon and d alone on the host (the
//   wrappers' read_splits), never from pos, so nothing waits on the
//   host. At the 2.7B's decode shape that is 8 splits of 128 columns:
//   2048 blocks where one block a row gave 256 for 132 SMs. A split that
//   starts past pos[b] exits at once (a cluster's barriers wait only for
//   threads that have not exited), so it holds no SM slot.
// - Each block stages its split's K and V rows in shared memory with
//   16-byte cp.async copies, neighbouring threads on neighbouring
//   addresses, one address for both planes (the contiguous split is one
//   run; the paged one a run a page, the block reading its page numbers
//   from the row's table first), through a ring of kReadRing sub-tiles
//   of kSubCols columns: the next sub-tile's copies are in flight while
//   the current one is scored and summed. A deeper ring measured slower
//   (its shared memory leaves fewer blocks on an SM). Rows whose bytes
//   no 16 divides (bf16 at d = 100, int8 at d = 72 or 100) copy in 8-,
//   4-, 2- or 1-byte units, a block-uniform choice. The quantized rows
//   are staged as stored, a byte a value; each column's two fp32 scales
//   land beside them in a 2 x kSubCols region of the ring stage, one
//   4-byte cp.async each (a paged scale run starts mid-page whenever P
//   does not divide 32, so no wider unit is safe), in the same commit
//   group as the rows.
// - Inside a block each warp owns 8 columns of a sub-tile: four lanes
//   score a column (q from shared memory, K by 16-byte vectors where
//   rows allow: 4 fp32 or 8 bf16 or fp16 values a load; one-byte rows by
//   4-byte words, so the quad's lanes share a d of 80 evenly) and add
//   their parts in a fixed order; the warp keeps an fp32 online
//   softmax (m, l, acc) with lanes over d for P.V, V read from shared
//   memory by consecutive lanes. The warps then merge in warp order, and
//   each live split pushes its (m, l, acc) into slot s of the split-0
//   block's shared memory (distributed shared memory), arrives on an
//   mbarrier there and exits; the split-0 block waits on it, then merges
//   the slots in split order, scales each by exp(m_s - m) and writes
//   out, rounded once, l floored at 1e-30: one launch, no workspace, no
//   atomics, the same bits every launch. The one cluster barrier
//   (arrived at the start, waited on before the push) only makes sure
//   the split-0 block has started and set its mbarrier up.
// - The quantized reads fold the scales as _attn_kernel_quant does: the
//   score is (q . k_int) * s_k * scale, and column j's V row is weighted
//   by p_j * s_v while l sums the unscaled p_j. int8 widens to fp32
//   around the conversion unit, which runs at a quarter of the FMA rate:
//   the byte, placed in the low bits of the float 2^23 (or 1.5 * 2^23),
//   is one add away from its value; fp8 widens in pairs by the hardware
//   e4m3x2 -> f16x2 conversion and then to fp32. Both are exact. So a
//   quantized read moves ~(d + 4) / (2 d) of the bf16 cache's bytes.
// - The fused launch (rows 7 and 13 inside rows 10 and 17): a
//   single-column write moves 2 x b x h x d values, ~40 KB at the 2.7B's
//   decode shape, a hundredth of a microsecond of HBM time, so a launch of
//   its own cost it its whole fixed cost (~2 us on the device, a wrapper
//   and its checks on the host), once a layer every decode step. The read
//   of the same layer follows it, and in that read only the block of rank
//   pos / split_cols ever touches column pos of its row. So that block
//   stages the column's slot of its last sub-tile from k_new/v_new's row,
//   by the same cp.async units, instead of from the cache, and once its
//   last sub-tile is scored stores that slot into the column (the
//   contiguous cell, or page table[b, pos / P] at pos % P from the page
//   numbers it loaded), by plain loads and stores of the copy unit.
//   Nothing in the launch reads a cell it writes (the .cg copies go
//   around L1, and the first sub-tiles are issued before anything else,
//   so a store followed by a copy from the cache would need a fence and a
//   wait in front of them), and the bytes scored are exactly the bytes
//   stored: the caches and out equal the write + read pair's bit for bit.
//   Stored from the slot after the loop, the row costs no second read
//   from device memory in front of the block's first sub-tile (stored
//   first from k_new, the launch was 2-4% slower on an H100 at the 355M's
//   decode shapes and the 2.7B's paged one). The helpers are out of line
//   (see store_row). A position outside [0,
//   horizon) writes nothing and substitutes nothing (the write kernel
//   drops it; the read keeps its clamp). Only the plain rows take new
//   rows: a quantized write quantizes a whole head row first. Rows that
//   share a cell (freed rows' tables all point at the sink page) race on
//   it as the pair's writes did; their outputs are never used, and a live
//   row's columns lie in its own pages.
// - The contiguous and the paged read differ only in where column c's
//   row (and scale) is copied from: the same bytes land in the same
//   shared-memory cells and are summed in the same order, so paged
//   decode equals contiguous decode bit for bit at the same horizon,
//   plain or quantized.
// - Any head width d from 1 to kMaxHeadDim (128, the head-major flash
//   kernels' cap): the reads are built for the padded width DP, d rounded
//   up to 32, 64, 96 or 128, and lane t of a warp owns dims t + 32 i
//   (i < DP / 32) of the P.V accumulator. Rows are d elements apart in
//   memory (the real d, at run time); q's padded dims are zeros in
//   shared memory, a lane's dims at or past d are never loaded or
//   stored, and the score's dot product runs over the d real dims only.
// - fp32, bf16 and fp16 q and rows, each widened to fp32 in registers
//   (the wrappers pass fp16 as it is).
// - Columns past pos[b] are never read: splits and sub-tiles end at
//   pos, and only columns <= pos are copied (their scales included),
//   scored and summed. Stale bytes past pos (what a retired request or
//   an uninitialised buffer left, NaN included, in a row or a scale; a
//   recycled page; the sink page) therefore contribute exact zeros,
//   which is what decode_attention.py:297-301 guards against.
// - Scores are fp32 and scaled in fp32, as in _attn_kernel.
// - The roundings of the reads' sums are pinned by intrinsics
//   (__fmaf_rn, __fmul_rn, __fadd_rn): the dot products, the P.V sums
//   and the merges as fused multiply-adds, the rescale of (l, acc) by
//   corr rounded apart from the add after it. Left to the compiler,
//   whether a product was fused into that add varied between
//   instantiations of the same source (l's update was fused in fp32 at DP
//   64, not at DP 96 nor in bf16: nvcc 12.8 for an H100), so two kernels
//   that sum in one order could still round apart; pinned, the verify
//   launch (decode_verify.cu) equals the split read bit for bit. The
//   choices are what the
//   bf16 instantiations computed, and leave every instantiation's
//   registers as they were. The score's product (dot * scale) is left
//   to the compiler, which keeps it apart from the max it meets: pinned
//   there, the plain reads took 8 to 24 more registers.
// - The quantized writes keep write_columns_kernel's addressing and
//   clamp and quantize every head row of the call at once: a group of
//   lanes a head row (8 at d 64 in bf16, one 16-byte load a lane), blocks
//   over (b, lane j, group of head rows), so the 2 x b x h x T head rows
//   spread over the SMs and no warp takes two in series. The group's
//   absmax is a shuffle within it, then the one quantizer (KvQuant) and
//   one packed store a lane; a byte a value and one fp32 scale a row, so
//   a write moves ~1/2 (bf16 in) of the bytes it would store unquantized.
#include "decode_common.cuh"

namespace apex_tpu_torch {

// The 4 one-byte values of one 4-byte word in shared memory, widened to
// fp32 exactly. int8: byte b with its sign bit flipped is x + 128, and as
// the low byte of the float 2^23 (0x4B000000) it is 2^23 + 128 + x, one
// byte permute and one add; fp8 e4m3 in pairs by the hardware e4m3x2 ->
// f16x2 conversion, then to fp32.
template <typename S>
__device__ __forceinline__ void load_word(const S* __restrict__ src,
                                          float* dst);
template <>
__device__ __forceinline__ void load_word<int8_t>(
    const int8_t* __restrict__ src, float* dst) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(src) ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    dst[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) -
             8388736.f;
}
template <>
__device__ __forceinline__ void load_word<__nv_fp8_e4m3>(
    const __nv_fp8_e4m3* __restrict__ src, float* dst) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3)));
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

namespace {

constexpr int kWriteThreads = 256;
// the quantized writes: threads a block (a group of lanes a head row)
constexpr int kQuantWriteThreads = 128;
// the bytes of a one-byte K row a lane of the scoring quad takes at a
// time (4-byte words: a quad's lanes take a d of 80 in 5 words each, where
// 16-byte vectors would give one lane 2 of the 5)
constexpr int kQuantKBytes = 4;

// rows stored a byte a value (int8 or fp8 e4m3) beside fp32 scales
template <typename S>
constexpr bool kQuantRows =
    std::is_same_v<S, int8_t> || std::is_same_v<S, __nv_fp8_e4m3>;

// f(Tag<S>{}) for the quantized storage kind: int8 or fp8 e4m3
template <typename F> cudaError_t with_kind(int kind, F&& f) {
  switch (kind) {
    case kInt8: return f(Tag<int8_t>{});
    case kFp8: return f(Tag<__nv_fp8_e4m3>{});
    default: return cudaErrorInvalidValue;
  }
}

// Where a multi-column write lands: the contiguous cache [b, h, S, d]
// (table == nullptr, P == S) or the paged pool [num_pages, h, P, d]
// under table [b, mp]; in units U of the head row (units per row).
struct ColumnDst {
  const int* table;
  int h, P, mp, units;

  // the (row or page, head, column) cell: its scale's index in a scale
  // plane, and its data row's in units of `units`
  __device__ __forceinline__ size_t cell(int b, int hh, int c) const {
    if (table == nullptr) return ((size_t)b * h + hh) * P + c;
    const int page = table[(size_t)b * mp + c / P];
    return ((size_t)page * h + hh) * P + c % P;
  }

  __device__ __forceinline__ size_t offset(int b, int hh, int c) const {
    return cell(b, hh, c) * units;
  }
};

// One block per (row b, lane j): new[b, :, j, :] ([b, h, T, d]) lands in
// logical column pos[b] + j of both planes. clamp: a lane past the
// horizon smax lands on smax - 1, and only the row's last lane writes
// that column (the last writer of the Pallas grid); otherwise a column
// outside [0, smax) is not written.
template <typename U>
__global__ void __launch_bounds__(kWriteThreads)
write_columns_kernel(const U* __restrict__ k_new, const U* __restrict__ v_new,
                     U* __restrict__ k_dst, U* __restrict__ v_dst,
                     const int* __restrict__ pos, ColumnDst dst, int T,
                     int smax, bool clamp) {
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  int c = pos[b] + j;
  if (c < 0) return;
  if (clamp) {
    if (c >= smax - 1) {
      if (j != T - 1) return;
      c = smax - 1;
    }
  } else if (c >= smax) {
    return;
  }
  const int n = dst.h * dst.units;
  for (int i = threadIdx.x; i < n; i += kWriteThreads) {
    const int hh = i / dst.units;
    const int u = i - hh * dst.units;
    const size_t o = dst.offset(b, hh, c) + u;
    const size_t src = (((size_t)b * dst.h + hh) * T + j) * dst.units + u;
    k_dst[o] = k_new[src];
    v_dst[o] = v_new[src];
  }
}

// THE KV quantizer of one value, bit for bit quantize_kv_rows (JAX and
// the port's plain version): y = x / scale by a true IEEE division (this
// file is built without --use_fast_math); int8 rounds half to even and
// clips to +-127, fp8 clips to +-448 and converts to e4m3 to nearest
// even. kRecip is the double 1 / qmax rounded once to fp32.
template <typename Q> struct KvQuant;
template <> struct KvQuant<int8_t> {
  static constexpr float kMax = 127.f;
  static constexpr float kRecip = static_cast<float>(1.0 / 127.0);
  __device__ __forceinline__ static int8_t store(float y) {
    const float r = fminf(fmaxf(rintf(y), -kMax), kMax);
    return static_cast<int8_t>(__float2int_rn(r));
  }
};
template <> struct KvQuant<__nv_fp8_e4m3> {
  static constexpr float kMax = 448.f;
  static constexpr float kRecip = static_cast<float>(1.0 / 448.0);
  __device__ __forceinline__ static __nv_fp8_e4m3 store(float y) {
    __nv_fp8_e4m3 out;
    out.__x = __nv_cvt_float_to_fp8(fminf(fmaxf(y, -kMax), kMax),
                                    __NV_SATFINITE, __NV_E4M3);
    return out;
  }
};

// the floor of a row's absmax, fp32(1e-12) as JAX rounds it
constexpr float kAmaxFloor = static_cast<float>(1e-12);

// the byte a quantized value is stored as
__device__ __forceinline__ uint32_t stored_byte(int8_t v) {
  return static_cast<uint8_t>(v);
}
__device__ __forceinline__ uint32_t stored_byte(__nv_fp8_e4m3 v) {
  return v.__x;
}

// E bytes (E = 1, 2, 4 or 8), byte i in w[i / 4] bits 8 (i % 4) up, as
// one store
template <int E> __device__ __forceinline__ void store_bytes(
    void* dst, const uint32_t* w) {
  if constexpr (E == 8) {
    *static_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else if constexpr (E == 4) {
    *static_cast<uint32_t*>(dst) = w[0];
  } else if constexpr (E == 2) {
    *static_cast<uint16_t*>(dst) = static_cast<uint16_t>(w[0]);
  } else {
    *static_cast<uint8_t*>(dst) = static_cast<uint8_t>(w[0]);
  }
}

// write_columns_kernel's addressing and clamp over the quantized planes,
// every head row of the call at once. Grid (b, T, row groups) of
// kQuantWriteThreads threads: block (b, j, z) takes head rows z * rpb ..
// (z + 1) * rpb - 1 of new[b, :, j, :] (K rows 0..h-1, then V rows
// h..2h-1), rpb = kQuantWriteThreads >> group_log2, a group of 2^group_log2
// lanes (aligned within the warp) a row. The row is `units` units of U
// (the widest of 16, 8, 4 and 2 bytes the row's bytes divide into: a 16-
// byte load a lane at d 64 or 80 in bf16), lane t of the group taking
// units t, t + group, ...; the group's absmax is an xor shuffle within it,
// and each unit's E values leave as one E-byte store of the quantized
// bytes; the group's first lane stores the row's scale into the scale
// plane at the same cell (dst.units == d). Rows 9, 11, 14 and 16 of the
// kernel table.
template <typename In, typename Q, typename U>
__global__ void __launch_bounds__(kQuantWriteThreads)
write_columns_quant_kernel(const In* __restrict__ k_new,
                           const In* __restrict__ v_new,
                           Q* __restrict__ k_q, float* __restrict__ k_s,
                           Q* __restrict__ v_q, float* __restrict__ v_s,
                           const int* __restrict__ pos, ColumnDst dst, int T,
                           int smax, bool clamp, int group_log2) {
  constexpr int E = sizeof(U) / sizeof(In);
  const int b = blockIdx.x;
  const int j = blockIdx.y;
  const int group = 1 << group_log2;
  const int t = threadIdx.x & (group - 1);
  const int r = blockIdx.z * (kQuantWriteThreads >> group_log2) +
                (threadIdx.x >> group_log2);
  const int d = dst.units;
  const int units = d / E;
  const bool live = r < 2 * dst.h;
  const bool is_v = r >= dst.h;
  const int hh = is_v ? r - dst.h : r;
  const U* src = reinterpret_cast<const U*>(
      (is_v ? v_new : k_new) + (((size_t)b * dst.h + hh) * T + j) * d);
  // the row's first unit, pos and the cell (a page-table read when paged)
  // are in flight together; the exits before the shuffle are the block's
  const bool first = live && t < units;
  U raw0;
  if (first) raw0 = src[t];
  int c = pos[b] + j;
  if (c < 0) return;
  if (clamp) {
    if (c >= smax - 1) {
      if (j != T - 1) return;
      c = smax - 1;
    }
  } else if (c >= smax) {
    return;
  }
  const size_t cell = dst.cell(b, hh, c);
  float amax = 0.f;
  for (int u = t; first && u < units; u += group) {
    const U raw = u == t ? raw0 : src[u];
    const In* e = reinterpret_cast<const In*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) amax = fmaxf(amax, fabsf(to_float<In>(e[i])));
  }
  // every lane of the warp takes part (the exits above are the whole
  // block's); the offsets stay inside a group
  for (int o = group >> 1; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!live) return;
  const float scale = fmaxf(amax, kAmaxFloor) * KvQuant<Q>::kRecip;
  Q* row = (is_v ? v_q : k_q) + cell * d;
  for (int u = t; u < units; u += group) {
    const U raw = u == t ? raw0 : src[u];
    const In* e = reinterpret_cast<const In*>(&raw);
    uint32_t w[(E + 3) / 4] = {};
#pragma unroll
    for (int i = 0; i < E; ++i)
      w[i / 4] |= stored_byte(KvQuant<Q>::store(
                      __fdiv_rn(to_float<In>(e[i]), scale)))
                  << (8 * (i % 4));
    store_bytes<E>(row + u * E, w);
  }
  if (t == 0) (is_v ? v_s : k_s)[cell] = scale;
}

// The fused launch's two jobs for the block holding column pos, out of
// line: inlined into the split read they took its plain instantiations
// from 56-72 registers a thread to 80-128 (spilling at DP 96 and in
// fp32) and so halved its blocks an SM; called, they leave it 64-72 and
// no spill. (A minimum of blocks an SM in the launch bounds held the
// plain reads to 64 too, but changed the quantized reads' code: 2-10%
// slower on an H100, 30% with a minimum of 1.) stage_row: the new row
// from kn/vn into the ring's slots ks/vs by the read's cp.async units (in
// the caller's commit group); store_row (decode_common.cuh) stores it
// from those slots after the loop.
template <int N>
__device__ __noinline__ void stage_row(char* ks, char* vs, const char* kn,
                                       const char* vn, int row_bytes) {
  stage_run<N>(ks, vs, kn, vn, 0, 0, 1, row_bytes);
}

// The fp32 scales of columns [c, c + nc) of one (batch, head) row into
// ss (K's at [0, nc), V's at [kSubCols, kSubCols + nc)), one 4-byte
// cp.async a scale from the block's first two warps; cell(cc) is column
// cc's index in a scale plane (contiguous, or through the page table).
template <typename Cell>
__device__ __forceinline__ void stage_scales(float* ss,
                                             const float* __restrict__ k_s,
                                             const float* __restrict__ v_s,
                                             int c, int nc, const Cell& cell) {
  const int i = threadIdx.x;
  const int j = i % kSubCols;
  if (i < 2 * kSubCols && j < nc)
    copy_unit<4>(reinterpret_cast<char*>(ss + i),
                 reinterpret_cast<const char*>(
                     (i < kSubCols ? k_s : v_s) + cell(c + j)));
}

// The four reads: out [b, h, d] = softmax(scale * q . K[:, :pos+1]) .
// V[:, :pos+1] per (batch, head) row, over the contiguous cache (kPaged
// false: k/v [b, h, horizon, d]) or the pools (kPaged: k/v [num_pages,
// h, P, d] under table [b, mp], horizon mp * P). The grid is n_splits
// blocks a row, each row's blocks one cluster; block rank s reads
// columns [s * split_cols, (s + 1) * split_cols) up to pos. Rows are S
// in memory and in shared memory: T for the plain reads (rows 10 and
// 17), int8 or fp8 e4m3 for the quantized ones (rows 12 and 18, kQuant),
// whose fp32 scales k_s/v_s lie beside the rows, [b, h, horizon] or
// [num_pages, h, P] (null for the plain reads), and fold in as
// _attn_kernel_quant folds them: score (q . k) * s_k * scale, V weight p
// * s_v, l the sum of the unscaled p. With k_new/v_new [b, h, d] (the
// plain reads only; null: read only) the launch is the fused decode step:
// the block holding column pos[b] (when it lies in [0, horizon)) stores
// the row's new K and V there and scores them from k_new/v_new. The
// dynamic shared memory holds
// the ring, kReadRing x (K, V) x kSubCols rows of d x sizeof(S) bytes,
// then (kQuant) kReadRing x (K, V) x kSubCols fp32 scales, then
// (kPaged) the split's page numbers.
template <typename T, typename S, int DP, bool kPaged>
__global__ void __launch_bounds__(kSplitThreads)
decode_read_split_kernel(const T* __restrict__ q, const S* __restrict__ k,
                         const float* __restrict__ k_s,
                         const S* __restrict__ v,
                         const float* __restrict__ v_s,
                         const S* __restrict__ k_new,
                         const S* __restrict__ v_new,
                         const int* __restrict__ table,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int h, int horizon, int P, int mp, int d,
                         float scale, int split_cols, int n_splits,
                         int unit) {
  static_assert(DP % 32 == 0 && DP <= kMaxHeadDim, "padded head width");
  static_assert(DP <= kSplitThreads, "a thread a dim in the merges");
  constexpr bool kQuant = kQuantRows<S>;
  static_assert(kQuant || std::is_same_v<S, T>, "rows as q, or quantized");
  constexpr int DPL = DP / 32;
  constexpr int VEC = Vec<S>::N;
  namespace cg = cooperative_groups;
  extern __shared__ uint4 dyn_smem[];
  __shared__ __align__(16) float qs[DP];
  __shared__ float wm[kSplitWarps], wl[kSplitWarps];
  __shared__ float wacc[kSplitWarps][DP];
  // in the split-0 block: every live split's (m, l, acc), pushed there
  // by its block, and the mbarrier its pushes arrive on
  __shared__ float pm[kMaxSplits], pl[kMaxSplits];
  __shared__ float pacc[kMaxSplits][DP];
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
  const int p = min(max(pw, 0), horizon - 1);
  const int c0 = s * split_cols;
  // a split that starts past pos has nothing to read or merge: it exits
  // at once, so it holds no SM slot while its cluster sweeps (the
  // cluster's barrier waits only for threads that have not exited, and
  // the merge counts live splits alone)
  if (c0 > p) return;
  const int c1 = min(c0 + split_cols, p + 1);  // past the split's last <= p
  // (the fused launch) this block holds column pw: it stores the new rows
  // there and stages them as the column's slot of its last sub-tile
  bool put = false;
  if constexpr (!kQuant)
    put = k_new != nullptr && pw == p && c1 == p + 1;
  // the split-0 block expects every thread of the other live splits'
  // blocks; the cluster barrier's arrival here and its wait before the
  // push make sure it has started and set its mbarrier up first
  const int n_live = p / split_cols + 1;
  if (s == 0 && tid == 0 && n_live > 1)
    mbar_init(&pushed, kSplitThreads * (n_live - 1));
  cluster_arrive_relaxed();
  const int row_bytes = d * (int)sizeof(S);
  const int tile_bytes = kSubCols * row_bytes;
  char* ring = reinterpret_cast<char*>(dyn_smem);
  const char* kb = reinterpret_cast<const char*>(k);
  const char* vb = reinterpret_cast<const char*>(v);
  // (kQuant) each ring stage's K and V scales, past the rows
  constexpr int kScaleWords = kQuant ? kReadRing * 2 * kSubCols : 0;
  float* scales = reinterpret_cast<float*>(ring + kReadRing * 2 * tile_bytes);
  // (paged) the split's page numbers, from page0 on
  int* pages = reinterpret_cast<int*>(scales + kScaleWords);
  const int page0 = c0 / P;
  if constexpr (kPaged) {
    const int n_pages = (c1 - 1) / P - page0 + 1;
    for (int i = tid; i < n_pages; i += kSplitThreads)
      pages[i] = table[(size_t)b * mp + page0 + i];
    __syncthreads();
  }
  const int n_sub = (c1 - c0 + kSubCols - 1) / kSubCols;
  const int t_put = put ? n_sub - 1 : -1;  // the sub-tile holding pw
  const char* knb = reinterpret_cast<const char*>(k_new);
  const char* vnb = reinterpret_cast<const char*>(v_new);
  // sub-tile t's copies into ring stage t % kReadRing, in the widest unit
  // the rows' bytes divide into (block-uniform), and (kQuant) its
  // columns' scales beside them, in the same commit group; in sub-tile
  // t_put the last column (pw) comes from the new rows, not the cache
  auto stage = [&](int t) {
    const int c = c0 + t * kSubCols;
    const int nc = min(kSubCols, c1 - c);
    const int cached = t == t_put ? nc - 1 : nc;
    char* ks = ring + (t % kReadRing) * 2 * tile_bytes;
    char* vs = ks + tile_bytes;
    with_unit<S>(unit, [&](auto n) {
      constexpr int N = decltype(n)::value;
      if constexpr (kPaged)
        stage_pages<N>(ks, vs, kb, vb, pages, page0, head, h, P, c, cached,
                       row_bytes);
      else
        stage_run<N>(ks, vs, kb, vb, (size_t)r * horizon, c, cached,
                     row_bytes);
      if constexpr (!kQuant) {
        if (t == t_put)
          stage_row<N>(ks + cached * row_bytes, vs + cached * row_bytes,
                       knb + (size_t)r * row_bytes,
                       vnb + (size_t)r * row_bytes, row_bytes);
      }
    });
    if constexpr (kQuant) {
      float* ss = scales + (t % kReadRing) * 2 * kSubCols;
      if constexpr (kPaged)
        stage_scales(ss, k_s, v_s, c, nc, [&](int cc) {
          return ((size_t)pages[cc / P - page0] * h + head) * P + cc % P;
        });
      else
        stage_scales(ss, k_s, v_s, c, nc,
                     [&](int cc) { return (size_t)r * horizon + cc; });
    }
  };
#pragma unroll
  for (int t = 0; t < kReadRing - 1; ++t) {
    if (t < n_sub) stage(t);
    cp_async_commit();
  }
  // q lands while the first copies are in flight
  for (int i = tid; i < DP; i += kSplitThreads)
    qs[i] = i < d ? to_float<T>(q[(size_t)r * d + i]) : 0.f;

  // four lanes score column j of the warp's 8: dims in 16-byte vectors
  // (one-byte rows: kQuantKBytes chunks) qtr, qtr + 4, ... where the rows
  // allow, else dims qtr, qtr + 4, ...
  const int j = warp * kColsPerWarp + (lane >> 2);
  const int qtr = lane & 3;
  const bool vec = row_bytes % (kQuant ? kQuantKBytes : 16) == 0;
  float m = kNeg, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_sub; ++t) {
    if (t + kReadRing - 1 < n_sub) stage(t + kReadRing - 1);
    cp_async_commit();
    cp_async_wait<kReadRing - 1>();  // sub-tile t has landed
    __syncthreads();
    const char* ks = ring + (t % kReadRing) * 2 * tile_bytes;
    const S* kt = reinterpret_cast<const S*>(ks);
    const S* vt = reinterpret_cast<const S*>(ks + tile_bytes);
    const float* kss = scales + (t % kReadRing) * 2 * kSubCols;
    const float* vss = kss + kSubCols;
    const int nc = min(kSubCols, c1 - (c0 + t * kSubCols));
    const bool valid = j < nc;
    float dot = 0.f;
    if (valid) {
      const S* kr = kt + j * d;
      if (vec) {
        if constexpr (kQuant) {
          for (int e0 = qtr * kQuantKBytes; e0 < d; e0 += 4 * kQuantKBytes) {
#pragma unroll
            for (int w = 0; w < kQuantKBytes; w += 4) {
              float x[4];
              load_word<S>(kr + e0 + w, x);
              const float4 qv = *reinterpret_cast<const float4*>(qs + e0 + w);
              dot = __fmaf_rn(qv.x, x[0], dot);
              dot = __fmaf_rn(qv.y, x[1], dot);
              dot = __fmaf_rn(qv.z, x[2], dot);
              dot = __fmaf_rn(qv.w, x[3], dot);
            }
          }
        } else {
          for (int e0 = qtr * VEC; e0 < d; e0 += 4 * VEC) {
            float x[VEC];
            load_vec<S>(kr + e0, x);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot = __fmaf_rn(qs[e0 + e], x[e], dot);
          }
        }
      } else {
        for (int e = qtr; e < d; e += 4)
          dot = __fmaf_rn(qs[e], to_float<S>(kr[e]), dot);
      }
    }
    // the quad's four parts, added in the same order on all four lanes
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    float sc = kNeg;
    if (valid) {
      if constexpr (kQuant)
        sc = dot * kss[j] * scale;
      else
        sc = dot * scale;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float corr = expf(m - m_new);
    const float prob = valid ? expf(sc - m_new) : 0.f;
    l = __fadd_rn(__fmul_rn(corr, l), warp_sum(qtr == 0 ? prob : 0.f));
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] = __fmul_rn(acc[i], corr);
#pragma unroll
    for (int u = 0; u < kColsPerWarp; ++u) {
      const int col = warp * kColsPerWarp + u;
      if (col < nc) {  // warp-uniform: a column past pos adds nothing
        // the weight of the column's V row: its probability, times
        // (kQuant) its V scale
        float pj = __shfl_sync(0xffffffffu, prob, 4 * u);
        if constexpr (kQuant) pj = __fmul_rn(pj, vss[col]);
        const S* vr = vt + col * d;
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          if (lane + 32 * i < d)
            acc[i] = __fmaf_rn(pj, to_float<S>(vr[lane + 32 * i]), acc[i]);
      }
    }
    m = m_new;
    __syncthreads();  // the stage is free for the copy issued next
  }
  // (put) the new rows, from the ring slots the last sub-tile staged them
  // into (no copy is issued after it), into the cache cell of column pw;
  // no block of the launch reads that cell, so the rows' pointers stay
  // read-only for every cell they load
  if constexpr (!kQuant) {
    if (put) {
      size_t cell = (size_t)r * horizon + p;
      if constexpr (kPaged)
        cell = ((size_t)pages[p / P - page0] * h + head) * P + p % P;
      const size_t o = cell * row_bytes;
      const char* slot = ring + (t_put % kReadRing) * 2 * tile_bytes +
                         (p - c0 - t_put * kSubCols) * row_bytes;
      with_unit<S>(unit, [&](auto n) {
        store_row<decltype(n)::value>(const_cast<char*>(kb) + o,
                                      const_cast<char*>(vb) + o, slot,
                                      slot + tile_bytes, row_bytes);
      });
    }
  }

  // the warps merged in warp order (a warp that scored no column holds
  // (kNeg, 0, 0): its factor is 0), and the block's (m, l, acc) pushed
  // into slot s of the split-0 block's arrays
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) wacc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  cluster_wait();
  if (tid < DP) {
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, wm[w]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float f = expf(wm[w] - mx);
      lsum = __fmaf_rn(wl[w], f, lsum);
      o = __fmaf_rn(wacc[w][tid], f, o);
    }
    const auto slot0 = [&](float* x) {
      return s == 0 ? x : cluster.map_shared_rank(x, 0);
    };
    *slot0(&pacc[s][tid]) = o;
    if (tid == 0) {
      *slot0(&pm[s]) = mx;
      *slot0(&pl[s]) = lsum;
    }
  }
  if (s != 0) {
    mbar_arrive_remote(&pushed, 0);
    return;
  }

  // the split-0 block: the live splits merged in split order
  __syncthreads();
  if (n_live > 1) mbar_wait_phase0(&pushed);
  if (tid < d) {
    float mx = kNeg;
    for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, pm[i]);
    float lsum = 0.f, o = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float f = expf(pm[i] - mx);
      lsum = __fmaf_rn(pl[i], f, lsum);
      o = __fmaf_rn(pacc[i][tid], f, o);
    }
    out[(size_t)r * d + tid] = from_float<T>(o / fmaxf(lsum, 1e-30f));
  }
}

template <typename U>
cudaError_t launch_write_cols_unit(const void* k_new, const void* v_new,
                                   void* k_dst, void* v_dst, const void* pos,
                                   const void* table, int b, int h, int T,
                                   int P, int mp, int row_bytes, int smax,
                                   bool clamp, cudaStream_t stream) {
  const ColumnDst dst{static_cast<const int*>(table), h, P, mp,
                      row_bytes / (int)sizeof(U)};
  write_columns_kernel<U><<<dim3(b, T), kWriteThreads, 0, stream>>>(
      static_cast<const U*>(k_new), static_cast<const U*>(v_new),
      static_cast<U*>(k_dst), static_cast<U*>(v_dst),
      static_cast<const int*>(pos), dst, T, smax, clamp);
  return cudaGetLastError();
}

// the widest copy unit the head row's bytes divide into
cudaError_t launch_write_cols(const void* k_new, const void* v_new,
                              void* k_dst, void* v_dst, const void* pos,
                              const void* table, int b, int h, int T, int P,
                              int mp, int d, int dtype, int smax, bool clamp,
                              cudaStream_t stream) {
  return with_dtype(dtype, [&](auto tag) {
    const int row_bytes = d * (int)sizeof(typename decltype(tag)::type);
    if (row_bytes % 16 == 0)
      return launch_write_cols_unit<uint4>(k_new, v_new, k_dst, v_dst, pos,
                                           table, b, h, T, P, mp, row_bytes,
                                           smax, clamp, stream);
    if (row_bytes % 4 == 0)
      return launch_write_cols_unit<uint32_t>(k_new, v_new, k_dst, v_dst,
                                              pos, table, b, h, T, P, mp,
                                              row_bytes, smax, clamp,
                                              stream);
    return launch_write_cols_unit<uint16_t>(k_new, v_new, k_dst, v_dst, pos,
                                            table, b, h, T, P, mp, row_bytes,
                                            smax, clamp, stream);
  });
}

// one launch of the split read: n_splits x n_rows blocks, each row's
// n_splits blocks one cluster, with `smem` bytes of dynamic shared memory
template <typename T, typename S, int DP, bool kPaged>
cudaError_t launch_read_split(const void* q, const void* k, const void* k_s,
                              const void* v, const void* v_s,
                              const void* k_new, const void* v_new,
                              const void* table, const void* pos, void* out,
                              int n_rows, int h, int horizon, int P, int mp,
                              int d, float scale, int split_cols,
                              int n_splits, int unit, size_t smem,
                              cudaStream_t stream) {
  auto kernel = decode_read_split_kernel<T, S, DP, kPaged>;
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
      &cfg, kernel, static_cast<const T*>(q), static_cast<const S*>(k),
      static_cast<const float*>(k_s), static_cast<const S*>(v),
      static_cast<const float*>(v_s), static_cast<const S*>(k_new),
      static_cast<const S*>(v_new), static_cast<const int*>(table),
      static_cast<const int*>(pos), static_cast<T*>(out), h, horizon, P, mp,
      d, scale, split_cols, n_splits, unit);
  const cudaError_t last = cudaGetLastError();  // clears what it left
  return err != cudaSuccess ? err : last;
}

// the split read over rows stored as S, for q's T and the padded width
// (k_new/v_new: the fused launch, or null)
template <typename T, typename S>
cudaError_t launch_read(const void* q, const void* k, const void* k_s,
                        const void* v, const void* v_s, const void* k_new,
                        const void* v_new, const void* table,
                        const void* pos, void* out, int b, int h,
                        int horizon, int P, int mp, int d, float scale,
                        int split_cols, int n_splits, cudaStream_t stream) {
  return with_padded_dim(d, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    const int row_bytes = d * (int)sizeof(S);
    // the widest unit a row's bytes divide into (16: cp.async.cg)
    const int unit = row_bytes % 16 == 0  ? 16
                     : row_bytes % 8 == 0 ? 8
                     : row_bytes % 4 == 0 ? 4
                     : row_bytes % 2 == 0 ? 2
                                          : 1;
    size_t smem = (size_t)kReadRing * 2 * kSubCols * row_bytes;
    if (kQuantRows<S>) smem += sizeof(float) * kReadRing * 2 * kSubCols;
    if (table == nullptr)
      return launch_read_split<T, S, DP, false>(
          q, k, k_s, v, v_s, k_new, v_new, nullptr, pos, out, b * h, h,
          horizon, 1, 1, d, scale, split_cols, n_splits, unit, smem, stream);
    smem += sizeof(int) * ((split_cols + P - 1) / P + 1);
    return launch_read_split<T, S, DP, true>(
        q, k, k_s, v, v_s, k_new, v_new, table, pos, out, b * h, h, horizon,
        P, mp, d, scale, split_cols, n_splits, unit, smem, stream);
  });
}

// the storage code of the plain reads: rows in q's dtype, no scales
constexpr int kRowsAsQ = -1;

// the four reads: table == nullptr is the contiguous cache [b, h,
// horizon, d], otherwise the pools [num_pages, h, P, d] under table [b,
// mp] (horizon mp * P); kind kRowsAsQ stores the rows as q's dtype,
// kInt8 or kFp8 as int8 or fp8 e4m3 with fp32 scale planes k_s/v_s
// beside them ([b, h, horizon] or [num_pages, h, P]); the horizon in
// n_splits splits of split_cols columns (a multiple of kSubCols, the
// last split holding the horizon's last column); k_new/v_new [b, h, d]
// (kind kRowsAsQ only; null: read only) make it the fused launch, which
// also stores them into column pos[b]
cudaError_t launch_attn(const void* q, const void* k, const void* k_s,
                        const void* v, const void* v_s, const void* k_new,
                        const void* v_new, const void* table,
                        const void* pos, void* out, int b, int h,
                        int horizon, int P, int mp, int d, float scale,
                        int dtype, int kind, int split_cols, int n_splits,
                        cudaStream_t stream) {
  if (split_cols <= 0 || split_cols % kSubCols != 0 || n_splits < 1 ||
      n_splits > kMaxSplits ||
      (long long)n_splits * split_cols < horizon ||
      (long long)(n_splits - 1) * split_cols >= horizon)
    return cudaErrorInvalidValue;
  return with_dtype(dtype, [&](auto t_tag) {
    using T = typename decltype(t_tag)::type;
    if (kind == kRowsAsQ)
      return launch_read<T, T>(q, k, nullptr, v, nullptr, k_new, v_new,
                               table, pos, out, b, h, horizon, P, mp, d,
                               scale, split_cols, n_splits, stream);
    return with_kind(kind, [&](auto s_tag) {
      using S = typename decltype(s_tag)::type;
      return launch_read<T, S>(q, k, k_s, v, v_s, nullptr, nullptr, table,
                               pos, out, b, h, horizon, P, mp, d, scale,
                               split_cols, n_splits, stream);
    });
  });
}

// the input rows' dtype times the storage kind
cudaError_t launch_write_quant(const void* k_new, const void* v_new,
                               void* k_q, void* k_s, void* v_q, void* v_s,
                               const void* pos, const void* table, int b,
                               int h, int T, int P, int mp, int d, int dtype,
                               int kind, int smax, bool clamp,
                               cudaStream_t stream) {
  return with_dtype(dtype, [&](auto in_tag) {
    using In = typename decltype(in_tag)::type;
    return with_kind(kind, [&](auto q_tag) {
      using Q = typename decltype(q_tag)::type;
      const ColumnDst dst{static_cast<const int*>(table), h, P, mp, d};
      // the unit, its count a row, the group of lanes a row (the units
      // rounded up to a power of two, at most a warp) and the row groups
      const int row_bytes = d * (int)sizeof(In);
      const int unit = row_bytes % 16 == 0  ? 16
                       : row_bytes % 8 == 0 ? 8
                       : row_bytes % 4 == 0 ? 4
                                            : 2;
      const int units = row_bytes / unit;
      int group_log2 = 0;
      while ((1 << group_log2) < units && group_log2 < 5) ++group_log2;
      const int rpb = kQuantWriteThreads >> group_log2;
      const dim3 grid(b, T, (2 * h + rpb - 1) / rpb);
      auto run = [&](auto u_tag) -> cudaError_t {
        using U = typename decltype(u_tag)::type;
        if constexpr (sizeof(U) < sizeof(In)) {
          return cudaErrorInvalidValue;
        } else {
          write_columns_quant_kernel<In, Q, U>
              <<<grid, kQuantWriteThreads, 0, stream>>>(
                  static_cast<const In*>(k_new),
                  static_cast<const In*>(v_new), static_cast<Q*>(k_q),
                  static_cast<float*>(k_s), static_cast<Q*>(v_q),
                  static_cast<float*>(v_s), static_cast<const int*>(pos),
                  dst, T, smax, clamp, group_log2);
          return cudaGetLastError();
        }
      };
      switch (unit) {
        case 16: return run(Tag<uint4>{});
        case 8: return run(Tag<uint2>{});
        case 4: return run(Tag<uint32_t>{});
        default: return run(Tag<uint16_t>{});
      }
    });
  });
}

}  // namespace
}  // namespace apex_tpu_torch

using namespace apex_tpu_torch;

// k_cache/v_cache [b, h, S, d] gain k_new/v_new [b, h, d] at column
// pos[b] (int32 [b], device), in place.
extern "C" int apex_tpu_torch_decode_write_column(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* pos, int b, int h, int S, int d, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || d <= 0) return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_cache, v_cache, pos, nullptr, b,
                           h, 1, S, 1, d, dtype, S, false,
                           static_cast<cudaStream_t>(stream));
}

// k_cache/v_cache [b, h, S, d] gain k_new/v_new [b, h, T, d] at columns
// pos[b] + j, lanes past the horizon clamped onto column S - 1, in place.
extern "C" int apex_tpu_torch_cache_write_columns(
    const void* k_new, const void* v_new, void* k_cache, void* v_cache,
    const void* pos, int b, int h, int T, int S, int d, int dtype,
    void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || S <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_cache, v_cache, pos, nullptr, b,
                           h, T, S, 1, d, dtype, S, true,
                           static_cast<cudaStream_t>(stream));
}

// the pools [num_pages, h, P, d] gain k_new/v_new [b, h, d] at logical
// column pos[b] of row b's table [b, mp]: page table[b, pos / P], offset
// pos % P, in place.
extern "C" int apex_tpu_torch_paged_write_column(
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const void* table, const void* pos, int b, int h, int P, int mp, int d,
    int dtype, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_pool, v_pool, pos, table, b, h, 1,
                           P, mp, d, dtype, mp * P, false,
                           static_cast<cudaStream_t>(stream));
}

// the pools gain k_new/v_new [b, h, T, d] at logical columns pos[b] + j,
// lanes past the horizon mp * P clamped onto its last column, in place.
extern "C" int apex_tpu_torch_paged_write_columns(
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    const void* table, const void* pos, int b, int h, int T, int P, int mp,
    int d, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_cols(k_new, v_new, k_pool, v_pool, pos, table, b, h, T,
                           P, mp, d, dtype, mp * P, true,
                           static_cast<cudaStream_t>(stream));
}

// out [b, h, d] = softmax(scale * q . K[:, :pos+1]) . V[:, :pos+1] per
// (batch, head) row over caches [b, h, S, d], 1 <= d <= 128, the horizon
// S read in n_splits splits of split_cols columns (read_splits(S, d)).
extern "C" int apex_tpu_torch_decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* pos,
    void* out, int b, int h, int S, int d, float scale, int dtype,
    int split_cols, int n_splits, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0) return cudaErrorInvalidValue;
  return launch_attn(q, k_cache, nullptr, v_cache, nullptr, nullptr, nullptr,
                     nullptr, pos, out, b, h, S, 1, 1, d, scale, dtype,
                     kRowsAsQ, split_cols, n_splits,
                     static_cast<cudaStream_t>(stream));
}

// The same read through row b's table [b, mp] over the pools
// [num_pages, h, P, d]: logical column c is page table[b, c / P], offset
// c % P; the horizon mp * P in splits of read_splits(mp * P, d).
extern "C" int apex_tpu_torch_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* pos, void* out, int b, int h, int P, int mp, int d,
    float scale, int dtype, int split_cols, int n_splits, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0) return cudaErrorInvalidValue;
  return launch_attn(q, k_pool, nullptr, v_pool, nullptr, nullptr, nullptr,
                     table, pos, out, b, h, mp * P, P, mp, d, scale, dtype,
                     kRowsAsQ, split_cols, n_splits,
                     static_cast<cudaStream_t>(stream));
}

// The decode step's write and read of one layer in ONE launch: k_new/v_new
// [b, h, d] land in column pos[b] of k_cache/v_cache [b, h, S, d] in place
// (a position outside [0, S) is not written) and out [b, h, d] attends
// over columns 0..pos[b], the new column scored from k_new/v_new:
// apex_tpu_torch_decode_write_column then apex_tpu_torch_decode_attention,
// caches and out bit for bit.
extern "C" int apex_tpu_torch_decode_attention_write(
    const void* q, const void* k_new, const void* v_new, void* k_cache,
    void* v_cache, const void* pos, void* out, int b, int h, int S, int d,
    float scale, int dtype, int split_cols, int n_splits, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || k_new == nullptr || v_new == nullptr)
    return cudaErrorInvalidValue;
  return launch_attn(q, k_cache, nullptr, v_cache, nullptr, k_new, v_new,
                     nullptr, pos, out, b, h, S, 1, 1, d, scale, dtype,
                     kRowsAsQ, split_cols, n_splits,
                     static_cast<cudaStream_t>(stream));
}

// The same through row b's table [b, mp] over the pools [num_pages, h, P,
// d]: the new rows land at page table[b, pos / P], offset pos % P (a
// position outside [0, mp * P) is not written), as
// apex_tpu_torch_paged_write_column then apex_tpu_torch_paged_attention.
extern "C" int apex_tpu_torch_paged_attention_write(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* table, const void* pos, void* out, int b,
    int h, int P, int mp, int d, float scale, int dtype, int split_cols,
    int n_splits, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || k_new == nullptr ||
      v_new == nullptr)
    return cudaErrorInvalidValue;
  return launch_attn(q, k_pool, nullptr, v_pool, nullptr, k_new, v_new,
                     table, pos, out, b, h, mp * P, P, mp, d, scale, dtype,
                     kRowsAsQ, split_cols, n_splits,
                     static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// the quantized cache: data planes int8 or fp8 e4m3 (kind) beside fp32
// scale planes; the new rows (and q) are fp32, bf16 or fp16 (dtype)
// ---------------------------------------------------------------------------

// k_q/v_q [b, h, S, d] and k_s/v_s [b, h, S] gain k_new/v_new [b, h, d]
// quantized at column pos[b], in place.
extern "C" int apex_tpu_torch_decode_write_column_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* pos, int b, int h, int S, int d, int dtype,
    int kind, void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || d <= 0) return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, nullptr,
                            b, h, 1, S, 1, d, dtype, kind, S, false,
                            static_cast<cudaStream_t>(stream));
}

// ... k_new/v_new [b, h, T, d] at columns pos[b] + j, lanes past the
// horizon clamped onto column S - 1, in place.
extern "C" int apex_tpu_torch_cache_write_columns_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* pos, int b, int h, int T, int S, int d, int dtype,
    int kind, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || S <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, nullptr,
                            b, h, T, S, 1, d, dtype, kind, S, true,
                            static_cast<cudaStream_t>(stream));
}

// the pools [num_pages, h, P, d] / [num_pages, h, P] gain k_new/v_new
// [b, h, d] quantized at logical column pos[b] of row b's table [b, mp].
extern "C" int apex_tpu_torch_paged_write_column_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* table, const void* pos, int b, int h, int P,
    int mp, int d, int dtype, int kind, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, table, b,
                            h, 1, P, mp, d, dtype, kind, mp * P, false,
                            static_cast<cudaStream_t>(stream));
}

// ... k_new/v_new [b, h, T, d] at logical columns pos[b] + j, lanes past
// the horizon mp * P clamped onto its last column, in place.
extern "C" int apex_tpu_torch_paged_write_columns_quant(
    const void* k_new, const void* v_new, void* k_q, void* k_s, void* v_q,
    void* v_s, const void* table, const void* pos, int b, int h, int T,
    int P, int mp, int d, int dtype, int kind, void* stream) {
  if (b <= 0 || h <= 0 || T <= 0 || P <= 0 || mp <= 0 || d <= 0)
    return cudaErrorInvalidValue;
  return launch_write_quant(k_new, v_new, k_q, k_s, v_q, v_s, pos, table, b,
                            h, T, P, mp, d, dtype, kind, mp * P, true,
                            static_cast<cudaStream_t>(stream));
}

// out [b, h, d]: q attends over columns 0..pos[b] of the quantized cache
// k_q/v_q [b, h, S, d] with scales k_s/v_s [b, h, S], 1 <= d <= 128, the
// horizon S read in n_splits splits of split_cols columns, as the plain
// read: read_splits(S, d).
extern "C" int apex_tpu_torch_decode_attention_quant(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* pos, void* out, int b, int h, int S, int d,
    float scale, int dtype, int kind, int split_cols, int n_splits,
    void* stream) {
  if (b <= 0 || h <= 0 || S <= 0 || kind == kRowsAsQ)
    return cudaErrorInvalidValue;
  return launch_attn(q, k_q, k_s, v_q, v_s, nullptr, nullptr, nullptr, pos,
                     out, b, h, S, 1, 1, d, scale, dtype, kind, split_cols,
                     n_splits, static_cast<cudaStream_t>(stream));
}

// The same read through row b's table [b, mp] over the quantized pools
// [num_pages, h, P, d] / [num_pages, h, P]: the horizon mp * P in splits
// of read_splits(mp * P, d).
extern "C" int apex_tpu_torch_paged_attention_quant(
    const void* q, const void* k_q, const void* k_s, const void* v_q,
    const void* v_s, const void* table, const void* pos, void* out, int b,
    int h, int P, int mp, int d, float scale, int dtype, int kind,
    int split_cols, int n_splits, void* stream) {
  if (b <= 0 || h <= 0 || P <= 0 || mp <= 0 || kind == kRowsAsQ)
    return cudaErrorInvalidValue;
  return launch_attn(q, k_q, k_s, v_q, v_s, nullptr, nullptr, table, pos,
                     out, b, h, mp * P, P, mp, d, scale, dtype, kind,
                     split_cols, n_splits, static_cast<cudaStream_t>(stream));
}

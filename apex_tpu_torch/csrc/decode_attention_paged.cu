// The split reads over the paged pools (rows 17 and 18, row 13 folded
// into 17): decode_attention.cu's read instantiated for the pools, in a
// source of its own so that nvcc compiles it beside the contiguous reads.
#define APEX_TPU_TORCH_PAGED_READS
#include "decode_attention.cu"

namespace apex_tpu_torch {

cudaError_t launch_read_paged(const void* q, const void* k, const void* k_s,
                              const void* v, const void* v_s,
                              const void* k_new, const void* v_new,
                              const void* table, const void* pos, void* out,
                              int b, int h, int horizon, int P, int mp,
                              int d, float scale, int dtype, int kind,
                              int split_cols, int n_splits,
                              cudaStream_t stream) {
  return launch_read_layout<true>(q, k, k_s, v, v_s, k_new, v_new, table,
                                  pos, out, b, h, horizon, P, mp, d, scale,
                                  dtype, kind, split_cols, n_splits, stream);
}

}  // namespace apex_tpu_torch

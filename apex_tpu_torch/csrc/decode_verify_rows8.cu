// The speculative verify's launch for one layout and row bound, built from
// decode_verify.cu in a source of its own so that nvcc compiles it beside
// the other three (see verify_contiguous_short there).
#define APEX_TPU_TORCH_VERIFY_PART
#include "decode_verify.cu"

namespace apex_tpu_torch {

cudaError_t verify_contiguous_max(const VerifyArgs& a) {
  return launch_verify_rows<false, kVerifyMaxRows>(a);
}

}  // namespace apex_tpu_torch

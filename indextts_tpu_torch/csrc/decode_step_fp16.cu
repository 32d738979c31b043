// The E = fp16 instantiations of the persistent decode step (K1's four
// variants and K6 co-located; decode_step.cuh), compiled apart from
// decode_step.cu so that nvcc builds the two halves in parallel.

#include "decode_step.cuh"

namespace dstep {

cudaError_t occupancy_fp16(bool w4, bool kvq, bool tp, int nt, int cluster, int smem,
                           int* clusters) {
  return variant_occupancy<attn_tma::f16>(w4, kvq, tp, nt, cluster, smem, clusters);
}

cudaError_t run_fp16(bool w4, bool kvq, bool tp, const Args& a, cudaStream_t s) {
  return variant_run<attn_tma::f16>(w4, kvq, tp, a, s);
}

}  // namespace dstep

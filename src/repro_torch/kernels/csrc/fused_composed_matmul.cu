// fused_composed_matmul: the fused composed wide (12/16-bit) datapath on
// float operands.  W-bit codes split into base-256 digits; each product
// is four tile-LUT lookups reduced by the shift/add tree named by the
// runtime code (kind, k) (registry.composed_reduce_dyn), truncated to
// the 2W-bit mask, and accumulated as two exact int32 limbs:
//
//   lo[m, n] = sum_k (p & 0xFFFF),  hi[m, n] = sum_k (p >> 16),
//   row[m] = sum_k qa[m, k],  col[n] = sum_k qw[k, n]
//
// (mask 0 marks a narrow lane: lo = sum_k LUT[qa & 255, qw & 255],
// hi = 0).  The caller recombines lo + 65536 * hi in f32 and applies the
// zero-point correction and dequant.
//
// Replaces the TPU kernel fused_composed_matmul_pallas
// (src/repro/kernels/fused_matmul.py:539, pallas_call at :556), which
// runs 4-wide K chunks of digit cubes and subtracts the K pad's limb
// contribution (_pad_limbs_dyn) on the last step.
//
// Bound on an H100: integer ops (14 a loa4 product) ahead of its four
// shared-memory lookups.  Design in fused_gather.cuh;
// the masked ragged K edge needs no pad-limb correction, and every
// shift of the tree is kept below 32 bits.
// out is one allocation: lo (M*N), hi (M*N), row (M), col
// (N), int32 (where K is split, one memset zeroes it).
#include "fused_gather.cuh"

extern "C" int fused_composed_matmul_launch(const float* x, const float* w,
                                            const uint16_t* lut,
                                            const unsigned* mask,
                                            const int* rcode,
                                            fusedmm::Scalars sc, int* out,
                                            int M, int K, int N, int grid,
                                            void* stream) {
  return fusedmm::launch_quant<true>(x, 0, w, lut, sc, mask, rcode, out, 1,
                                     M, K, N, grid,
                                     static_cast<cudaStream_t>(stream));
}

// The expert form: x (slices, M, K), w (experts, K, N); slice s
// quantized with the scalars at s against w[s % experts] -> out: lo, hi
// (slices M N each), row (slices M), col (slices N).
extern "C" int fused_composed_matmul_experts_launch(
    const float* x, const float* w, const uint16_t* lut,
    const unsigned* mask, const int* rcode, fusedmm::Scalars sc, int* out,
    int slices, int experts, int M, int K, int N, int grid, void* stream) {
  return fusedmm::launch_quant<true>(x, 0, w, lut, sc, mask, rcode, out, 1,
                                     M, K, N, grid,
                                     static_cast<cudaStream_t>(stream),
                                     slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

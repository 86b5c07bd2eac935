// composed_matmul: the two-step composed wide (12/16-bit) LUT matmul on
// int32 W-bit codes.  Codes split into base-256 digits; each product is
// four tile-LUT lookups reduced by the shift/add tree of the entry's
// (static) reduce, passed as its runtime code (kind, k) — the same values
// (registry.composed_reduce_dyn) — truncated to the 2W-bit mask, and
// accumulated as two exact int32 limbs:
//
//   lo[m, n] = sum_k (p & 0xFFFF),  hi[m, n] = sum_k (p >> 16)
//
// (mask 0 marks a narrow lane: lo = sum_k LUT[qa & 255, qw & 255],
// hi = 0).  The caller recombines lo + 65536 * hi in f32.
//
// Replaces the TPU kernel composed_matmul_pallas
// (src/repro/kernels/composed_matmul.py:118, pallas_call at :136), which
// pads M, N and K to its blocks, builds four (BM, 8, BN) digit cubes per
// K chunk in VMEM and subtracts the K pad's limbs afterwards
// (_pad_limbs).
//
// Bound on an H100: integer ops (four table addresses, the tree, the mask
// and two limb sums: 14 a loa4 product) ahead of its four shared-memory
// lookups; the int32 codes are as wide as the f32 operands K7 reads.  The body is K7's (fused_gather.cuh,
// instantiated on int codes: staged as they are, no code sums); the
// masked ragged K edge needs no pad-limb correction, and every shift of
// the tree is kept below 32 bits.
#include "fused_gather.cuh"

extern "C" int composed_matmul_launch(const int* qa, const int* qw,
                                      const uint16_t* lut,
                                      const unsigned* mask,
                                      const int* rcode, int* lo, int* hi,
                                      int M, int K, int N, int grid,
                                      void* stream) {
  return fusedmm::launch_codes<true>(qa, 0, qw, 0, lut, mask, rcode, lo,
                                     hi, 1, M, K, N, grid,
                                     static_cast<cudaStream_t>(stream));
}

// The expert form: qa (slices, M, K), qw (experts, K, N); slice s against
// qw[s % experts] under the one table, mask and reduce code -> lo, hi
// (slices, M, N).
extern "C" int composed_matmul_experts_launch(
    const int* qa, const int* qw, const uint16_t* lut, const unsigned* mask,
    const int* rcode, int* lo, int* hi, int slices, int experts, int M,
    int K, int N, int grid, void* stream) {
  return fusedmm::launch_codes<true>(qa, 0, qw, 0, lut, mask, rcode, lo,
                                     hi, 1, M, K, N, grid,
                                     static_cast<cudaStream_t>(stream),
                                     slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

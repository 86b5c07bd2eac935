// lut_matmul: bit-true LUT-gather approximate matmul on 8-bit codes,
//
//   out[m, n] = sum_k LUT[qa[m, k], qw[k, n]]        (exact int32)
//
// Replaces the TPU kernel approx_matmul_lut_pallas
// (src/repro/kernels/approx_matmul.py:55, pallas_call at :69), which
// pins the int32 table in VMEM, pads M/N/K to 128 and subtracts the
// K-pad's pk * LUT[0,0] afterwards.
//
// Bound on an H100: shared-memory gather throughput, one table lookup
// per multiply (no tensor cores).  The body is K3's (fused_gather.cuh,
// instantiated on int codes: staged as they are, no quantize, no code
// sums): the swizzled uint16 table in shared memory, persistent blocks,
// the N tile sized to the real N, masked ragged edges instead of padding,
// and K split into ranges where one lane's tiles leave SMs idle (the
// deep layers: 64 tiles for 132 SMs).
#include "fused_gather.cuh"

extern "C" int lut_matmul_launch(const int* qa, const int* qw,
                                 const uint16_t* lut, int* out, int M,
                                 int K, int N, int grid, void* stream) {
  return fusedmm::launch_codes<false>(qa, 0, qw, 0, lut, nullptr, nullptr,
                                      out, nullptr, 1, M, K, N, grid,
                                      static_cast<cudaStream_t>(stream));
}

// The expert form (one launch for an MoE projection's experts, the
// reference's pallas_call batched over them): qa (slices, M, K), qw
// (experts, K, N), slice s against qw[s % experts] -> out (slices, M, N).
extern "C" int lut_matmul_experts_launch(const int* qa, const int* qw,
                                         const uint16_t* lut, int* out,
                                         int slices, int experts, int M,
                                         int K, int N, int grid,
                                         void* stream) {
  return fusedmm::launch_codes<false>(qa, 0, qw, 0, lut, nullptr, nullptr,
                                      out, nullptr, 1, M, K, N, grid,
                                      static_cast<cudaStream_t>(stream),
                                      slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

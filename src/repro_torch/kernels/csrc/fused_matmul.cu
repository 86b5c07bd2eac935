// fused_matmul: the fused 8-bit datapath on float operands,
//
//   qa = quant(x; sa, za), qw = quant(w; sw, zw)      (in the kernel)
//   acc[m, n] = sum_k LUT[qa[m, k], qw[k, n]],  row[m] = sum_k qa[m, k],
//   col[n] = sum_k qw[k, n]                            (exact int32)
//
// with the scalars read from device memory through their own pointers
// (the calibration's tensors as they are) or passed by value
// (fusedmm::Scalars).  The caller applies the f32 zero-point correction
// and dequant.
//
// Replaces the TPU kernel fused_matmul_pallas
// (src/repro/kernels/fused_matmul.py:446, pallas_call at :461), which
// quantizes each VMEM tile in registers, masks the K pad and subtracts
// pk * LUT[0,0] on the last K step.
//
// Bound on an H100: shared-memory gather throughput, one table lookup
// per product (no tensor cores); see fused_gather.cuh for the design
// (quant8_kernel: uint16 table in shared memory, persistent blocks, two
// byte-code buffers, every thread issuing chunk c + 1's loads before it
// gathers chunk c and quantizing them after, one barrier a chunk; code
// sums made where the codes are; masked ragged edges instead of
// padding).
// out is one allocation: acc (M*N), then row (M), then col (N), int32
// (where K is split, one memset zeroes it).
#include "fused_gather.cuh"

extern "C" int fused_matmul_launch(const float* x, const float* w,
                                   const uint16_t* lut, fusedmm::Scalars sc,
                                   int* out, int M, int K, int N, int grid,
                                   void* stream) {
  return fusedmm::launch_quant<false>(x, 0, w, lut, sc, nullptr, nullptr,
                                      out, 1, M, K, N, grid,
                                      static_cast<cudaStream_t>(stream));
}

// The expert form: x (slices, M, K), w (experts, K, N), slice s
// quantized with its own scalars (sc read at s) against w[s % experts]
// -> out: acc (slices M N), row (slices M), col (slices N).
extern "C" int fused_matmul_experts_launch(const float* x, const float* w,
                                           const uint16_t* lut,
                                           fusedmm::Scalars sc, int* out,
                                           int slices, int experts, int M,
                                           int K, int N, int grid,
                                           void* stream) {
  return fusedmm::launch_quant<false>(x, 0, w, lut, sc, nullptr, nullptr,
                                      out, 1, M, K, N, grid,
                                      static_cast<cudaStream_t>(stream),
                                      slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

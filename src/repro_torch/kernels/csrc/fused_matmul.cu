// fused_matmul: the fused 8-bit datapath on float operands,
//
//   qa = quant(x; sa, za), qw = quant(w; sw, zw)      (in the kernel)
//   acc[m, n] = sum_k LUT[qa[m, k], qw[k, n]],  row[m] = sum_k qa[m, k],
//   col[n] = sum_k qw[k, n]                            (exact int32)
//
// with the scalars read from device memory (fp = sa, sw, qmax; ip = za,
// zw).  The caller applies the f32 zero-point correction and dequant.
//
// Replaces the TPU kernel fused_matmul_pallas
// (src/repro/kernels/fused_matmul.py:446, pallas_call at :461), which
// quantizes each VMEM tile in registers, masks the K pad and subtracts
// pk * LUT[0,0] on the last K step.
//
// Bound on an H100: shared-memory gather throughput, one table lookup
// per product (no tensor cores); see fused_gather.cuh for the design
// (uint16 table in shared memory, persistent blocks, quantize while
// staging each K chunk, masked ragged edges instead of padding).
#include "fused_gather.cuh"

extern "C" int fused_matmul_launch(const float* x, const float* w,
                                   const uint16_t* lut, const float* fp,
                                   const int* ip, int* acc, int* row,
                                   int* col, int M, int K, int N, int grid,
                                   void* stream) {
  return fusedmm::launch<false>(x, 0, w, 0, lut, fp, ip, nullptr, nullptr,
                                acc, nullptr, row, col, 1, M, K, N, grid,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

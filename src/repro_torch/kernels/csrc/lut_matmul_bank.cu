// lut_matmul_bank: the LUT-gather approximate matmul for a whole bank
// of n product tables in one launch,
//
//   out[l, m, n] = sum_k LUT_l[qa_l[m, k], qw[k, n]]  (exact int32)
//
// with qa shared by every lane (M, K) (lane stride 0) or banked
// (n, M, K), and qw shared (K, N).
//
// Replaces the TPU kernel approx_matmul_lut_bank_pallas
// (src/repro/kernels/lut_bank.py:63, pallas_call at :91), whose grid
// puts the multiplier axis first with one VMEM-pinned table per
// program and subtracts a per-lane K-pad correction.
//
// Bound on an H100: shared-memory gather throughput, one table lookup
// per multiply (no tensor cores).  The body is K4's (fused_gather.cuh on
// int codes): its persistent blocks walk contiguous (lane, tile) ranges,
// so each block stages the swizzled uint16 table of the lane it works on
// once, not per tile.
#include "fused_gather.cuh"

extern "C" int lut_matmul_bank_launch(const int* qa,
                                      long long qa_lane_stride,
                                      const int* qw, const uint16_t* luts,
                                      int* out, int n_lanes, int M, int K,
                                      int N, int grid, void* stream) {
  return fusedmm::launch_codes<false>(qa, qa_lane_stride, qw, 0, luts,
                                      nullptr, nullptr, out, nullptr,
                                      n_lanes, M, K, N, grid,
                                      static_cast<cudaStream_t>(stream));
}

// The expert form: qa (slices, M, K) shared (lane stride 0) or
// (n, slices, M, K) banked, qw (experts, K, N); lane l's slice s against
// qw[s % experts] under luts[l] -> out (n, slices, M, N), pairs walked
// lane-major, slice-minor (one table staged a lane per block).
extern "C" int lut_matmul_bank_experts_launch(
    const int* qa, long long qa_lane_stride, const int* qw,
    const uint16_t* luts, int* out, int n_lanes, int slices, int experts,
    int M, int K, int N, int grid, void* stream) {
  return fusedmm::launch_codes<false>(qa, qa_lane_stride, qw, 0, luts,
                                      nullptr, nullptr, out, nullptr,
                                      n_lanes, M, K, N, grid,
                                      static_cast<cudaStream_t>(stream),
                                      slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// composed_matmul_bank: the two-step composed matmul on codes for a bank
// of n tile LUTs in one launch.  Per lane l: its table, its 2W-bit mask
// masks[l] (0 = narrow lane: the plain tile sum of the low digits) and
// the bank's one reduce tree as the runtime code rcodes[l] = (kind, k);
// outputs the limbs lo, hi (n, M, N).  qa is shared (lane stride 0) or
// banked (n, M, K); qw is shared (K, N) or banked (n, K, N): a bank mixing
// operand widths quantizes the weights per lane.
//
// Replaces the TPU kernel composed_matmul_bank_pallas
// (src/repro/kernels/composed_matmul.py:158, pallas_call at :190), whose
// grid walks the multiplier axis with one VMEM-pinned tile LUT per
// program and one static tree for every lane.
//
// Bound on an H100: integer ops on wide lanes (14 a loa4 product against
// four lookups), lookups on narrow ones.  The persistent blocks of
// fused_gather.cuh split the lanes' items by cost and stage each lane's
// table once; the lane's mask and tree are uniform across a block, so
// its inner loop never diverges within a warp.
#include "fused_gather.cuh"

extern "C" int composed_matmul_bank_launch(
    const int* qa, long long qa_lane_stride, const int* qw,
    long long qw_lane_stride, const uint16_t* luts, const unsigned* masks,
    const int* rcodes, int* lo, int* hi, int n_lanes, int M, int K, int N,
    int grid, void* stream) {
  return fusedmm::launch_codes<true>(qa, qa_lane_stride, qw,
                                     qw_lane_stride, luts, masks, rcodes,
                                     lo, hi, n_lanes, M, K, N, grid,
                                     static_cast<cudaStream_t>(stream));
}

// The expert form: qa (slices, M, K) shared (lane stride 0) or (n,
// slices, M, K) banked, qw (experts, K, N) shared or (n, experts, K, N)
// banked; lane l's slice s against its qw[s % experts] under luts[l],
// masks[l] and rcodes[l] -> lo, hi (n, slices, M, N), pairs walked
// lane-major (one table staged a lane per block).
extern "C" int composed_matmul_bank_experts_launch(
    const int* qa, long long qa_lane_stride, const int* qw,
    long long qw_lane_stride, const uint16_t* luts, const unsigned* masks,
    const int* rcodes, int* lo, int* hi, int n_lanes, int slices,
    int experts, int M, int K, int N, int grid, void* stream) {
  return fusedmm::launch_codes<true>(qa, qa_lane_stride, qw,
                                     qw_lane_stride, luts, masks, rcodes,
                                     lo, hi, n_lanes, M, K, N, grid,
                                     static_cast<cudaStream_t>(stream),
                                     slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// fused_composed_matmul_bank: the fused composed datapath for a bank
// that mixes operand widths (8, 12, 16 bits; mask 0 = narrow lane) and
// reduction trees, in one launch.  Per lane l: its table (a tile LUT),
// quantization scalars (sa, za, sw, zw, qmax: fusedmm::Scalars), 2W-bit
// mask masks[l] and reduce code rcodes[l] = (kind, k); outputs the
// limbs lo, hi (n, M, N) and the code sums row (n, M), col (n, N).
// x is shared (lane stride 0, re-quantized per lane) or banked.
//
// Replaces the TPU kernel fused_composed_matmul_bank_pallas
// (src/repro/kernels/fused_matmul.py:590, pallas_call at :614), which
// carries the per-lane masks and codes in SMEM beside the scalars and
// double-buffers the next lane's table by DMA.
//
// Bound on an H100: integer ops on wide lanes (14 a loa4 product against
// four lookups), lookups on narrow ones.  The persistent blocks of
// fused_gather.cuh split the lanes' items by cost and stage each lane's
// table once; the lane's mask and code are uniform across a block, so
// the narrow/wide and tree-kind branches never diverge within a warp.
// out is one allocation: lo (n*M*N), hi (n*M*N), row (n*M), col
// (n*N), int32 (where K is split, one memset zeroes it).
#include "fused_gather.cuh"

extern "C" int fused_composed_matmul_bank_launch(
    const float* x, long long x_lane_stride, const float* w,
    const uint16_t* luts, const unsigned* masks, const int* rcodes,
    fusedmm::Scalars sc, int* out, int n_lanes, int M, int K, int N,
    int grid, void* stream) {
  return fusedmm::launch_quant<true>(x, x_lane_stride, w, luts, sc, masks,
                                     rcodes, out, n_lanes, M, K, N, grid,
                                     static_cast<cudaStream_t>(stream));
}

// The expert form: x (slices, M, K) shared (lane stride 0) or (n, slices,
// M, K) banked, w (experts, K, N); pair p = l slices + s quantized with
// the scalars at p against w[s % experts] under luts[l], masks[l] and
// rcodes[l] -> out: lo, hi (n slices M N each), row (n slices M), col
// (n slices N).
extern "C" int fused_composed_matmul_bank_experts_launch(
    const float* x, long long x_lane_stride, const float* w,
    const uint16_t* luts, const unsigned* masks, const int* rcodes,
    fusedmm::Scalars sc, int* out, int n_lanes, int slices, int experts,
    int M, int K, int N, int grid, void* stream) {
  return fusedmm::launch_quant<true>(x, x_lane_stride, w, luts, sc, masks,
                                     rcodes, out, n_lanes, M, K, N, grid,
                                     static_cast<cudaStream_t>(stream),
                                     slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

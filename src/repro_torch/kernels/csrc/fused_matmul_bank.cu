// fused_matmul_bank: the fused 8-bit datapath for a whole bank of n
// product tables in one launch, with per-lane quantization scalars:
//
//   acc[l, m, n] = sum_k LUT_l[quant(x_l; sa_l, za_l), quant(w; sw_l, zw_l)]
//   row[l, m], col[l, n]: the lane's code sums          (exact int32)
//
// x is shared (M, K) (lane stride 0: each lane re-quantizes it with its
// own scalars) or banked (n, M, K); w is shared (K, N).
//
// Replaces the TPU kernel fused_matmul_bank_pallas
// (src/repro/kernels/fused_matmul.py:487, pallas_call at :508), whose
// grid puts the lane axis first and double-buffers the next lane's
// table by DMA.
//
// Bound on an H100: shared-memory gather throughput (one lookup per
// product).  Two uint16 tables do not fit next to the tiles, so instead
// of double buffering the table, the persistent blocks of
// fused_gather.cuh (quant8_kernel) walk contiguous (lane, tile) ranges
// and stage each lane's table once; the operand chunks are double
// buffered: every thread issues chunk c + 1's loads before it gathers
// chunk c and quantizes them after, one barrier a chunk.
// out is one allocation: acc (n*M*N), then row (n*M), then col (n*N),
// int32 (where K is split, one memset zeroes it).
#include "fused_gather.cuh"

extern "C" int fused_matmul_bank_launch(const float* x,
                                        long long x_lane_stride,
                                        const float* w,
                                        const uint16_t* luts,
                                        fusedmm::Scalars sc, int* out,
                                        int n_lanes, int M, int K, int N,
                                        int grid, void* stream) {
  return fusedmm::launch_quant<false>(x, x_lane_stride, w, luts, sc,
                                      nullptr, nullptr, out, n_lanes, M, K,
                                      N, grid,
                                      static_cast<cudaStream_t>(stream));
}

// The expert form: x (slices, M, K) shared (lane stride 0) or
// (n, slices, M, K) banked, w (experts, K, N); pair p = l slices + s
// quantized with the scalars at p against w[s % experts] under luts[l]
// -> out: acc (n slices M N), row (n slices M), col (n slices N).
extern "C" int fused_matmul_bank_experts_launch(
    const float* x, long long x_lane_stride, const float* w,
    const uint16_t* luts, fusedmm::Scalars sc, int* out, int n_lanes,
    int slices, int experts, int M, int K, int N, int grid, void* stream) {
  return fusedmm::launch_quant<false>(x, x_lane_stride, w, luts, sc,
                                      nullptr, nullptr, out, n_lanes, M, K,
                                      N, grid,
                                      static_cast<cudaStream_t>(stream),
                                      slices, experts);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

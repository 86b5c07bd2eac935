// Shared body of the LUT-gather approximate matmul kernels
// (lut_matmul.cu, lut_matmul_bank.cu).
//
//   out[l, m, n] = sum_k LUT_l[qa_l[m, k], qw[k, n]]     (exact int32)
//
// qa: int32 codes in [0, 255], (M, K) per lane, lane stride 0 when the
// activations are shared by every lane; qw: int32 codes, (K, N), shared;
// luts: uint16 product tables (n_lanes, 256, 256); out: int32
// (n_lanes, M, N).
//
// What bounds it on an H100: one shared-memory table lookup per
// multiply (no tensor cores can do a data-dependent gather), so the
// least time is lookups / (132 SMs x 32 lookups per clock).  The
// random (qa, qw) pairs of a warp hit random shared-memory banks, so a
// warp's gather takes several bank passes on average.
//
// Design:
//  * The product table lives in shared memory as uint16 (128 KiB): the
//    library's 8-bit multipliers are 16-output-bit netlists, so every
//    entry fits (the wrapper rejects a table that does not).  The int32
//    table (256 KiB) would not fit a block.
//  * One persistent block per SM walks a contiguous range of
//    (lane, row tile, column tile) work items, so each block stages a
//    table once per lane it meets instead of once per tile.
//  * The column tile is sized to the real N (8 outputs per thread,
//    1..8 threads across N) instead of the TPU kernel's 128-wide pad,
//    since the case study's N is 10..64.
//  * K is walked inside the block in chunks of KC: the chunk's
//    activation codes (pre-shifted to row offsets qa << 8) and weight
//    codes are staged in shared memory; ragged M, N and K edges are
//    masked, so no padded term reaches a sum and no pad correction is
//    needed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Internal linkage throughout: each kernel library carries its own copy,
// and nothing here (least of all the once-only flag in launch) may be
// merged with the other library's copy when both are loaded.
namespace lutmm {
namespace {

constexpr int kThreads = 512;   // threads per block
constexpr int kNT = 8;          // outputs per thread along N
constexpr int kKC = 32;         // K chunk staged per step
constexpr int kLutEntries = 65536;

// Threads across N for a given N: the column tile is tn * kNT wide.
inline int threads_across_n(int n) {
  if (n <= 8) return 1;
  if (n <= 16) return 2;
  if (n <= 32) return 4;
  return 8;
}

inline size_t smem_bytes(int tn) {
  const int tm = kThreads / tn;
  return kLutEntries * sizeof(uint16_t)
       + (size_t)tm * (kKC + 1) * sizeof(int)
       + (size_t)kKC * tn * kNT * sizeof(int);
}

__global__ void __launch_bounds__(kThreads, 1)
lut_gather_kernel(const int* __restrict__ qa, long long qa_lane_stride,
                  const int* __restrict__ qw,
                  const uint16_t* __restrict__ luts,
                  int* __restrict__ out,
                  int n_lanes, int M, int K, int N, int tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  const int tm = kThreads / tn;            // rows per tile
  const int tile_n = tn * kNT;             // columns per tile
  int* s_a = reinterpret_cast<int*>(smem + kLutEntries * sizeof(uint16_t));
  int* s_w = s_a + tm * (kKC + 1);

  const int tid = threadIdx.x;
  const int r = tid / tn;                  // this thread's row in a tile
  const int g = tid % tn;                  // its column group
  const int tiles_m = (M + tm - 1) / tm;
  const int tiles_n = (N + tile_n - 1) / tile_n;
  const long long per_lane = (long long)tiles_m * tiles_n;
  const long long total = per_lane * n_lanes;
  const long long begin = total * blockIdx.x / gridDim.x;
  const long long end = total * (blockIdx.x + 1) / gridDim.x;

  int staged_lane = -1;
  for (long long item = begin; item < end; ++item) {
    const int lane = (int)(item / per_lane);
    const long long rem = item % per_lane;
    const int m0 = (int)(rem / tiles_n) * tm;
    const int n0 = (int)(rem % tiles_n) * tile_n;

    if (lane != staged_lane) {
      __syncthreads();                     // previous table no longer read
      const uint4* src = reinterpret_cast<const uint4*>(
          luts + (size_t)lane * kLutEntries);
      uint4* dst = reinterpret_cast<uint4*>(s_lut);
      for (int i = tid; i < kLutEntries * 2 / 16; i += kThreads)
        dst[i] = src[i];
      staged_lane = lane;
    }
    const int* a_lane = qa + (size_t)lane * qa_lane_stride;

    // unsigned: int32 sums wrap modulo 2^32 like the reference's
    unsigned acc[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[j] = 0u;

    for (int k0 = 0; k0 < K; k0 += kKC) {
      const int kc = min(kKC, K - k0);
      __syncthreads();                     // previous chunk consumed
      for (int e = tid; e < tm * kKC; e += kThreads) {
        const int rr = e / kKC, kk = e % kKC;
        const int m = m0 + rr;
        int v = 0;
        if (m < M && kk < kc) v = a_lane[(size_t)m * K + k0 + kk];
        s_a[rr * (kKC + 1) + kk] = (v & 255) << 8;
      }
      for (int e = tid; e < kKC * tile_n; e += kThreads) {
        const int kk = e / tile_n, nn = e % tile_n;
        const int n = n0 + nn;
        int v = 0;
        if (n < N && kk < kc) v = qw[(size_t)(k0 + kk) * N + n];
        s_w[kk * tile_n + nn] = v & 255;
      }
      __syncthreads();                     // chunk (and table) staged

      const int* a_row = s_a + r * (kKC + 1);
      const int* w_grp = s_w + g * kNT;
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const int base = a_row[kk];
        const int4 w0 = *reinterpret_cast<const int4*>(w_grp + kk * tile_n);
        const int4 w1 =
            *reinterpret_cast<const int4*>(w_grp + kk * tile_n + 4);
        acc[0] += s_lut[base | w0.x];
        acc[1] += s_lut[base | w0.y];
        acc[2] += s_lut[base | w0.z];
        acc[3] += s_lut[base | w0.w];
        acc[4] += s_lut[base | w1.x];
        acc[5] += s_lut[base | w1.y];
        acc[6] += s_lut[base | w1.z];
        acc[7] += s_lut[base | w1.w];
      }
    }

    const int m = m0 + r;
    if (m < M) {
      int* o = out + ((size_t)lane * M + m) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + g * kNT + j;
        if (n < N) o[n] = (int)acc[j];
      }
    }
  }
}

// Launch on `stream` with `grid` persistent blocks; returns the launch's
// cudaGetLastError().
inline int launch(const int* qa, long long qa_lane_stride, const int* qw,
                  const uint16_t* luts, int* out, int n_lanes, int M, int K,
                  int N, int grid, cudaStream_t stream) {
  const int tn = threads_across_n(N);
  const size_t smem = smem_bytes(tn);
  static bool configured = false;          // once: the largest tile's need
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        lut_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(1));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  lut_gather_kernel<<<grid, kThreads, smem, stream>>>(
      qa, qa_lane_stride, qw, luts, out, n_lanes, M, K, N, tn);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lutmm

// lowrank_matmul: rank-R factored approximate matmul on 8-bit codes,
//
//   out[m, n] = sum_r sum_k U[r, qa[m, k]] * V[r, qw[k, n]]      (f32)
//
// i.e. the product of A'(M, R*K) and B'(R*K, N) whose entries are
// gathered from the two (R, 256) factor tables of a multiplier's LUT.
//
// Replaces the TPU kernel lowrank_matmul_pallas
// (src/repro/kernels/lowrank_matmul.py:48, pallas_call at :61), which
// gathers (R, 128, 128) operand tiles in VMEM, runs R MXU products per
// grid step, pads M/N/K to 128 and subtracts pk * sum_r U[r,0]V[r,0]
// for the K pad afterwards.
//
// Bound on an H100: the FP32 FMAs, 2*M*K*N*R flops at the SIMT rate
// (132 SMs x 128 lanes x 2 x clock); the codes are read once.  No
// tensor cores: the factor values reach ~255 in magnitude and TF32's
// 10-bit mantissa would break the f32 error bound the tests hold.
//
// Design:
//  * Both tables live in shared memory (2 * R * 256 floats, 32 KB at
//    the largest R this kernel takes, kMaxRank).
//  * A block owns a BM x BN output tile, each thread a TM x TN register
//    tile.  BM is sized from M: the decode steps have M = batch rows,
//    so rows <= 8 take an 8 x 16 tile (one output a thread) instead of
//    the 64 x 64 tile the prefill shapes fill.
//  * K is walked in chunks of kKC: each chunk's codes are read from
//    device memory and gathered through the tables straight into
//    shared-memory operand tiles ua[r][k][BM] and vw[r][k][BN]; the
//    inner loop is then a plain SIMT product over the R*kKC merged
//    contraction, one FMA into one f32 accumulator per (r, k).
//  * Ragged M, N and K edges are masked (out-of-range entries stage
//    0.0), so no padded term reaches a sum and no pad correction is
//    needed.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRank = 16;     // lowrank_matmul.MAX_RANK in Python
constexpr int kKC = 16;          // K chunk staged per step

template <int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static size_t smem_bytes(int R) {
    return (size_t)2 * R * 256 * sizeof(float)
         + (size_t)R * kKC * (BM + BN) * sizeof(float);
  }
};

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN>::kThreads)
lowrank_kernel(const int* __restrict__ qa, const int* __restrict__ qw,
               const float* __restrict__ u, const float* __restrict__ v,
               float* __restrict__ out, int M, int K, int N, int R) {
  constexpr int kThreads = Tile<BM, BN, TM, TN>::kThreads;
  constexpr int kCols = BN / TN;           // threads across N
  extern __shared__ __align__(16) float smem[];
  float* s_u = smem;                       // (R, 256)
  float* s_v = s_u + R * 256;              // (R, 256)
  float* s_ua = s_v + R * 256;             // (R, kKC, BM)
  float* s_vw = s_ua + R * kKC * BM;       // (R, kKC, BN)

  const int tid = threadIdx.x;
  const int tx = tid % kCols, ty = tid / kCols;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  for (int i = tid; i < R * 256; i += kThreads) {
    s_u[i] = u[i];
    s_v[i] = v[i];
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();                       // tables staged / chunk consumed
    for (int e = tid; e < kKC * BM; e += kThreads) {
      const int kk = e / BM, mm = e % BM;
      const int m = m0 + mm, k = k0 + kk;
      const bool in = m < M && k < K;
      const int code = in ? (qa[(size_t)m * K + k] & 255) : 0;
      for (int r = 0; r < R; ++r)
        s_ua[(r * kKC + kk) * BM + mm] = in ? s_u[r * 256 + code] : 0.f;
    }
    for (int e = tid; e < kKC * BN; e += kThreads) {
      const int kk = e / BN, nn = e % BN;
      const int n = n0 + nn, k = k0 + kk;
      const bool in = n < N && k < K;
      const int code = in ? (qw[(size_t)k * N + n] & 255) : 0;
      for (int r = 0; r < R; ++r)
        s_vw[(r * kKC + kk) * BN + nn] = in ? s_v[r * 256 + code] : 0.f;
    }
    __syncthreads();                       // operand tiles staged

    for (int rk = 0; rk < R * kKC; ++rk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s_ua[rk * BM + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s_vw[rk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch(const int* qa, const int* qw, const float* u, const float* v,
           float* out, int M, int K, int N, int R, cudaStream_t stream) {
  using T = Tile<BM, BN, TM, TN>;
  static bool configured = false;          // once: the largest R's need
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        lowrank_kernel<BM, BN, TM, TN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::smem_bytes(kMaxRank));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  lowrank_kernel<BM, BN, TM, TN><<<grid, T::kThreads, T::smem_bytes(R),
                                   stream>>>(qa, qw, u, v, out, M, K, N, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lowrank_matmul_launch(const int* qa, const int* qw,
                                     const float* u, const float* v,
                                     float* out, int M, int K, int N, int R,
                                     void* stream) {
  if (R < 1 || R > kMaxRank) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<8, 16, 1, 1>(qa, qw, u, v, out, M, K, N, R, s);
  return launch<64, 64, 4, 4>(qa, qw, u, v, out, M, K, N, R, s);
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared body of the fused quantize -> LUT-gather -> accumulate kernels
// (fused_matmul.cu, fused_matmul_bank.cu, fused_composed_matmul.cu,
// fused_composed_matmul_bank.cu) and of the two-step composed kernels on
// codes (composed_matmul.cu, composed_matmul_bank.cu).  For each lane l:
//
//   qa = clip(rint(x_l / sa_l) + za_l, 0, qmax_l)     (M, K) codes
//   qw = clip(rint(w   / sw_l) + zw_l, 0, qmax_l)     (K, N) codes
//   8-bit:     acc[l, m, n] = sum_k LUT_l[qa[m, k], qw[k, n]]   (int32)
//   composed:  p = tree_l(LUT_l[a0,w0], LUT_l[a0,w1], LUT_l[a1,w0],
//                         LUT_l[a1,w1]) & mask_l   (digits q & 255, q >> 8)
//              lo[l, m, n] = sum_k (p & 0xFFFF), hi = sum_k (p >> 16);
//              a narrow lane (mask 0) takes lo = sum_k LUT_l[a0, w0], hi = 0
//   row[l, m] = sum_k qa[m, k],   col[l, n] = sum_k qw[k, n]
//
// x: f32 (M, K) per lane, lane stride 0 when the activations are shared
// (each lane still quantizes them with its own scale and zero point);
// w: f32 (K, N), shared (lane stride 0; the codes of a mixed-width bank
// are per lane, (n_lanes, K, N)); luts: uint16 (n_lanes, 256, 256); fp: f32
// (n_lanes, 3) = (sa, sw, qmax); ip: int32 (n_lanes, 2) = (za, zw);
// masks: uint32 (n_lanes,); rcodes: int32 (n_lanes, 2) = encode_reduce
// (kind, k).  Every per-lane value is read from device memory, so no
// launch waits on the host.  The f32 correction and dequant stay with
// the caller (eager PyTorch), as the TPU kernels leave them to theirs.
//
// Instantiated on int operands (In = int: composed_matmul*.cu), the
// kernel reads x and w as int32 W-bit codes, stages them as they are
// (no quantize, no per-lane scalars: fp and ip are not read) and keeps
// no code sums (row_out and col_out are not written).
//
// Bit-exact quantization: IEEE division (__fdiv_rn), rint (half to
// even, like jnp.round), + zero point in f32, clip, then the int cast
// — the reference's _quant_tile order.  No fast-math flags.
//
// What bounds it on an H100: shared-memory table lookups (one per
// product at 8 bits, four per product for composed lanes), no tensor
// cores, so the least time is lookups / (132 SMs x 32 lookups a clock);
// the f32 operands are read once per (row tile, column tile).
//
// Design (as lut_gather.cuh): the uint16 table (128 KiB) sits in shared
// memory; one persistent block per SM walks a contiguous range of (lane,
// row tile, column tile) items, so a block stages a lane's table and
// reads its scalars once per lane it meets; the column tile is sized to
// the real N; K is walked in chunks of kKC, quantized while staged;
// ragged M, N and K edges are masked, so no padded term reaches a sum
// and no pad correction is needed.  Row sums are kept by the threads of
// column group 0 and written by the column-tile-0 item, column sums by
// the threads of row 0 and written by the row-tile-0 item.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// Internal linkage throughout: each kernel library carries its own copy,
// and nothing here (least of all the once-only flags in launch) may be
// merged with another library's copy when several are loaded.
namespace fusedmm {
namespace {

constexpr int kThreads = 512;   // threads per block
constexpr int kNT = 8;          // outputs per thread along N
constexpr int kKC = 32;         // K chunk staged per step
constexpr int kLutEntries = 65536;

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

__device__ __forceinline__ int quantize(float v, float scale, float zp,
                                        float qmax) {
  const float q = rintf(__fdiv_rn(v, scale)) + zp;
  return (int)fminf(fmaxf(q, 0.0f), qmax);
}

// The code a staged operand element becomes: quantized from f32, or an
// int32 code taken as it is.
__device__ __forceinline__ int stage_code(float v, float scale, float zp,
                                          float qmax) {
  return quantize(v, scale, zp, qmax);
}
__device__ __forceinline__ int stage_code(int v, float, float, float) {
  return v;
}

// uint32 shifts with XLA's semantics: a shift of 32 or more gives 0
// (C++ leaves it undefined).
__device__ __forceinline__ unsigned shl(unsigned a, unsigned s) {
  return s < 32u ? a << s : 0u;
}
__device__ __forceinline__ unsigned shr(unsigned a, unsigned s) {
  return s < 32u ? a >> s : 0u;
}

// registry.reduce_apply_dyn: kind 0 exact, 1 truncated, else lower-part
// OR (loa, low part max(k, 1)).
__device__ __forceinline__ unsigned reduce_dyn(unsigned a, unsigned b,
                                               int kind, unsigned k) {
  if (kind == 0) return a + b;
  const unsigned hs = shr(a, k) + shr(b, k);
  if (kind == 1) return shl(hs, k);
  const unsigned km = k > 1u ? k : 1u;
  const unsigned low = shl(1u, km) - 1u;
  const unsigned carry = shr(a, km - 1u) & shr(b, km - 1u) & 1u;
  return ((a | b) & low) | shl(hs + carry, k);
}

// registry.composed_reduce_dyn over the four digit products.
__device__ __forceinline__ unsigned composed_tree(unsigned p00,
                                                  unsigned p01,
                                                  unsigned p10,
                                                  unsigned p11, int kind,
                                                  unsigned k) {
  const unsigned s1 = reduce_dyn(p01, p10, kind, k);
  const unsigned s2 = reduce_dyn(p00, s1 << 8, kind, k);
  return reduce_dyn(s2, p11 << 16, kind, k);
}

template <bool kComposed, typename In>
__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const In* __restrict__ x, long long x_lane_stride,
             const In* __restrict__ w, long long w_lane_stride,
             const uint16_t* __restrict__ luts,
             const float* __restrict__ fp, const int* __restrict__ ip,
             const unsigned* __restrict__ masks,
             const int* __restrict__ rcodes,
             int* __restrict__ out_lo, int* __restrict__ out_hi,
             int* __restrict__ row_out, int* __restrict__ col_out,
             int n_lanes, int M, int K, int N, int tn) {
  // f32 operands are quantized per lane and their code sums kept; int32
  // codes are staged as they are
  constexpr bool kQuant = std::is_same<In, float>::value;
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
  float sa = 0.f, sw = 0.f, qmax = 0.f, za = 0.f, zw = 0.f;
  unsigned mask = 0u, kd = 0u;
  int kind = 0;
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
      if (kQuant) {
        sa = fp[lane * 3];
        sw = fp[lane * 3 + 1];
        qmax = fp[lane * 3 + 2];
        za = (float)ip[lane * 2];
        zw = (float)ip[lane * 2 + 1];
      }
      if (kComposed) {
        mask = masks[lane];
        kind = rcodes[lane * 2];
        kd = (unsigned)rcodes[lane * 2 + 1];
      }
      staged_lane = lane;
    }
    const In* x_lane = x + (size_t)lane * x_lane_stride;
    const In* w_lane = w + (size_t)lane * w_lane_stride;

    // unsigned: int32 sums wrap modulo 2^32 like the reference's
    unsigned lo[kNT], hi[kNT], col_sum[kNT];
    unsigned row_sum = 0u;
#pragma unroll
    for (int j = 0; j < kNT; ++j) lo[j] = hi[j] = col_sum[j] = 0u;

    for (int k0 = 0; k0 < K; k0 += kKC) {
      const int kc = min(kKC, K - k0);
      __syncthreads();                     // previous chunk consumed
      for (int e = tid; e < tm * kKC; e += kThreads) {
        const int rr = e / kKC, kk = e % kKC;
        const int m = m0 + rr;
        int q = 0;
        if (m < M && kk < kc)
          q = stage_code(x_lane[(size_t)m * K + k0 + kk], sa, za, qmax);
        s_a[rr * (kKC + 1) + kk] = q;
      }
      for (int e = tid; e < kKC * tile_n; e += kThreads) {
        const int kk = e / tile_n, nn = e % tile_n;
        const int n = n0 + nn;
        int q = 0;
        if (n < N && kk < kc)
          q = stage_code(w_lane[(size_t)(k0 + kk) * N + n], sw, zw, qmax);
        s_w[kk * tile_n + nn] = q;
      }
      __syncthreads();                     // chunk (and table) staged

      const int* a_row = s_a + r * (kKC + 1);
      const int* w_grp = s_w + g * kNT;
      if (kQuant && g == 0)
        for (int kk = 0; kk < kc; ++kk) row_sum += (unsigned)a_row[kk];
      if (kQuant && r == 0)
        for (int kk = 0; kk < kc; ++kk)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            col_sum[j] += (unsigned)w_grp[kk * tile_n + j];

      if (!kComposed || mask == 0u) {
        // 8-bit codes, or a narrow lane of a composed bank: the plain
        // tile sum over the low digits
#pragma unroll 4
        for (int kk = 0; kk < kc; ++kk) {
          const int base = (a_row[kk] & 255) << 8;
          const int4 w0 = *reinterpret_cast<const int4*>(w_grp + kk * tile_n);
          const int4 w1 =
              *reinterpret_cast<const int4*>(w_grp + kk * tile_n + 4);
          lo[0] += s_lut[base | (w0.x & 255)];
          lo[1] += s_lut[base | (w0.y & 255)];
          lo[2] += s_lut[base | (w0.z & 255)];
          lo[3] += s_lut[base | (w0.w & 255)];
          lo[4] += s_lut[base | (w1.x & 255)];
          lo[5] += s_lut[base | (w1.y & 255)];
          lo[6] += s_lut[base | (w1.z & 255)];
          lo[7] += s_lut[base | (w1.w & 255)];
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < kc; ++kk) {
          const int qa = a_row[kk];
          const int a0 = (qa & 255) << 8, a1 = (qa >> 8) << 8;
          const int* wk = w_grp + kk * tile_n;
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int qw = wk[j];
            const int w0 = qw & 255, w1 = qw >> 8;
            const unsigned p = composed_tree(
                s_lut[a0 | w0], s_lut[a0 | w1], s_lut[a1 | w0],
                s_lut[a1 | w1], kind, kd) & mask;
            lo[j] += p & 0xFFFFu;
            hi[j] += p >> 16;
          }
        }
      }
    }

    const int m = m0 + r;
    if (m < M) {
      const size_t o = ((size_t)lane * M + m) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + g * kNT + j;
        if (n < N) {
          out_lo[o + n] = (int)lo[j];
          if (kComposed) out_hi[o + n] = (int)hi[j];
        }
      }
      if (kQuant && n0 == 0 && g == 0)
        row_out[(size_t)lane * M + m] = (int)row_sum;
    }
    if (kQuant && m0 == 0 && r == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + g * kNT + j;
        if (n < N) col_out[(size_t)lane * N + n] = (int)col_sum[j];
      }
    }
  }
}

// Launch on `stream` with `grid` persistent blocks; returns the launch's
// cudaGetLastError().
template <bool kComposed, typename In>
inline int launch(const In* x, long long x_lane_stride, const In* w,
                  long long w_lane_stride,
                  const uint16_t* luts, const float* fp, const int* ip,
                  const unsigned* masks, const int* rcodes, int* out_lo,
                  int* out_hi, int* row_out, int* col_out, int n_lanes,
                  int M, int K, int N, int grid, cudaStream_t stream) {
  const int tn = threads_across_n(N);
  static bool configured = false;          // once: the largest tile's need
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_kernel<kComposed, In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(1));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  fused_kernel<kComposed, In><<<grid, kThreads, smem_bytes(tn), stream>>>(
      x, x_lane_stride, w, w_lane_stride, luts, fp, ip, masks, rcodes,
      out_lo, out_hi, row_out, col_out, n_lanes, M, K, N, tn);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fusedmm

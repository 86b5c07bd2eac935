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
// for the K pad afterwards.  Here ragged M, N and K edges are masked
// (out-of-range entries contribute 0), so there is no pad correction.
//
// Two regimes, picked from the shape (lowrank_matmul_launch):
//
//  * stream (M <= kStreamRows, the decode steps; also any shape with
//    K*R < kMinMmaTerms): bound on an H100 by reading the K*N weight
//    codes once (4 bytes each at 3.35 TB/s) and by the shared-memory
//    table lookups, not by FMAs.  A block owns 128 columns x one K
//    slice of at most kStreamMaxK rows; cp.async streams the slice's
//    codes into shared memory as 16-byte vectors (a warp reads 512
//    contiguous bytes of a row) while both tables are staged code-major,
//    (256, RP) with RP = R rounded up to 4, so one 16-byte load gives
//    four ranks of a code, and the U side of the slice, M x rows x RP
//    values, is gathered once and read as broadcasts.  Each thread owns
//    4 adjacent columns and keeps M x 4 f32 accumulators in registers
//    (M rounded up to 1, 2, 4, 8 or 16; larger M takes row groups of 16
//    on gridDim.z); the 8 warps take every 8th row and their partials
//    are summed in warp order.  K is split so that the grid holds about
//    2 blocks per SM (the split is the caller's plan).
//  * mma (M > kStreamRows and K*R >= kMinMmaTerms, the prefill steps):
//    2*M*K*N*R flops, f32-accurate on tensor cores through the 3xTF32
//    split: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), both
//    rounded as cvt.rna does; every product is accumulated as
//    lo_a*hi_b + hi_a*lo_b + hi_a*hi_b (three mma.sync.m16n8k8 TF32),
//    which errs by ~3 * 2^-22 |ab| per product, far inside the
//    2 (K R + 1) 2^-24 S bound for the K*R >= kMinMmaTerms this regime
//    takes.  A 256-thread block owns a 64 x 64 output tile (2 x 4 warps
//    of 32 x 16) and one K slice, walked in chunks of BK codes (16, or
//    8 past R = 4, so the R*BK contraction fits shared memory): a ring
//    of kStages code tiles is kept in flight with cp.async, and each
//    chunk is gathered through the code-major tables straight into the
//    MMA's operand layouts, A' as (R, 64, BK+4) and B' as (R, BK, 64+8)
//    f32 (pads that make the fragment loads free of bank conflicts).
//    What bounds it on the card is shared memory: the gather's table
//    lookups and stores and the fragment loads, not the MMAs (PERF.md).
//    K is split so that N = 1024 still fills the card.
//
// Split K in both regimes reduces inside the same launch, in a fixed
// order, with no float atomics: each block writes its partial tile to a
// workspace (slices, splits, M, N) the caller allocates, then thread 0
// bumps an int counter per (slice, output tile) (an acq_rel atomic after
// a barrier); the last block to arrive sums the partials in split order
// 0..S-1, writes the output and resets the counter to 0 for the next
// launch.  Two launches on the same inputs give the same bits.
//
// The slice axis (an MoE projection's experts in one launch, as the
// reference's pallas_call batched over stacked expert weights runs
// them): qa holds `slices` (M, K) slices, qw `experts` (K, N) slices, and
// slice s computes out[s] = qa[s] x qw[s % experts] through the shared
// u and v.  Both regimes fold the slices into a grid dimension (stream:
// gridDim.z = slices x row groups; mma: gridDim.y = slices x row tiles),
// so a block finds its slice, offsets its three pointers and its
// workspace, and runs as before; slices = experts = 1 is the launch
// without the axis.  The reference subtracts each slice's K pad term
// pk * sum_r U[r,0]V[r,0]; the masked edges here leave it nothing to
// subtract.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRank = 16;       // lowrank_matmul.MAX_RANK in Python
constexpr int kStreamRows = 16;    // lowrank_matmul.STREAM_ROWS
constexpr int kMinMmaTerms = 64;   // lowrank_matmul.MIN_MMA_TERMS
constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamCols = 128;   // 32 lanes x 4 columns
constexpr int kStreamMaxK = 64;   // lowrank_matmul.STREAM_MAX_K
constexpr int kStages = 3;         // code tiles in flight (cp.async ring)
constexpr int kMaxDevices = 64;    // device ordinals a shared memory opt-in tracks
// the mma block tile (lowrank_matmul.MMA_TILE) and its 2 x 4 warps,
// each owning 32 x 16 outputs, 2 x 2 m16n8 MMA tiles
constexpr int kBM = 64, kBN = 64, kWM = 2, kWN = 4;
constexpr int kMmaThreads = 32 * kWM * kWN;
constexpr int kSB = kBN + 8;       // B' row stride (floats)
// dynamic shared memory a block may ask for: an H100's 227 KB less 1 KB
// for arrive_last's static flag
constexpr int kMaxSmem = 232448 - 1024;

__host__ __device__ inline int round4(int r) { return (r + 3) & ~3; }

// ---- asynchronous copies and table staging ----------------------------

// cp.async of `bytes` (4 or 16) from global to shared memory; only the
// first `valid` bytes are read, the rest of the destination is zeroed
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x cols int32 tile of `src` (row stride ld, tile origin at src) into
// dst (row stride dcols); entries past `rows_in` rows or `cols_in`
// columns are zeroed.  16-byte copies when every row start is aligned.
__device__ __forceinline__ void copy_codes(int* dst, int dcols,
                                           const int* src, size_t ld,
                                           int rows, int cols, int rows_in,
                                           int cols_in, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    const int groups = cols / 4;
    for (int g = tid; g < rows * groups; g += nthreads) {
      const int r = g / groups, c = 4 * (g % groups);
      const int n = r < rows_in ? min(max(cols_in - c, 0), 4) : 0;
      cp_async<16>(dst + r * dcols + c, n ? src + r * ld + c : src, 4 * n);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthreads) {
      const int r = e / cols, c = e % cols;
      const bool in = r < rows_in && c < cols_in;
      cp_async<4>(dst + r * dcols + c, in ? src + r * ld + c : src,
                  in ? 4 : 0);
    }
  }
}

// (R, 256) table, read coalesced, into shared memory code-major (256, rp)
// with the ranks past R zeroed
__device__ __forceinline__ void stage_table(float* dst,
                                            const float* __restrict__ src,
                                            int R, int rp, int tid,
                                            int nthreads) {
#pragma unroll 4
  for (int i = tid; i < rp * 256; i += nthreads) {
    const int r = i >> 8, code = i & 255;
    dst[code * rp + r] = r < R ? __ldg(src + i) : 0.f;
  }
}

// ---- split-K finish ---------------------------------------------------

// After every thread stored its partial: true in the block that arrives
// last at this output tile (it then owns the reduction).
// The barrier orders the block's stores before thread 0's acq_rel
// atomic, which releases them to the other blocks and acquires theirs.
__device__ bool arrive_last(int* counter, int splits) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(counter) : "memory");
    s_last = prev == splits - 1;
    if (s_last) *counter = 0;        // reset for the next launch
  }
  __syncthreads();
  return s_last;
}

// The last block's pass: out[mn] = sum over s = 0..S-1, in that order,
// of ws[s, mn], for the C outputs mn[c] (< 0: masked) of this thread.
// D splits' loads are issued before any is added, so the pass takes
// ~S / D round trips to L2 rather than S * C.
template <int C>
__device__ __forceinline__ void sum_splits(const float* __restrict__ ws,
                                           float* __restrict__ out,
                                           int splits, size_t plane,
                                           const int (&mn)[C]) {
  constexpr int D = C >= 32 ? 1 : (32 / C < 16 ? 32 / C : 16);
  float tot[C];
#pragma unroll
  for (int c = 0; c < C; ++c) tot[c] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += D) {
    float part[D][C];
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int c = 0; c < C; ++c)
        part[d][c] = s0 + d < splits && mn[c] >= 0
                         ? __ldcg(ws + (s0 + d) * plane + mn[c]) : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int c = 0; c < C; ++c) tot[c] += part[d][c];   // + 0 is exact
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (mn[c] >= 0) out[mn[c]] = tot[c];
}

// ---- stream regime ------------------------------------------------------

template <int MB>
size_t stream_smem(int R, int kps) {
  const int rp = round4(R);
  return ((size_t)2 * 256 * rp + (size_t)kps * MB * rp
          + (size_t)kStreamWarps * MB * kStreamCols
          + (size_t)kps * kStreamCols) * sizeof(float);
}

// grid (col tiles of 128, splits, slices x row groups of MB); block 256
template <int MB>
__global__ void __launch_bounds__(kStreamThreads)
stream_kernel(const int* __restrict__ qa, const int* __restrict__ qw,
              const float* __restrict__ u, const float* __restrict__ v,
              float* __restrict__ out, float* __restrict__ ws,
              int* __restrict__ counters, int M, int K, int N, int R,
              int kps, int experts, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int rp = round4(R);
  float* s_u = smem;                            // (256, rp)
  float* s_v = s_u + 256 * rp;                  // (256, rp)
  float* s_ua = s_v + 256 * rp;                 // (kps, MB, rp)
  float* s_red = s_ua + kps * MB * rp;          // (warps, MB, 128)
  int* s_qw = reinterpret_cast<int*>(s_red + kStreamWarps * MB * kStreamCols);
                                                // (kps, 128) codes

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int groups = (M + MB - 1) / MB;
  const int slice = blockIdx.z / groups;
  const int n0 = blockIdx.x * kStreamCols, m0 = (blockIdx.z % groups) * MB;
  const int splits = gridDim.y;
  qa += (size_t)slice * M * K;
  qw += (size_t)(slice % experts) * K * N;
  out += (size_t)slice * M * N;
  if (splits > 1) ws += (size_t)slice * splits * M * N;
  const int kb = blockIdx.y * kps, ke = min(K, kb + kps);
  const int rows = max(ke - kb, 0);

  // the slice's weight codes stream in while the tables are staged
  copy_codes(s_qw, kStreamCols, qw + (size_t)kb * N + n0, N, kps,
             kStreamCols, rows, N - n0, vec, tid, kStreamThreads);
  asm volatile("cp.async.commit_group;\n" ::);
  constexpr int kQa = (kStreamMaxK * MB + kStreamThreads - 1) / kStreamThreads;
  int ca[kQa];                                  // this slice's qa codes
#pragma unroll
  for (int q = 0; q < kQa; ++q) {
    const int i = tid + q * kStreamThreads, kk = i / MB, m = i % MB;
    ca[q] = i < rows * MB && m0 + m < M
                ? (__ldg(qa + (size_t)(m0 + m) * K + kb + kk) & 255) : -1;
  }
  stage_table(s_u, u, R, rp, tid, kStreamThreads);
  stage_table(s_v, v, R, rp, tid, kStreamThreads);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kQa; ++q) {
    const int i = tid + q * kStreamThreads;
    if (i >= rows * MB) break;
    for (int g = 0; g < rp; g += 4)
      *reinterpret_cast<float4*>(s_ua + i * rp + g) =
          ca[q] >= 0 ? *reinterpret_cast<const float4*>(s_u + ca[q] * rp + g)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_wait_all();
  __syncthreads();

  float acc[MB][4];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  // this warp's rows of the slice: w, w + 8, w + 16, ...
#pragma unroll 2
  for (int kk = w; kk < rows; kk += kStreamWarps) {
    const int4 c = *reinterpret_cast<const int4*>(s_qw + kk * kStreamCols
                                                  + 4 * lane);
    const int cc[4] = {c.x & 255, c.y & 255, c.z & 255, c.w & 255};
    const float* ua = s_ua + kk * MB * rp;
    for (int g = 0; g < rp; g += 4) {
      float4 vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vv[j] = *reinterpret_cast<const float4*>(s_v + cc[j] * rp + g);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(ua + m * rp + g);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = acc[m][j];
          x = fmaf(a.x, vv[j].x, x);
          x = fmaf(a.y, vv[j].y, x);
          x = fmaf(a.z, vv[j].z, x);
          x = fmaf(a.w, vv[j].w, x);
          acc[m][j] = x;
        }
      }
    }
  }

  // sum the 8 warps' partials in warp order
#pragma unroll
  for (int m = 0; m < MB; ++m)
    *reinterpret_cast<float4*>(s_red + (w * MB + m) * kStreamCols
                               + 4 * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  float* dst = splits > 1 ? ws + (size_t)blockIdx.y * M * N : out;
  for (int gi = tid; gi < MB * 32; gi += kStreamThreads) {
    const int m = gi / 32, c = 4 * (gi % 32);
    float4 x = *reinterpret_cast<const float4*>(s_red + m * kStreamCols + c);
    for (int ww = 1; ww < kStreamWarps; ++ww) {
      const float4 y = *reinterpret_cast<const float4*>(
          s_red + (ww * MB + m) * kStreamCols + c);
      x.x += y.x; x.y += y.y; x.z += y.z; x.w += y.w;
    }
    const int gm = m0 + m;
    if (gm >= M) continue;
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + c + j < N) dst[(size_t)gm * N + n0 + c + j] = xs[j];
  }
  if (splits == 1) return;
  if (!arrive_last(counters + blockIdx.z * gridDim.x + blockIdx.x, splits))
    return;
  constexpr int C = MB * kStreamCols / kStreamThreads > 0
                        ? MB * kStreamCols / kStreamThreads : 1;
  int mn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = tid + c * kStreamThreads;
    const int gm = m0 + e / kStreamCols, gn = n0 + e % kStreamCols;
    mn[c] = e < MB * kStreamCols && gm < M && gn < N ? gm * N + gn : -1;
  }
  sum_splits<C>(ws, out, splits, (size_t)M * N, mn);
}

// ---- mma regime (3xTF32) ---------------------------------------------

// Round f32 bits to TF32 (10 mantissa bits), ties away from zero: what
// cvt.rna.tf32.f32 computes for finite values, in two integer ops
// (sm_90 emulates the cvt with a predicated sequence that serializes).
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split3(float x, uint32_t& hi,
                                       uint32_t& lo) {
  hi = tf32_rna(__float_as_uint(x));
  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BK>
size_t mma_smem(int R) {
  constexpr int BM = kBM;
  return ((size_t)2 * 256 * round4(R) + (size_t)kStages * BK * (BM + kBN)
          + (size_t)R * (BM * (BK + 4) + BK * kSB)) * sizeof(float);
}

// grid (col tiles of 64, slices x row tiles of 64, splits)
template <int BK>
__global__ void __launch_bounds__(kMmaThreads)
mma_kernel(const int* __restrict__ qa, const int* __restrict__ qw,
           const float* __restrict__ u, const float* __restrict__ v,
           float* __restrict__ out, float* __restrict__ ws,
           int* __restrict__ counters, int M, int K, int N, int R,
           int kps, int experts, bool vec_a, bool vec_b) {
  constexpr int BM = kBM, kThreads = kMmaThreads;
  constexpr int MI = BM / kWM / 16, NJ = kBN / kWN / 8;
  constexpr int SA = BK + 4;                    // A' row stride (floats)
  constexpr int kCodes = BK * (BM + kBN);       // ints a stage holds
  extern __shared__ __align__(16) float smem[];
  const int rp = round4(R);
  float* s_u = smem;                            // (256, rp)
  float* s_v = s_u + 256 * rp;                  // (256, rp)
  int* s_codes = reinterpret_cast<int*>(s_v + 256 * rp);
      // kStages x [(BM, BK) qa codes, (BK, 64) qw codes]
  float* s_a = reinterpret_cast<float*>(s_codes + kStages * kCodes);
                                                // (R, BM, SA)
  float* s_b = s_a + R * BM * SA;               // (R, BK, kSB)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / kWN) * (BM / kWM), wn = (warp % kWN) * (kBN / kWN);
  const int tiles_m = (M + BM - 1) / BM;
  const int slice = blockIdx.y / tiles_m;
  const int n0 = blockIdx.x * kBN, m0 = (blockIdx.y % tiles_m) * BM;
  const int splits = gridDim.z;
  qa += (size_t)slice * M * K;
  qw += (size_t)(slice % experts) * K * N;
  out += (size_t)slice * M * N;
  if (splits > 1) ws += (size_t)slice * splits * M * N;
  const int kb = blockIdx.z * kps, ke = min(K, kb + kps);
  const int chunks = (ke - kb + BK - 1) / BK;

  // chunk c's codes into stage c % kStages; one commit group per chunk
  // (empty past the slice) so that wait_group counts chunks
  auto copy = [&](int c) {
    if (c < chunks) {
      const int k0 = kb + c * BK;
      int* sc = s_codes + (c % kStages) * kCodes;
      copy_codes(sc, BK, qa + (size_t)m0 * K + k0, K, BM, BK, M - m0,
                 ke - k0, vec_a, tid, kThreads);
      copy_codes(sc + BM * BK, kBN, qw + (size_t)k0 * N + n0, N, BK, kBN,
                 ke - k0, N - n0, vec_b, tid, kThreads);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) copy(c);
  stage_table(s_u, u, R, rp, tid, kThreads);
  stage_table(s_v, v, R, rp, tid, kThreads);

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int k0 = kb + c * BK;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();              // chunk c landed; chunk c-1's MMAs done
    // gather through the tables into the operand layouts; the copies
    // zeroed the codes past the edges, the masks zero their values
    const int* ca = s_codes + (c % kStages) * kCodes;
    const int* cb = ca + BM * BK;
#pragma unroll
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int m = e / BK, kk = e % BK;
      const bool in = m0 + m < M && k0 + kk < ke;
      const float* tab = s_u + (ca[e] & 255) * rp;
      for (int r0 = 0; r0 < R; r0 += 4) {
        const float4 x = in ? *reinterpret_cast<const float4*>(tab + r0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r0 + q < R) s_a[((r0 + q) * BM + m) * SA + kk] = xs[q];
      }
    }
#pragma unroll
    for (int e = tid; e < BK * kBN; e += kThreads) {
      const int kk = e / kBN, n = e % kBN;
      const bool in = k0 + kk < ke && n0 + n < N;
      const float* tab = s_v + (cb[e] & 255) * rp;
      for (int r0 = 0; r0 < R; r0 += 4) {
        const float4 x = in ? *reinterpret_cast<const float4*>(tab + r0)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r0 + q < R) s_b[((r0 + q) * BK + kk) * kSB + n] = xs[q];
      }
    }
    __syncthreads();              // operands staged; stage c-1 is free
    copy(c + kStages - 1);        // in flight during the next chunks

    for (int r = 0; r < R; ++r) {
      const float* A = s_a + r * BM * SA;
      const float* B = s_b + r * BK * kSB;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 8) {
        uint32_t ahi[MI][4], alo[MI][4], bhi[NJ][2], blo[NJ][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float* a = A + (wm + 16 * i + g) * SA + ks + t;
          split3(a[0], ahi[i][0], alo[i][0]);
          split3(a[8 * SA], ahi[i][1], alo[i][1]);
          split3(a[4], ahi[i][2], alo[i][2]);
          split3(a[8 * SA + 4], ahi[i][3], alo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float* b = B + (ks + t) * kSB + wn + 8 * j + g;
          split3(b[0], bhi[j][0], blo[j][0]);
          split3(b[4 * kSB], bhi[j][1], blo[j][1]);
        }
        // the three terms of each product, small ones first; each pass
        // over the warp's tiles issues independent MMAs, so no MMA waits
        // on the one just before it
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  float* dst = splits > 1 ? ws + (size_t)blockIdx.z * M * N : out;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm + 16 * i + g + 8 * (q >> 1);
        const int n = n0 + wn + 8 * j + 2 * t + (q & 1);
        if (m < M && n < N) dst[(size_t)m * N + n] = acc[i][j][q];
      }
  if (splits == 1) return;
  if (!arrive_last(counters + blockIdx.y * gridDim.x + blockIdx.x, splits))
    return;
  constexpr int C = BM * kBN / kThreads;
  int mn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int e = tid + c * kThreads;
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    mn[c] = m < M && n < N ? m * N + n : -1;
  }
  sum_splits<C>(ws, out, splits, (size_t)M * N, mn);
}

// ---- launch -------------------------------------------------------------

// The opt-in acts on the current device only, so ``done`` holds one flag
// a device ordinal.
template <typename Kernel>
int set_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done[dev] = err == cudaSuccess;
  return (int)err;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int MB>
int launch_stream(const int* qa, const int* qw, const float* u,
                  const float* v, float* out, float* ws, int* counters,
                  int n_counters, int M, int K, int N, int R, int kps,
                  int splits, int slices, int experts, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  if (int err = set_smem(stream_kernel<MB>, configured)) return err;
  const size_t smem = stream_smem<MB>(R, kps);
  const long long z = (long long)slices * ((M + MB - 1) / MB);
  const dim3 grid((N + kStreamCols - 1) / kStreamCols, splits,
                  (unsigned)z);
  if (smem > (size_t)kMaxSmem || kps > kStreamMaxK || z > 65535
      || splits > 65535
      || (splits > 1 && (ws == nullptr || counters == nullptr
                         || (long long)grid.x * z > n_counters)))
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && aligned16(qw);
  stream_kernel<MB><<<grid, kStreamThreads, smem, stream>>>(
      qa, qw, u, v, out, ws, counters, M, K, N, R, kps, experts, vec);
  return (int)cudaGetLastError();
}

template <int BK>
int launch_mma(const int* qa, const int* qw, const float* u, const float* v,
               float* out, float* ws, int* counters, int n_counters, int M,
               int K, int N, int R, int kps, int splits, int slices,
               int experts, cudaStream_t stream) {
  constexpr auto kernel = mma_kernel<BK>;
  static bool configured[kMaxDevices] = {};
  if (int err = set_smem(kernel, configured)) return err;
  const size_t smem = mma_smem<BK>(R);
  const long long y = (long long)slices * ((M + kBM - 1) / kBM);
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)y, splits);
  if (smem > (size_t)kMaxSmem || y > 65535 || splits > 65535
      || (splits > 1 && (ws == nullptr || counters == nullptr
                         || (long long)grid.x * y > n_counters)))
    return (int)cudaErrorInvalidValue;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      qa, qw, u, v, out, ws, counters, M, K, N, R, kps, experts,
      K % 4 == 0 && kps % 4 == 0 && aligned16(qa),
      N % 4 == 0 && aligned16(qw));
  return (int)cudaGetLastError();
}

}  // namespace

// One launch's arguments, every field 8 bytes (packed by the Python
// wrapper as 17 int64, ``lowrank_matmul._ARGS``).  qa: (slices, M, K),
// qw: (experts, K, N), out: (slices, M, N); ws: (slices, splits, M, N)
// f32 partials and counters: n_counters ints, all 0, one per (slice,
// output tile); both unused when splits == 1.  The K slices are
// [s * kps, min(K, (s + 1) * kps)) for s < splits.
struct LowrankArgs {
  const int* qa;
  const int* qw;
  const float* u;
  const float* v;
  float* out;
  float* ws;
  int* counters;
  int64_t n_counters, M, K, N, R, kps, splits, slices, experts;
  void* stream;
};

extern "C" int lowrank_matmul_launch(const LowrankArgs* a) {
  const int64_t M = a->M, K = a->K, N = a->N, R = a->R, kps = a->kps,
                splits = a->splits, slices = a->slices,
                experts = a->experts;
  if (R < 1 || R > kMaxRank || kps < 1 || splits < 1 || M < 1 || N < 1
      || K < 0 || K > INT32_MAX || splits * kps < K
      || (splits > 1 && (splits - 1) * kps >= K)
      || M * N > INT32_MAX || experts < 1 || slices < experts
      || slices % experts != 0 || slices > INT32_MAX
      || a->n_counters > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
#define LOWRANK_ARGS                                                      \
  a->qa, a->qw, a->u, a->v, a->out, a->ws, a->counters,                   \
      (int)a->n_counters, (int)M, (int)K, (int)N, (int)R, (int)kps,       \
      (int)splits, (int)slices, (int)experts, s
  if (M > kStreamRows && K * R >= kMinMmaTerms) {
    if (R <= 4) return launch_mma<16>(LOWRANK_ARGS);
    return launch_mma<8>(LOWRANK_ARGS);
  }
  if (M <= 1) return launch_stream<1>(LOWRANK_ARGS);
  if (M <= 2) return launch_stream<2>(LOWRANK_ARGS);
  if (M <= 4) return launch_stream<4>(LOWRANK_ARGS);
  if (M <= 8) return launch_stream<8>(LOWRANK_ARGS);
  return launch_stream<16>(LOWRANK_ARGS);
#undef LOWRANK_ARGS
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

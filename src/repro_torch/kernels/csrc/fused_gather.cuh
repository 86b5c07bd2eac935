// Shared body of every LUT-gather kernel: the 8-bit LUT matmul on codes
// (lut_matmul.cu, lut_matmul_bank.cu), the fused quantize -> LUT-gather
// -> accumulate kernels (fused_matmul.cu, fused_matmul_bank.cu,
// fused_composed_matmul.cu, fused_composed_matmul_bank.cu) and the
// two-step composed kernels on codes (composed_matmul.cu,
// composed_matmul_bank.cu).  For each lane l:
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
// Instantiated on int operands (In = int), the kernel reads x and w as
// int32 codes, stages them as they are (no quantize, no per-lane scalars:
// fp and ip are not read) and keeps no code sums (row_out and col_out
// are not written): composed_matmul*.cu take <true, int> (W-bit codes),
// lut_matmul*.cu <false, int> (8-bit codes; masks, rcodes and out_hi are
// not touched either, and every lane weighs 1 in the split).
//
// Bit-exact quantization: IEEE division (__fdiv_rn), rint (half to
// even, like jnp.round), + zero point in f32, clip, then the int cast
// — the reference's _quant_tile order.  No fast-math flags.
//
// What bounds it on an H100: shared-memory table lookups (one per
// product at 8 bits, four per product on a wide lane, at most 32 a clock
// per SM) and, on a wide lane, the integer work of the reduce tree; no
// tensor cores can do a data-dependent gather.
//
// Design:
//  * The product table sits in shared memory as uint16 (128 KiB): the
//    library's 8-bit multipliers and composed tiles are 16-output-bit
//    netlists, so every entry fits (the wrappers reject a table that
//    does not); the int32 table (256 KiB) would not fit a block.
//  * One persistent block per SM walks a contiguous range of (lane, row
//    tile, column tile, K range) work units, so a block stages a lane's
//    table and reads its scalars once per lane it meets, not per tile.
//  * The column tile is sized to the real N (kNT outputs a thread, 1..8
//    threads across N) instead of the TPU kernels' 128-wide pad, since
//    the case study's N is 10..64.
//  * K is walked in chunks of kKC, quantized while staged (loads issued
//    kBatch at a time); ragged M, N and K edges are masked, so no padded
//    term reaches a sum and no pad correction is needed.  Row sums are
//    kept by the threads of column group 0 and written by the
//    column-tile-0 unit, column sums by the threads of row 0 and written
//    by the row-tile-0 unit.
//  * K split: where the (lane, tile) items leave blocks idle (fewer items
//    than blocks: one lane at the deep layers has 64 items for 132 SMs;
//    a bank's thousands of items never split), each item's K is cut into
//    `splits` ranges of whole kKC chunks (k_splits picks the count that
//    shortens the busiest block most).  Each unit then adds its partial
//    sums into outputs zeroed first on the same stream (red.global.add
//    on uint32): bit-exact in any order, since every output is an
//    integer sum mod 2^32, and lo = acc - (hi << 16) is linear, so the
//    limbs' partials sum to the whole.  With one range the stores stay
//    plain stores.
//
// The table is swizzled: the threads of a warp share the column digit and
// differ in the row digit, and in a row-major uint16 table the bank of an
// entry is a function of the column digit alone, so every row of the warp
// would hit one bank (a 32/tn-way conflict); entry (a, w) sits at
// (a << 8) | (w ^ ((a & kSwizzle) << 1)) instead, which spreads the rows
// over the banks.  The composed kernels (K5-K8) add:
//  * a split balanced by cost: a wide lane's item weighs kWideCost, a
//    narrow one's kNarrowCost, and each block finds its range from the
//    lanes' masks on the device (range_start; with equal lanes, the even
//    split);
//  * one inner loop per reduce kind, chosen per lane (uniform across the
//    block, so no warp diverges), with the lane's constants hoisted and the
//    tree in closed forms that need no right shift (see tree()); codes the
//    closed forms do not take (loa with k = 0 or k >= 32) keep the guarded
//    runtime tree of registry.reduce_apply_dyn.
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
constexpr int kBatch = 8;       // staged loads in flight per thread
constexpr int kLutEntries = 65536;
// split weights of a wide and a narrow lane's item
constexpr int kWideCost = 5;
constexpr int kNarrowCost = 2;
// row bits of the table swizzle (0: row-major table)
constexpr unsigned kSwizzle = 31u;

// the inner loops, one per lane (the 8-bit kernels' lanes are narrow)
enum Path { kNarrow, kExact, kTrunc, kLoa8, kLoa, kDyn };

inline int threads_across_n(int n) {
  if (n <= 8) return 1;
  if (n <= 16) return 2;
  if (n <= 32) return 4;
  return 8;
}

// Work items (lane, row tile, column tile) of a launch.
inline long long gather_items(int n_lanes, int M, int N) {
  const int tn = threads_across_n(N);
  const int tm = kThreads / tn, tile_n = tn * kNT;
  return (long long)n_lanes * ((M + tm - 1) / tm)
       * ((N + tile_n - 1) / tile_n);
}

// K ranges per item.  With at least one item a block, 1: a split could
// shorten the busiest block by one item's share at most, and would
// multiply the output's adds.  With fewer items than blocks (idle SMs),
// the count s in [1, chunks] whose busiest block has the fewest kKC
// chunks to sum, ceil(items s / grid) units of at most ceil(chunks / s)
// chunks each; ties go to the smaller s, so s = 1 wherever a split would
// not shorten the busiest block.  (Mirrored by
// kernels.fused_matmul.k_split.)
inline int k_splits(long long items, int chunks, int grid) {
  if (items >= grid) return 1;
  int best = 1;
  long long best_work = -1;
  for (int s = 1; s <= chunks; ++s) {
    const long long work =
        (items * s + grid - 1) / grid * ((chunks + s - 1) / s);
    if (best_work < 0 || work < best_work) {
      best = s;
      best_work = work;
    }
  }
  return best;
}

// table, row tile and two column-digit tiles (the 8-bit kernels use one)
inline size_t smem_bytes(int tn) {
  const int tm = kThreads / tn;
  return kLutEntries * sizeof(uint16_t)
       + (size_t)tm * (kKC + 1) * sizeof(int)
       + 2 * (size_t)kKC * tn * kNT * sizeof(int);
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

// A lane's reduce tree: its inner loop and the constants hoisted out of it.
struct Tree {
  int path;
  unsigned mask;    // 2W-bit product mask (0: narrow lane)
  unsigned h;       // trunc: the bits from k up (0 from k = 32 on)
  unsigned cbit;    // loa: 1 << (k - 1)
  unsigned lowm1;   // loa: cbit - 1
  int kind;         // the runtime code, for kDyn
  unsigned k;
};

__device__ __forceinline__ Tree lane_tree(unsigned mask, int kind,
                                          unsigned k) {
  Tree t;
  t.mask = mask;
  t.kind = kind;
  t.k = k;
  t.h = k < 32u ? ~0u << k : 0u;
  t.cbit = k - 1u < 31u ? 1u << (k - 1u) : 0u;
  t.lowm1 = t.cbit - 1u;
  const int wide = kind == 0 ? kExact
                 : kind == 1 ? kTrunc
                 : k - 1u < 8u ? kLoa8
                 : k - 1u < 31u ? kLoa : kDyn;
  t.path = mask == 0u ? kNarrow : wide;
  return t;
}

// loa node for 1 <= k <= 31: with c = a & b, the lower-part-OR sum is
// a + b + (c & cbit) - (c & lowm1) mod 2^32 (the low part's OR is the
// low sum less the low AND; the carry into bit k is bit k-1 of c).
__device__ __forceinline__ unsigned loa_node(unsigned a, unsigned b,
                                             const Tree& t) {
  const unsigned c = a & b;
  return a + b + (c & t.cbit) - (c & t.lowm1);
}

// The tree of registry.reduce_apply_dyn in closed form, mod 2^32:
//  exact  p00 + (p01 + p10) << 8 + p11 << 16;
//  trunc  ((a >> k) + (b >> k)) << k == (a & h) + (b & h), and a sum of
//         such terms keeps its low k bits clear, so the inner nodes need
//         no second mask;
//  loa    loa_node at every node; a node whose second operand has its low
//         k bits clear adds (s1 << 8 for k <= 8, p11 << 16 for k <= 16),
//         which kLoa8 uses.
template <int kPath>
__device__ __forceinline__ unsigned tree(unsigned p00, unsigned p01,
                                         unsigned p10, unsigned p11,
                                         const Tree& t) {
  if (kPath == kExact) return p00 + ((p01 + p10) << 8) + (p11 << 16);
  if (kPath == kTrunc)
    return (p00 & t.h) + (((p01 & t.h) + (p10 & t.h)) << 8)
         + ((p11 << 16) & t.h);
  if (kPath == kLoa8) return p00 + (loa_node(p01, p10, t) << 8) + (p11 << 16);
  if (kPath == kLoa)
    return loa_node(loa_node(p00, loa_node(p01, p10, t) << 8, t), p11 << 16,
                    t);
  return composed_tree(p00, p01, p10, p11, t.kind, t.k);
}

// Byte offset of row a of the staged table with its swizzle key: entry
// (a, w) is at row_addr(a) ^ (w << 1).
__device__ __forceinline__ unsigned row_addr(unsigned a) {
  return (a << 9) | ((a & kSwizzle) << 2);
}

__device__ __forceinline__ unsigned lookup(const unsigned char* lut,
                                           unsigned addr) {
  return *reinterpret_cast<const uint16_t*>(lut + addr);
}

// Stage a lane's table with row a's 16-byte chunks permuted by
// (a & kSwizzle) >> 2 and the words in a chunk by a & 3, which puts entry
// (a, w) at (a << 8) | (w ^ ((a & kSwizzle) << 1)) (row-major when
// kSwizzle is 0).
__device__ __forceinline__ void stage_table(const uint16_t* lut,
                                            uint16_t* s_lut) {
  const uint4* src = reinterpret_cast<const uint4*>(lut);
  uint4* dst = reinterpret_cast<uint4*>(s_lut);
  for (int i = threadIdx.x; i < kLutEntries * 2 / 16; i += kThreads) {
    uint4 v = src[i];
    const unsigned a = (unsigned)i >> 5, key = a & kSwizzle;
    if (key & 1u) v = make_uint4(v.y, v.x, v.w, v.z);
    if (key & 2u) v = make_uint4(v.z, v.w, v.x, v.y);
    dst[(a << 5) | ((i & 31) ^ (key >> 2))] = v;
  }
}

// Cost of lane l's items when splitting: kWideCost on a wide lane
// (mask != 0), else kNarrowCost; every lane weighs 1 without masks.
__device__ __forceinline__ long long lane_cost(const unsigned* masks,
                                               int l) {
  if (masks == nullptr) return 1;
  return masks[l] != 0u ? kWideCost : kNarrowCost;
}

// First item of block b's range out of G: the number of items whose
// cost, summed from item 0 through the item itself, is at most b / G of
// the total.  The ranges are contiguous and lane-major and cover every
// item once; a block's cost exceeds total / G by at most one item's;
// with equal lanes the start is total * b / G, the even split.
// (Mirrored by kernels.fused_matmul.split_starts.)
__device__ long long range_start(const unsigned* masks, int n_lanes,
                                 long long per_lane, long long b,
                                 long long G) {
  long long total_cost = 0;
  for (int l = 0; l < n_lanes; ++l) total_cost += lane_cost(masks, l);
  const long long target = b * total_cost * per_lane;
  long long start = 0, before = 0;          // before: cost of lanes < l
  for (int l = 0; l < n_lanes; ++l) {
    const long long c = lane_cost(masks, l);
    long long n = (target - G * before) / (G * c);
    n = n < 0 ? 0 : n > per_lane ? per_lane : n;
    start += n;
    if (n < per_lane) break;
    before += per_lane * c;
  }
  return start;
}

// A unit's partial sum into its output: a plain store when K is not
// split, else an add mod 2^32 into the zeroed output (red.global.add.u32).
__device__ __forceinline__ void put(int* p, unsigned v, bool add) {
  if (add)
    atomicAdd(reinterpret_cast<unsigned*>(p), v);
  else
    *p = (int)v;
}

// One K chunk of a narrow lane (8-bit codes, or a composed kernel's
// narrow lane): the plain tile sum of the low digits (w0s: the column
// digits, doubled).
__device__ __forceinline__ void narrow_chunk(const int* a_row,
                                             const int* w0s, int tile_n,
                                             int kc,
                                             const unsigned char* lut,
                                             unsigned (&acc)[kNT]) {
#pragma unroll 4
  for (int kk = 0; kk < kc; ++kk) {
    const unsigned r0 = row_addr((unsigned)a_row[kk] & 255u);
    const int4 x0 = *reinterpret_cast<const int4*>(w0s + kk * tile_n);
    const int4 x1 = *reinterpret_cast<const int4*>(w0s + kk * tile_n + 4);
    const unsigned w0[kNT] = {(unsigned)x0.x, (unsigned)x0.y, (unsigned)x0.z,
                              (unsigned)x0.w, (unsigned)x1.x, (unsigned)x1.y,
                              (unsigned)x1.z, (unsigned)x1.w};
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[j] += lookup(lut, r0 ^ w0[j]);
  }
}

// One K chunk of a wide lane: four lookups per product, the lane's tree
// and mask, then acc += p and hi += p >> 16 (lo is acc - (hi << 16) at
// the end: exact, since the lo sum stays below 2^31).
template <int kPath>
__device__ __forceinline__ void wide_chunk(const int* a_row, const int* w0s,
                                           const int* w1s, int tile_n,
                                           int kc, const unsigned char* lut,
                                           const Tree& t,
                                           unsigned (&acc)[kNT],
                                           unsigned (&hi)[kNT]) {
#pragma unroll 2
  for (int kk = 0; kk < kc; ++kk) {
    const unsigned qa = (unsigned)a_row[kk];
    const unsigned r0 = row_addr(qa & 255u), r1 = row_addr(qa >> 8);
    const int4 x0 = *reinterpret_cast<const int4*>(w0s + kk * tile_n);
    const int4 x1 = *reinterpret_cast<const int4*>(w0s + kk * tile_n + 4);
    const int4 y0 = *reinterpret_cast<const int4*>(w1s + kk * tile_n);
    const int4 y1 = *reinterpret_cast<const int4*>(w1s + kk * tile_n + 4);
    const unsigned w0[kNT] = {(unsigned)x0.x, (unsigned)x0.y, (unsigned)x0.z,
                              (unsigned)x0.w, (unsigned)x1.x, (unsigned)x1.y,
                              (unsigned)x1.z, (unsigned)x1.w};
    const unsigned w1[kNT] = {(unsigned)y0.x, (unsigned)y0.y, (unsigned)y0.z,
                              (unsigned)y0.w, (unsigned)y1.x, (unsigned)y1.y,
                              (unsigned)y1.z, (unsigned)y1.w};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const unsigned p = tree<kPath>(lookup(lut, r0 ^ w0[j]),
                                     lookup(lut, r0 ^ w1[j]),
                                     lookup(lut, r1 ^ w0[j]),
                                     lookup(lut, r1 ^ w1[j]), t) & t.mask;
      acc[j] += p;
      hi[j] += p >> 16;
    }
  }
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
             int n_lanes, int M, int K, int N, int tn, int splits) {
  // f32 operands are quantized per lane and their code sums kept; int32
  // codes are staged as they are
  constexpr bool kQuant = std::is_same<In, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  const int tm = kThreads / tn;            // rows per tile
  const int tile_n = tn * kNT;             // columns per tile
  int* s_a = reinterpret_cast<int*>(smem + kLutEntries * sizeof(uint16_t));
  // low and high column digits, doubled (a uint16 entry's byte offset);
  // the 8-bit kernels stage the low ones only
  int* s_w = s_a + tm * (kKC + 1);
  int* s_w1 = s_w + kKC * tile_n;

  const unsigned char* lut = smem;
  const int tid = threadIdx.x;
  const int r = tid / tn;                  // this thread's row in a tile
  const int g = tid % tn;                  // its column group
  const int tiles_m = (M + tm - 1) / tm;
  const int tiles_n = (N + tile_n - 1) / tile_n;
  const int chunks = (K + kKC - 1) / kKC;
  const bool add = splits > 1;             // partial sums: add, not store
  // work units per lane: (row tile, column tile) items x K ranges
  const long long per_lane = (long long)tiles_m * tiles_n * splits;
  const unsigned* cost_masks = kComposed ? masks : nullptr;
  const long long begin =
      range_start(cost_masks, n_lanes, per_lane, blockIdx.x, gridDim.x);
  const long long end =
      range_start(cost_masks, n_lanes, per_lane, blockIdx.x + 1, gridDim.x);

  int staged_lane = -1;
  float sa = 0.f, sw = 0.f, qmax = 0.f, za = 0.f, zw = 0.f;
  Tree tr = lane_tree(0u, 0, 0u);
  for (long long item = begin; item < end; ++item) {
    const int lane = (int)(item / per_lane);
    const long long rem = item % per_lane;
    const long long tile = rem / splits;
    const int part = (int)(rem % splits);  // K range: whole kKC chunks
    const int m0 = (int)(tile / tiles_n) * tm;
    const int n0 = (int)(tile % tiles_n) * tile_n;
    const int k_begin = (int)((long long)part * chunks / splits) * kKC;
    const int k_end =
        min(K, (int)((long long)(part + 1) * chunks / splits) * kKC);

    if (lane != staged_lane) {
      __syncthreads();                     // previous table no longer read
      stage_table(luts + (size_t)lane * kLutEntries, s_lut);
      if (kQuant) {
        sa = fp[lane * 3];
        sw = fp[lane * 3 + 1];
        qmax = fp[lane * 3 + 2];
        za = (float)ip[lane * 2];
        zw = (float)ip[lane * 2 + 1];
      }
      if (kComposed)
        tr = lane_tree(masks[lane], rcodes[lane * 2],
                       (unsigned)rcodes[lane * 2 + 1]);
      staged_lane = lane;
    }
    const In* x_lane = x + (size_t)lane * x_lane_stride;
    const In* w_lane = w + (size_t)lane * w_lane_stride;

    // unsigned: int32 sums wrap modulo 2^32 like the reference's
    unsigned acc[kNT], hi[kNT], col_sum[kNT];
    unsigned row_sum = 0u;
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[j] = hi[j] = col_sum[j] = 0u;

    for (int k0 = k_begin; k0 < k_end; k0 += kKC) {
      const int kc = min(kKC, K - k0);
      __syncthreads();                     // previous chunk consumed
      for (int e0 = tid; e0 < tm * kKC; e0 += kBatch * kThreads) {
        In v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          const int m = m0 + e / kKC, kk = e % kKC;
          v[u] = e < tm * kKC && m < M && kk < kc
                     ? x_lane[(size_t)m * K + k0 + kk] : In(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          const int rr = e / kKC, kk = e % kKC;
          if (e < tm * kKC)
            s_a[rr * (kKC + 1) + kk] =
                m0 + rr < M && kk < kc ? stage_code(v[u], sa, za, qmax) : 0;
        }
      }
      for (int e0 = tid; e0 < kKC * tile_n; e0 += kBatch * kThreads) {
        In v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          const int kk = e / tile_n, n = n0 + e % tile_n;
          v[u] = e < kKC * tile_n && n < N && kk < kc
                     ? w_lane[(size_t)(k0 + kk) * N + n] : In(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int e = e0 + u * kThreads;
          const int kk = e / tile_n, n = n0 + e % tile_n;
          if (e < kKC * tile_n) {
            const int q =
                n < N && kk < kc ? stage_code(v[u], sw, zw, qmax) : 0;
            s_w[e] = (q & 255) << 1;
            if (kComposed) s_w1[e] = (q >> 8) << 1;
          }
        }
      }
      __syncthreads();                     // chunk (and table) staged

      const int* a_row = s_a + r * (kKC + 1);
      const int* w_grp = s_w + g * kNT;
      const int* w1_grp = s_w1 + g * kNT;
      if (kQuant && g == 0)
        for (int kk = 0; kk < kc; ++kk) row_sum += (unsigned)a_row[kk];
      if (kQuant && r == 0)
        for (int kk = 0; kk < kc; ++kk)
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            const int i = kk * tile_n + j;
            col_sum[j] += ((unsigned)w_grp[i]
                           + (kComposed ? (unsigned)w1_grp[i] << 8 : 0u)) >> 1;
          }

      switch (kComposed ? tr.path : kNarrow) {
        case kNarrow:
          narrow_chunk(a_row, w_grp, tile_n, kc, lut, acc);
          break;
        case kExact:
          wide_chunk<kExact>(a_row, w_grp, w1_grp, tile_n, kc, lut, tr,
                             acc, hi);
          break;
        case kTrunc:
          wide_chunk<kTrunc>(a_row, w_grp, w1_grp, tile_n, kc, lut, tr,
                             acc, hi);
          break;
        case kLoa8:
          wide_chunk<kLoa8>(a_row, w_grp, w1_grp, tile_n, kc, lut, tr,
                            acc, hi);
          break;
        case kLoa:
          wide_chunk<kLoa>(a_row, w_grp, w1_grp, tile_n, kc, lut, tr,
                           acc, hi);
          break;
        default:
          wide_chunk<kDyn>(a_row, w_grp, w1_grp, tile_n, kc, lut, tr,
                           acc, hi);
      }
    }

    const int m = m0 + r;
    if (m < M) {
      const size_t o = ((size_t)lane * M + m) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + g * kNT + j;
        if (n < N) {
          put(out_lo + o + n, kComposed ? acc[j] - (hi[j] << 16) : acc[j],
              add);
          if (kComposed) put(out_hi + o + n, hi[j], add);
        }
      }
      if (kQuant && n0 == 0 && g == 0)
        put(row_out + (size_t)lane * M + m, row_sum, add);
    }
    if (kQuant && m0 == 0 && r == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + g * kNT + j;
        if (n < N) put(col_out + (size_t)lane * N + n, col_sum[j], add);
      }
    }
  }
}

// Launch on `stream` with `grid` persistent blocks; returns the first
// CUDA error of the launch (the outputs' zeroing when K is split, then
// cudaGetLastError()).
template <bool kComposed, typename In>
inline int launch(const In* x, long long x_lane_stride, const In* w,
                  long long w_lane_stride,
                  const uint16_t* luts, const float* fp, const int* ip,
                  const unsigned* masks, const int* rcodes, int* out_lo,
                  int* out_hi, int* row_out, int* col_out, int n_lanes,
                  int M, int K, int N, int grid, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<In, float>::value;
  const int tn = threads_across_n(N);
  const int splits =
      k_splits(gather_items(n_lanes, M, N), (K + kKC - 1) / kKC, grid);
  if (splits > 1) {                        // the units add into zeros
    const size_t mn = (size_t)n_lanes * M * N * sizeof(int);
    int* zero[4] = {out_lo, kComposed ? out_hi : nullptr,
                    kQuant ? row_out : nullptr, kQuant ? col_out : nullptr};
    const size_t bytes[4] = {mn, mn, (size_t)n_lanes * M * sizeof(int),
                             (size_t)n_lanes * N * sizeof(int)};
    for (int i = 0; i < 4; ++i) {
      if (zero[i] == nullptr) continue;
      const cudaError_t err = cudaMemsetAsync(zero[i], 0, bytes[i], stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
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
      out_lo, out_hi, row_out, col_out, n_lanes, M, K, N, tn, splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fusedmm

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
// are per lane, (n_lanes, K, N)); luts: uint16 (n_lanes, 256, 256);
// Scalars: sa, za, sw, zw, qmax, each read through its own pointer with
// its own lane stride (0 when the lanes share it; f32, za and zw int32),
// or passed by value when its pointer is null, so the calibration's
// tensors go in as they are and a call queues no packing kernel;
// masks: uint32 (n_lanes,); rcodes: int32 (n_lanes, 2) = encode_reduce
// (kind, k).  No launch waits on the host.  The f32 correction and
// dequant stay with the caller (eager PyTorch), as the TPU kernels leave
// them to theirs.
//
// The expert axis (an MoE projection's E experts in one launch, as the
// reference's batched pallas_call runs them): each lane holds `slices`
// operand slices, and a work item's (lane, slice) pair p = lane * slices
// + s has lane `lane`'s table, the activations at x + lane * x_lane_stride
// + s * M * K, the weights at w + lane * w_lane_stride + (s % experts) * K
// * N (several token blocks' buffers may follow one another, each over
// the E experts), pair p's scalars and outputs (acc, row and column sums
// at p).  Pairs run lane-major, slice-minor, so a block stages a lane's
// table once for every slice it walks; a composed pair has its lane's
// mask and reduce code and costs as its lane does in the split.  slices
// = experts = 1 is the launch without that axis.
//
// Instantiated on int operands (In = int), the kernel reads x and w as
// int32 codes, stages them as they are (no quantize, no per-lane scalars
// are read) and keeps no code sums (row_out and col_out are not
// written): composed_matmul*.cu take <true, int> (W-bit codes),
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
//  * K is walked in chunks of kKC, quantized while staged (fused_kernel:
//    loads issued kBatch at a time, between two barriers); ragged M, N
//    and K edges are masked, so no padded term reaches a sum and no pad
//    correction is needed.  In fused_kernel (K7, K8) row sums are kept by
//    the threads of column group 0 and written by the column-tile-0 unit,
//    column sums by the threads of row 0 and written by the row-tile-0
//    unit; K3/K4 make them at staging (below).
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
//
// The 8-bit float kernels (K3, K4: quant8_kernel) stage their chunks in
// a kernel of their own, where the other six keep fused_kernel's two
// barriers a chunk:
//  * Two operand buffers, one barrier a chunk.  Every thread issues the
//    f32 loads of chunk c + 1 (a warp's rows of A, up to kARegs a thread,
//    and its W elements, in registers: `Staged`), gathers chunk c from
//    one buffer while they are in flight, then quantizes them (__fdiv_rn,
//    rint, clip) into the other buffer; one __syncthreads hands the
//    buffers over.  The loads' latency hides under the gather, and the
//    block waits once a chunk, not twice.
//  * Codes as bytes: a row of A codes is kARow bytes (kKC codes and a
//    pad word, so the 32 / tn rows a warp reads fall in distinct banks),
//    read four k steps a 32-bit load; a chunk's W codes are kKC x tile_n
//    bytes, a thread's eight columns one 8-byte load a k step (the int32
//    tiles took an A load a step and two 16-byte W loads).  Two buffers
//    then fit beside the table at every tile (170 528 bytes at tn = 1;
//    the int32 A tile alone was 67 584 there).
//  * Code sums where the codes are made: a warp quantizes whole rows (row
//    e / kKC, k e % kKC of element e = t + i kThreads), so a row's chunk
//    sum is one __reduce_add_sync, kept in shared memory by the lane that
//    writes it out; every W element a thread makes lies in column
//    t % tile_n (tile_n divides kThreads), so its column sum is one
//    register, reduced across the threads once per unit (warp shuffles,
//    then shared atomics).  Row sums are made only by units of
//    column tile 0 and column sums only by units of row tile 0, the ones
//    that write them (a branch uniform across the block).
//  * The table is staged by the threads' 16-byte copy before a lane's
//    first chunk; a unit's first loads are issued before the copy, under
//    which their latency hides.
//  * Outputs (of K7/K8 too, launch_quant): one allocation, the
//    accumulator (K7/K8: the limbs lo, hi), then the row sums, then the
//    column sums, so where K is split one memset zeroes them.
//  * The tile follows M as well as N (quant8_tile): of a few compiled
//    tiles (kQuant8Tiles: tn threads across N, `rows` rows a thread), the
//    one whose tiles gather the fewest padded rows and columns, the
//    tile above (one row a thread, tm = kThreads / tn) on a tie.  An
//    MoE expert's capacity buffer (qwen3-moe: M = 80 rows) takes 80 x
//    256 (tn 32, five rows a thread) where the 64-row tile gathered 128
//    rows for 80; each step's eight W codes are read once for a thread's
//    rows, and a chunk's W codes are quantized once for all 80.  M = 4
//    (a decode step) takes 16 x 256.  A warp then shares one row set, so
//    its A reads are broadcasts.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// Internal linkage throughout: each kernel library carries its own copy,
// and nothing here (least of all the once-only flags in launch) may be
// merged with another library's copy when several are loaded.
namespace fusedmm {

// The quantization scalars of every lane: sa, za, sw, zw, qmax (za and
// zw int32, the others f32), each read at ptr[i] + lane * stride[i]
// (stride 0: one value for every lane), or value[i] when ptr[i] is null.
// Outside the unnamed namespace: the extern "C" launch functions take it
// by value, and a type of internal linkage would hide them.
struct Scalars {
  const void* ptr[5];
  long long stride[5];
  float value[5];
};

namespace {

constexpr int kThreads = 512;   // threads per block
constexpr int kNT = 8;          // outputs per thread along N
constexpr int kKC = 32;         // K chunk staged per step
constexpr int kBatch = 8;       // staged loads in flight per thread
constexpr int kLutEntries = 65536;
constexpr int kMaxDevices = 64;  // device ordinals the opt-in tracks
// split weights of a wide and a narrow lane's item
constexpr int kWideCost = 5;
constexpr int kNarrowCost = 2;
// row bits of the table swizzle (0: row-major table)
constexpr unsigned kSwizzle = 31u;
// quant8_kernel: operand buffers, chunk c + 1's loads issued before
// chunk c's gather, A rows and W elements a thread stages a chunk, bytes
// a staged A row; code sums kept by the gathering threads in their loop
// in place of the staging (the last three switches are gather_ablation's)
constexpr int kStages = 2;
constexpr bool kPrefetch = true;
constexpr int kARegs = 32;
constexpr int kWRegs = 4;
constexpr int kARow = kKC + 4;
constexpr bool kSumsInLoop = false;
static_assert(kThreads / 32 * kARegs >= kThreads &&
              kWRegs * kThreads >= kKC * 8 * kNT,
              "a thread's registers hold its share of a chunk at every tile");

enum { kSa, kZa, kSw, kZw, kQmax };

// the inner loops, one per lane (the 8-bit kernels' lanes are narrow)
enum Path { kNarrow, kExact, kTrunc, kLoa8, kLoa, kDyn };

inline int threads_across_n(int n) {
  if (n <= 8) return 1;
  if (n <= 16) return 2;
  if (n <= 32) return 4;
  return 8;
}

// A launch's tile: tn threads across N, each gathering `rows` rows of kNT
// columns, so tm = kThreads / tn * rows rows by tile_n = tn kNT columns.
struct Tile {
  int tn, rows;
  int tm() const { return kThreads / tn * rows; }
  int tile_n() const { return tn * kNT; }
};

// The tile of every kernel but quant8_kernel: one row a thread, the
// column tile sized to N.
inline Tile gather_tile(int N) { return Tile{threads_across_n(N), 1}; }

// quant8_kernel's compiled tiles, {tn, rows}, in the order the plan
// prefers them on a tie; tn 0 is gather_tile(N), the tile above.  (Each
// is an instantiation of quant8_kernel; mirrored by
// kernels.fused_matmul.QUANT8_TILES.)
constexpr int kQuant8Tiles[][2] = {{0, 1}, {32, 5}, {32, 1}};
constexpr int kNumQuant8Tiles = 3;

inline Tile quant8_tile_at(int i, int N) {
  return kQuant8Tiles[i][0] ? Tile{kQuant8Tiles[i][0], kQuant8Tiles[i][1]}
                            : gather_tile(N);
}

// (Row, column) slots the tiles of one (lane, slice) pair gather: M x N
// and the padded rows and columns of its edge tiles.
inline long long gathered_slots(int M, int N, Tile t) {
  const int tm = t.tm(), tile_n = t.tile_n();
  return (long long)((M + tm - 1) / tm) * tm
       * ((N + tile_n - 1) / tile_n) * tile_n;
}

// quant8_kernel's tile for an M x N launch: the index in kQuant8Tiles of
// the tile that gathers the fewest slots, the first listed on a tie (so
// gather_tile(N) wherever it pads no more than the others).  (Mirrored by
// kernels.fused_matmul.quant8_tile.)
inline int quant8_tile(int M, int N) {
  int best = 0;
  for (int i = 1; i < kNumQuant8Tiles; ++i)
    if (gathered_slots(M, N, quant8_tile_at(i, N))
        < gathered_slots(M, N, quant8_tile_at(best, N)))
      best = i;
  return best;
}

// Work items (lane, row tile, column tile) of a launch.
inline long long gather_items(int n_lanes, int M, int N, Tile t) {
  const int tm = t.tm(), tile_n = t.tile_n();
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

// fused_kernel's table, row tile and column-digit tiles (two composed,
// one at 8 bits)
inline size_t smem_bytes(int tn, bool composed) {
  const int tm = kThreads / tn;
  return kLutEntries * sizeof(uint16_t)
       + (size_t)tm * (kKC + 1) * sizeof(int)
       + (composed ? 2 : 1) * (size_t)kKC * tn * kNT * sizeof(int);
}

// quant8_kernel's table, kStages byte buffers of the A and W codes, the
// row sums (tm) and the column sums (tile_n), all offsets multiples of 16
inline size_t quant_smem_bytes(Tile t) {
  const int tm = t.tm(), tile_n = t.tile_n();
  return kLutEntries * sizeof(uint16_t)
       + kStages * ((size_t)tm * kARow + (size_t)kKC * tile_n)
       + (size_t)(tm + tile_n) * sizeof(unsigned);
}

__device__ __forceinline__ int quantize(float v, float scale, float zp,
                                        float qmax) {
  const float q = rintf(__fdiv_rn(v, scale)) + zp;
  return (int)fminf(fmaxf(q, 0.0f), qmax);
}

// Lane l's scalar i as f32 (za and zw are exact: codes below 2^24).
__device__ __forceinline__ float lane_scalar(const Scalars& s, int i,
                                             int l) {
  if (s.ptr[i] == nullptr) return s.value[i];
  const long long at = (long long)l * s.stride[i];
  return i == kZa || i == kZw ? (float)static_cast<const int*>(s.ptr[i])[at]
                              : static_cast<const float*>(s.ptr[i])[at];
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
// Thread t of T copies every T-th 16-byte chunk.
__device__ __forceinline__ void stage_table(const uint16_t* lut,
                                            uint16_t* s_lut, int t, int T) {
  const uint4* src = reinterpret_cast<const uint4*>(lut);
  uint4* dst = reinterpret_cast<uint4*>(s_lut);
#pragma unroll 4
  for (int i = t; i < kLutEntries * 2 / 16; i += T) {
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
// the total.  Items come in n_pairs runs of per_pair, one run a (lane,
// slice) pair p, which costs as its lane p / slices does.  The ranges
// are contiguous and pair-major and cover every item once; a block's
// cost exceeds total / G by at most one item's; with equal lanes the
// start is total * b / G, the even split.  (Mirrored by
// kernels.fused_matmul.split_starts, given each pair's cost.)
__device__ long long range_start(const unsigned* masks, int n_pairs,
                                 int slices, long long per_pair,
                                 long long b, long long G) {
  long long total_cost = 0;
  for (int p = 0; p < n_pairs; ++p)
    total_cost += lane_cost(masks, p / slices);
  const long long target = b * total_cost * per_pair;
  long long start = 0, before = 0;          // before: cost of pairs < p
  for (int p = 0; p < n_pairs; ++p) {
    const long long c = lane_cost(masks, p / slices);
    long long n = (target - G * before) / (G * c);
    n = n < 0 ? 0 : n > per_pair ? per_pair : n;
    start += n;
    if (n < per_pair) break;
    before += per_pair * c;
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
             const uint16_t* __restrict__ luts, Scalars sc,
             const unsigned* __restrict__ masks,
             const int* __restrict__ rcodes,
             int* __restrict__ out_lo, int* __restrict__ out_hi,
             int* __restrict__ row_out, int* __restrict__ col_out,
             int n_lanes, int slices, int experts, int M, int K, int N,
             int tn, int splits) {
  // f32 operands are quantized per (lane, slice) pair and their code sums
  // kept; int32 codes are staged as they are
  constexpr bool kQuant = std::is_same<In, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  const int tm = kThreads / tn;            // rows per tile
  const int tile_n = tn * kNT;             // columns per tile
  int* s_a = reinterpret_cast<int*>(smem + kLutEntries * sizeof(uint16_t));
  // low and high column digits, doubled (a uint16 entry's byte offset);
  // the 8-bit kernels stage the low ones only (and have no s_w1)
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
  // work units per pair: (row tile, column tile) items x K ranges; the
  // composed kernels weigh a pair's items by its lane's mask
  const long long per_pair = (long long)tiles_m * tiles_n * splits;
  const unsigned* cost_masks = kComposed ? masks : nullptr;
  const int n_pairs = n_lanes * slices;
  const long long begin =
      range_start(cost_masks, n_pairs, slices, per_pair, blockIdx.x,
                  gridDim.x);
  const long long end = range_start(cost_masks, n_pairs, slices, per_pair,
                                    blockIdx.x + 1, gridDim.x);

  int staged_lane = -1, staged_pair = -1;
  float sa = 0.f, sw = 0.f, qmax = 0.f, za = 0.f, zw = 0.f;
  Tree tr = lane_tree(0u, 0, 0u);
  for (long long item = begin; item < end; ++item) {
    const int pair = (int)(item / per_pair);
    const int lane = pair / slices, slice = pair % slices;
    const long long rem = item % per_pair;
    const long long tile = rem / splits;
    const int part = (int)(rem % splits);  // K range: whole kKC chunks
    const int m0 = (int)(tile / tiles_n) * tm;
    const int n0 = (int)(tile % tiles_n) * tile_n;
    const int k_begin = (int)((long long)part * chunks / splits) * kKC;
    const int k_end =
        min(K, (int)((long long)(part + 1) * chunks / splits) * kKC);

    if (lane != staged_lane) {
      __syncthreads();                     // previous table no longer read
      stage_table(luts + (size_t)lane * kLutEntries, s_lut, tid, kThreads);
      if (kComposed)
        tr = lane_tree(masks[lane], rcodes[lane * 2],
                       (unsigned)rcodes[lane * 2 + 1]);
      staged_lane = lane;
    }
    if (kQuant && pair != staged_pair) {
      sa = lane_scalar(sc, kSa, pair);
      za = lane_scalar(sc, kZa, pair);
      sw = lane_scalar(sc, kSw, pair);
      zw = lane_scalar(sc, kZw, pair);
      qmax = lane_scalar(sc, kQmax, pair);
      staged_pair = pair;
    }
    const In* x_lane =
        x + (size_t)lane * x_lane_stride + (size_t)slice * M * K;
    const In* w_lane = w + (size_t)lane * w_lane_stride
                     + (size_t)(slice % experts) * K * N;

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
      const size_t o = ((size_t)pair * M + m) * N;
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
        put(row_out + (size_t)pair * M + m, row_sum, add);
    }
    if (kQuant && m0 == 0 && r == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + g * kNT + j;
        if (n < N) put(col_out + (size_t)pair * N + n, col_sum[j], add);
      }
    }
  }
}

// ---- quant8_kernel: the 8-bit float kernels (K3, K4) ----

// A unit of work, decoded from its index: its (lane, slice) pair, tile
// and K range.
struct Unit {
  int pair, lane, slice, m0, n0, k_begin, k_end;
};

__device__ __forceinline__ Unit decode_unit(long long item,
                                            long long per_pair, int slices,
                                            int splits, int tiles_n, int tm,
                                            int tile_n, int chunks, int K) {
  Unit u;
  u.pair = (int)(item / per_pair);
  u.lane = u.pair / slices;
  u.slice = u.pair % slices;
  const long long rem = item % per_pair;
  const long long tile = rem / splits;
  const int part = (int)(rem % splits);
  u.m0 = (int)(tile / tiles_n) * tm;
  u.n0 = (int)(tile % tiles_n) * tile_n;
  u.k_begin = (int)((long long)part * chunks / splits) * kKC;
  u.k_end = min(K, (int)((long long)(part + 1) * chunks / splits) * kKC);
  return u;
}

// The quantization scalars of one lane.
struct Quant {
  float sa, za, sw, zw, qmax;
};

// A thread's raw operands of a chunk: a[j] the A element of its warp's
// row j (row warp + j warps of the tile, k = lane), w[j] the W element
// e = t + j kThreads; kA and kW are the most a tile of the kernel stages.
template <int kA, int kW>
struct Staged {
  float a[kA];
  float w[kW];
};

// Issue thread t's loads of the chunk at k0 (kc codes deep) of unit u,
// whose pair's operands are x_lane and w; masked elements are 0.
template <int kA, int kW>
__device__ __forceinline__ void load_chunk(
    Staged<kA, kW>& v, const float* __restrict__ x_lane,
    const float* __restrict__ w, const Unit& u, int k0, int kc, int M,
    int K, int N, int tm, int tile_n, int t) {
  const int lane = t & 31, warp = t >> 5, warps = kThreads >> 5;
  const int rows = tm / warps;             // rows a warp quantizes
  const bool k_in = lane < kc;
#pragma unroll
  for (int j = 0; j < kA; ++j) {
    const int m = u.m0 + warp + j * warps;
    v.a[j] = j < rows && m < M && k_in ? x_lane[(size_t)m * K + k0 + lane]
                                       : 0.0f;
  }
  const int nn = t % tile_n;               // this thread's column
  const bool n_in = u.n0 + nn < N;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const int e = t + j * kThreads, kk = e / tile_n;
    v.w[j] = e < kKC * tile_n && n_in && kk < kc
                 ? w[(size_t)(k0 + kk) * N + u.n0 + nn] : 0.0f;
  }
}

// Quantize thread t's operands into one buffer as bytes (0 where
// masked): a warp makes whole rows, so a row's chunk sum is one warp
// reduction, added to s_row by lane j % 32, which writes it out
// (sums_out); every W element of thread t lies in column t % tile_n, so
// csum keeps their sum.
template <int kA, int kW>
__device__ __forceinline__ void store_chunk(
    const Staged<kA, kW>& v, const Unit& u, int kc, int M, int N, int tm,
    int tile_n, const Quant& q, unsigned char* a_buf, unsigned char* w_buf,
    unsigned* s_row, unsigned& csum, int t) {
  const int lane = t & 31, warp = t >> 5, warps = kThreads >> 5;
  const int rows = tm / warps;
  const bool row_on = !kSumsInLoop && u.n0 == 0;
  const bool col_on = !kSumsInLoop && u.m0 == 0;
  const bool k_in = lane < kc;
#pragma unroll
  for (int j = 0; j < kA; ++j) {
    if (j < rows) {                        // uniform across the warp
      const int rr = warp + j * warps;
      const unsigned c = u.m0 + rr < M && k_in
          ? (unsigned)quantize(v.a[j], q.sa, q.za, q.qmax) : 0u;
      a_buf[rr * kARow + lane] = (unsigned char)c;
      if (row_on) {
        const unsigned s = __reduce_add_sync(0xffffffffu, c);
        if (lane == (j & 31)) s_row[rr] += s;
      }
    }
  }
  const bool n_in = u.n0 + t % tile_n < N;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const int e = t + j * kThreads, kk = e / tile_n;
    if (e < kKC * tile_n) {
      const unsigned c = n_in && kk < kc
          ? (unsigned)quantize(v.w[j], q.sw, q.zw, q.qmax) : 0u;
      w_buf[e] = (unsigned char)c;
      if (col_on) csum += c;
    }
  }
}

// The code sums of unit u into the outputs, and their slots cleared:
// rows by the lanes that kept them, columns reduced over the threads of
// one column (shuffles, then shared atomics).  Every thread calls it.
__device__ __forceinline__ void sums_out(
    const Unit& u, int M, int N, int tm, int tile_n, unsigned* s_row,
    unsigned* s_col, unsigned csum, int* row_out, int* col_out, bool add,
    int t) {
  if (kSumsInLoop) return;
  const int lane = t & 31, warp = t >> 5, warps = kThreads >> 5;
  if (u.n0 == 0) {
    for (int i = lane; i < tm / warps; i += 32) {
      const int rr = warp + i * warps;
      if (u.m0 + rr < M)
        put(row_out + (size_t)u.pair * M + u.m0 + rr, s_row[rr], add);
      s_row[rr] = 0u;
    }
  }
  if (u.m0 == 0) {                         // uniform across the block
    for (int off = tile_n; off < 32; off <<= 1)
      csum += __shfl_xor_sync(0xffffffffu, csum, off);
    if (lane < tile_n) atomicAdd(&s_col[t % tile_n], csum);
    __syncthreads();
    if (t < tile_n) {
      if (u.n0 + t < N)
        put(col_out + (size_t)u.pair * N + u.n0 + t, s_col[t], add);
      s_col[t] = 0u;
    }
    __syncthreads();
  }
}

// A step's eight column codes (bytes of wv) as doubled table offsets.
__device__ __forceinline__ void w_offsets(uint2 wv, unsigned (&wo)[kNT]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wo[j] = (wv.x >> (8 * j) << 1) & 0x1FEu;
    wo[j + 4] = (wv.y >> (8 * j) << 1) & 0x1FEu;
  }
}

// One step k of a row (table row offset r0) against the eight columns
// (offsets wo): acc[j] += LUT[a, w_j].
__device__ __forceinline__ void narrow8_step(unsigned r0,
                                             const unsigned (&wo)[kNT],
                                             const unsigned char* lut,
                                             unsigned (&acc)[kNT]) {
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j] += lookup(lut, r0 ^ wo[j]);
}

// One K chunk (kc steps) of a gathering thread: its kR rows' codes (row i
// at a_row + i a_step, bytes, four a load) against its columns' w_grp (8
// bytes a step, row stride tile_n), each step's column codes read once
// for all kR rows; with kSumsInLoop, the sums its rows (g == 0) and
// columns (the thread of row 0) need.
template <int kR>
__device__ __forceinline__ void narrow8_chunk(
    const unsigned char* a_row, int a_step, const unsigned char* w_grp,
    int tile_n, int kc, const unsigned char* lut, unsigned (&acc)[kR][kNT],
    bool row_sum_on, bool col_sum_on, unsigned (&row_sum)[kR],
    unsigned (&col_sum)[kNT]) {
  int kk = 0;
  // two steps of four unrolled on one row; on several, one (registers)
#pragma unroll (kR == 1 ? 2 : 1)
  for (; kk + 4 <= kc; kk += 4) {
    unsigned av[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
      av[i] = *reinterpret_cast<const unsigned*>(a_row + i * a_step + kk);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned wo[kNT];
      w_offsets(*reinterpret_cast<const uint2*>(w_grp + (kk + s) * tile_n),
                wo);
#pragma unroll
      for (int i = 0; i < kR; ++i)
        narrow8_step(row_addr((av[i] >> (8 * s)) & 255u), wo, lut, acc[i]);
    }
  }
  for (; kk < kc; ++kk) {
    unsigned wo[kNT];
    w_offsets(*reinterpret_cast<const uint2*>(w_grp + kk * tile_n), wo);
#pragma unroll
    for (int i = 0; i < kR; ++i)
      narrow8_step(row_addr(a_row[i * a_step + kk]), wo, lut, acc[i]);
  }
  if (kSumsInLoop && row_sum_on)
#pragma unroll
    for (int i = 0; i < kR; ++i)
      for (kk = 0; kk < kc; ++kk) row_sum[i] += a_row[i * a_step + kk];
  if (kSumsInLoop && col_sum_on)
    for (kk = 0; kk < kc; ++kk)
#pragma unroll
      for (int j = 0; j < kNT; ++j) col_sum[j] += w_grp[kk * tile_n + j];
}

// A gathering thread's outputs of unit u: rows r + i row_step (i < kR),
// column group g.
template <int kR>
__device__ __forceinline__ void acc_out(const Unit& u, int M, int N, int r,
                                        int row_step, int g,
                                        const unsigned (&acc)[kR][kNT],
                                        const unsigned (&row_sum)[kR],
                                        const unsigned (&col_sum)[kNT],
                                        int* out, int* row_out,
                                        int* col_out, bool add) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int m = u.m0 + r + i * row_step;
    if (m < M) {
      const size_t o = ((size_t)u.pair * M + m) * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = u.n0 + g * kNT + j;
        if (n < N) put(out + o + n, acc[i][j], add);
      }
      if (kSumsInLoop && u.n0 == 0 && g == 0)
        put(row_out + (size_t)u.pair * M + m, row_sum[i], add);
    }
  }
  if (kSumsInLoop && u.m0 == 0 && r == 0) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = u.n0 + g * kNT + j;
      if (n < N) put(col_out + (size_t)u.pair * N + n, col_sum[j], add);
    }
  }
}

// K3/K4: fused_kernel<false, float>'s function (see the file comment for
// the staging) at the tile {kTN, kR} of kQuant8Tiles (kTN 0: tn threads
// across N as the launch gives it, one row a thread).  Every thread
// stages its share of a chunk and gathers rows r + i kThreads / tn of
// the tile (i < kR, r = tid / tn) by column group tid % tn; chunk c of a
// unit is in buffer (gc + c) % kStages, gc the block's chunks so far.
template <int kTN, int kR>
__global__ void __launch_bounds__(kThreads, 1)
quant8_kernel(const float* __restrict__ x, long long x_lane_stride,
              const float* __restrict__ w,
              const uint16_t* __restrict__ luts, Scalars sc,
              int* __restrict__ out, int* __restrict__ row_out,
              int* __restrict__ col_out, int n_lanes, int slices,
              int experts, int M, int K, int N, int tn_given, int splits) {
  // A rows a warp and W elements a thread stage a chunk, at most
  constexpr int kTNor1 = kTN ? kTN : 1;
  constexpr int kA = kTN ? 32 * kR / kTNor1 : kARegs;
  constexpr int kW = kTN ? kKC * kNT * kTN / kThreads : kWRegs;
  static_assert(kTN ? (32 * kR) % kTNor1 == 0 && kA >= 1
                          && (kKC * kNT * kTN) % kThreads == 0
                          && kThreads % (kTNor1 * kNT) == 0
                    : kR == 1,
                "a warp stages whole rows and a thread one column");
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* s_lut = reinterpret_cast<uint16_t*>(smem);
  const int tn = kTN ? kTN : tn_given;
  const int step = kThreads / tn;          // rows between a thread's rows
  const int tm = step * kR, tile_n = tn * kNT;
  unsigned char* s_a = smem + kLutEntries * sizeof(uint16_t);
  unsigned char* s_w = s_a + kStages * tm * kARow;
  unsigned* s_row = reinterpret_cast<unsigned*>(s_w + kStages * kKC * tile_n);
  unsigned* s_col = s_row + tm;

  const int tid = threadIdx.x;
  const int tiles_m = (M + tm - 1) / tm;
  const int tiles_n = (N + tile_n - 1) / tile_n;
  const int chunks = (K + kKC - 1) / kKC;
  const bool add = splits > 1;
  const long long per_pair = (long long)tiles_m * tiles_n * splits;
  const int n_pairs = n_lanes * slices;
  const long long begin =
      range_start(nullptr, n_pairs, 1, per_pair, blockIdx.x, gridDim.x);
  const long long end =
      range_start(nullptr, n_pairs, 1, per_pair, blockIdx.x + 1, gridDim.x);

  for (int i = tid; i < tm + tile_n; i += kThreads) s_row[i] = 0u;
  __syncthreads();

  const int r = tid / tn, g = tid % tn;    // this thread's row and group
  const unsigned char* lut = smem;
  int staged_lane = -1, staged_pair = -1;
  Quant q{0.f, 0.f, 0.f, 0.f, 0.f};
  long long gc = 0;                        // chunks of the block so far
  // the next chunk's loads are issued before each gather, across units
  // too (v holds them)
  constexpr bool kPipelined = kStages > 1 && kPrefetch;
  Staged<kA, kW> v;
  bool loaded = false;                     // v holds this unit's chunk 0
  auto load = [&](const Unit& un, int c) {  // unit un's chunk c
    const int k0 = un.k_begin + c * kKC;
    load_chunk(v,
               x + (size_t)un.lane * x_lane_stride + (size_t)un.slice * M * K,
               w + (size_t)(un.slice % experts) * K * N, un, k0,
               min(kKC, K - k0), M, K, N, tm, tile_n, tid);
  };
  for (long long item = begin; item < end; ++item) {
    const Unit u = decode_unit(item, per_pair, slices, splits, tiles_n, tm,
                               tile_n, chunks, K);
    const int n_chunks = (u.k_end - u.k_begin + kKC - 1) / kKC;
    // a first unit's loads go out before the table copy, under which
    // their latency hides
    if (kPipelined && !loaded && n_chunks > 0) load(u, 0);
    loaded = false;
    if (u.lane != staged_lane) {
      __syncthreads();                     // the old table is no longer read
      stage_table(luts + (size_t)u.lane * kLutEntries, s_lut, tid, kThreads);
      staged_lane = u.lane;
    }
    if (u.pair != staged_pair) {
      q = Quant{lane_scalar(sc, kSa, u.pair), lane_scalar(sc, kZa, u.pair),
                lane_scalar(sc, kSw, u.pair), lane_scalar(sc, kZw, u.pair),
                lane_scalar(sc, kQmax, u.pair)};
      staged_pair = u.pair;
    }
    unsigned acc[kR][kNT], row_sum[kR], col_sum[kNT], csum = 0u;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      row_sum[i] = 0u;
#pragma unroll
      for (int j = 0; j < kNT; ++j) acc[i][j] = 0u;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) col_sum[j] = 0u;
    auto a_buf = [&](long long c) { return s_a + (c % kStages) * tm * kARow; };
    auto w_buf = [&](long long c) {
      return s_w + (c % kStages) * kKC * tile_n;
    };
    auto store = [&](int c) {              // chunk c of this unit
      store_chunk(v, u, min(kKC, K - u.k_begin - c * kKC), M, N, tm, tile_n,
                  q, a_buf(gc + c), w_buf(gc + c), s_row, csum, tid);
    };
    auto stage = [&](int c) {
      load(u, c);
      store(c);
    };
    auto gather = [&](int c) {
      const int k0 = u.k_begin + c * kKC;
      narrow8_chunk<kR>(a_buf(gc + c) + r * kARow, step * kARow,
                        w_buf(gc + c) + g * kNT, tile_n, min(kKC, K - k0),
                        lut, acc, u.n0 == 0 && g == 0, u.m0 == 0 && r == 0,
                        row_sum, col_sum);
    };

    if (kStages == 1) {
      for (int c = 0; c < n_chunks; ++c) {
        __syncthreads();                   // the buffer consumed
        stage(c);
        __syncthreads();                   // chunk (and table) staged
        gather(c);
      }
    } else {
      // chunk c + 1's loads (or the next unit's chunk 0) are in flight
      // while chunk c is gathered, then quantized into the other buffer
      if (n_chunks > 0) {
        if (kPipelined) store(0);
        else stage(0);
      }
      __syncthreads();                     // chunk 0 (and table) staged
      for (int c = 0; c < n_chunks; ++c) {
        const bool next = c + 1 < n_chunks;
        if (kPipelined && next) {
          load(u, c + 1);
        } else if (kPipelined && item + 1 < end) {
          const Unit un = decode_unit(item + 1, per_pair, slices, splits,
                                      tiles_n, tm, tile_n, chunks, K);
          if (un.k_end > un.k_begin) {
            load(un, 0);
            loaded = true;
          }
        } else if (next) {
          stage(c + 1);
        }
        gather(c);
        if (kPipelined && next) store(c + 1);
        __syncthreads();                   // chunk c consumed, c+1 staged
      }
    }
    gc += n_chunks;
    sums_out(u, M, N, tm, tile_n, s_row, s_col, csum, row_out, col_out, add,
             tid);
    acc_out<kR>(u, M, N, r, step, g, acc, row_sum, col_sum, out, row_out,
                col_out, add);
  }
}

// K ranges of a launch's items at tile t (k_splits).
inline int launch_splits(int n_lanes, int M, int K, int N, int grid,
                         Tile t) {
  return k_splits(gather_items(n_lanes, M, N, t), (K + kKC - 1) / kKC, grid);
}

// Opt kernel `fn` into `bytes` of dynamic shared memory on the current
// device, once a device (`configured`: the kernel's flag a device; the
// opt-in acts on the current device only).
inline int opt_in(const void* fn, size_t bytes,
                  bool (&configured)[kMaxDevices]) {
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  return 0;
}

// fused_kernel (K1, K2, K5-K8) on `stream` with `grid` persistent blocks,
// configured for the largest tile's shared memory.
template <bool kComposed, typename In>
inline int run(const In* x, long long x_lane_stride, const In* w,
               long long w_lane_stride, const uint16_t* luts,
               const Scalars& sc, const unsigned* masks, const int* rcodes,
               int* out_lo, int* out_hi, int* row_out, int* col_out,
               int n_lanes, int slices, int experts, int M, int K, int N,
               int grid, int splits, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  if (const int err = opt_in((const void*)fused_kernel<kComposed, In>,
                             smem_bytes(1, kComposed), configured))
    return err;
  const int tn = threads_across_n(N);
  fused_kernel<kComposed, In><<<grid, kThreads, smem_bytes(tn, kComposed),
                                stream>>>(
      x, x_lane_stride, w, w_lane_stride, luts, sc, masks, rcodes, out_lo,
      out_hi, row_out, col_out, n_lanes, slices, experts, M, K, N, tn,
      splits);
  return (int)cudaGetLastError();
}

// quant8_kernel (K3, K4) at the tile {kTN, kR} of kQuant8Tiles on
// `stream` with `grid` persistent blocks, configured for the
// instantiation's largest tile (tn = 1 at kTN 0).
template <int kTN, int kR>
inline int run_quant8(const float* x, long long x_lane_stride,
                      const float* w, const uint16_t* luts,
                      const Scalars& sc, int* out, int* row_out,
                      int* col_out, int n_lanes, int slices, int experts,
                      int M, int K, int N, int grid, int splits,
                      cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const Tile t = kTN ? Tile{kTN, kR} : gather_tile(N);
  if (const int err = opt_in((const void*)quant8_kernel<kTN, kR>,
                             quant_smem_bytes(kTN ? t : Tile{1, 1}),
                             configured))
    return err;
  quant8_kernel<kTN, kR><<<grid, kThreads, quant_smem_bytes(t), stream>>>(
      x, x_lane_stride, w, luts, sc, out, row_out, col_out, n_lanes, slices,
      experts, M, K, N, t.tn, splits);
  return (int)cudaGetLastError();
}

// The kernels on codes (K1, K2: 8-bit; K5, K6: composed).  out_lo (and
// out_hi) are each their own allocation of n_lanes slices M N int32,
// zeroed apiece where K is split.  `slices` and `experts`: the expert
// axis (1 and 1 without it).  Returns the first CUDA error of the
// launch.
template <bool kComposed>
inline int launch_codes(const int* qa, long long qa_lane_stride,
                        const int* qw, long long qw_lane_stride,
                        const uint16_t* luts, const unsigned* masks,
                        const int* rcodes, int* out_lo, int* out_hi,
                        int n_lanes, int M, int K, int N, int grid,
                        cudaStream_t stream, int slices = 1,
                        int experts = 1) {
  const int n_pairs = n_lanes * slices;
  const int splits =
      launch_splits(n_pairs, M, K, N, grid, gather_tile(N));
  if (splits > 1) {                        // the units add into zeros
    const size_t bytes = (size_t)n_pairs * M * N * sizeof(int);
    int* const outs[2] = {out_lo, kComposed ? out_hi : nullptr};
    for (int* p : outs) {
      if (p == nullptr) continue;
      const cudaError_t err = cudaMemsetAsync(p, 0, bytes, stream);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return run<kComposed, int>(qa, qa_lane_stride, qw, qw_lane_stride, luts,
                             Scalars{}, masks, rcodes, out_lo, out_hi,
                             nullptr, nullptr, n_lanes, slices, experts, M, K,
                             N, grid, splits, stream);
}

// The kernels on f32 operands (K3, K4: 8-bit, quant8_kernel at the tile
// quant8_tile picks; K7, K8: composed).  `out` is one allocation of
// int32: the accumulator (K7/K8: the limbs lo, then hi), P M N each,
// then the row sums (P M), then the column sums (P N), P = n_lanes
// slices pairs; where K is split, one memset zeroes it.  `slices` and
// `experts`: the expert axis (1 and 1 without it).  Returns the first
// CUDA error of the launch.
template <bool kComposed>
inline int launch_quant(const float* x, long long x_lane_stride,
                        const float* w, const uint16_t* luts,
                        const Scalars& sc, const unsigned* masks,
                        const int* rcodes, int* out, int n_lanes, int M,
                        int K, int N, int grid, cudaStream_t stream,
                        int slices = 1, int experts = 1) {
  const int n_pairs = n_lanes * slices;
  const size_t mn = (size_t)n_pairs * M * N;
  int* row_out = out + (kComposed ? 2 : 1) * mn;
  int* col_out = row_out + (size_t)n_pairs * M;
  const int tile = kComposed ? 0 : quant8_tile(M, N);
  const Tile t = kComposed ? gather_tile(N) : quant8_tile_at(tile, N);
  const int splits = launch_splits(n_pairs, M, K, N, grid, t);
  if (splits > 1) {                        // the units add into zeros
    const size_t words = (size_t)(col_out - out) + (size_t)n_pairs * N;
    const cudaError_t err =
        cudaMemsetAsync(out, 0, words * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kComposed) {
    return run<true, float>(x, x_lane_stride, w, 0, luts, sc, masks, rcodes,
                            out, out + mn, row_out, col_out, n_lanes, slices,
                            experts, M, K, N, grid, splits, stream);
  } else {
    switch (tile) {
#define FUSEDMM_QUANT8(i)                                                   \
  case i:                                                                   \
    return run_quant8<kQuant8Tiles[i][0], kQuant8Tiles[i][1]>(              \
        x, x_lane_stride, w, luts, sc, out, row_out, col_out, n_lanes,      \
        slices, experts, M, K, N, grid, splits, stream);
      FUSEDMM_QUANT8(1)
      FUSEDMM_QUANT8(2)
      default:
      FUSEDMM_QUANT8(0)
#undef FUSEDMM_QUANT8
    }
  }
}

}  // namespace
}  // namespace fusedmm

// Shared body of the gate-netlist simulators: bitsim.cu (one netlist,
// K10) and bitsim_pop.cu (a population of stacked netlists, K11).
//
//   sig[0:n_i]    = planes                       (n_i, W) uint32 words
//   sig[n_i + j]  = gate_j(sig[in0_j], sig[in1_j])   j = 0 .. n_nodes-1
//   out[p, o]     = sig[outs[p, o]]               (P, n_o, W)
//
// Every signal holds one bit per simulated input vector, 32 to a word;
// the ten gate functions are those of core/gates.py (identity, not, and,
// or, xor, nand, nor, xnor, const0, const1).  Candidate p reads its own
// rows of funcs/in0/in1 (P, n_nodes) and outs (P, n_o); the planes are
// shared by every candidate.
//
// Replaces the TPU kernels bitsim_pallas (src/repro/kernels/bitsim.py:73,
// K10) and bitsim_pop_pallas (:149, K11), which walk the gates one by one
// (fori_loop + lax.switch) over a (n_i + n_nodes, 512) VMEM scratch.
//
// What bounds it on an H100: not bytes or operations (a CGP generation,
// 32 candidates x 256 words x ~320 gates, is about a microsecond of
// shared-memory traffic) but the chain of dependent gates.  With one or
// two blocks an SM (a generation is 256 blocks of 32 words, K10's
// exhaustive planes 64), a scheduler holds at most a warp or two, so
// every dependent instruction costs its full latency: a block's time
// is the instructions on its path times ~4-5 cycles.  The earlier body
// walked the gates in order in one warp, three __ldg of funcs/in0/in1
// and a branch tree on the code in every step.  This one:
//
//   1. One block per (word block, candidate), blockDim (WB, G): thread
//      (x, y) owns word x of the block's WB words (its column of the
//      signal scratch, row a at a * WB + x); the G warps of a column
//      share the gates.  The planes go to shared memory by cp.async
//      while the netlist is staged.
//   2. Each gate is staged once per block as a 32-bit descriptor: its
//      4-bit truth table t (bit 2a + b = f(a, b)) and two 14-bit signal
//      indices; an input the gate's arity does not use is set to a used
//      one (b = a for identity/not, both 0 for the constants), so stale
//      indices of a compacted netlist are never read.  A gate runs
//      without a branch: the masks of t's bits select, bit by bit,
//      (b ? t3 : t2) where a is set and (b ? t1 : t0) where it is not
//      (three logic ops).
//   3. Serial walk (kSerial, G = 1): each warp walks all gates in index
//      order for its own words, software-pipelined (the next gate's
//      inputs load while this one runs; its value reaches the next gate
//      in a register).  No schedule and no barrier.  kSerialGlobal is
//      the same walk reading funcs/in0/in1 through __ldg, for a netlist
//      whose scratch and descriptors do not fit shared memory together.
//   4. Level walk (kLevel, G = 4 warps a column): depth x (shared round
//      trip + barrier) in place of n_nodes x the serial step, for a
//      schedule paid by every block.  Warp 0 computes the levels
//      (lev = 1 + max(lev of the inputs used), planes at 0) 32 gates at
//      a time in index order: inputs before the window are final in
//      shared memory, inside it the levels rise in rounds of shuffles
//      until none changes (the window's longest chain); then counts, a
//      scan, and all threads scatter each gate into level order as a
//      32-byte record (its row offsets and its four masks, so a gate in
//      the walk is two 16-byte loads, two input loads, three logic ops
//      and a store).  Level by level, warp y runs gates y, y + G, ...,
//      two at a time with their loads together, and a barrier closes
//      the level.  A level's gates never read each other, so their
//      order cannot change a bit.  The 8-bit array multiplier is 40
//      levels deep.
//
// Which walk (kernels/bitsim.py, walk_plan, held by a CPU test): the
// schedule costs a level-walk block about as much as its walk saves, so
// the level walk wins only where each block has an SM to itself (K10 on
// the exact 8-bit multiplier, 64 blocks); a generation (256 blocks, two
// level blocks an SM contending) and the narrow 8-bit adder (37 gates,
// 15 levels, 2.5 gates a level) take the serial walk
// (kernels/bitsim_ablation.py times each walk and part; PERF.md §6).
//
// Shared memory: the scratch (n_i + n_nodes) * WB * 4 bytes, then the
// level walk's records (32 bytes a gate) and level starts, or the
// serial walk's descriptors (4 bytes a gate).  The schedule's working
// arrays (levels, descriptors, counts) live in the scratch's gate rows,
// which the walk overwrites only after them.  launch checks the walk,
// G and the word block the wrapper passes.
#pragma once

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// Internal linkage: each kernel library carries its own copy, and the
// per-device opt-in flags in launch are never merged with another
// library's.
namespace bitsim {
namespace {

constexpr int kMaxDevices = 64;     // device ordinals the opt-in tracks
constexpr int kSmemOptin = 232448;   // H100: dynamic shared memory a block
                                     // may opt in to
constexpr int kIndexBits = 14;       // a signal index (<= 1816 signals)
constexpr unsigned kIndexMask = (1u << kIndexBits) - 1;
// the truth tables of gate codes 0..9, four bits each (bit 2a + b is
// f(a, b)): buf 1100, inv 0011, and 1000, or 1110, xor 0110, nand 0111,
// nor 0001, xnor 1001, tie0 0000, tie1 1111
constexpr unsigned long long kTruth = 0xF09176E83CULL;

enum Walk : int { kLevel = 0, kSerial = 1, kSerialGlobal = 2 };
constexpr int kStage = 2;            // descriptors a thread stages at once

__device__ __forceinline__ unsigned pack(int f, int a, int b) {
  const unsigned t = (unsigned)(kTruth >> (4 * f)) & 15u;
  const int ia = f >= 8 ? 0 : a;               // constants read nothing
  const int ib = f >= 2 && f < 8 ? b : ia;     // identity, not: b = a
  return t << 28 | (unsigned)ib << kIndexBits | (unsigned)ia;
}

__device__ __forceinline__ int in_a(unsigned d) { return d & kIndexMask; }
__device__ __forceinline__ int in_b(unsigned d) {
  return (d >> kIndexBits) & kIndexMask;
}
__device__ __forceinline__ bool reads_nothing(unsigned d) {
  return (d >> 28) == 0u || (d >> 28) == 15u;
}

struct Args {
  const int* funcs;
  const int* in0;
  const int* in1;
  const int* outs;
  const unsigned* planes;
  unsigned* out;
  int n_nodes, n_i, n_o, W;
};

// A word of the scratch by its byte offset.
__device__ __forceinline__ unsigned& word(unsigned char* smem, int byte) {
  return *reinterpret_cast<unsigned*>(smem + byte);
}

// A gate ready to run, 32 bytes: the byte offsets of its inputs' and
// its output's rows (rows of WB words; a thread adds its column), and
// the masks of its truth table's bits t3, t2, t1, t0.
struct Rec {
  uint4 at, t;
};

// The masks of a descriptor's truth table bits t3, t2, t1, t0.
__device__ __forceinline__ uint4 masks(unsigned d) {
  return make_uint4((unsigned)((int)d >> 31), (unsigned)((int)(d << 1) >> 31),
                    (unsigned)((int)(d << 2) >> 31),
                    (unsigned)((int)(d << 3) >> 31));
}

template <int WB>
__device__ __forceinline__ Rec record(unsigned d, int sig_out) {
  return Rec{make_uint4(in_a(d) * (WB * 4), in_b(d) * (WB * 4),
                        sig_out * (WB * 4), 0u),
             masks(d)};
}

// f(a, b) bit by bit from the truth table's masks, no branch
__device__ __forceinline__ unsigned gate_eval(const uint4& t, unsigned a,
                                              unsigned b) {
  const unsigned x1 = (b & t.x) | (~b & t.y);
  const unsigned x0 = (b & t.z) | (~b & t.w);
  return (a & x1) | (~a & x0);
}

// Gate descriptors of candidate p's gates j, j + step, ... (kN of them,
// clamped below n), the loads all issued before the first is used.
template <int kN>
__device__ __forceinline__ void load_desc(unsigned (&d)[kN],
                                          const int* f_p, const int* a_p,
                                          const int* b_p, int j, int step,
                                          int n) {
  int f[kN], a[kN], b[kN];
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    const int k = min(j + u * step, n - 1);
    f[u] = __ldg(f_p + k);
    a[u] = __ldg(a_p + k);
    b[u] = __ldg(b_p + k);
  }
#pragma unroll
  for (int u = 0; u < kN; ++u) d[u] = pack(f[u], a[u], b[u]);
}

// Thread x's in-order walk of all gates over its word column (byte x4
// of a row); desc(j) gives gate j's descriptor (j <= n + 1).
// Software-pipelined: gate j + 1's inputs are loaded (and gate j + 2's
// descriptor) before gate j is evaluated, after gate j - 1's value is
// stored; gate j's value reaches gate j + 1 through a register.
template <int WB, class Desc>
__device__ __forceinline__ void walk_serial(Desc desc, unsigned char* smem,
                                            int n_i, int n, int x4) {
  if (n == 0) return;
  unsigned d = desc(0), dn = desc(1);
  unsigned va = word(smem, in_a(d) * (WB * 4) + x4);
  unsigned vb = word(smem, in_b(d) * (WB * 4) + x4);
  unsigned r = 0;                    // the last gate's value, not stored
  int prev = -1;                     // and its signal
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const unsigned dnn = desc(j + 2);
    if (prev >= 0) word(smem, prev * (WB * 4) + x4) = r;
    const unsigned na = word(smem, in_a(dn) * (WB * 4) + x4);
    const unsigned nb = word(smem, in_b(dn) * (WB * 4) + x4);
    if (in_a(d) == prev) va = r;
    if (in_b(d) == prev) vb = r;
    r = gate_eval(masks(d), va, vb);
    prev = n_i + j;
    d = dn;
    dn = dnn;
    va = na;
    vb = nb;
  }
  word(smem, prev * (WB * 4) + x4) = r;
}

template <int WB>
__global__ void bitsim_kernel(Args g, int walk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* sig = reinterpret_cast<unsigned*>(smem);
  const int G = blockDim.y, T = WB * G;
  const int x = threadIdx.x, y = threadIdx.y, tid = y * WB + x;
  const int lane = tid & 31, x4 = 4 * x;
  const int p = blockIdx.y, w = blockIdx.x * WB + x;
  const int n = g.n_nodes, n_i = g.n_i, n_o = g.n_o;
  const int* f_p = g.funcs + (size_t)p * n;
  const int* a_p = g.in0 + (size_t)p * n;
  const int* b_p = g.in1 + (size_t)p * n;
  const int* o_p = g.outs + (size_t)p * n_o;

  // the planes in flight while the netlist is staged (zeros past W),
  // and the first 32 output indices, one a lane
  for (int i = y; i < n_i; i += G)
    __pipeline_memcpy_async(sig + i * WB + x,
                            g.planes + (w < g.W ? (size_t)i * g.W + w : 0),
                            4, w < g.W ? 0 : 4);
  __pipeline_commit();
  const int out0 = lane < n_o ? __ldg(o_p + lane) : 0;

  // the gate records after the scratch (16-byte aligned: a row is
  // WB * 4 bytes)
  Rec* rec = reinterpret_cast<Rec*>(sig + (size_t)(n_i + n) * WB);
  if (walk == kLevel && n > 0) {
    unsigned short* loff =
        reinterpret_cast<unsigned short*>(rec + n);           // n + 1
    // the schedule's working arrays, in the gate rows of the scratch:
    // levels (lev[1 + j] for gate j; lev[0] = 0 stands for the planes),
    // counts (n + 2; levels start at 1, so cnt[0] passes the depth on,
    // and the kernel needs no static shared memory), descriptors (n)
    unsigned short* lev =
        reinterpret_cast<unsigned short*>(sig + (size_t)n_i * WB);
    int* cnt = reinterpret_cast<int*>(lev + ((n + 2) & ~1));
    unsigned* udesc = reinterpret_cast<unsigned*>(cnt + n + 2);
    for (int j = tid; j < n; j += kStage * T) {
      unsigned dj[kStage];
      load_desc(dj, f_p, a_p, b_p, j, T, n);
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (j + u * T < n) udesc[j + u * T] = dj[u];
    }
    for (int i = tid; i < n + 2; i += T) cnt[i] = 0;
    if (tid == 0) lev[0] = 0;
    __syncthreads();
    // levels, by warp 0, 32 gates (a lane each) at a time in index
    // order: the levels of inputs before the window are final and read
    // from lev; inside the window, where a gate may read a gate a few
    // lanes down, the levels are raised in rounds of shuffles from the
    // lower bound (inputs inside the window at 0) until none changes
    // (as many rounds as the window's longest chain).  Then the counts
    // of each level and their scan: loff[L - 1] is where level L starts.
    if (tid < 32) {
      int depth = 0;
      for (int w0 = 0; w0 < n; w0 += 32) {
        const int j = min(w0 + lane, n - 1);
        const unsigned d = udesc[j];
        const bool none = reads_nothing(d);
        const int ga = in_a(d) - n_i, gb = in_b(d) - n_i;   // <0: a plane
        const bool ia = !none && ga >= w0, ib = !none && gb >= w0;
        const int sa = ia ? ga - w0 : lane, sb = ib ? gb - w0 : lane;
        const int ea = none || ia ? 0 : lev[max(ga + 1, 0)];
        const int eb = none || ib ? 0 : lev[max(gb + 1, 0)];
        int l = 1 + max(ea, eb);
        for (;;) {
          const int va = __shfl_sync(0xFFFFFFFFu, l, sa);
          const int vb = __shfl_sync(0xFFFFFFFFu, l, sb);
          const int l2 = 1 + max(max(ea, ia ? va : 0), max(eb, ib ? vb : 0));
          if (__all_sync(0xFFFFFFFFu, l2 == l)) break;
          l = l2;
        }
        if (w0 + lane < n) {
          lev[1 + j] = (unsigned short)l;
          atomicAdd(&cnt[l], 1);
          depth = max(depth, l);
        }
        __syncwarp();
      }
      depth = __reduce_max_sync(0xFFFFFFFFu, depth);
      int carry = 0;
      for (int base = 1; base <= depth; base += 32) {
        const int L = base + lane;
        const int v = L <= depth ? cnt[L] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xFFFFFFFFu, incl, o);
          if (lane >= o) incl += u;
        }
        if (L <= depth) {
          loff[L - 1] = (unsigned short)(carry + incl - v);
          cnt[L] = carry + incl - v;                   // the level's cursor
        }
        carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      if (lane == 0) {
        loff[depth] = (unsigned short)n;
        cnt[0] = depth;
      }
    }
    __syncthreads();
    const int depth = cnt[0];
    // the records, scattered into level order
    for (int j = tid; j < n; j += T)
      rec[atomicAdd(&cnt[lev[1 + j]], 1)] = record<WB>(udesc[j], n_i + j);
    __pipeline_wait_prior(0);
    __syncthreads();
    // the walk: level by level, warp y takes gates y, y + G, ... two at
    // a time, both gates' loads out before either store (a level's
    // gates never read each other; a lone last gate runs twice and
    // stores the same word twice), and a barrier closes the level
    int s = 0, e = loff[1], en = depth > 1 ? loff[2] : n;
    for (int L = 0; L < depth; ++L) {
      const int enn = L + 2 < depth ? loff[L + 3] : n;
      for (int i = s + y; i < e; i += 2 * G) {
        const Rec g0 = rec[i], g1 = rec[i + G < e ? i + G : i];
        const unsigned a0 = word(smem, g0.at.x + x4);
        const unsigned b0 = word(smem, g0.at.y + x4);
        const unsigned a1 = word(smem, g1.at.x + x4);
        const unsigned b1 = word(smem, g1.at.y + x4);
        word(smem, g0.at.z + x4) = gate_eval(g0.t, a0, b0);
        word(smem, g1.at.z + x4) = gate_eval(g1.t, a1, b1);
      }
      s = e;
      e = en;
      en = enn;
      __syncthreads();
    }
  } else if (walk == kSerial) {
    // the descriptors, and two copies of the last past them
    unsigned* tab = reinterpret_cast<unsigned*>(rec);
    for (int j = tid; n > 0 && j < n + 2; j += kStage * T) {
      unsigned dj[kStage];
      load_desc(dj, f_p, a_p, b_p, j, T, n);
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (j + u * T < n + 2) tab[j + u * T] = dj[u];
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    walk_serial<WB>([&](int j) { return tab[j]; }, smem, n_i, n, x4);
  } else {
    __pipeline_wait_prior(0);
    __syncthreads();
    walk_serial<WB>([&](int j) {
      j = min(j, n - 1);
      return pack(__ldg(f_p + j), __ldg(a_p + j), __ldg(b_p + j));
    }, smem, n_i, n, x4);
  }

  // outputs: warp y writes rows k = y, y + G, ..., four at a time,
  // each row's signal index taken from the lane that loaded it
  unsigned* o = g.out + (size_t)p * n_o * g.W + w;
  for (int k0 = 0; k0 < n_o; k0 += 32) {
    const int idx = k0 == 0 ? out0
                            : (k0 + lane < n_o ? __ldg(o_p + k0 + lane) : 0);
    const int kend = min(k0 + 32, n_o);
    for (int k = k0 + y; k < kend; k += 4 * G) {
      unsigned v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = __shfl_sync(0xFFFFFFFFu, idx,
                                  min(k + u * G, kend - 1) - k0);
        v[u] = sig[r * WB + x];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (w < g.W && k + u * G < kend) o[(size_t)(k + u * G) * g.W] = v[u];
    }
  }
}

// Dynamic shared memory of a walk: the scratch, then the level walk's
// 32-byte gate records and level starts, or the serial walk's
// descriptors (two past the last).
inline size_t smem_bytes(int n_nodes, int n_i, int wb, int walk) {
  const size_t scratch = ((size_t)n_i + n_nodes) * wb * sizeof(unsigned);
  if (walk == kLevel)
    return scratch + sizeof(Rec) * n_nodes + (2 * (size_t)n_nodes + 5) / 4 * 4;
  if (walk == kSerial) return scratch + 4 * ((size_t)n_nodes + 2);
  return scratch;
}

template <int WB>
int launch_wb(const Args& g, int P, int walk, int G, size_t smem,
              cudaStream_t stream) {
  // once a device: the opt-in limit acts on the current device only
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        bitsim_kernel<WB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemOptin);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  const dim3 grid((g.W + WB - 1) / WB, P);
  bitsim_kernel<WB><<<grid, dim3(WB, G), smem, stream>>>(g, walk);
  return (int)cudaGetLastError();
}

// Launch P candidates over W words: word blocks of wb (32, 64 or 128)
// words, G warps a word column (G = 1 for the serial walks).  Returns
// the launch's cudaGetLastError(), or cudaErrorInvalidValue for a walk
// the shape cannot take.
inline int launch(const int* funcs, const int* in0, const int* in1,
                  const int* outs, const unsigned* planes, unsigned* out,
                  int P, int n_nodes, int n_i, int n_o, int W, int wb,
                  int walk, int G, cudaStream_t stream) {
  if (walk < kLevel || walk > kSerialGlobal || G < 1
      || (walk != kLevel && G != 1) || wb * G > 1024
      || n_i + n_nodes > (int)kIndexMask + 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_nodes, n_i, wb, walk);
  if (smem > (size_t)kSmemOptin) return (int)cudaErrorInvalidValue;
  const Args g{funcs, in0, in1, outs, planes, out, n_nodes, n_i, n_o, W};
  if (wb == 32) return launch_wb<32>(g, P, walk, G, smem, stream);
  if (wb == 64) return launch_wb<64>(g, P, walk, G, smem, stream);
  if (wb == 128) return launch_wb<128>(g, P, walk, G, smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace bitsim

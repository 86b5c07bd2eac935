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
// Design: one block per (word block, candidate), one thread per uint32
// word.  A thread only ever reads and writes its own word column of the
// signal scratch (n_i + n_nodes) x WB, row a at a * WB + t, so the
// threads of a warp hit 32 different banks and no barrier is needed.
// Every thread of a block walks the same gate at the same time, so the
// reads of funcs/in0/in1 are uniform (one broadcast load for the warp)
// and the branch on the gate's arity never diverges.
// The scratch lives in dynamic shared memory: (n_i + n_nodes) * WB * 4
// bytes must fit a block's 227 KB (the wrapper picks WB: 128, 64 or 32
// words, and refuses a netlist of more than 1816 signals, where even
// WB = 32 does not fit).
//
// What bounds it on an H100: latency of the dependent shared-memory
// loads of each gate, not bandwidth — a CGP generation (32 candidates x
// 256 words x ~320 gates) is a few microseconds of work, under the
// launch cost.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Internal linkage: each kernel library carries its own copy, and the
// once-only flag in launch is never merged with another library's.
namespace bitsim {
namespace {

constexpr int kSmemOptin = 232448;   // H100: dynamic shared memory a block
                                     // may opt in to

// The two-input gates (codes 2..7).
__device__ __forceinline__ unsigned gate2(int f, unsigned a, unsigned b) {
  switch (f) {
    case 2: return a & b;          // and
    case 3: return a | b;          // or
    case 4: return a ^ b;          // xor
    case 5: return ~(a & b);       // nand
    case 6: return ~(a | b);       // nor
    default: return ~(a ^ b);      // xnor
  }
}

__global__ void bitsim_kernel(const int* __restrict__ funcs,
                              const int* __restrict__ in0,
                              const int* __restrict__ in1,
                              const int* __restrict__ outs,
                              const unsigned* __restrict__ planes,
                              unsigned* __restrict__ out, int n_nodes,
                              int n_i, int n_o, int W, int wb) {
  extern __shared__ unsigned sig[];
  const int p = blockIdx.y;
  const int t = threadIdx.x;
  const int w = blockIdx.x * wb + t;
  if (w >= W) return;              // no barrier below: columns are private
  const int* f_p = funcs + (size_t)p * n_nodes;
  const int* a_p = in0 + (size_t)p * n_nodes;
  const int* b_p = in1 + (size_t)p * n_nodes;
  const int* o_p = outs + (size_t)p * n_o;

  for (int i = 0; i < n_i; ++i) sig[i * wb + t] = planes[(size_t)i * W + w];
  unsigned* dst = sig + (size_t)n_i * wb + t;
  for (int j = 0; j < n_nodes; ++j, dst += wb) {
    // a gate reads only the inputs its arity uses (Netlist.eval_words):
    // a compacted netlist keeps stale indices in its unused input fields
    const int f = __ldg(f_p + j);
    unsigned r;
    if (f >= 8) {
      r = f == 8 ? 0u : 0xFFFFFFFFu;                 // const0, const1
    } else {
      const unsigned a = sig[__ldg(a_p + j) * wb + t];
      r = f == 0 ? a
        : f == 1 ? ~a                                // identity, not
        : gate2(f, a, sig[__ldg(b_p + j) * wb + t]);
    }
    *dst = r;
  }
  unsigned* o = out + (size_t)p * n_o * W + w;
  for (int k = 0; k < n_o; ++k) o[(size_t)k * W] = sig[__ldg(o_p + k) * wb + t];
}

// Launch P candidates over W words with word blocks of wb threads, the
// signals in (n_i + n_nodes) * wb words of shared memory.  Returns the
// launch's cudaGetLastError().
inline int launch(const int* funcs, const int* in0, const int* in1,
                  const int* outs, const unsigned* planes, unsigned* out,
                  int P, int n_nodes, int n_i, int n_o, int W, int wb,
                  cudaStream_t stream) {
  static bool configured = false;    // once: the opt-in limit
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bitsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemOptin);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const size_t smem = ((size_t)n_i + n_nodes) * wb * sizeof(unsigned);
  if (smem > (size_t)kSmemOptin) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + wb - 1) / wb, P);
  bitsim_kernel<<<grid, wb, smem, stream>>>(funcs, in0, in1, outs, planes,
                                            out, n_nodes, n_i, n_o, W, wb);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace bitsim

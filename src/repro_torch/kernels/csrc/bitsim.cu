// bitsim: one gate netlist on uint32 bit-planes (K10), the drop-in for
// Netlist.eval_words (kernels/ops.bitsim).  funcs/in0/in1 (n_nodes,),
// outs (n_o,) int32; planes (n_i, W) uint32 -> out (n_o, W) uint32.
//
// Replaces the TPU kernel bitsim_pallas (src/repro/kernels/bitsim.py:73,
// pallas_call at :86), which walks the gates with fori_loop + lax.switch
// over a (n_i + n_nodes, 512) uint32 VMEM scratch per 512-word block.
//
// Bound and design: bitsim.cuh (K11's body with one candidate).  Also
// here: bitsim_probe, the shared-memory round trip and barrier that one
// level of the level walk waits on (chip_smoke.py's depth floor).
#include "bitsim.cuh"

namespace {

// One block; each round a thread loads a word of its column at a row
// that depends on the last round's value, adds one, stores it and meets
// the block at a barrier: one level of the level walk, without the gate.
__global__ void probe_kernel(unsigned* out, int rounds) {
  extern __shared__ unsigned buf[];                    // 32 rows
  const int t = threadIdx.x, n = blockDim.x;
  for (int r = 0; r < 32; ++r) buf[r * n + t] = (unsigned)(r + t);
  __syncthreads();
  unsigned v = (unsigned)t;
  for (int r = 0; r < rounds; ++r) {
    v = buf[(v & 31u) * n + t] + 1u;
    buf[((r + 1) & 31) * n + t] = v;
    __syncthreads();
  }
  out[t] = v;
}

}  // namespace

extern "C" int bitsim_launch(const int* funcs, const int* in0,
                             const int* in1, const int* outs,
                             const unsigned* planes, unsigned* out,
                             int n_nodes, int n_i, int n_o, int W, int wb,
                             int walk, int warps, void* stream) {
  return bitsim::launch(funcs, in0, in1, outs, planes, out, 1, n_nodes,
                        n_i, n_o, W, wb, walk, warps,
                        static_cast<cudaStream_t>(stream));
}

// rounds of the probe in one block of `threads` threads (out: threads
// words)
extern "C" int bitsim_probe_launch(unsigned* out, int rounds, int threads,
                                   void* stream) {
  probe_kernel<<<1, threads, 32 * threads * sizeof(unsigned),
                 static_cast<cudaStream_t>(stream)>>>(out, rounds);
  return (int)cudaGetLastError();
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bitsim: one gate netlist on uint32 bit-planes (K10), the drop-in for
// Netlist.eval_words (kernels/ops.bitsim).  funcs/in0/in1 (n_nodes,),
// outs (n_o,) int32; planes (n_i, W) uint32 -> out (n_o, W) uint32.
//
// Replaces the TPU kernel bitsim_pallas (src/repro/kernels/bitsim.py:73,
// pallas_call at :86), which walks the gates with fori_loop + lax.switch
// over a (n_i + n_nodes, 512) uint32 VMEM scratch per 512-word block.
//
// Bound and design: bitsim.cuh (K11's body with one candidate).
#include "bitsim.cuh"

extern "C" int bitsim_launch(const int* funcs, const int* in0,
                             const int* in1, const int* outs,
                             const unsigned* planes, unsigned* out,
                             int n_nodes, int n_i, int n_o, int W, int wb,
                             void* stream) {
  return bitsim::launch(funcs, in0, in1, outs, planes, out, 1, n_nodes,
                        n_i, n_o, W, wb,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

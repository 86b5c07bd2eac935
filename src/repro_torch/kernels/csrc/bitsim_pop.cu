// bitsim_pop: a population of P stacked gate netlists on shared uint32
// bit-planes in one launch (K11), the scorer of every CGP generation
// (core/evolve_pop.PopEvaluator, engine="device").  funcs/in0/in1
// (P, n_nodes), outs (P, n_o) int32 (core/netlist.stack_netlists pads
// shorter genomes with inactive const0 nodes); planes (n_i, W) uint32 ->
// out (P, n_o, W) uint32, row p equal to bitsim on candidate p.
//
// Replaces the TPU kernel bitsim_pop_pallas
// (src/repro/kernels/bitsim.py:149, pallas_call at :169), whose grid
// (P, W / 512) re-uses one VMEM scratch per step and reads candidate p's
// netlist slice through its BlockSpec index map.
//
// Bound and design: bitsim.cuh.  The grid's y axis is the candidate, so
// a generation's 32 candidates x 256 words run as 32 x (256 / wb) blocks,
// each of which stages and schedules its candidate's netlist.
#include "bitsim.cuh"

extern "C" int bitsim_pop_launch(const int* funcs, const int* in0,
                                 const int* in1, const int* outs,
                                 const unsigned* planes, unsigned* out,
                                 int P, int n_nodes, int n_i, int n_o,
                                 int W, int wb, int walk, int warps,
                                 void* stream) {
  return bitsim::launch(funcs, in0, in1, outs, planes, out, P, n_nodes,
                        n_i, n_o, W, wb, walk, warps,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* lutmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

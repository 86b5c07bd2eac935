"""CUDA kernels K10, K11: bit-parallel gate-netlist simulation.

Hopper counterparts of the reference's TPU kernels in
``repro/kernels/bitsim.py``:

  * K10 ``bitsim_words`` (``csrc/bitsim.cu``) — one netlist:
    funcs/in0/in1 (n_nodes,), outs (n_o,) int32, planes (n_i, W) words
    -> (n_o, W) words;
  * K11 ``bitsim_pop_words`` (``csrc/bitsim_pop.cu``) — P stacked
    netlists (``core.netlist.stack_netlists``) over shared planes ->
    (P, n_o, W) words, one launch per CGP generation.

Words travel as int32 tensors holding the uint32 bit patterns (PyTorch's
uint32 lacks the bitwise ops on the CPU); the kernels read them as
uint32.  ``plan`` picks the word block from the netlist's signal count
so that the signal scratch fits shared memory, and refuses a netlist too
large for it (see ``csrc/bitsim.cuh``).

Callers go through ``repro_torch.kernels.ops`` (``bitsim_planes``,
``bitsim_pop_planes``), which validates the operands and sends CPU
tensors to the plain versions (``kernels.ref``).  Each launcher's
``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .approx_matmul import _ptr

#: Shared memory a block uses for its signal scratch before the wrapper
#: takes a narrower word block: 48 KB leaves room for four blocks per SM.
SMEM_TARGET = 48 * 1024
#: H100's opt-in limit of dynamic shared memory per block (227 KB).
SMEM_MAX = 232448
WORD_BLOCKS = (128, 64, 32)


def plan(n_signals: int) -> int:
    """The word block for a netlist of ``n_signals`` (inputs plus
    nodes): the widest whose uint32 scratch fits ``SMEM_TARGET``, else 32
    words up to ``SMEM_MAX``.  Past that (more than 1816 signals, e.g.
    ``array_multiplier(32)``) the kernels have no room: ValueError."""
    for wb in WORD_BLOCKS:
        if n_signals * wb * 4 <= SMEM_TARGET:
            return wb
    wb = WORD_BLOCKS[-1]
    if n_signals * wb * 4 > SMEM_MAX:
        raise ValueError(
            f"netlist of {n_signals} signals (inputs + nodes) does not "
            f"fit the bitsim kernels' shared memory: at most "
            f"{SMEM_MAX // (4 * wb)} signals")
    return wb


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"bitsim": [_P] * 6 + [_I] * 5 + [_P],
             "bitsim_pop": [_P] * 6 + [_I] * 6 + [_P]}


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, fn, funcs, in0, in1, outs, planes) -> torch.Tensor:
    pop = name == "bitsim_pop"
    p = funcs.shape[0] if pop else 1
    n_nodes = funcs.shape[-1]
    n_o = outs.shape[-1]
    n_i, w = planes.shape
    wb = plan(n_i + n_nodes)
    out = torch.empty((p, n_o, w), dtype=torch.int32, device=planes.device)
    if p == 0 or n_o == 0 or w == 0:
        return out
    dims = (p, n_nodes, n_i, n_o, w, wb) if pop else (n_nodes, n_i, n_o, w,
                                                       wb)
    err = _launcher(name)(
        _ptr(funcs), _ptr(in0), _ptr(in1), _ptr(outs), _ptr(planes),
        _ptr(out), *dims,
        ctypes.c_void_p(torch.cuda.current_stream(planes.device).cuda_stream))
    build.check(name, err)
    fn.launches += 1
    return out


def bitsim_words(funcs, in0, in1, outs, planes) -> torch.Tensor:
    """Launch K10.  funcs/in0/in1 (n_nodes,), outs (n_o,) int32, planes
    (n_i, W) int32 words, all contiguous on one CUDA device (checked by
    ``ops.bitsim_planes``) -> (n_o, W) int32 words."""
    return _launch("bitsim", bitsim_words, funcs, in0, in1, outs,
                   planes)[0]


def bitsim_pop_words(funcs, in0, in1, outs, planes) -> torch.Tensor:
    """Launch K11.  funcs/in0/in1 (P, n_nodes), outs (P, n_o) int32,
    planes (n_i, W) int32 words -> (P, n_o, W) int32 words."""
    return _launch("bitsim_pop", bitsim_pop_words, funcs, in0, in1, outs,
                   planes)


bitsim_words.launches = 0
bitsim_pop_words.launches = 0

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
large for it; ``walk_plan`` picks how a block walks the gates (see
``csrc/bitsim.cuh``).  ``level_schedule`` and ``pack_descriptors`` are
the host mirrors of what a block computes before its walk: each gate's
level and the level order, and the gates' 32-bit descriptors.

Callers go through ``repro_torch.kernels.ops`` (``bitsim_planes``,
``bitsim_pop_planes``), which validates the operands and sends CPU
tensors to the plain versions (``kernels.ref``).  Each launcher's
``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.gates import GATE_ARITY
from . import build
from .approx_matmul import _ptr, enter_device, leave_device, sm_count
from .fused_matmul import _stream

#: Shared memory a block uses for its signal scratch before the wrapper
#: takes a narrower word block: 48 KB leaves room for four blocks per SM.
SMEM_TARGET = 48 * 1024
#: H100's opt-in limit of dynamic shared memory per block (227 KB).
SMEM_MAX = 232448
WORD_BLOCKS = (128, 64, 32)
#: The kernel's walks (``csrc/bitsim.cuh``'s ``Walk``).
WALKS = ("level", "serial", "serial_global")
#: Warps sharing a word column's gates in the level walk.
LEVEL_WARPS = 4
#: Truth table of each gate code of ``core.gates`` (bit 2a + b is
#: f(a, b)): buf, inv, and, or, xor, nand, nor, xnor, tie0, tie1.
TRUTH_TABLES = np.array([0b1100, 0b0011, 0b1000, 0b1110, 0b0110, 0b0111,
                         0b0001, 0b1001, 0b0000, 0b1111], dtype=np.uint32)
INDEX_BITS = 14


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


class WalkPlan(NamedTuple):
    wb: int       # words a block (one thread a word)
    walk: str     # one of WALKS
    warps: int    # warps a word column (blockDim.y)
    smem: int     # dynamic shared memory a block, bytes


def smem_bytes(n_i: int, n_nodes: int, wb: int, walk: str) -> int:
    """A block's dynamic shared memory (``bitsim.cuh``'s ``smem_bytes``):
    the scratch, then a 32-byte record a gate and the level starts (2
    bytes a level, rounded to 4 bytes), or a 4-byte descriptor a gate
    and two past the last (serial)."""
    scratch = (n_i + n_nodes) * wb * 4
    return scratch + {"level": 32 * n_nodes + (2 * n_nodes + 5) // 4 * 4,
                      "serial": 4 * (n_nodes + 2),
                      "serial_global": 0}[walk]


def walk_plan(n_i: int, n_nodes: int, p: int = 1, w: int = 1,
              sms: int = 132) -> WalkPlan:
    """How the kernels walk P netlists of ``n_i`` inputs and ``n_nodes``
    gates over ``w`` words on a card of ``sms`` SMs.  A wide netlist
    (32-word blocks, more than 192 signals: the 8-bit multiplier) takes
    the level walk with ``LEVEL_WARPS`` warps a word column when the
    grid has no more blocks than the card has SMs, so that each block
    has an SM to itself (K10's exhaustive re-verification: 64 blocks);
    where blocks share SMs (a CGP generation: 256) and for narrow
    netlists (the 8-bit adder, 128-word blocks) the serial walk, whose
    one warp a block leaves no schedule to pay for.  A netlist whose
    scratch and tables pass ``SMEM_MAX`` falls to the next walk: the
    level walk's records past about 1440 signals, the serial walk's
    descriptors past about 1760, to the serial walk reading its netlist
    from device memory.  Raises past 1816 signals (``plan``)."""
    wb = plan(n_i + n_nodes)
    walks = [("serial", 1), ("serial_global", 1)]
    if wb == WORD_BLOCKS[-1] and n_nodes > 0 and p * -(-w // wb) <= sms:
        walks.insert(0, ("level", LEVEL_WARPS))
    for walk, warps in walks:
        smem = smem_bytes(n_i, n_nodes, wb, walk)
        if smem <= SMEM_MAX:
            return WalkPlan(wb, walk, warps, smem)
    raise AssertionError("plan() leaves the scratch within SMEM_MAX")


def pack_descriptors(funcs, in0, in1) -> np.ndarray:
    """The kernels' gate descriptors, uint32, any shape: the truth table
    in bits 28-31, input b in bits 14-27, input a in bits 0-13; an input
    the gate's arity does not use is set to a used one (b = a for
    identity/not, both 0 for the constants)."""
    funcs = np.asarray(funcs, dtype=np.int64)
    arity = GATE_ARITY[funcs]
    a = np.where(arity >= 1, np.asarray(in0, dtype=np.int64), 0)
    b = np.where(arity >= 2, np.asarray(in1, dtype=np.int64), a)
    return ((TRUTH_TABLES[funcs].astype(np.uint32) << np.uint32(28))
            | (b.astype(np.uint32) << np.uint32(INDEX_BITS))
            | a.astype(np.uint32))


def eval_descriptor(desc, a, b):
    """A gate from its descriptor's truth table on uint32 words, without
    a branch (``bitsim.cuh``'s ``gate_eval``)."""
    desc = np.uint32(desc)
    t = [np.uint32(0xFFFFFFFF) if desc >> np.uint32(28 + k) & np.uint32(1)
         else np.uint32(0) for k in range(4)]
    x1 = (b & t[3]) | (~b & t[2])
    x0 = (b & t[1]) | (~b & t[0])
    return (a & x1) | (~a & x0)


def level_schedule(funcs, in0, in1, n_i: int) -> tuple:
    """Each gate's level and the level order, as a block computes them
    before its level walk: level = 1 + the largest level of the inputs
    the gate's arity uses (planes at 0, constants at 1), and the gates
    sorted by level.  The kernel orders a level's gates in whatever
    order its atomics give, which cannot change a bit (a gate never
    reads one of its own level); this mirror keeps index order inside a
    level.  -> (levels, order), (n_nodes,) int64 each."""
    funcs = np.asarray(funcs, dtype=np.int64)
    arity = GATE_ARITY[funcs]
    lev = np.zeros(n_i + funcs.shape[0], dtype=np.int64)
    for j, (f, a, b) in enumerate(zip(arity.tolist(), np.asarray(in0).tolist(),
                                      np.asarray(in1).tolist())):
        lev[n_i + j] = 1 + max(lev[a] if f >= 1 else 0,
                               lev[b] if f >= 2 else 0)
    levels = lev[n_i:]
    return levels, np.argsort(levels, kind="stable")


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"bitsim": [_P] * 6 + [_I] * 7 + [_P],
             "bitsim_pop": [_P] * 6 + [_I] * 8 + [_P]}


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def _dims(pop: bool, p: int, n_nodes: int, n_i: int, n_o: int, w: int,
          device_index: int) -> tuple:
    """The launch's integer arguments for one shape on one card, the walk
    plan's included (kept: a CGP search launches one shape thousands of
    times, and the card's host takes microseconds for the plan)."""
    plan(n_i + n_nodes)          # refuses a netlist too large, device or not
    wp = walk_plan(n_i, n_nodes, p, w, sm_count(device_index))
    dims = (n_nodes, n_i, n_o, w, wp.wb, WALKS.index(wp.walk), wp.warps)
    return (p,) + dims if pop else dims


def _launch(name: str, fn, funcs, in0, in1, outs, planes) -> torch.Tensor:
    pop = name == "bitsim_pop"
    p = funcs.shape[0] if pop else 1
    n_i, w = planes.shape
    dims = _dims(pop, p, funcs.shape[-1], n_i, outs.shape[-1], w,
                 planes.get_device())
    out = torch.empty((p, outs.shape[-1], w), dtype=torch.int32,
                      device=planes.device)
    if p == 0 or outs.shape[-1] == 0 or w == 0:
        return out
    prev = enter_device(planes.get_device())
    try:
        err = _launcher(name)(
            funcs.data_ptr(), in0.data_ptr(), in1.data_ptr(),
            outs.data_ptr(), planes.data_ptr(), out.data_ptr(), *dims,
            _stream(planes))
    finally:
        leave_device(prev)
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


def probe_round_ms(device, rounds: int = 100_000,
                   threads: int = 32 * LEVEL_WARPS) -> float:
    """One level's wait in the level walk, measured on the card: a
    dependent shared-memory load, one add, a store and a barrier in one
    block of ``threads`` threads (``csrc/bitsim.cu``'s ``bitsim_probe``),
    ms a round from CUDA events over ``rounds`` rounds less a zero-round
    launch."""
    fn = build.load("bitsim").bitsim_probe_launch
    fn.argtypes = [_P, _I, _I, _P]
    fn.restype = ctypes.c_int
    out = torch.empty(threads, dtype=torch.int32, device=device)
    stream = ctypes.c_void_p(_stream(out))

    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        build.check("bitsim", fn(_ptr(out), n, threads, stream))
        start.record()
        build.check("bitsim", fn(_ptr(out), n, threads, stream))
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    with torch.cuda.device(out.device):
        return (run(rounds) - run(0)) / rounds

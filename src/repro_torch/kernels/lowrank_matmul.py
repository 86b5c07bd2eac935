"""CUDA kernel K9: rank-R factored approximate matmul.

``lowrank_matmul(qa, qw, u, v)`` launches ``csrc/lowrank_matmul.cu`` —
the Hopper counterpart of the reference's TPU kernel
``lowrank_matmul_pallas`` (``repro/kernels/lowrank_matmul.py``):
``out[m,n] = Σ_r Σ_k U[r, qa[m,k]] · V[r, qw[k,n]]`` in f32.  The kernel
has two regimes: a streaming split-K SIMT kernel for few rows (decode)
and a 3xTF32 tensor-core kernel for many (prefill); ``plan`` picks the
regime and the K split, and the source holds the design.

The expert form (an MoE projection's experts in one launch, as the
reference's ``pallas_call`` batched over stacked expert weights): qa
(X,M,K) against qw (E,K,N), E dividing X, slice ``s`` against ``qw[s %
E]`` with the shared factors -> (X,M,N).  Its split-K workspace is
(X, splits, M, N) f32, sized a launch (``plan(...).workspace_bytes``).

Callers go through ``repro_torch.kernels.ops.lowrank_matmul``, which
validates the operands and sends CPU tensors to the plain version
(``kernels.ref.lowrank_matmul_ref``).  ``lowrank_matmul.launches``
counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import NamedTuple

import torch

from . import build
from .approx_matmul import enter_device, leave_device

#: Largest rank the kernel takes: its factor tables live in shared
#: memory (``csrc/lowrank_matmul.cu`` ``kMaxRank``).
MAX_RANK = 16
#: Rows up to which the streaming regime runs (``kStreamRows``).
STREAM_ROWS = 16
#: Fewest K·R terms a sum takes on tensor cores (``kMinMmaTerms``): the
#: 3xTF32 split errs by ~12·2^-24 |ab| a product, which the f32 bound
#: 2 (K R + 1) 2^-24 S covers only for sums of many terms.
MIN_MMA_TERMS = 64
#: Output tile of each regime: (rows, columns) of a block.
STREAM_TILE = (STREAM_ROWS, 128)
MMA_TILE = (64, 64)
#: Blocks the K split aims at: two per SM of an H100.
TARGET_BLOCKS = 2 * 132
#: The streaming regime's K slice: a multiple of its 8 warps, at most
#: 64 rows (its codes and gathered U side live in shared memory).
STREAM_K_STEP, STREAM_MAX_K = 8, 64
#: The tensor-core regime's slice: at least 128 codes.
MMA_MIN_K = 128


class Plan(NamedTuple):
    """How one call is cut: ``regime`` "stream" or "mma", ``tiles`` output
    tiles over all its slices, ``splits`` K slices of ``k_per_split``
    codes each (the last one ragged); ``outputs`` the f32 outputs over
    all slices."""
    regime: str
    tiles: int
    splits: int
    k_per_split: int
    outputs: int = 0

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    @property
    def workspace_bytes(self) -> int:
        """The split-K workspace a launch needs: (slices, splits, M, N)
        f32 partials, none without a split."""
        return 4 * self.splits * self.outputs if self.splits > 1 else 0


def mma_chunk(r: int) -> int:
    """K codes the tensor-core regime gathers per step at rank ``r``
    (its template BK), so the R·BK contraction fits shared memory."""
    return 16 if r <= 4 else 8


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, r: int, slices: int = 1) -> Plan:
    """The regime and K split of an (m,k) x (k,n) call at rank ``r``, on
    each of ``slices`` slices (the expert form): the regime as
    ``lowrank_matmul_launch`` picks it, and the fewest K slices (each a
    multiple of the regime's step, within its size limits) that give the
    grid, every slice's tiles counted, about ``TARGET_BLOCKS`` blocks."""
    if m > STREAM_ROWS and k * r >= MIN_MMA_TERMS:
        regime, (bm, bn) = "mma", MMA_TILE
        step, lo, hi = mma_chunk(r), MMA_MIN_K, None
    else:
        regime, (bm, bn) = "stream", STREAM_TILE
        if m <= STREAM_ROWS:
            bm = m
        step, lo, hi = STREAM_K_STEP, STREAM_K_STEP, STREAM_MAX_K
    tiles = math.ceil(m / bm) * math.ceil(n / bn) * slices
    want = max(1, math.ceil(TARGET_BLOCKS / tiles))
    kps = step * math.ceil(math.ceil(max(k, 1) / want) / step)
    kps = max(kps, lo)
    if hi is not None:
        kps = min(kps, hi)
    splits = max(1, math.ceil(k / kps))
    if splits == 1:
        kps = max(k, 1)
    return Plan(regime, tiles, splits, kps, slices * m * n)


#: The launch's arguments as the C side's ``LowrankArgs``: 7 pointers,
#: n_counters, M, K, N, R, k_per_split, splits, slices, experts and the
#: stream, all 8 bytes; one packed buffer costs less host time than 17
#: ctypes args.
_ARGS = struct.Struct("=17q")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("lowrank_matmul").lowrank_matmul_launch
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


class _Scratch:
    """Per (device, stream): the split-K workspace, grown on demand, and
    the tile counters, all 0 between launches (the kernel resets each
    one it used).  Launches on one stream run in order, so they share
    both."""

    def __init__(self, device: int):
        self.device = torch.device("cuda", device)
        self.n_ws = self.n_counters = 0
        self.grow(1, 1024)

    def grow(self, n_ws: int, n_counters: int) -> None:
        if n_ws > self.n_ws:
            self.ws = torch.empty(n_ws, dtype=torch.float32,
                                  device=self.device)
            self.n_ws, self.ws_ptr = n_ws, self.ws.data_ptr()
        if n_counters > self.n_counters:
            self.counters = torch.zeros(n_counters, dtype=torch.int32,
                                        device=self.device)
            self.n_counters = n_counters
            self.counters_ptr = self.counters.data_ptr()


_SCRATCH: dict[tuple[int, int], _Scratch] = {}


def lowrank_matmul(qa: torch.Tensor, qw: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Launch K9 on the current stream.  qa (M,K) int32, qw (K,N) int32,
    u, v (R,256) f32 with 1 <= R <= ``MAX_RANK``, all contiguous on one
    CUDA device (checked by ``ops.lowrank_matmul``) -> (M,N) f32.  The
    expert form: qa (X,M,K), qw (E,K,N) with E dividing X -> (X,M,N)."""
    m, k = qa.shape[-2:]
    n = qw.shape[-1]
    r = u.shape[0]
    slices = qa.shape[0] if qw.ndim == 3 else 1
    experts = qw.shape[0] if qw.ndim == 3 else 1
    out = qa.new_empty((*qa.shape[:-1], n), dtype=torch.float32)
    if out.numel() == 0:
        return out
    p = plan(m, k, n, r, slices)
    dev = qa.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws = counters = n_counters = 0
    if p.splits > 1:
        scratch = _SCRATCH.get((dev, stream))
        if scratch is None:
            scratch = _SCRATCH[(dev, stream)] = _Scratch(dev)
        n_ws = p.splits * p.outputs
        if scratch.n_ws < n_ws or scratch.n_counters < p.tiles:
            scratch.grow(n_ws, p.tiles)
        ws, counters = scratch.ws_ptr, scratch.counters_ptr
        n_counters = scratch.n_counters
    prev = enter_device(dev)
    try:
        err = _launcher()(_ARGS.pack(
            qa.data_ptr(), qw.data_ptr(), u.data_ptr(), v.data_ptr(),
            out.data_ptr(), ws, counters, n_counters, m, k, n, r,
            p.k_per_split, p.splits, slices, experts, stream))
    finally:
        leave_device(prev)
    if err:
        build.check("lowrank_matmul", err)
    lowrank_matmul.launches += 1
    return out


lowrank_matmul.launches = 0

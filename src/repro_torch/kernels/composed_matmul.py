"""CUDA kernels K5, K6: the two-step composed wide (12/16-bit) LUT matmul
on codes.

Hopper counterparts of the reference's TPU kernels in
``repro/kernels/composed_matmul.py``:

  * K5 ``composed_matmul`` (``csrc/composed_matmul.cu``) — int32 W-bit
    codes qa (M,K), qw (K,N) as base-256 digits, four tile-LUT gathers
    per product, the shift/add tree of a reduce code, the 2W-bit mask
    (0 = narrow lane: the plain tile sum): int32 limbs ``lo``, ``hi``
    (M,N);
  * K6 ``composed_matmul_bank`` (``csrc/composed_matmul_bank.cu``) — K5
    over a bank of n tile LUTs with per-lane masks, qa and qw shared or
    banked (a bank mixing widths quantizes both per lane): (n,M,N) limbs.

Both also take the expert axis (an MoE projection's experts, for every
lane, in one launch, as the reference's ``pallas_call`` batched over
lanes and experts): qa (X,M,K), or (n,X,M,K) for K6, against qw (E,K,N),
or (n,E,K,N) for K6's per-lane weight codes, slice ``s`` against weight
``s % E``: limbs (X,M,N), or (n,X,M,N).

They run K7/K8's body (``csrc/fused_gather.cuh``) on codes, without the
quantize step and the code sums.  The reference's kernels take a static
tree; here it travels as its ``registry.encode_reduce`` code, which
computes the same values.  The f32 recombination ``lo + 65536 * hi``
runs in the caller (``fused_matmul.limbs_to_f32``).

Callers go through ``repro_torch.kernels.ops`` (``composed_matmul_lut``,
``composed_matmul_lut_bank``), which validates the operands and sends
CPU tensors to the plain versions (``kernels.ref``).  Each launcher's
``.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .approx_matmul import _ptr, enter_device, leave_device, sm_count
from .fused_matmul import _mask_bits, _stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"composed_matmul": [_P] * 7 + [_I] * 4 + [_P],
             "composed_matmul_bank": [_P, _L, _P, _L] + [_P] * 5 + [_I] * 5
             + [_P],
             # the expert forms (``<name>_experts_launch``)
             "composed_matmul_experts": [_P] * 7 + [_I] * 6 + [_P],
             "composed_matmul_bank_experts": [_P, _L, _P, _L] + [_P] * 5
             + [_I] * 7 + [_P]}


@functools.lru_cache(maxsize=None)
def _launcher(name: str, experts: bool = False):
    key = f"{name}_experts" if experts else name
    fn = getattr(build.load(name), f"{key}_launch")
    fn.argtypes = _ARGTYPES[key]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, fn, qa, qw, luts16, masks, rcodes,
            experts: bool = False) -> tuple:
    banked = name.endswith("_bank")
    n_lanes = luts16.shape[0] if banked else 1
    slices = qa.shape[-3] if experts else 1
    m, k = qa.shape[-2:]
    n = qw.shape[-1]
    lead = (n_lanes, slices) if experts else (n_lanes,)
    lo, hi = (torch.empty((*lead, m, n), dtype=torch.int32,
                          device=qa.device) for _ in range(2))
    if lo.numel() == 0:
        return lo.zero_(), hi.zero_()
    # every operand stays referenced until the launch is queued
    ins = [luts16, _mask_bits(masks), rcodes.contiguous(), lo, hi]
    # banked codes: one lane's slices (weights) apart; shared: stride 0
    a_stride = slices * m * k if qa.ndim == 3 + experts else 0
    w_stride = ((qw.shape[-3] if experts else 1) * k * n
                if qw.ndim == 3 + experts else 0)
    first = ((_ptr(qa), a_stride, _ptr(qw), w_stride) if banked
             else (_ptr(qa), _ptr(qw)))
    dims = (((n_lanes,) if banked else ())
            + ((slices, qw.shape[-3]) if experts else ()) + (m, k, n))
    dev = qa.get_device()
    prev = enter_device(dev)
    try:
        err = _launcher(name, experts)(*first, *(_ptr(t) for t in ins),
                                       *dims, sm_count(dev), _stream(qa))
    finally:
        leave_device(prev)
    build.check(name, err)
    fn.launches += 1
    return lo, hi


def composed_matmul(qa, qw, lut16, masks, rcodes) -> tuple:
    """Launch K5.  qa (M,K), qw (K,N) int32 codes, lut16 (256,256)
    uint16, masks (1,) int64, rcodes (1,2) int32, all contiguous on one
    CUDA device (checked by ``ops.composed_matmul_lut``) -> lo, hi (M,N)
    int32.  The expert form: qa (X,M,K), qw (E,K,N) -> (X,M,N)."""
    return tuple(t[0] for t in _launch("composed_matmul", composed_matmul,
                                       qa, qw, lut16, masks, rcodes,
                                       qw.ndim == 3))


def composed_matmul_bank(qa, qw, luts16, masks, rcodes,
                         experts: bool = False) -> tuple:
    """Launch K6.  qa (M,K) shared or (n,M,K) banked, qw (K,N) or (n,K,N),
    luts16 (n,256,256), masks (n,) int64, rcodes (n,2) int32 -> lo, hi
    (n,M,N) int32.  The expert form (``experts``): qa (X,M,K) or
    (n,X,M,K), qw (E,K,N) or (n,E,K,N) -> (n,X,M,N)."""
    return _launch("composed_matmul_bank", composed_matmul_bank, qa, qw,
                   luts16, masks, rcodes, experts)


composed_matmul.launches = 0
composed_matmul_bank.launches = 0

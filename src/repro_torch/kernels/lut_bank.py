"""CUDA kernel K2: banked bit-true LUT-gather approximate matmul.

``lut_matmul_bank(qa, qw, luts16)`` launches ``csrc/lut_matmul_bank.cu``
— the Hopper counterpart of the reference's TPU kernel
``approx_matmul_lut_bank_pallas`` (``repro/kernels/lut_bank.py``): the
same matmul under ``n`` product tables in one launch,
``out[l] = Σ_k luts[l][qa_l, qw]`` with ``qa`` shared ``(M, K)`` or
banked ``(n, M, K)``.  Lane ``l`` equals K1 run with ``luts[l]``, the
contract the batched resilience engine relies on.

The expert form (an MoE projection's experts for every lane in one
launch, the reference's ``pallas_call`` batched over lanes and experts):
qa (X, M, K) shared or (n, X, M, K) banked against qw (E, K, N), lane
``l``'s slice ``s`` against ``qw[s % E]`` under ``luts[l]``.

Callers go through ``repro_torch.kernels.ops.approx_matmul_lut_bank``.
``lut_matmul_bank.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .approx_matmul import _ptr, enter_device, leave_device, sm_count


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("lut_matmul_bank").lut_matmul_bank_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher():
    fn = build.load("lut_matmul_bank").lut_matmul_bank_experts_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lut_matmul_bank(qa: torch.Tensor, qw: torch.Tensor,
                    luts16: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the current stream of the operands' device (made
    current for the launch).  qa (M,K) or (n,M,K) int32, qw (K,N) int32,
    luts16 (n,256,256) uint16, all contiguous on one CUDA device
    (checked by ``ops.approx_matmul_lut_bank``) -> (n,M,N) int32.  The
    expert form: qa (X,M,K) or (n,X,M,K), qw (E,K,N) with E dividing X
    -> (n,X,M,N)."""
    n_lanes = luts16.shape[0]
    experts = qw.ndim == 3
    slices = qa.shape[-3] if experts else 1
    m, k = qa.shape[-2:]
    n = qw.shape[-1]
    lead = (n_lanes, slices) if experts else (n_lanes,)
    out = torch.empty((*lead, m, n), dtype=torch.int32, device=qa.device)
    if out.numel() == 0:
        return out
    # banked activations: one lane's slices apart; shared: stride 0
    stride = slices * m * k if qa.ndim == (4 if experts else 3) else 0
    dev = qa.get_device()
    prev = enter_device(dev)
    try:
        stream = ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev))
        if experts:
            err = _experts_launcher()(
                _ptr(qa), stride, _ptr(qw), _ptr(luts16), _ptr(out),
                n_lanes, slices, qw.shape[0], m, k, n, sm_count(dev), stream)
        else:
            err = _launcher()(_ptr(qa), stride, _ptr(qw), _ptr(luts16),
                              _ptr(out), n_lanes, m, k, n, sm_count(dev),
                              stream)
    finally:
        leave_device(prev)
    build.check("lut_matmul_bank", err)
    lut_matmul_bank.launches += 1
    return out


lut_matmul_bank.launches = 0

"""CUDA kernel K2: banked bit-true LUT-gather approximate matmul.

``lut_matmul_bank(qa, qw, luts16)`` launches ``csrc/lut_matmul_bank.cu``
— the Hopper counterpart of the reference's TPU kernel
``approx_matmul_lut_bank_pallas`` (``repro/kernels/lut_bank.py``): the
same matmul under ``n`` product tables in one launch,
``out[l] = Σ_k luts[l][qa_l, qw]`` with ``qa`` shared ``(M, K)`` or
banked ``(n, M, K)``.  Lane ``l`` equals K1 run with ``luts[l]``, the
contract the batched resilience engine relies on.

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


def lut_matmul_bank(qa: torch.Tensor, qw: torch.Tensor,
                    luts16: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the current stream of the operands' device (made
    current for the launch).  qa (M,K) or (n,M,K) int32, qw (K,N) int32,
    luts16 (n,256,256) uint16, all contiguous on one CUDA device
    (checked by ``ops.approx_matmul_lut_bank``) -> (n,M,N) int32."""
    n_lanes = luts16.shape[0]
    m, k = qa.shape[-2:]
    n = qw.shape[1]
    out = torch.empty((n_lanes, m, n), dtype=torch.int32, device=qa.device)
    if m == 0 or n == 0 or n_lanes == 0:
        return out
    dev = qa.get_device()
    prev = enter_device(dev)
    try:
        err = _launcher()(
            _ptr(qa), m * k if qa.ndim == 3 else 0, _ptr(qw), _ptr(luts16),
            _ptr(out), n_lanes, m, k, n, sm_count(dev),
            ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev)))
    finally:
        leave_device(prev)
    build.check("lut_matmul_bank", err)
    lut_matmul_bank.launches += 1
    return out


lut_matmul_bank.launches = 0

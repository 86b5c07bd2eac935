"""CUDA kernel K1: bit-true LUT-gather approximate matmul.

``lut_matmul(qa, qw, lut16)`` launches ``csrc/lut_matmul.cu`` — the
Hopper counterpart of the reference's TPU kernel
``approx_matmul_lut_pallas`` (``repro/kernels/approx_matmul.py``):
``out[m,n] = Σ_k LUT[qa[m,k], qw[k,n]]`` with exact int32 sums.  The
product table travels as uint16 (every 8-bit library multiplier's
products are < 2^16; ``lut_to_uint16`` checks) and sits in shared
memory; see the source for the design.

``lut_matmul`` also takes the expert axis (an MoE projection's experts
in one launch, as the reference's ``pallas_call`` batched over them):
qa (X, M, K) against qw (E, K, N), slice s against ``qw[s % E]``.

Callers go through ``repro_torch.kernels.ops.approx_matmul_lut``, which
validates the operands and sends CPU tensors to the plain version
(``kernels.ref``).  ``lut_matmul.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build


def lut_to_uint16(lut: torch.Tensor) -> torch.Tensor:
    """An integer product table as uint16, raising when an entry lies
    outside [0, 65535] (the kernels keep the table in 16 bits and never
    truncate).  A uint16 table passes through unchecked."""
    if lut.dtype == torch.uint16:
        return lut
    if lut.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"LUT must be int32 or uint16, got {lut.dtype}")
    if lut.numel() and (int(lut.min()) < 0 or int(lut.max()) > 0xFFFF):
        raise ValueError(
            "LUT entries must lie in [0, 65535] (16-bit products); got "
            f"range [{int(lut.min())}, {int(lut.max())}]")
    return lut.to(torch.uint16)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device: the persistent grid."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def enter_device(index: int) -> int:
    """Make CUDA device ``index`` current for a launch: a kernel launches
    on the current device, whatever device its stream belongs to.
    Returns the device to give back to ``leave_device``, or -1 when
    ``index`` was current already (raw calls, about as cheap as reading
    the raw stream)."""
    prev = torch._C._cuda_getDevice()
    if prev == index:
        return -1
    torch._C._cuda_setDevice(index)
    return prev


def leave_device(prev: int) -> None:
    """Undo ``enter_device``."""
    if prev >= 0:
        torch._C._cuda_setDevice(prev)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("lut_matmul").lut_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _experts_launcher():
    fn = build.load("lut_matmul").lut_matmul_experts_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def lut_matmul(qa: torch.Tensor, qw: torch.Tensor,
               lut16: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the current stream of the operands' device (made
    current for the launch).  qa (M,K) int32, qw (K,N) int32, lut16
    (256,256) uint16, all contiguous on one CUDA device (checked by
    ``ops.approx_matmul_lut``) -> (M,N) int32.  The expert form: qa
    (X,M,K), qw (E,K,N) with E dividing X -> (X,M,N)."""
    experts = qw.ndim == 3
    m, k = qa.shape[-2:]
    n = qw.shape[-1]
    out = torch.empty((*qa.shape[:-1], n), dtype=torch.int32,
                      device=qa.device)
    if out.numel() == 0:
        return out
    dev = qa.get_device()
    prev = enter_device(dev)
    try:
        stream = ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(dev))
        if experts:
            err = _experts_launcher()(
                _ptr(qa), _ptr(qw), _ptr(lut16), _ptr(out), qa.shape[0],
                qw.shape[0], m, k, n, sm_count(dev), stream)
        else:
            err = _launcher()(_ptr(qa), _ptr(qw), _ptr(lut16), _ptr(out),
                              m, k, n, sm_count(dev), stream)
    finally:
        leave_device(prev)
    build.check("lut_matmul", err)
    lut_matmul.launches += 1
    return out


lut_matmul.launches = 0

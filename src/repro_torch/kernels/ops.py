"""Public wrappers of the CUDA kernels (port of ``repro.kernels.ops``).

Each wrapper validates its operands, then dispatches on where they
live: a CPU tensor goes to the kernel's plain version (``kernels.ref``;
the tests run there), a CUDA tensor launches the kernel — there is no
fallback from one to the other.

The reference reaches its banked kernel through a ``custom_vmap`` rule
on ``approx_matmul_lut``; the port writes the bank axis out instead, so
the banked datapath calls ``approx_matmul_lut_bank`` directly.
"""
from __future__ import annotations

import torch

from ..approx.registry import MAX_LUT_K
from . import ref
from .approx_matmul import lut_matmul, lut_to_uint16
from .lut_bank import lut_matmul_bank


def _check_codes(qa: torch.Tensor, qw: torch.Tensor, lut: torch.Tensor,
                 a_ndim: tuple, lut_shape: tuple) -> None:
    if qa.ndim not in a_ndim or qw.ndim != 2:
        raise ValueError(f"qa must have {' or '.join(map(str, a_ndim))} "
                         f"dims and qw 2, got {tuple(qa.shape)} and "
                         f"{tuple(qw.shape)}")
    k = qa.shape[-1]
    if qw.shape[0] != k:
        raise ValueError(f"contraction mismatch: qa K={k}, qw K="
                         f"{qw.shape[0]}")
    if k > MAX_LUT_K:
        raise ValueError(
            f"K={k} exceeds the int32-safe LUT accumulation bound "
            f"{MAX_LUT_K}")
    if tuple(lut.shape) != lut_shape:
        raise ValueError(f"LUT shape must be {lut_shape}, got "
                         f"{tuple(lut.shape)}")
    for name, t in (("qa", qa), ("qw", qw)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 codes, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not lut.is_contiguous():
        raise ValueError("LUT must be contiguous")
    if not qa.device == qw.device == lut.device:
        raise ValueError(f"operands on different devices: {qa.device}, "
                         f"{qw.device}, {lut.device}")


def _dispatch(kernel, plain, qa, qw, lut):
    lut16 = lut_to_uint16(lut)       # raises on entries >= 2^16
    if qa.device.type == "cpu":
        return plain(qa, qw, lut16.to(torch.int32))
    if qa.device.type != "cuda":
        raise ValueError(f"no kernel for device {qa.device}")
    if lut16.data_ptr() % 16:
        raise ValueError("LUT must be 16-byte aligned (the kernel stages "
                         "it with 16-byte loads)")
    return kernel(qa, qw, lut16)


def approx_matmul_lut(qa: torch.Tensor, qw: torch.Tensor,
                      lut: torch.Tensor) -> torch.Tensor:
    """Bit-true approximate matmul on uint8 codes (kernel K1).
    qa (M,K) int32, qw (K,N) int32, lut (256,256) int32 or uint16
    (entries in [0, 65535]) -> (M,N) int32."""
    _check_codes(qa, qw, lut, (2,), (256, 256))
    return _dispatch(lut_matmul, ref.approx_matmul_lut_ref, qa, qw, lut)


def approx_matmul_lut_bank(qa: torch.Tensor, qw: torch.Tensor,
                           luts: torch.Tensor) -> torch.Tensor:
    """Banked bit-true matmul, one launch for a whole LUT bank (kernel
    K2).  qa (M,K) shared or (n,M,K) banked codes; luts (n,256,256)
    int32 or uint16 -> (n,M,N) int32, lane ``b`` equal to
    ``approx_matmul_lut(qa_b, qw, luts[b])``."""
    n = luts.shape[0] if luts.ndim == 3 else -1
    _check_codes(qa, qw, luts, (2, 3), (n, 256, 256))
    if qa.ndim == 3 and qa.shape[0] != n:
        raise ValueError(f"banked qa has {qa.shape[0]} lanes, the bank "
                         f"{n}")
    return _dispatch(lut_matmul_bank, ref.approx_matmul_lut_bank_ref,
                     qa, qw, luts)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {"lut_matmul": lut_matmul.launches,
            "lut_matmul_bank": lut_matmul_bank.launches}


def reset_launch_counts() -> None:
    lut_matmul.launches = 0
    lut_matmul_bank.launches = 0

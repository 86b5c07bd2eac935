"""Public wrappers of the CUDA kernels (port of ``repro.kernels.ops``).

Each wrapper validates its operands, then dispatches on where they
live: a CPU tensor goes to the kernel's plain version (``kernels.ref``;
the tests run there), a CUDA tensor launches the kernel — there is no
fallback from one to the other.

The reference reaches its banked kernels through ``custom_vmap`` rules
on the single-table ops; the port writes the bank axis out instead, so
the banked datapaths call the ``*_bank`` wrappers directly.

The fused wrappers take float operands and the pre-calibrated
quantization scalars (``quant.scalar_params``; numbers or tensors, per
lane for the banked ones) and return the f32 result; ``raw=True``
returns the kernel's int32 outputs instead (accumulator or lo/hi
limbs, then the row and column code sums).
"""
from __future__ import annotations

import torch

from ..approx.registry import MAX_COMPOSED_K, MAX_LUT_K
from . import ref
from .approx_matmul import lut_matmul, lut_to_uint16
from .fused_matmul import (dequant, fused_composed_matmul,
                           fused_composed_matmul_bank, fused_matmul,
                           fused_matmul_bank, limbs_to_f32, pack_codes,
                           pack_scalars)
from .lut_bank import lut_matmul_bank

#: Every CUDA kernel's launcher (its ``.launches`` counts launches).
KERNELS = {"lut_matmul": lut_matmul, "lut_matmul_bank": lut_matmul_bank,
           "fused_matmul": fused_matmul,
           "fused_matmul_bank": fused_matmul_bank,
           "fused_composed_matmul": fused_composed_matmul,
           "fused_composed_matmul_bank": fused_composed_matmul_bank}


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


def _dispatch(kernel, plain, qa, qw, lut, *rest):
    lut16 = lut_to_uint16(lut)       # raises on entries >= 2^16
    if qa.device.type == "cpu":
        return plain(qa, qw, lut16.to(torch.int32), *rest)
    if qa.device.type != "cuda":
        raise ValueError(f"no kernel for device {qa.device}")
    if lut16.data_ptr() % 16:
        raise ValueError("LUT must be 16-byte aligned (the kernel stages "
                         "it with 16-byte loads)")
    return kernel(qa, qw, lut16, *rest)


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


def _check_fused(x: torch.Tensor, w: torch.Tensor, luts: torch.Tensor,
                 banked: bool, bound: int, what: str) -> int:
    """Validate fused operands; returns the lane count (1 unbanked)."""
    n = luts.shape[0] if banked and luts.ndim == 3 else -1
    if x.ndim not in ((2, 3) if banked else (2,)) or w.ndim != 2:
        raise ValueError(f"x must have {'2 or 3' if banked else 2} dims "
                         f"and w 2, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    k = x.shape[-1]
    if w.shape[0] != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K="
                         f"{w.shape[0]}")
    if k > bound:
        raise ValueError(f"K={k} exceeds the int32-safe {what} "
                         f"accumulation bound {bound}")
    lut_shape = (n, 256, 256) if banked else (256, 256)
    if tuple(luts.shape) != lut_shape:
        raise ValueError(f"LUT shape must be {lut_shape}, got "
                         f"{tuple(luts.shape)}")
    if banked and x.ndim == 3 and x.shape[0] != n:
        raise ValueError(f"banked x has {x.shape[0]} lanes, the bank {n}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not luts.is_contiguous():
        raise ValueError("LUT must be contiguous")
    if not x.device == w.device == luts.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w.device}, {luts.device}")
    return n if banked else 1


def _finish(out: tuple, fp, ip, k: int, raw: bool):
    if raw:
        return out
    s = limbs_to_f32(*out[:2]) if len(out) == 4 else out[0].to(
        torch.float32)
    return dequant(s, out[-2], out[-1], fp, ip, k)


def fused_matmul_lut(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
                     sa, za, sw, zw, qmax, *, raw: bool = False):
    """Fused 8-bit approximate matmul on float operands (kernel K3):
    in-kernel quantize with the scalars, LUT gather, int32 accumulation
    and code sums; f32 correction and dequant here.  x (M,K), w (K,N)
    f32, lut (256,256) int32 or uint16 -> (M,N) f32."""
    _check_fused(x, w, lut, False, MAX_LUT_K, "LUT")
    fp, ip = pack_scalars(1, x.device, sa, za, sw, zw, qmax)
    out = _dispatch(fused_matmul, ref.fused_matmul_ref, x, w, lut, fp, ip)
    return _finish(out, fp, ip, x.shape[-1], raw)


def fused_matmul_lut_bank(x: torch.Tensor, w: torch.Tensor,
                          luts: torch.Tensor, sa, za, sw, zw, qmax, *,
                          raw: bool = False):
    """Banked fused 8-bit matmul, one launch for a whole LUT bank (kernel
    K4): x (M,K) shared or (n,M,K) banked f32, luts (n,256,256),
    scalars per lane (n,) or shared -> (n,M,N) f32, lane ``b`` equal to
    ``fused_matmul_lut`` with lane ``b``'s table and scalars."""
    n = _check_fused(x, w, luts, True, MAX_LUT_K, "LUT")
    fp, ip = pack_scalars(n, x.device, sa, za, sw, zw, qmax)
    out = _dispatch(fused_matmul_bank, ref.fused_matmul_bank_ref, x, w,
                    luts, fp, ip)
    return _finish(out, fp, ip, x.shape[-1], raw)


def fused_composed_matmul_lut(x: torch.Tensor, w: torch.Tensor,
                              lut: torch.Tensor, mask, rcode, sa, za, sw,
                              zw, qmax, *, raw: bool = False):
    """Fused composed wide (12/16-bit) matmul on floats (kernel K7):
    digit products through the 256x256 tile LUT, the reduce tree named
    by ``rcode`` (``registry.encode_reduce`` (kind, k)), ``mask`` the
    2W-bit product mask (0 = narrow lane), int32 limbs recombined and
    dequantized here -> (M,N) f32."""
    _check_fused(x, w, lut, False, MAX_COMPOSED_K, "composed limb")
    fp, ip = pack_scalars(1, x.device, sa, za, sw, zw, qmax)
    masks, rcodes = pack_codes(1, x.device, mask, rcode)
    out = _dispatch(fused_composed_matmul, ref.fused_composed_matmul_ref,
                    x, w, lut, masks, rcodes, fp, ip)
    return _finish(out, fp, ip, x.shape[-1], raw)


def fused_composed_matmul_lut_bank(x: torch.Tensor, w: torch.Tensor,
                                   luts: torch.Tensor, masks, rcodes, sa,
                                   za, sw, zw, qmax, *, raw: bool = False):
    """Banked fused composed matmul (kernel K8): per-lane masks (n,),
    reduce codes (n,2) and scalars (n,) in one launch, so one call
    evaluates a bank mixing widths and reduce trees -> (n,M,N) f32."""
    n = _check_fused(x, w, luts, True, MAX_COMPOSED_K, "composed limb")
    fp, ip = pack_scalars(n, x.device, sa, za, sw, zw, qmax)
    masks, rcodes = pack_codes(n, x.device, masks, rcodes)
    out = _dispatch(fused_composed_matmul_bank,
                    ref.fused_composed_matmul_bank_ref, x, w, luts, masks,
                    rcodes, fp, ip)
    return _finish(out, fp, ip, x.shape[-1], raw)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0

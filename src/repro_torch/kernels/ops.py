"""Public wrappers of the CUDA kernels (port of ``repro.kernels.ops``).

Each wrapper validates its operands, then dispatches on where they
live: a CPU tensor goes to the kernel's plain version (``kernels.ref``;
the tests run there), a CUDA tensor launches the kernel — there is no
fallback from one to the other.

The reference reaches its banked kernels through ``custom_vmap`` rules
on the single-table ops; the port writes the bank axis out instead, so
the banked datapaths call the ``*_bank`` wrappers directly.  Its batched
weights (an MoE's experts, ``vmap``ped over ``backend_matmul``) go to
``pallas_call``'s own batching rule, which adds the expert axis (and
under a bank the lane axis) to the kernel's grid; the port writes that
axis out too: K1-K9 take stacked weights ``(E, K, N)`` against
activations ``(X, M, K)`` (banked ``(n, X, M, K)``), slice ``s`` against
weight ``s % E``, in one launch counted under the kernel's own name
(``w.ndim == 3``, or ``experts=True`` for ``composed_matmul_lut_bank``,
whose weight codes may carry a lane axis of their own).

The bitsim wrappers carry uint32 words as int32 bit patterns
(``bitsim_planes``, ``bitsim_pop_planes``); ``bitsim`` and ``bitsim_pop``
take and return the uint64 planes of ``Netlist.eval_words`` on the host.

The fused wrappers take float operands and the pre-calibrated
quantization scalars (``quant.scalar_params``; numbers or tensors, per
lane for the banked ones), which reach the kernel as they are
(``fused_matmul.lane_scalars``: on the datapath a K3 or K4 call queues
its kernel, and a memset where K is split), and return the f32 result;
``raw=True`` returns the kernel's int32 outputs instead (accumulator or
lo/hi limbs, then the row and column code sums).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..approx.registry import MAX_COMPOSED_K, MAX_LUT_K, encode_reduce
from ..core.gates import GATE_ARITY
from ..core.netlist import stack_netlists
from ..device import DeviceLike, resolve_device
from . import ref
from .approx_matmul import lut_matmul, lut_to_uint16
from .bitsim import bitsim_pop_words, bitsim_words
from .composed_matmul import composed_matmul, composed_matmul_bank
from .fused_matmul import (dequant_lanes, fused_composed_matmul,
                           fused_composed_matmul_bank, fused_matmul,
                           fused_matmul_bank, lane_scalars, limbs_to_f32,
                           pack_codes, pack_scalars, quant8_lookups)
from .lowrank_matmul import MAX_RANK, lowrank_matmul as lowrank_kernel
from .lut_bank import lut_matmul_bank

#: Every CUDA kernel's launcher (its ``.launches`` counts launches).
KERNELS = {"lut_matmul": lut_matmul, "lut_matmul_bank": lut_matmul_bank,
           "fused_matmul": fused_matmul,
           "fused_matmul_bank": fused_matmul_bank,
           "fused_composed_matmul": fused_composed_matmul,
           "fused_composed_matmul_bank": fused_composed_matmul_bank,
           "composed_matmul": composed_matmul,
           "composed_matmul_bank": composed_matmul_bank,
           "bitsim": bitsim_words, "bitsim_pop": bitsim_pop_words,
           "lowrank_matmul": lowrank_kernel}


def _check_codes(qa: torch.Tensor, qw: torch.Tensor, lut: torch.Tensor,
                 a_ndim: tuple, lut_shape: tuple,
                 bound: int = MAX_LUT_K,
                 what: str = "LUT accumulation",
                 w_ndim: tuple = (2,)) -> None:
    if qa.ndim not in a_ndim or qw.ndim not in w_ndim:
        raise ValueError(f"qa must have {' or '.join(map(str, a_ndim))} "
                         f"dims and qw {' or '.join(map(str, w_ndim))}, "
                         f"got {tuple(qa.shape)} and {tuple(qw.shape)}")
    k = qa.shape[-1]
    if qw.shape[-2] != k:
        raise ValueError(f"contraction mismatch: qa K={k}, qw K="
                         f"{qw.shape[-2]}")
    if k > bound:
        raise ValueError(
            f"K={k} exceeds the int32-safe {what} bound {bound}")
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


def _check_experts(a: torch.Tensor, w: torch.Tensor) -> None:
    """The expert form's slices: E = w.shape[-3] weights dividing the X
    activation slices of ``a`` (..., X, M, K)."""
    e, x = w.shape[-3], a.shape[-3]
    if e < 1 or x < 1 or x % e:
        raise ValueError(f"{x} activation slices are no multiple of the "
                         f"{e} stacked weights")


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
    (entries in [0, 65535]) -> (M,N) int32.  The expert form, one
    launch: qa (X,M,K), qw (E,K,N) with E dividing X -> (X,M,N), slice
    ``s`` equal to ``approx_matmul_lut(qa[s], qw[s % E], lut)``."""
    if qw.ndim == 3:
        _check_codes(qa, qw, lut, (3,), (256, 256), w_ndim=(3,))
        _check_experts(qa, qw)
        return _dispatch(lut_matmul, ref.approx_matmul_lut_experts_ref, qa,
                         qw, lut)
    _check_codes(qa, qw, lut, (2,), (256, 256))
    return _dispatch(lut_matmul, ref.approx_matmul_lut_ref, qa, qw, lut)


def approx_matmul_lut_bank(qa: torch.Tensor, qw: torch.Tensor,
                           luts: torch.Tensor) -> torch.Tensor:
    """Banked bit-true matmul, one launch for a whole LUT bank (kernel
    K2).  qa (M,K) shared or (n,M,K) banked codes; luts (n,256,256)
    int32 or uint16 -> (n,M,N) int32, lane ``b`` equal to
    ``approx_matmul_lut(qa_b, qw, luts[b])``.  The expert form, one
    launch for every lane and expert: qa (X,M,K) shared or (n,X,M,K), qw
    (E,K,N) with E dividing X -> (n,X,M,N), lane ``b``'s slice ``s``
    equal to ``approx_matmul_lut(qa_b[s], qw[s % E], luts[b])``."""
    n = luts.shape[0] if luts.ndim == 3 else -1
    experts = qw.ndim == 3
    ndims = (3, 4) if experts else (2, 3)
    _check_codes(qa, qw, luts, ndims, (n, 256, 256),
                 w_ndim=(3,) if experts else (2,))
    if experts:
        _check_experts(qa, qw)
    if qa.ndim == ndims[1] and qa.shape[0] != n:
        raise ValueError(f"banked qa has {qa.shape[0]} lanes, the bank "
                         f"{n}")
    return _dispatch(lut_matmul_bank,
                     ref.approx_matmul_lut_bank_experts_ref if experts
                     else ref.approx_matmul_lut_bank_ref, qa, qw, luts)


def composed_matmul_lut(qa: torch.Tensor, qw: torch.Tensor,
                        lut: torch.Tensor, mask,
                        reduce: tuple = ("exact", 0), *,
                        raw: bool = False):
    """Composed wide (12/16-bit) matmul on W-bit codes (kernel K5):
    digit products through the 256x256 tile LUT, the static ``reduce``
    tree, ``mask`` the 2W-bit product mask (0 = narrow lane: the plain
    tile sum), exact int32 limbs recombined as ``lo + 65536 * hi`` in
    f32.  qa (M,K), qw (K,N) int32, lut (256,256) int32 or uint16 ->
    (M,N) f32 (``raw=True``: the limbs).  The expert form, one launch:
    qa (X,M,K), qw (E,K,N) with E dividing X -> (X,M,N), slice ``s``
    equal to ``composed_matmul_lut(qa[s], qw[s % E], ...)``."""
    experts = qa.ndim == qw.ndim == 3
    if qa.ndim != qw.ndim:
        raise ValueError(f"qa must have 2 dims and qw 2, or both 3 (the "
                         f"expert form), got {tuple(qa.shape)} and "
                         f"{tuple(qw.shape)}")
    _check_codes(qa, qw, lut, (2 + experts,), (256, 256), MAX_COMPOSED_K,
                 "composed limb accumulation", (2 + experts,))
    if experts:
        _check_experts(qa, qw)
    masks, rcodes = pack_codes(1, qa.device, mask, encode_reduce(reduce))
    lo, hi = _dispatch(composed_matmul,
                       ref.composed_matmul_limbs_experts_ref if experts
                       else ref.composed_matmul_limbs_ref, qa, qw, lut,
                       masks, rcodes)
    return (lo, hi) if raw else limbs_to_f32(lo, hi)


def composed_matmul_lut_bank(qa: torch.Tensor, qw: torch.Tensor,
                             luts: torch.Tensor, masks,
                             reduce: tuple = ("exact", 0), *,
                             raw: bool = False, experts: bool = False):
    """Banked composed matmul, one launch for a whole mixed-width bank
    (kernel K6): qa (M,K) shared or (n,M,K) banked codes, qw (K,N) shared
    or (n,K,N) banked (a bank mixing widths quantizes the weights per
    lane), luts (n,256,256) tile LUTs, masks (n,) per-lane 2W-bit masks
    (0 = narrow lane), one static ``reduce`` tree for every lane ->
    (n,M,N) f32, lane ``b`` equal to ``composed_matmul_lut(qa_b, qw_b,
    luts[b], masks[b], reduce)``.  The expert form (``experts``), one
    launch for every lane and expert: qa (X,M,K) shared or (n,X,M,K), qw
    (E,K,N) shared or (n,E,K,N), E dividing X -> (n,X,M,N), lane ``b``'s
    slice ``s`` equal to ``composed_matmul_lut(qa_b[s], qw_b[s % E],
    luts[b], masks[b], reduce)``."""
    n = luts.shape[0] if luts.ndim == 3 else -1
    ndims = (3, 4) if experts else (2, 3)
    _check_codes(qa, qw, luts, ndims, (n, 256, 256), MAX_COMPOSED_K,
                 "composed limb accumulation", ndims)
    if experts:
        _check_experts(qa, qw)
    for name, t in (("qa", qa), ("qw", qw)):
        if t.ndim == ndims[1] and t.shape[0] != n:
            raise ValueError(f"banked {name} has {t.shape[0]} lanes, the "
                             f"bank {n}")
    masks, rcodes = pack_codes(n, qa.device, masks, encode_reduce(reduce))
    if experts:
        lo, hi = _dispatch(
            lambda *a: composed_matmul_bank(*a, experts=True),
            ref.composed_matmul_bank_experts_ref, qa, qw, luts, masks,
            rcodes)
    else:
        lo, hi = _dispatch(composed_matmul_bank,
                           ref.composed_matmul_bank_ref, qa, qw, luts,
                           masks, rcodes)
    return (lo, hi) if raw else limbs_to_f32(lo, hi)


def _check_fused(x: torch.Tensor, w: torch.Tensor, luts: torch.Tensor,
                 banked: bool, bound: int, what: str,
                 experts: bool = False) -> int:
    """Validate fused operands; returns the count of (lane, slice) pairs
    the scalars are read for: the lanes (1 unbanked), times the slices
    of the expert form (``experts``: w (E,K,N))."""
    n = luts.shape[0] if banked and luts.ndim == 3 else -1
    x_ndims = tuple(d + experts for d in ((2, 3) if banked else (2,)))
    if x.ndim not in x_ndims or w.ndim != 2 + experts:
        raise ValueError(f"x must have {' or '.join(map(str, x_ndims))} "
                         f"dims and w {2 + experts}, got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    k = x.shape[-1]
    if w.shape[-2] != k:
        raise ValueError(f"contraction mismatch: x K={k}, w K="
                         f"{w.shape[-2]}")
    if experts:
        _check_experts(x, w)
    if k > bound:
        raise ValueError(f"K={k} exceeds the int32-safe {what} "
                         f"accumulation bound {bound}")
    lut_shape = (n, 256, 256) if banked else (256, 256)
    if tuple(luts.shape) != lut_shape:
        raise ValueError(f"LUT shape must be {lut_shape}, got "
                         f"{tuple(luts.shape)}")
    if banked and x.ndim == x_ndims[1] and x.shape[0] != n:
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
    return (n if banked else 1) * (x.shape[-3] if experts else 1)


def _plain_fused(plain, n: int):
    """A fused kernel's plain version as ``_dispatch`` calls it: the
    ``lane_scalars`` last, packed here."""
    def call(x, w, lut, *rest):
        return plain(x, w, lut, *rest[:-1],
                     *pack_scalars(n, x.device, *rest[-1].values))
    return call


def _count_quant8(pairs: int, x: torch.Tensor, w: torch.Tensor) -> None:
    """A K3/K4 call's table lookups as its tiles gather them, counters
    ``gather.lookups`` and ``gather.pad_lookups`` (those on padded rows
    or columns, ``fused_matmul.quant8_lookups``) of the open span, while
    the profiler records; the plain versions on the CPU count the plan
    the kernel would take."""
    if obs.counting():
        looked, pad = quant8_lookups(pairs, x.shape[-2], x.shape[-1],
                                     w.shape[-1])
        obs.count("gather.lookups", looked)
        obs.count("gather.pad_lookups", pad)


def _finish(out: tuple, sc, k: int, raw: bool):
    """A fused kernel's outputs dequantized to f32 (the epilogue), or as
    they are with ``raw``."""
    if raw:
        return out
    with obs.span("datapath.epilogue"):
        s = limbs_to_f32(*out[:2]) if len(out) == 4 else out[0].to(
            torch.float32)
        row, col = out[-2], out[-1]
        if s.ndim == 4:          # lanes x slices: one axis of scalar pairs
            return dequant_lanes(s.flatten(0, 1), row.flatten(0, 1),
                                 col.flatten(0, 1), sc, k).view(s.shape)
        return dequant_lanes(s, row, col, sc, k)


def fused_matmul_lut(x: torch.Tensor, w: torch.Tensor, lut: torch.Tensor,
                     sa, za, sw, zw, qmax, *, raw: bool = False):
    """Fused 8-bit approximate matmul on float operands (kernel K3):
    in-kernel quantize with the scalars, LUT gather, int32 accumulation
    and code sums; f32 correction and dequant here.  x (M,K), w (K,N)
    f32, lut (256,256) int32 or uint16 -> (M,N) f32.  The expert form,
    one launch: x (X,M,K), w (E,K,N) with E dividing X, scalars shared
    or one a slice (X,) -> (X,M,N), slice ``s`` equal to
    ``fused_matmul_lut(x[s], w[s % E], lut, <slice s's scalars>)``."""
    pairs = _check_fused(x, w, lut, False, MAX_LUT_K, "LUT", w.ndim == 3)
    _count_quant8(pairs, x, w)
    sc = lane_scalars(pairs, x.device, sa, za, sw, zw, qmax)
    plain = (ref.fused_matmul_experts_ref if w.ndim == 3
             else ref.fused_matmul_ref)
    out = _dispatch(fused_matmul, _plain_fused(plain, pairs), x, w, lut,
                    sc)
    return _finish(out, sc, x.shape[-1], raw)


def fused_matmul_lut_bank(x: torch.Tensor, w: torch.Tensor,
                          luts: torch.Tensor, sa, za, sw, zw, qmax, *,
                          raw: bool = False):
    """Banked fused 8-bit matmul, one launch for a whole LUT bank (kernel
    K4): x (M,K) shared or (n,M,K) banked f32, luts (n,256,256),
    scalars per lane (n,) or shared -> (n,M,N) f32, lane ``b`` equal to
    ``fused_matmul_lut`` with lane ``b``'s table and scalars.  The
    expert form, one launch for every lane and expert: x (X,M,K) shared
    or (n,X,M,K), w (E,K,N) with E dividing X, scalars shared or one a
    (lane, slice) pair (n X,), lane-major -> (n,X,M,N), lane ``b``'s
    slice ``s`` equal to ``fused_matmul_lut(x_b[s], w[s % E], luts[b],
    <pair (b, s)'s scalars>)``."""
    pairs = _check_fused(x, w, luts, True, MAX_LUT_K, "LUT", w.ndim == 3)
    _count_quant8(pairs, x, w)
    sc = lane_scalars(pairs, x.device, sa, za, sw, zw, qmax)
    plain = (ref.fused_matmul_bank_experts_ref if w.ndim == 3
             else ref.fused_matmul_bank_ref)
    out = _dispatch(fused_matmul_bank, _plain_fused(plain, pairs), x, w,
                    luts, sc)
    return _finish(out, sc, x.shape[-1], raw)


def fused_composed_matmul_lut(x: torch.Tensor, w: torch.Tensor,
                              lut: torch.Tensor, mask, rcode, sa, za, sw,
                              zw, qmax, *, raw: bool = False):
    """Fused composed wide (12/16-bit) matmul on floats (kernel K7):
    digit products through the 256x256 tile LUT, the reduce tree named
    by ``rcode`` (``registry.encode_reduce`` (kind, k)), ``mask`` the
    2W-bit product mask (0 = narrow lane), int32 limbs recombined and
    dequantized here -> (M,N) f32.  The expert form, one launch: x
    (X,M,K), w (E,K,N) with E dividing X, scalars shared or one a slice
    (X,) -> (X,M,N), slice ``s`` equal to ``fused_composed_matmul_lut(
    x[s], w[s % E], ...)`` with slice ``s``'s scalars."""
    experts = w.ndim == 3
    pairs = _check_fused(x, w, lut, False, MAX_COMPOSED_K, "composed limb",
                         experts)
    sc = lane_scalars(pairs, x.device, sa, za, sw, zw, qmax)
    codes = pack_codes(1, x.device, mask, rcode)
    plain = (ref.fused_composed_matmul_experts_ref if experts
             else ref.fused_composed_matmul_ref)
    out = _dispatch(fused_composed_matmul, _plain_fused(plain, pairs), x, w,
                    lut, *codes, sc)
    return _finish(out, sc, x.shape[-1], raw)


def fused_composed_matmul_lut_bank(x: torch.Tensor, w: torch.Tensor,
                                   luts: torch.Tensor, masks, rcodes, sa,
                                   za, sw, zw, qmax, *, raw: bool = False):
    """Banked fused composed matmul (kernel K8): per-lane masks (n,),
    reduce codes (n,2) and scalars (n,) in one launch, so one call
    evaluates a bank mixing widths and reduce trees -> (n,M,N) f32.  The
    expert form, one launch for every lane and expert: x (X,M,K) shared
    or (n,X,M,K), w (E,K,N) with E dividing X, masks and codes a lane,
    scalars shared or one a (lane, slice) pair (n X,), lane-major ->
    (n,X,M,N)."""
    experts = w.ndim == 3
    pairs = _check_fused(x, w, luts, True, MAX_COMPOSED_K, "composed limb",
                         experts)
    n = luts.shape[0]
    sc = lane_scalars(pairs, x.device, sa, za, sw, zw, qmax)
    codes = pack_codes(n, x.device, masks, rcodes)
    plain = (ref.fused_composed_matmul_bank_experts_ref if experts
             else ref.fused_composed_matmul_bank_ref)
    out = _dispatch(fused_composed_matmul_bank, _plain_fused(plain, pairs),
                    x, w, luts, *codes, sc)
    return _finish(out, sc, x.shape[-1], raw)


def lowrank_matmul(qa: torch.Tensor, qw: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Rank-R factored approximate matmul (kernel K9):
    Σ_r U_r(qa) @ V_r(qw) in f32.  qa (M,K), qw (K,N) int32 codes in
    [0,255]; u, v (R,256) f32 -> (M,N) f32.  The kernel takes
    1 <= R <= ``lowrank_matmul.MAX_RANK`` (its tables live in shared
    memory); a larger R raises on every device.  The expert form, one
    launch: qa (X,M,K), qw (E,K,N) with E dividing X -> (X,M,N), slice
    ``s`` equal to ``lowrank_matmul(qa[s], qw[s % E], u, v)``."""
    experts = qw.ndim == 3
    if (qa.ndim != 2 + experts or qw.ndim not in (2, 3)
            or qa.shape[-1] != qw.shape[-2]):
        raise ValueError(f"qa (M,K) and qw (K,N), or qa (X,M,K) and qw "
                         f"(E,K,N), expected, got {tuple(qa.shape)} and "
                         f"{tuple(qw.shape)}")
    if experts:
        _check_experts(qa, qw)
    if u.ndim != 2 or u.shape != v.shape or u.shape[1] != 256:
        raise ValueError(f"u and v must both be (R, 256), got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    if not 1 <= u.shape[0] <= MAX_RANK:
        raise ValueError(f"rank R={u.shape[0]} outside the 1..{MAX_RANK} "
                         "the lowrank_matmul kernel takes (its factor "
                         "tables live in shared memory)")
    # one cheap pass on the hot path (K9 is launched per projection per
    # token); the loop below names the culprit
    cuda = qa.is_cuda
    if not (qa.dtype == qw.dtype == torch.int32
            and u.dtype == v.dtype == torch.float32
            and qa.is_contiguous() and qw.is_contiguous()
            and u.is_contiguous() and v.is_contiguous()
            and (qw.get_device() == u.get_device() == v.get_device()
                 == qa.get_device() if cuda else
                 qa.device == qw.device == u.device == v.device)):
        for name, t, dt in (("qa", qa, torch.int32), ("qw", qw, torch.int32),
                            ("u", u, torch.float32), ("v", v, torch.float32)):
            if t.dtype != dt:
                raise TypeError(f"{name} must be {dt}, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != qa.device:
                raise ValueError(f"{name} on {t.device}, qa on {qa.device}")
    if cuda:
        return lowrank_kernel(qa, qw, u, v)
    if qa.device.type == "cpu":
        return (ref.lowrank_matmul_experts_ref if experts
                else ref.lowrank_matmul_ref)(qa, qw, u, v)
    raise ValueError(f"no kernel for device {qa.device}")


def _check_netlist(funcs, in0, in1, outs, planes, pop: bool) -> None:
    nd = 2 if pop else 1
    if funcs.ndim != nd or in0.shape != funcs.shape \
            or in1.shape != funcs.shape or outs.ndim != nd \
            or outs.shape[:-1] != funcs.shape[:-1] or planes.ndim != 2:
        raise ValueError(
            f"netlist arrays must be {'(P, n) ' if pop else '(n,) '}"
            f"with matching shapes and planes (n_i, W), got funcs "
            f"{tuple(funcs.shape)}, in0 {tuple(in0.shape)}, in1 "
            f"{tuple(in1.shape)}, outs {tuple(outs.shape)}, planes "
            f"{tuple(planes.shape)}")
    for name, t in (("funcs", funcs), ("in0", in0), ("in1", in1),
                    ("outs", outs), ("planes", planes)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != planes.device:
            raise ValueError(f"{name} on {t.device}, planes on "
                             f"{planes.device}")


def _dispatch_netlist(kernel, plain, *args):
    dev = args[-1].device
    if dev.type == "cpu":
        return plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return kernel(*args)


def bitsim_planes(funcs: torch.Tensor, in0: torch.Tensor,
                  in1: torch.Tensor, outs: torch.Tensor,
                  planes: torch.Tensor) -> torch.Tensor:
    """One gate netlist on bit-planes (kernel K10): funcs/in0/in1
    (n_nodes,), outs (n_o,) int32, planes (n_i, W) int32 words (uint32
    bit patterns) -> (n_o, W) int32 words.  Gate semantics of
    ``core.gates``; each input a gate uses must name an earlier signal
    (``netlist_tensors`` checks that on the host)."""
    _check_netlist(funcs, in0, in1, outs, planes, pop=False)
    return _dispatch_netlist(bitsim_words, ref.bitsim_ref, funcs, in0,
                             in1, outs, planes)


def bitsim_pop_planes(funcs: torch.Tensor, in0: torch.Tensor,
                      in1: torch.Tensor, outs: torch.Tensor,
                      planes: torch.Tensor) -> torch.Tensor:
    """A population of stacked netlists on shared bit-planes in one
    launch (kernel K11): funcs/in0/in1 (P, n_nodes), outs (P, n_o) int32
    (``core.netlist.stack_netlists``), planes (n_i, W) int32 words ->
    (P, n_o, W) int32 words, row p equal to ``bitsim_planes`` on
    candidate p."""
    _check_netlist(funcs, in0, in1, outs, planes, pop=True)
    return _dispatch_netlist(bitsim_pop_words, ref.bitsim_pop_ref, funcs,
                             in0, in1, outs, planes)


def split_planes64(planes64: np.ndarray) -> np.ndarray:
    """(n, W) uint64 bit-planes -> (n, 2W) uint32 lanes, low word first
    (the lane layout both bitsim kernels consume)."""
    n, w64 = planes64.shape
    planes32 = np.empty((n, 2 * w64), dtype=np.uint32)
    planes32[:, 0::2] = (planes64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    planes32[:, 1::2] = (planes64 >> np.uint64(32)).astype(np.uint32)
    return planes32


def join_planes32(planes32: np.ndarray) -> np.ndarray:
    """Inverse of ``split_planes64`` on the trailing axis (any rank)."""
    return (planes32[..., 0::2].astype(np.uint64)
            | (planes32[..., 1::2].astype(np.uint64) << np.uint64(32)))


def words_to_device(planes32: np.ndarray, device) -> torch.Tensor:
    """uint32 words as the int32 tensor (same bits) the kernels take."""
    return torch.from_numpy(np.ascontiguousarray(planes32).view(
        np.int32)).to(device)


def words_to_host(words: torch.Tensor) -> np.ndarray:
    """The kernels' int32 words back as uint32 numpy words."""
    return words.cpu().numpy().view(np.uint32)


def netlist_tensors(arrays, n_i: int, device) -> list:
    """Netlist arrays ``(funcs, in0, in1, outs)`` — one netlist's, or a
    population's from ``stack_netlists`` — as int32 tensors on
    ``device``, after checking on the host that every input a gate uses
    (its ``core.gates.GATE_ARITY``) and every output names an earlier
    signal: the kernels read signals at those indices unchecked."""
    funcs, in0, in1, outs = (np.asarray(a, dtype=np.int32) for a in arrays)
    if funcs.size and (funcs.min() < 0 or funcs.max() >= len(GATE_ARITY)):
        raise ValueError("invalid gate function code")
    limit = n_i + np.arange(funcs.shape[-1])
    arity = GATE_ARITY[funcs]
    for k, idx in ((1, in0), (2, in1)):
        used = arity >= k
        if np.any(used & ((idx < 0) | (idx >= limit))):
            raise ValueError("a gate input violates the feed-forward "
                             "order")
    if np.any((outs < 0) | (outs >= n_i + funcs.shape[-1])):
        raise ValueError("output index out of range")
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (funcs, in0, in1, outs)]


def bitsim(netlist, planes64: np.ndarray,
           device: DeviceLike = None) -> np.ndarray:
    """Evaluate a ``core.netlist.Netlist`` on uint64 bit-planes through
    kernel K10 on ``device`` (default: the GPU) — the drop-in for
    ``netlist.eval_words``; ``device="cpu"`` runs the plain version."""
    dev = resolve_device(device)
    arrs = netlist_tensors((netlist.funcs, netlist.in0, netlist.in1,
                            netlist.outputs), netlist.n_i, dev)
    out = bitsim_planes(*arrs, words_to_device(split_planes64(planes64),
                                               dev))
    return join_planes32(words_to_host(out))


def bitsim_pop(netlists, planes64: np.ndarray,
               device: DeviceLike = None) -> np.ndarray:
    """Evaluate a population of same-interface netlists on shared uint64
    bit-planes in one launch of kernel K11 -> (P, n_o, W) uint64, row p
    equal to ``netlists[p].eval_words(planes64)``.  Mixed node counts
    are padded with inactive const0 nodes (``stack_netlists``)."""
    dev = resolve_device(device)
    netlists = list(netlists)
    arrs = netlist_tensors(stack_netlists(netlists), netlists[0].n_i, dev)
    out = bitsim_pop_planes(*arrs, words_to_device(
        split_planes64(planes64), dev))
    return join_planes32(words_to_host(out))


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches_during(fn):
    """``fn()`` and the kernel launches it made (nonzero counts only;
    none on the CPU, where the wrappers run their plain versions)."""
    before = launch_counts()
    out = fn()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}

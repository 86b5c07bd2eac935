"""Unsigned affine quantization for approximate-multiplier emulation.

The library's multipliers are *unsigned* W-bit, so both operands are
quantized asymmetrically to [0, 2^W - 1]:

    q = clip(round(x / s) + zp, 0, 2^W - 1),      x ≈ s * (q - zp)

and an exact product decomposes as

    (qa - za)(qw - zw) = qa*qw - za*qw - zw*qa + za*zw .

Only the qa*qw term flows through the (approximate) multiplier; the
correction terms are row/column sums computed exactly, outside the MAC
array, as in the reference (``repro.approx.quant``).

Bit parity with the reference: every reference main path runs under
``jax.jit``, where XLA rewrites the calibration's division by the
constant ``qmax`` into a multiply by its float32 reciprocal — at 8, 12
and 16 bits alike, and also for a width traced under ``vmap`` (the
reference then selects among constant-divisor scales, one per
``TRACED_WIDTHS`` entry, each rewritten the same way).  The port does
the same multiply, so scales, zero points and codes equal the jitted
reference bit for bit.

``bits`` is a Python int, or a per-lane width tensor ``(n,)`` with
values in ``TRACED_WIDTHS`` (a mixed-width bank).  Per-lane widths give
per-lane parameters of shape ``(n, 1, ..., 1)``: with ``lanes=True``
each lane of the tensor calibrates on its own, and an unbanked tensor
is calibrated once per lane width, as the reference's ``vmap`` over the
bank does.

``lanes=True`` marks a tensor whose leading axis is a bank lane axis
(the batched resilience engine, ``approx.layers.bank_eval``): min/max
then reduce over everything but that axis, so each lane calibrates
exactly as the reference's ``vmap`` lane does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

Bits = Union[int, torch.Tensor]

#: Widths a per-lane ``bits`` tensor may take (the bankable datapath
#: widths); a Python-int width is unrestricted.
TRACED_WIDTHS = (8, 12, 16)


class QuantParams(NamedTuple):
    scale: torch.Tensor       # f32, scalar or (n, 1, ..., 1) per lane
    zero_point: torch.Tensor  # int32 in [0, qmax], same shape as scale
    qmax: Union[float, torch.Tensor] = 255.0   # 2^bits - 1


def _recip(bits: int) -> float:
    """float32(1 / (2^bits - 1)): jitted XLA's reciprocal of qmax."""
    return float(np.float32(1.0 / ((1 << bits) - 1)))


def _select(bits: torch.Tensor, value) -> torch.Tensor:
    """Per-lane ``value(b)`` for each ``TRACED_WIDTHS`` entry, as an f32
    tensor of ``bits``' shape; other widths take the widest entry's
    value (the reference's ``jnp.select`` default)."""
    out = torch.full(bits.shape, value(TRACED_WIDTHS[-1]),
                     dtype=torch.float32, device=bits.device)
    for b in TRACED_WIDTHS[:-1]:
        out = torch.where(bits == b, value(b), out)
    return out


def qmax_for(bits: Bits) -> Union[float, torch.Tensor]:
    """``2^bits - 1`` (exact in float32 for every width <= 24): a float
    for an int width, an f32 tensor for per-lane widths."""
    if isinstance(bits, int):
        return float((1 << bits) - 1)
    return _select(bits, lambda b: float((1 << b) - 1))


def _lane_extremes(x: torch.Tensor, lanes: bool):
    if not lanes:
        return torch.amin(x), torch.amax(x)
    dims = tuple(range(1, x.ndim))
    return (torch.amin(x, dim=dims, keepdim=True),
            torch.amax(x, dim=dims, keepdim=True))


def calibrate(x: torch.Tensor, bits: Bits = 8, eps: float = 1e-8,
              lanes: bool = False) -> QuantParams:
    """Min/max affine calibration to the full unsigned ``bits`` range,
    per lane when ``lanes`` is set or ``bits`` is a per-lane tensor."""
    lo, hi = _lane_extremes(x, lanes)
    lo = torch.clamp_max(lo, 0.0).to(torch.float32)
    hi = torch.clamp_min(hi, 0.0).to(torch.float32)
    if isinstance(bits, int):
        qmax = qmax_for(bits)
        recip = _recip(bits)
    else:
        bits = torch.as_tensor(bits, device=x.device).reshape(-1)
        shape = (bits.numel(),) + (1,) * (x.ndim - 1 if lanes else x.ndim)
        qmax = qmax_for(bits).reshape(shape)
        recip = _select(bits, _recip).reshape(shape)
    scale = torch.clamp_min((hi - lo) * recip, eps)
    zp = clip_codes(torch.round(-lo / scale), qmax).to(torch.int32)
    return QuantParams(scale=scale, zero_point=zp, qmax=qmax)


def calibrate_slices(x: torch.Tensor, bits: Bits = 8) -> QuantParams:
    """``calibrate`` of each trailing ``(M, K)`` slice of ``x`` on its own
    (an MoE's experts, with or without a lane axis in front, as the
    reference's ``vmap`` over them calibrates each): scale and zero
    point of shape ``(..., 1, 1)``.  Per-lane widths ``bits`` (n,) (a
    mixed-width bank): ``x`` is ``(n, X, M, K)``, lane l's slices at
    width ``bits[l]``, or ``(X, M, K)`` shared (the stacked weights),
    each slice calibrated once a lane width; parameters and ``qmax``
    ``(n, X, 1, 1)`` and ``(n, 1, 1, 1)``."""
    if isinstance(bits, int):
        qp = calibrate(x.reshape(-1, *x.shape[-2:]), bits, lanes=True)
        lead = (*x.shape[:-2], 1, 1)
        return QuantParams(qp.scale.reshape(lead),
                           qp.zero_point.reshape(lead), qp.qmax)
    # calibrate's ops with the lane width broadcast over the slices
    lo, hi = _lane_extremes(x.reshape(-1, *x.shape[-2:]), True)
    lead = (*x.shape[:-2], 1, 1)
    lo = torch.clamp_max(lo, 0.0).to(torch.float32).reshape(lead)
    hi = torch.clamp_min(hi, 0.0).to(torch.float32).reshape(lead)
    bits = torch.as_tensor(bits, device=x.device).reshape(-1, 1, 1, 1)
    qmax = qmax_for(bits)
    scale = torch.clamp_min((hi - lo) * _select(bits, _recip), 1e-8)
    zp = clip_codes(torch.round(-lo / scale), qmax).to(torch.int32)
    return QuantParams(scale=scale, zero_point=zp, qmax=qmax)


def slice_params(t: torch.Tensor, slices: int) -> torch.Tensor:
    """Per-expert values ``t`` (..., E, a, b) for ``slices`` activation
    slices, E dividing them, slice s taking expert ``s % E``'s (several
    token blocks' buffers over the same experts, one after another)."""
    e = t.shape[-3]
    return t if e == slices else t.repeat(*(1,) * (t.ndim - 3),
                                          slices // e, 1, 1)


def pair_scalars(qp_a: QuantParams, qp_w: QuantParams, lanes: int,
                 slices: int) -> tuple:
    """``scalar_params`` of the expert form: ``(sa, za, sw, zw, qmax)``,
    one value a (lane, slice) pair, lane-major, from ``calibrate_slices``
    of the activations (``(lanes, slices, M, K)``, or ``(slices, M, K)``
    shared by the lanes) and of the stacked weights (E, K, N), slice s
    taking expert ``s % E``'s; per-lane widths give per-lane weight
    parameters and a ``qmax`` a pair too."""
    def per_pair(t):
        return t.expand(lanes, slices, 1, 1).reshape(-1)
    qmax = qp_a.qmax
    return (per_pair(qp_a.scale), per_pair(qp_a.zero_point),
            per_pair(slice_params(qp_w.scale, slices)),
            per_pair(slice_params(qp_w.zero_point, slices)),
            per_pair(qmax) if isinstance(qmax, torch.Tensor) else qmax)


def clip_codes(q: torch.Tensor, qmax) -> torch.Tensor:
    """``clip(q, 0, qmax)`` for a float or per-lane tensor ``qmax``."""
    q = torch.clamp_min(q, 0.0)
    if isinstance(qmax, torch.Tensor):
        return torch.minimum(q, qmax)
    return torch.clamp_max(q, qmax)


def scalar_params(qp_a: QuantParams, qp_w: QuantParams) -> tuple:
    """The flat ``(sa, za, sw, zw, qmax)`` tuple of an operand pair (the
    fused datapath's scalar interface; both operands share ``qmax``)."""
    return (qp_a.scale, qp_a.zero_point, qp_w.scale, qp_w.zero_point,
            qp_a.qmax)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / qp.scale) + qp.zero_point
    return clip_codes(q, qp.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return (q - qp.zero_point).to(torch.float32) * qp.scale


def fake_quant(x: torch.Tensor, qp: Optional[QuantParams] = None,
               bits: Bits = 8) -> torch.Tensor:
    """Quantize-dequantize round trip (for QAT-style experiments):
    ``calibrate`` (unless ``qp`` is given), ``quantize``,
    ``dequantize``."""
    qp = qp or calibrate(x, bits=bits)
    return dequantize(quantize(x, qp), qp)


def dequant_sums(s: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
                 za, zw, sa, sw, k: int) -> torch.Tensor:
    """The f32 zero-point correction and dequant of a non-exact
    datapath, the reference's ``backend._quantized_matmul`` (and the
    fused kernels' caller-side ``_dequant``/``_bank_dequant``):
    ``s`` the raw f32 sums (..., M, N); ``row`` (..., M, 1) and ``col``
    (..., 1, N) the int32 code sums; ``za, zw, sa, sw`` scalars or
    per-lane ``(n, 1, 1)``.

    ``trunc`` is an exact identity on these integer-valued products but
    pins each one to its own f32 rounding, as the reference does to keep
    its variants bit-identical; each is its own eager op here, so
    nothing contracts mul+sub into an FMA."""
    rowf = row.to(torch.float32)
    colf = col.to(torch.float32)
    zaf, zwf = za.to(torch.float32), zw.to(torch.float32)
    t_row = torch.trunc(zwf * rowf)
    t_col = torch.trunc(zaf * colf)
    t_k = torch.trunc(k * zaf * zwf)
    acc = s - t_row - t_col + t_k
    return acc * (sa * sw)

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
constant ``qmax`` into a multiply by its float32 reciprocal.  The port
does the same multiply, so scales, zero points and codes equal the
jitted reference bit for bit.  ``bits`` is a static Python int here;
per-lane traced widths arrive with the composed-width datapaths.

``lanes=True`` marks a tensor whose leading axis is a bank lane axis
(the batched resilience engine, ``approx.layers.bank_eval``): min/max
then reduce over everything but that axis, so each lane calibrates
exactly as the reference's ``vmap`` lane does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class QuantParams(NamedTuple):
    scale: torch.Tensor       # f32, scalar or (n, 1, ..., 1) per lane
    zero_point: torch.Tensor  # int32 in [0, qmax], same shape as scale
    qmax: float = 255.0       # 2^bits - 1


def qmax_for(bits: int) -> float:
    """``2^bits - 1`` (exact in float32 for every width <= 24)."""
    return float((1 << int(bits)) - 1)


def _lane_extremes(x: torch.Tensor, lanes: bool):
    if not lanes:
        return torch.amin(x), torch.amax(x)
    dims = tuple(range(1, x.ndim))
    return (torch.amin(x, dim=dims, keepdim=True),
            torch.amax(x, dim=dims, keepdim=True))


def calibrate(x: torch.Tensor, bits: int = 8, eps: float = 1e-8,
              lanes: bool = False) -> QuantParams:
    """Min/max affine calibration to the full unsigned ``bits`` range,
    per lane when ``lanes`` is set."""
    lo, hi = _lane_extremes(x, lanes)
    lo = torch.clamp_max(lo, 0.0).to(torch.float32)
    hi = torch.clamp_min(hi, 0.0).to(torch.float32)
    qmax = qmax_for(bits)
    recip = float(np.float32(1.0 / qmax))    # jitted XLA's reciprocal
    scale = torch.clamp_min((hi - lo) * recip, eps)
    zp = torch.clamp(torch.round(-lo / scale), 0.0, qmax).to(torch.int32)
    return QuantParams(scale=scale, zero_point=zp, qmax=qmax)


def scalar_params(qp_a: QuantParams, qp_w: QuantParams) -> tuple:
    """The flat ``(sa, za, sw, zw, qmax)`` tuple of an operand pair (the
    fused datapath's scalar interface; both operands share ``qmax``)."""
    return (qp_a.scale, qp_a.zero_point, qp_w.scale, qp_w.zero_point,
            qp_a.qmax)


def quantize(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    q = torch.round(x.to(torch.float32) / qp.scale) + qp.zero_point
    return torch.clamp(q, 0.0, qp.qmax).to(torch.int32)


def dequantize(q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    return (q - qp.zero_point).to(torch.float32) * qp.scale

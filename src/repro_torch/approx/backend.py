"""Matmul backends: the accelerator datapath being emulated (port of
``repro.approx.backend``).

Every projection matmul in every model flows through ``backend_matmul``.
Modes (each a registered datapath, see ``repro_torch.approx.registry``):

  * ``f32`` / ``bf16`` — exact float (the paper's pre-quantization net)
  * ``int8``           — exact uint8-quantized datapath (golden 8-bit)
  * ``lut``            — approximate multiplier, bit-true LUT emulation
                         at 8 bits or composed 12/16 bits (plain
                         PyTorch, or the CUDA kernels under the
                         ``pallas``/``fused`` variants)

Gradients: straight-through estimator (``torch.autograd.Function``) —
the backward pass is the exact f32 matmul.

Banked evaluation (the batched resilience engine, DESIGN.md §2.4): a
banked backend (``MaterializedBackend.lanes`` = n) returns one result
per bank lane, ``(n, ..., N)``.  ``lanes=True`` says that ``x``
already carries that lane axis in front; each lane is then calibrated
on its own, exactly as the reference's ``vmap`` lane is, for banked and
unbanked backends alike.
"""
from __future__ import annotations

from typing import Union

import torch

from .quant import calibrate, dequant_sums, quantize
from .specs import BackendSpec, MaterializedBackend, materialize

BackendLike = Union[None, BackendSpec, MaterializedBackend]


def as_backend(backend: BackendLike) -> MaterializedBackend:
    """Coerce any accepted backend handle to a MaterializedBackend."""
    if backend is None:
        return materialize(BackendSpec())
    if isinstance(backend, MaterializedBackend):
        return backend
    if isinstance(backend, BackendSpec):
        return materialize(backend)
    raise TypeError(f"not a backend: {type(backend).__name__}")


# ----------------------------------------------------------------------
# Quantized execution (operates on uint8 codes stored as int32)
# ----------------------------------------------------------------------
def _quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                      backend: MaterializedBackend,
                      lanes: bool = False) -> torch.Tensor:
    """x: (M, K), or (n, M, K) with ``lanes``; w: (K, N) ->
    (M, N), or (n, M, N) when ``x`` or the backend is banked."""
    dp = backend.datapath
    consts = backend.device_consts(x.device)
    if dp.fused:
        # single-kernel datapath: calibration, quantization, gather and
        # code sums live in its kernel — hand it the float operands
        return dp.forward_fused(x, w, consts, lanes)
    # operand width: 8, a composed entry's 12/16, or per-lane widths
    # (n,) in a mixed-width bank (then every lane quantizes at its own
    # width and the codes carry the lane axis)
    bits = consts.get("bits", 8)
    qp_a = calibrate(x, bits, lanes=lanes)
    qp_w = calibrate(w, bits)
    qa = quantize(x, qp_a)
    qw = quantize(w, qp_w)
    za, zw = qp_a.zero_point, qp_w.zero_point
    k = x.shape[-1]
    # int32 sums, or f32 already for composed datapaths (limbs
    # recombined)
    s = dp.forward_q(qa, qw, consts)
    row = torch.sum(qa, dim=-1, dtype=torch.int32)[..., None]   # (.., M, 1)
    col = torch.sum(qw, dim=-2, dtype=torch.int32)[..., None, :]  # (.., 1, N)
    if dp.exact_int32:
        # exact datapath: Σ (qa-za)(qw-zw) with int32 accumulation
        acc = (s - zw * row - za * col + k * za * zw).to(torch.float32)
        return acc * (qp_a.scale * qp_w.scale)
    return dequant_sums(s.to(torch.float32), row, col, za, zw,
                        qp_a.scale, qp_w.scale, k)


def _forward(x: torch.Tensor, w: torch.Tensor,
             backend: MaterializedBackend, lanes: bool) -> torch.Tensor:
    if backend.mode == "f32":
        return torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if backend.mode == "bf16":
        # bf16 operands, f32 accumulation (the reference's
        # preferred_element_type=f32): bf16 products are exact in f32
        return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                            w.to(torch.bfloat16).to(torch.float32))
    return _quantized_matmul(x.to(torch.float32), w.to(torch.float32),
                             backend, lanes)


class _SteMatmul(torch.autograd.Function):
    """Approximate forward, exact f32 matmul gradients."""

    @staticmethod
    def forward(ctx, x2d, w, backend):
        ctx.save_for_backward(x2d, w)
        return _forward(x2d, w, backend, False)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        g = g.to(torch.float32)
        dx = torch.matmul(g, w.to(torch.float32).T).to(x2d.dtype)
        dw = torch.matmul(x2d.to(torch.float32).T, g).to(w.dtype)
        return dx, dw, None


def backend_matmul(x: torch.Tensor, w: torch.Tensor,
                   backend: BackendLike = None,
                   lanes: bool = False) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N) f32 through the selected
    accelerator datapath.  ``lanes=True``: x's leading axis is a bank
    lane axis, kept in front of the result for every mode.  A banked
    backend turns an unbanked x into (n, ..., N).  Lane-carrying
    evaluation is forward-only (no STE)."""
    mb = as_backend(backend)
    k = x.shape[-1]
    n = w.shape[-1]
    if lanes:
        y = _forward(x.reshape(x.shape[0], -1, k), w, mb, lanes=True)
        return y.reshape(*x.shape[:-1], n)
    x2d = x.reshape(-1, k)
    if mb.spec.is_quantized and mb.ste:     # banked backends set ste=False
        y = _SteMatmul.apply(x2d, w, mb)
    else:
        y = _forward(x2d, w, mb, False)
    lead = x.shape[:-1] if mb.lanes is None else (mb.lanes, *x.shape[:-1])
    return y.reshape(*lead, n)

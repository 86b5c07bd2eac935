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
  * ``lowrank``        — approximate multiplier, rank-R factored LUT:
                         R 256-entry table gathers + an f32 contraction
                         (plain PyTorch, or kernel K9 under ``pallas``)

``w`` may also be a prepared-weight dict (``prepare_weight``): the
weight side of a ``lowrank`` datapath precomputed once per checkpoint.

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


# ----------------------------------------------------------------------
# Prepared weights (beyond-paper serving optimization, EXPERIMENTS §Perf)
# ----------------------------------------------------------------------
# The weight-side rank tables V_r(q_w) are static per checkpoint: a real
# deployment precomputes them offline.  ``prepare_weight`` replaces a
# projection weight with {tabs: (R,K,N) bf16, colsum, scales}, so each
# step does no weight requantization and no weight-side gather.
def prepare_weight(w, backend: BackendLike) -> dict:
    """The prepared form of one (K, N) projection weight under a
    ``lowrank`` backend: bf16 weight tables ``V_r(q_w)``, the code
    column sums and the weight's scale and zero point (f32)."""
    mb = as_backend(backend)
    w = torch.as_tensor(w).to(torch.float32)
    qp_w = calibrate(w)
    qw = quantize(w, qp_w)
    v = mb.device_consts(w.device)["v"]                   # (R,256)
    tabs = v[:, qw.long()].to(torch.bfloat16)             # (R,K,N)
    colsum = torch.sum(qw, dim=0, dtype=torch.int32).to(torch.float32)
    return {"tabs": tabs, "colsum": colsum, "w_scale": qp_w.scale,
            "w_zp": qp_w.zero_point.to(torch.float32)}


def is_prepared(w) -> bool:
    return isinstance(w, dict) and "tabs" in w


def _prepared_matmul(x2d: torch.Tensor, pw: dict,
                     backend: MaterializedBackend) -> torch.Tensor:
    qp_a = calibrate(x2d)
    qa = quantize(x2d, qp_a)
    u = backend.device_consts(x2d.device)["u"]            # (R,256)
    ua = u[:, qa.long()].to(torch.bfloat16)               # (R,M,K)
    # bf16 operands, f32 accumulation (the reference's
    # preferred_element_type=f32): bf16 products are exact in f32
    y_q = torch.matmul(ua.to(torch.float32),
                       pw["tabs"].to(torch.float32)).sum(dim=0)  # (M,N)
    k = x2d.shape[1]
    row = torch.sum(qa, dim=1, dtype=torch.int32).to(torch.float32)
    zaf = qp_a.zero_point.to(torch.float32)
    acc = (y_q - pw["w_zp"] * row[:, None] - zaf * pw["colsum"][None, :]
           + k * zaf * pw["w_zp"])
    return acc * (qp_a.scale * pw["w_scale"])


_PROJECTION_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "wi", "wg", "in_proj", "out_proj",
    "wuq", "wdq", "wqr", "wdkv", "wuk", "wuv", "wkr", "img_proj",
})


def _prepare_stacked(w: torch.Tensor, mb: MaterializedBackend) -> dict:
    """``prepare_weight`` over every leading (group, expert) index of a
    stacked weight, stacked back: each slice calibrates on its own, as
    the reference's ``vmap`` does."""
    if w.ndim == 2:
        return prepare_weight(w, mb)
    parts = [_prepare_stacked(w[i], mb) for i in range(w.shape[0])]
    return {key: torch.stack([p[key] for p in parts]) for key in parts[0]}


def prepare_tree(params, backend: BackendLike):
    """Pre-pack every projection weight in a nested param dict for
    lowrank serving (DESIGN.md §4.2, §Perf); stacked leading dims (layer
    groups, experts) are prepared slice by slice."""
    mb = as_backend(backend)

    def walk(node):
        if not isinstance(node, dict):
            return node
        return {k: (_prepare_stacked(v, mb)
                    if k in _PROJECTION_LEAVES
                    and isinstance(v, torch.Tensor) and v.ndim >= 2
                    else walk(v))
                for k, v in node.items()}

    return walk(params)


def backend_matmul(x: torch.Tensor, w,
                   backend: BackendLike = None,
                   lanes: bool = False) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N) f32 through the selected
    accelerator datapath.  ``lanes=True``: x's leading axis is a bank
    lane axis, kept in front of the result for every mode.  A banked
    backend turns an unbanked x into (n, ..., N).  Lane-carrying
    evaluation is forward-only (no STE).  ``w`` may be a
    prepared-weight dict (``prepare_weight``)."""
    mb = as_backend(backend)
    k = x.shape[-1]
    if is_prepared(w):
        y = _prepared_matmul(x.reshape(-1, k).to(torch.float32), w, mb)
        return y.reshape(*x.shape[:-1], y.shape[-1])
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

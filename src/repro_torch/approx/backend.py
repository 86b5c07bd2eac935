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

The preferred handle is a ``BackendSpec`` (or the ``MaterializedBackend``
it caches to); the legacy array-carrying ``MatmulBackend`` remains as a
deprecation shim, as in the reference, and is converted on entry.

Gradients: straight-through estimator (``torch.autograd.Function``) —
the backward pass is the exact f32 matmul.

Banked evaluation (the batched resilience engine, DESIGN.md §2.4): a
banked backend (``MaterializedBackend.lanes`` = n) returns one result
per bank lane, ``(n, ..., N)``.  ``lanes=True`` says that ``x``
already carries that lane axis in front; each lane is then calibrated
on its own, exactly as the reference's ``vmap`` lane is, for banked and
unbanked backends alike.

Stacked expert weights (an MoE projection, ``experts=True``): ``w`` is
``(E, K, N)`` (or ``prepare_tree``'s stacked prepared dict) and ``x``
``(X, C, K)`` (``(n, X, C, K)`` with lanes), slice ``s`` against
``w[s % E]``, each (lane, slice) pair calibrated on its own (at its
lane's width) as the reference's ``vmap`` over experts does.  Every mode
runs them in one call: the float modes and prepared weights as one
batched product, a quantized datapath through its expert form
(``forward_q_experts`` / ``forward_fused_experts``: one kernel launch
under ``pallas``/``fused``, as the reference's batched ``pallas_call``);
an STE backend under autograd runs one call a slice.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from .. import obs
from ..launch.mesh import reduce_partial, sharded_reshape
from .quant import (calibrate, calibrate_slices, dequant_sums, quantize,
                    slice_params)
from .registry import experts_product, experts_view
from .specs import BackendSpec, MaterializedBackend, materialize

# ----------------------------------------------------------------------
# Legacy shim (pre-spec API): id-hashed dataclass carrying raw arrays.
# Prefer BackendSpec everywhere new; this stays so reference-style call
# sites run unchanged.
# ----------------------------------------------------------------------
@dataclass(frozen=True, eq=False)  # eq=False: id-hash (ndarray fields)
class MatmulBackend:
    mode: str = "bf16"                       # f32|bf16|int8|lut|lowrank
    multiplier: str = "mul8u_exact"          # library entry name
    lut: Optional[np.ndarray] = None         # (256,256) int32 product LUT
    factors_u: Optional[np.ndarray] = None   # (R,256) f32
    factors_v: Optional[np.ndarray] = None   # (R,256) f32
    rank: int = 0
    block_m: int = 512                       # LUT-emulation row blocking
    ste: bool = True                         # straight-through gradients
    use_pallas: bool = False                 # route through the kernels

    @staticmethod
    def exact(mode: str = "bf16") -> "MatmulBackend":
        return MatmulBackend(mode=mode)

    @staticmethod
    def from_library(name: str, mode: str = "lut",
                     rank: Optional[int] = None, library=None,
                     use_pallas: bool = False) -> "MatmulBackend":
        """Deprecated: use ``BackendSpec.from_library(...).materialize()``.
        Builds a legacy backend emulating library multiplier ``name``."""
        warnings.warn(
            "MatmulBackend.from_library is deprecated; use "
            "BackendSpec.from_library(name, ...).materialize(library)",
            DeprecationWarning, stacklevel=2)
        from ..core.library import get_default_library
        from .registry import pack_lowrank, pack_lut
        lib = library if library is not None else get_default_library()
        spec = BackendSpec(mode=mode, multiplier=name, rank=rank,
                           variant="pallas" if use_pallas else "ref")
        lut = pack_lut(spec, lib)["lut"]
        lr = pack_lowrank(spec, lib)     # shares the auto-rank heuristic
        return MatmulBackend(
            mode=mode, multiplier=name, lut=lut,
            factors_u=lr["u"], factors_v=lr["v"],
            rank=int(lr["u"].shape[0]), use_pallas=use_pallas)

    def to_spec(self) -> BackendSpec:
        """Best-effort serializable spec: faithful whenever the arrays
        came from a library; the one legacy-field -> spec mapping."""
        return BackendSpec(
            mode=self.mode, multiplier=self.multiplier,
            rank=(int(self.rank) or None), block_m=self.block_m,
            ste=self.ste,
            variant="pallas" if self.use_pallas else "ref")


BackendLike = Union[None, BackendSpec, MaterializedBackend, MatmulBackend]


def as_backend(backend: BackendLike) -> MaterializedBackend:
    """Coerce any accepted backend handle to a MaterializedBackend."""
    if backend is None:
        return materialize(BackendSpec())
    if isinstance(backend, MaterializedBackend):
        return backend
    if isinstance(backend, BackendSpec):
        return materialize(backend)
    if isinstance(backend, MatmulBackend):
        return _from_legacy(backend)
    raise TypeError(f"not a backend: {type(backend).__name__}")


def _from_legacy(be: MatmulBackend) -> MaterializedBackend:
    from .registry import get_datapath
    spec = be.to_spec()
    if not spec.is_quantized:
        return materialize(spec)
    dp = get_datapath(spec.datapath_name)
    if not dp.needs_library:                 # int8: no consts to carry
        return materialize(spec)
    # Raw arrays were attached by hand — wrap them uncached (id-hash
    # semantics identical to the legacy class).
    if be.mode.startswith("lut"):
        if be.lut is None:
            raise ValueError("legacy lut backend without a LUT")
        lut = np.asarray(be.lut, np.int32)
        consts = {"lut": lut, "block_m": int(be.block_m)}
        if spec.variant != "ref":            # the kernels' uint16 table
            from ..kernels.approx_matmul import lut_to_uint16
            consts["lut16"] = lut_to_uint16(torch.from_numpy(lut))
    elif be.mode.startswith("lowrank"):
        if be.factors_u is None or be.factors_v is None:
            raise ValueError("legacy lowrank backend without factors")
        consts = {"u": np.asarray(be.factors_u, np.float32),
                  "v": np.asarray(be.factors_v, np.float32)}
    else:
        raise ValueError(f"legacy backend mode {be.mode!r} needs a spec")
    return MaterializedBackend(spec=spec, datapath=dp, consts=consts)


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
    with obs.span("datapath.calibrate"):
        qp_a = calibrate(x, bits, lanes=lanes)
        qp_w = calibrate(w, bits)
        qa = quantize(x, qp_a)
        qw = quantize(w, qp_w)
    za, zw = qp_a.zero_point, qp_w.zero_point
    k = x.shape[-1]
    # int32 sums, or f32 already for composed datapaths (limbs
    # recombined)
    s = reduce_partial(dp.forward_q(qa, qw, consts))
    row = reduce_partial(                                       # (.., M, 1)
        torch.sum(qa, dim=-1, dtype=torch.int32)[..., None])
    col = reduce_partial(                                       # (.., 1, N)
        torch.sum(qw, dim=-2, dtype=torch.int32)[..., None, :])
    with obs.span("datapath.epilogue"):
        if dp.exact_int32:
            # exact datapath: Σ (qa-za)(qw-zw) with int32 accumulation
            acc = (s - zw * row - za * col + k * za * zw).to(torch.float32)
            return acc * (qp_a.scale * qp_w.scale)
        return dequant_sums(s.to(torch.float32), row, col, za, zw,
                            qp_a.scale, qp_w.scale, k)


def _quantized_experts(x: torch.Tensor, w: torch.Tensor,
                       backend: MaterializedBackend) -> torch.Tensor:
    """x (X,C,K), or (n,X,C,K) with a lane axis; w (E,K,N), E dividing X
    -> (X,C,N), or (n,X,C,N) when ``x`` or the backend is banked, through
    the datapath's expert form: one call for every (lane, slice) pair,
    each calibrated and quantized on its own at its lane's width
    (zero-padded capacity rows and a starved expert's all-zero buffer
    included), its sums and dequant per pair with the
    ``_quantized_matmul`` formula (the int32 one for an exact
    datapath)."""
    dp = backend.datapath
    consts = backend.device_consts(x.device)
    if dp.fused:
        return dp.forward_fused_experts(x, w, consts)
    bits = consts.get("bits", 8)
    with obs.span("datapath.calibrate"):
        qp_a, qp_w = calibrate_slices(x, bits), calibrate_slices(w, bits)
        qa, qw = quantize(x, qp_a), quantize(w, qp_w)
    s = dp.forward_q_experts(qa, qw, consts)
    slices, k = x.shape[-3], x.shape[-1]
    row = torch.sum(qa, dim=-1, dtype=torch.int32)[..., None]
    col = slice_params(torch.sum(qw, dim=-2, dtype=torch.int32)[..., None, :],
                       slices)
    za, zw = qp_a.zero_point, slice_params(qp_w.zero_point, slices)
    sa, sw = qp_a.scale, slice_params(qp_w.scale, slices)
    with obs.span("datapath.epilogue"):
        if dp.exact_int32:
            acc = (s - zw * row - za * col + k * za * zw).to(torch.float32)
            return acc * (sa * sw)
        return dequant_sums(s.to(torch.float32), row, col, za, zw, sa, sw,
                            k)


def _float_experts(x: torch.Tensor, w: torch.Tensor,
                   backend: MaterializedBackend) -> torch.Tensor:
    """The ``f32`` / ``bf16`` expert form: one batched matmul of x
    (..., X, C, K) against w (E, K, N), differentiable as it stands."""
    return experts_product(x, w, lambda a, w_: _forward(a, w_, backend,
                                                        False))


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


def _prepared_experts(x: torch.Tensor, pw: dict,
                      backend: MaterializedBackend) -> torch.Tensor:
    """``_prepared_matmul`` of each slice of x (..., X, C, K) against
    expert ``s % E`` of a stacked prepared weight (``prepare_tree`` of an
    (E, K, N) stack: tabs (E, R, K, N), colsum (E, N), w_scale and w_zp
    (E,)), each slice calibrated and quantized on its own, as the
    reference's ``vmap`` over experts runs it: one batched product."""
    tabs = pw["tabs"]                                     # (E,R,K,N)
    e = tabs.shape[0]
    qp_a = calibrate_slices(x)
    qa = quantize(x, qp_a)
    u = backend.device_consts(x.device)["u"]              # (R,256)
    ua = u[:, experts_view(qa, e).long()].to(torch.bfloat16)
    ua = ua.movedim(0, -3)                                # (B,E,R,C,K)
    # bf16 operands, f32 accumulation, as in _prepared_matmul; the f32
    # copy of the tables is made for about 2^27 entries at a time
    step = max(1, (1 << 27) // max(1, tabs[0].numel()))
    y_q = torch.cat([
        torch.matmul(ua[:, i:i + step].to(torch.float32),
                     tabs[i:i + step].to(torch.float32)).sum(dim=2)
        for i in range(0, e, step)], dim=1)
    y_q = sharded_reshape(y_q, (*x.shape[:-1], y_q.shape[-1]))
    slices, k = x.shape[-3], x.shape[-1]

    def per_slice(t):                     # (E,) or (E, N) -> (X, 1, 1 or N)
        return slice_params(t.reshape(e, 1, -1), slices)
    row = torch.sum(qa, dim=-1, dtype=torch.int32).to(torch.float32)
    zaf = qp_a.zero_point.to(torch.float32)               # (..., X, 1, 1)
    w_zp = per_slice(pw["w_zp"])
    acc = (y_q - w_zp * row[..., None] - zaf * per_slice(pw["colsum"])
           + k * zaf * w_zp)
    return acc * (qp_a.scale * per_slice(pw["w_scale"]))


def _prepared_matmul(x2d: torch.Tensor, pw: dict,
                     backend: MaterializedBackend) -> torch.Tensor:
    qp_a = calibrate(x2d)
    qa = quantize(x2d, qp_a)
    u = backend.device_consts(x2d.device)["u"]            # (R,256)
    ua = u[:, qa.long()].to(torch.bfloat16)               # (R,M,K)
    # bf16 operands, f32 accumulation (the reference's
    # preferred_element_type=f32): bf16 products are exact in f32
    y_q = reduce_partial(torch.matmul(
        ua.to(torch.float32), pw["tabs"].to(torch.float32)).sum(dim=0))
    k = x2d.shape[1]
    row = reduce_partial(torch.sum(qa, dim=1, dtype=torch.int32)
                         ).to(torch.float32)
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
    if w.device.type == "meta":      # shapes only: one slice, stacked
        one = _prepare_stacked(w[(0,) * (w.ndim - 2)], mb)
        return {key: t.expand(*w.shape[:-2], *t.shape).contiguous()
                for key, t in one.items()}
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


def _expert_matmul(x: torch.Tensor, w, mb: MaterializedBackend,
                   lanes: bool) -> torch.Tensor:
    """``backend_matmul(experts=True)``: the float modes' batched matmul,
    prepared weights' batched product, or the datapath's expert form
    where no gradient is asked for; else (an STE backend under autograd)
    one call a slice."""
    if is_prepared(w):
        return _prepared_experts(x.to(torch.float32), w, mb)
    if not mb.spec.is_quantized:
        return _float_experts(x, w, mb)
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return _quantized_experts(x.to(torch.float32), w.to(torch.float32),
                                  mb)
    e = w.shape[0]
    return torch.stack([
        backend_matmul(x[:, j].contiguous() if lanes else x[j], w[j % e],
                       mb, lanes=lanes)
        for j in range(x.shape[-3])], dim=-3)


def backend_matmul(x: torch.Tensor, w,
                   backend: BackendLike = None,
                   lanes: bool = False,
                   experts: bool = False) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) -> (..., N) f32 through the selected
    accelerator datapath.  ``lanes=True``: x's leading axis is a bank
    lane axis, kept in front of the result for every mode.  A banked
    backend turns an unbanked x into (n, ..., N).  Lane-carrying
    evaluation is forward-only (no STE).  ``w`` may be a
    prepared-weight dict (``prepare_weight``).  ``experts=True``: w is
    the (E, K, N) stack of an MoE projection's expert weights and x (X,
    C, K) (``(n, X, C, K)`` with lanes), E dividing X, slice s against
    ``w[s % E]`` -> (X, C, N) (with a lane axis in front as above)."""
    mb = as_backend(backend)
    if experts:
        return _expert_matmul(x, w, mb, lanes)
    k = x.shape[-1]
    if is_prepared(w):
        y = _prepared_matmul(x.reshape(-1, k).to(torch.float32), w, mb)
        return sharded_reshape(y, (*x.shape[:-1], y.shape[-1]))
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
    return sharded_reshape(y, (*lead, n))



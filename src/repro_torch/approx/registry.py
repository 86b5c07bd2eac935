"""Pluggable datapath registry (port of ``repro.approx.registry``).

A *datapath* is the arithmetic core of the accelerator being emulated:
given unsigned operand codes it returns the raw accumulated products
``Σ_k mul(qa[m,k], qw[k,n])``.  Zero-point correction, scaling and the
straight-through gradient live in ``repro_torch.approx.backend`` and are
shared by every datapath.

Built-in datapaths registered here:

  * ``int8`` — exact uint8 datapath (the paper's golden reference),
               int32-exact correction arithmetic
  * ``lut``  — bit-true LUT emulation in plain PyTorch (the reference's
               ``jnp.take`` path), width-generic: 8-bit entries gather
               their own 256x256 LUT, composed 12/16-bit entries
               (DESIGN.md §2.6) gather four digit products from their
               tile LUT, reduce them by the recipe's shift/add tree and
               accumulate two exact int32 limbs
  * ``lowrank`` — rank-R factored LUT (DESIGN.md §4.2): R 256-entry
               table gathers per operand and an f32 contraction

The hand-written CUDA variants — ``lut_pallas``, ``lut_fused`` and
``lowrank_pallas``, named after the reference's Pallas datapaths they
replace — are registered by ``repro_torch.kernels.datapaths`` and
resolved lazily on first lookup.

``forward_q`` takes codes as int32 tensors: ``qa`` is ``(M, K)`` or,
inside a banked evaluation, ``(n, M, K)`` with one lane per bank entry;
``consts`` holds the backend's constants as tensors on the codes'
device (``MaterializedBackend.device_consts``).  A banked backend
carries ``luts`` (n, 256, 256) instead of ``lut`` and returns
``(n, M, N)``; a wide bank also carries per-lane ``bits``, ``masks``
and ``reduce_codes``, and its weight codes ``qw`` are per lane
``(n, K, N)`` (each lane quantizes at its own width).

uint32 arithmetic of the composed shift/add tree runs in int64 masked
to 32 bits (``torch.uint32`` supports few ops); shifts of 32 or more
give 0, as XLA's do.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.families import parse_reduce
from ..core.luts import decompose_lut, rank_for_tolerance
from ..launch.mesh import sharded_reshape

MAX_LUT_K = 33030  # int32-safe accumulation bound: 2^31 / 255^2
# Composed wide products accumulate as two 16-bit limbs (DESIGN.md
# §2.6): each limb is < 2^16, so int32 limb sums stay exact for up to
# 2^31 / (2^16 - 1) contraction terms.
MAX_COMPOSED_K = (1 << 31) // ((1 << 16) - 1)  # = 32768

class Datapath:
    """Base class for registered datapaths.

    ``pack(spec, library)`` runs once per (spec, library) on the host and
    returns the numpy constant dict ``forward_q`` consumes (as tensors);
    the result is cached by ``repro_torch.approx.specs.materialize``.
    ``exact_int32`` datapaths return int32 sums whose zero-point
    correction stays in int32; the rest are corrected in float32.
    ``bankable`` datapaths accept a banked ``luts`` constant and run a
    whole LUT bank in one call (the batched resilience engine).
    ``fused`` datapaths take the FLOAT operands through
    ``forward_fused(x, w, consts, lanes)`` and calibrate, quantize,
    gather and dequant themselves; ``forward_q`` is never called."""

    name: str = "?"
    exact_int32: bool = False
    needs_library: bool = True
    fused: bool = False
    spec_fields: tuple = ("multiplier", "rank", "block_m")
    bankable: bool = False

    def pack(self, spec, library) -> dict:
        return {}

    def bank_consts(self, bank) -> dict:
        """Numpy constants of a banked backend over ``bank`` (a
        ``LutBank``); only ``bankable`` datapaths are asked.  A bank with
        composed wide lanes adds the per-lane operand widths, 2W-bit
        product masks (0 = narrow lane), ``encode_reduce`` codes and the
        bank's static reduction tree (the reference's
        ``_bank_lane_backend``)."""
        consts = {"luts": bank.luts, "block_m": bank.block_m}
        if bank.any_wide:
            consts.update(composed=True, bits=bank.lane_bits,
                          masks=bank.lane_masks.astype(np.int64),
                          reduce=parse_reduce(bank.reduce),
                          reduce_codes=bank.lane_reduce_codes)
        return consts

    def forward_q(self, qa: torch.Tensor, qw: torch.Tensor, consts: dict
                  ) -> torch.Tensor:
        raise NotImplementedError

    def forward_q_experts(self, qa: torch.Tensor, qw: torch.Tensor,
                          consts: dict) -> torch.Tensor:
        """Stacked expert weights in one call, as the reference's ``vmap``
        over experts runs them: qa (..., X, C, K) codes, qw (..., E, K,
        N) (per lane in a mixed-width bank), E dividing X -> (..., X, C,
        N).  This default runs ``forward_q`` of each slice against expert
        ``s % E``; a datapath with a batched product overrides it (a
        fused one implements ``forward_fused_experts`` instead)."""
        e = qw.shape[-3]
        return torch.stack([
            self.forward_q(qa[..., s, :, :], qw[..., s % e, :, :], consts)
            for s in range(qa.shape[-3])], dim=-3)


def experts_view(x: torch.Tensor, e: int) -> torch.Tensor:
    """x (..., X, C, K) as (B, E, C, K): every leading index and slice in
    one run of blocks over the same E experts (E dividing X), so a
    product with (E, K, N) weights broadcasts over the blocks, slice s
    of each against expert s % E."""
    return sharded_reshape(x, (-1, e, *x.shape[-2:]))


def experts_product(qa: torch.Tensor, qw: torch.Tensor, fn) -> torch.Tensor:
    """``fn(a, qw)`` of ``experts_view(qa, E)`` against stacked weights
    qw (E, K, N), back in qa's lead: (..., X, C, N)."""
    y = fn(experts_view(qa, qw.shape[0]), qw)
    return sharded_reshape(y, (*qa.shape[:-1], qw.shape[-1]))


_REGISTRY: dict[str, Datapath] = {}


def register_datapath(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register under ``name``."""
    def deco(cls: type) -> type:
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def get_datapath(name: str) -> Datapath:
    if name not in _REGISTRY and name.endswith(("_pallas", "_fused")):
        # the CUDA-kernel variants live in the kernel layer
        import repro_torch.kernels.datapaths  # noqa: F401  (registers)
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown datapath {name!r}; available: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_datapaths() -> list[str]:
    return sorted(_REGISTRY)


def _resolve_rank(spec, library, lut: np.ndarray) -> int:
    """spec.rank, or the smallest R whose decomposition error is
    negligible next to the circuit's own error (floor 0.25 LSB^2)."""
    if spec.rank:
        return int(spec.rank)
    mult_mae = max(library.entry(spec.multiplier).errors.mae, 0.0)
    tol = max(0.25, 0.1 * mult_mae)
    return int(rank_for_tolerance(lut, tol, max_rank=16))


def _validate_reduce(spec, comp) -> tuple:
    """The parsed reduction of the entry's composition recipe, checked
    against the spec's ``reduce_adder`` declaration when present."""
    reduce = parse_reduce(comp["reduce"])
    declared = getattr(spec, "reduce_adder", None)
    if declared is not None and parse_reduce(declared) != reduce:
        raise ValueError(
            f"spec declares reduce_adder={declared!r} but composed "
            f"entry {spec.multiplier!r} reduces with "
            f"{comp['reduce']!r}")
    return reduce


def pack_lut(spec, library) -> dict:
    """Numpy constants of the (width-generic) LUT datapaths.

    8-bit entries pack their own 256x256 LUT.  Composed wide entries
    pack the composition TILE's 256x256 LUT plus the composition
    descriptor — operand width (``bits``), the ``composed`` dispatch
    flag, the 2W-bit product ``mask`` and the parsed ``reduce`` tree
    (DESIGN.md §2.6)."""
    entry = library.entry(spec.multiplier,
                          bit_width=getattr(spec, "bit_width", None))
    comp = library.composition_of(spec.multiplier)
    lut = np.asarray(library.tile_lut(spec.multiplier), dtype=np.int32)
    consts = {"lut": lut, "block_m": int(spec.block_m)}
    if comp is not None:
        consts.update(composed=True, bits=int(entry.width),
                      mask=int(lane_mask_np(entry.width)),
                      reduce=_validate_reduce(spec, comp))
    elif getattr(spec, "reduce_adder", None) is not None:
        raise ValueError(
            f"reduce_adder={spec.reduce_adder!r} is only meaningful "
            f"for composed wide entries; {spec.multiplier!r} is "
            f"{entry.width}-bit and materializes directly")
    return consts


def pack_lowrank(spec, library) -> dict:
    """Numpy constants of the low-rank datapaths: the rank-R SVD
    factors ``u``, ``v`` (R, 256) f32 of the multiplier's LUT."""
    lut = np.asarray(library.lut(spec.multiplier), dtype=np.int32)
    fac = decompose_lut(lut, _resolve_rank(spec, library, lut))
    return {"u": np.asarray(fac.u), "v": np.asarray(fac.v)}


# ----------------------------------------------------------------------
# Composed wide products: tiled 8x8 partial products + shift/add tree
# (DESIGN.md §2.6).  uint32 values live in int64 tensors, masked to 32
# bits after every operation that could leave them.
# ----------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _shl(a: torch.Tensor, s) -> torch.Tensor:
    """uint32 ``a << s`` for a shift ``s >= 0`` (int or int64 tensor):
    0 from 32 on."""
    if isinstance(s, int):
        return (a << s) & _M32 if s < 32 else torch.zeros_like(a)
    return torch.where(s < 32, (a << torch.clamp_max(s, 31)) & _M32, 0)


def _shr(a: torch.Tensor, s) -> torch.Tensor:
    """uint32 ``a >> s`` for a shift ``s >= 0`` (int or int64 tensor):
    0 from 32 on."""
    if isinstance(s, int):
        return a >> s if s < 32 else torch.zeros_like(a)
    return torch.where(s < 32, a >> torch.clamp_max(s, 31), 0)


def reduce_apply(a: torch.Tensor, b: torch.Tensor,
                 reduce: tuple) -> torch.Tensor:
    """One reduction-tree adder on uint32 values (int64 tensors in
    [0, 2^32)) — the vectorized semantics of the library's adder
    families, bit-identical to the gate-level generators in
    ``repro_torch.core.families``.  (An int64 holds every intermediate
    here, so only results are masked to 32 bits.)"""
    kind, k = reduce
    if kind == "exact":
        return (a + b) & _M32
    if kind == "trunc":
        return (((a >> k) + (b >> k)) << k) & _M32
    if kind == "loa":
        carry = (a >> (k - 1)) & (b >> (k - 1)) & 1
        return (((a | b) & ((1 << k) - 1))
                | ((((a >> k) + (b >> k) + carry) << k) & _M32))
    raise ValueError(f"unknown reduction kind {kind!r}")


def composed_reduce(pp00, pp01, pp10, pp11, reduce: tuple) -> torch.Tensor:
    """uint32 shift/add tree over the four digit products:
    ``p = ADD(ADD(pp00, ADD(pp01, pp10) << 8), pp11 << 16)`` — the tree
    ``core.families.composed_multiplier`` builds in gates.  Callers
    apply ``product_mask(bits)`` to keep the netlist's 2W output bits."""
    s1 = reduce_apply(pp01, pp10, reduce)
    s2 = reduce_apply(pp00, (s1 << 8) & _M32, reduce)
    return reduce_apply(s2, (pp11 << 16) & _M32, reduce)


#: Order fixing the integer encoding of reduction kinds for the fused
#: kernels (``encode_reduce``); index == wire value.
REDUCE_KINDS = ("exact", "trunc", "loa")


def encode_reduce(reduce: tuple) -> tuple[int, int]:
    """A parsed ``(kind, k)`` reduction as two small ints — the runtime
    encoding the fused composed kernels consume, so one kernel serves
    every adder family and mixed-reduce banks."""
    kind, k = reduce
    if kind not in REDUCE_KINDS:
        raise ValueError(f"unknown reduction kind {kind!r}")
    return (REDUCE_KINDS.index(kind), int(k))


def reduce_apply_dyn(a: torch.Tensor, b: torch.Tensor, kind,
                     k) -> torch.Tensor:
    """``reduce_apply`` with the reduction selected by runtime integers
    ``(kind, k)`` (see ``encode_reduce``): tensors broadcastable against
    ``a``, or host ints.  Tensor codes compute all three adder families
    and select; a host code computes its own family only (the same
    values).  ``k`` is read as uint32 and ``loa`` uses ``max(k, 1)`` for
    its low part, as the reference does."""
    if isinstance(k, int):
        k &= _M32
        km = max(k, 1)
        low = ((1 << km) - 1) & _M32 if km < 32 else _M32
    else:
        k = torch.as_tensor(k, device=a.device).to(torch.int64) & _M32
        km = torch.clamp_min(k, 1)
        low = (_shl(torch.ones_like(km), km) - 1) & _M32

    def exact():
        return (a + b) & _M32

    def half_sum():
        return (_shr(a, k) + _shr(b, k)) & _M32

    def trunc():
        return _shl(half_sum(), k)

    def loa():
        carry = _shr(a, km - 1) & _shr(b, km - 1) & 1
        return ((a | b) & low) | _shl((half_sum() + carry) & _M32, k)

    if isinstance(kind, int):
        return exact() if kind == 0 else trunc() if kind == 1 else loa()
    kind = torch.as_tensor(kind, device=a.device)
    return torch.where(kind == 0, exact(),
                       torch.where(kind == 1, trunc(), loa()))


def composed_reduce_dyn(pp00, pp01, pp10, pp11, kind, k) -> torch.Tensor:
    """``composed_reduce`` with a runtime-selected adder family — the
    same shift/add tree, every node through ``reduce_apply_dyn``."""
    s1 = reduce_apply_dyn(pp01, pp10, kind, k)
    s2 = reduce_apply_dyn(pp00, (s1 << 8) & _M32, kind, k)
    return reduce_apply_dyn(s2, (pp11 << 16) & _M32, kind, k)


def product_mask(bits):
    """Mask keeping the composed netlist's 2W output bits (``0xFFFFFF``
    at W=12, ``0xFFFFFFFF`` at W=16): a Python int for an int width,
    an int64 tensor for a width tensor (a right shift of all-ones, so
    no shift reaches the full register width)."""
    if isinstance(bits, int):
        return (1 << (2 * bits)) - 1 if bits < 16 else _M32
    shift = (32 - 2 * torch.as_tensor(bits).to(torch.int64)) & _M32
    return _shr(torch.full_like(shift, _M32), shift)


def lane_mask_np(bits) -> np.ndarray:
    """Host-side per-lane selector-and-mask of the banked composed
    engines: 0 for narrow (8-bit) lanes — "take the plain tile sum" —
    and the 2W-bit ``product_mask`` for wide lanes."""
    bits = np.asarray(bits, np.int64)
    masks = np.where(bits >= 16, 0xFFFFFFFF, (1 << (2 * bits)) - 1)
    return np.where(bits > 8, masks, 0).astype(np.uint32)


def digit_products(qa, qw, flat_lut):
    """The four (rows, K, N) tile-LUT digit products of W-bit codes
    (``q & 255`` and ``q >> 8``), as int64."""
    a0, a1 = qa & 255, qa >> 8
    w0, w1 = qw & 255, qw >> 8

    def pp(x, y):
        idx = x[:, :, None].long() * 256 + y[None, :, :].long()
        return flat_lut[idx].to(torch.int64)

    return pp(a0, w0), pp(a0, w1), pp(a1, w0), pp(a1, w1)


def _as_i32(v: int) -> int:
    """The int32 with the bits of the uint32 ``v``."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _loa_(a: torch.Tensor, b: torch.Tensor, cbit: int) -> torch.Tensor:
    """``reduce_apply(a, b, ("loa", k))`` on int32 bit patterns, in place
    in ``a``, for 1 <= k <= 31 (``cbit = 1 << (k - 1)``): with ``t = a &
    b``, the LOA sum is ``a + b + (t & cbit) - (t & (cbit - 1))`` mod
    2^32 (the low part's OR is ``a + b`` less the low AND; the carry
    into bit k is bit k-1 of ``t``), so no right shift is needed."""
    t = a & b
    a += b
    a += t & cbit
    return a.sub_(t.bitwise_and_(cbit - 1))


def _limbs_block(qa_blk: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                 flat_lut: torch.Tensor, mask: int, kind: int,
                 k: int) -> tuple:
    """``composed_limbs`` for one row block on int32 bit patterns (int32
    adds and left shifts wrap modulo 2^32 as uint32's do): four
    ``index_select`` gathers, the tree of the host code ``(kind, k)``
    with its constants folded, the mask, the two limb sums."""
    shape = (qa_blk.shape[0], *w0.shape)
    a0 = ((qa_blk & 255) << 8)[:, :, None]
    a1 = ((qa_blk >> 8) << 8)[:, :, None]
    p00, p01, p10, p11 = (
        flat_lut.index_select(0, (a + w).view(-1)).view(shape)
        for a, w in ((a0, w0), (a0, w1), (a1, w0), (a1, w1)))
    if kind in (0, 1):
        # trunc: ((a >> k) + (b >> k)) << k == (a & h) + (b & h) with h
        # the bits from k up (0 from k = 32 on); exact is h = all ones.
        # Node sums of masked terms keep their low k bits clear, so the
        # inner nodes need no second mask
        h = -1 if kind == 0 else _as_i32(_M32 << k) if k < 32 else 0
        if h != -1:
            p00 &= h
            p01 &= h
            p10 &= h
        s = p01.add_(p10).bitwise_left_shift_(8).add_(p00)
        p11.bitwise_left_shift_(16)
        if h != -1:
            p11 &= h
        s += p11
    else:
        # loa, 1 <= k <= 31; a node whose second operand has its low k
        # bits clear (s1 << 8 for k <= 8, pp11 << 16 for k <= 16) adds
        cbit = 1 << (k - 1)
        s = _loa_(p01, p10, cbit).bitwise_left_shift_(8)
        s = s.add_(p00) if k <= 8 else _loa_(p00, s, cbit)
        p11.bitwise_left_shift_(16)
        s = s.add_(p11) if k <= 16 else _loa_(s, p11, cbit)
    if _as_i32(mask) != -1:
        s &= _as_i32(mask)
    lo = torch.sum(s & 0xFFFF, dim=1, dtype=torch.int32)
    s.bitwise_right_shift_(16).bitwise_and_(0xFFFF)
    return lo, torch.sum(s, dim=1, dtype=torch.int32)


def _limbs_block_dyn(qa_blk, qw, flat_lut, mask: int, kind: int,
                     k: int) -> tuple:
    """``composed_limbs`` for one row block through ``reduce_apply_dyn``
    on int64 (the codes the int32 tree does not take: loa with k = 0 or
    k >= 32)."""
    p = composed_reduce_dyn(*digit_products(qa_blk, qw, flat_lut), kind,
                            k) & mask
    return (torch.sum(p & 0xFFFF, dim=1, dtype=torch.int32),
            torch.sum(p >> 16, dim=1, dtype=torch.int32))


def composed_limbs(qa: torch.Tensor, qw: torch.Tensor,
                   flat_lut: torch.Tensor, mask: int, kind: int, k: int,
                   block_m: int) -> tuple:
    """Composed matmul on W-bit codes as its two exact int32 limb sums:
    qa (M,K) x qw (K,N) -> ``lo = Σ_k (p & 0xFFFF)``, ``hi = Σ_k (p >>
    16)``, ``p`` the digit products' shift/add tree under the host code
    ``(kind, k)`` (``encode_reduce``; ``reduce_apply_dyn``'s values)
    masked to the host uint32 ``mask``.  A narrow lane (mask 0) takes
    the plain tile sum of the low digits, hi 0.  ``block_m`` rows at a
    time; ``flat_lut`` is the (65536,) int32 tile LUT."""
    m, n = qa.shape[0], qw.shape[1]
    lo = torch.empty((m, n), dtype=torch.int32, device=qa.device)
    hi = torch.zeros_like(lo)
    if not mask:
        lo[:] = lut_gather(qa & 255, qw & 255, flat_lut, block_m)
        return lo, hi
    k &= _M32
    fast = kind in (0, 1) or 1 <= k <= 31
    w0, w1 = qw & 255, qw >> 8
    for start in range(0, m, max(1, block_m)):
        blk = qa[start:start + block_m]
        lo[start:start + block_m], hi[start:start + block_m] = (
            _limbs_block(blk, w0, w1, flat_lut, mask, kind, k) if fast
            else _limbs_block_dyn(blk, qw, flat_lut, mask, kind, k))
    return lo, hi


def composed_product(qa: torch.Tensor, qw: torch.Tensor,
                     flat_lut: torch.Tensor, reduce: tuple,
                     bits: int = 16) -> torch.Tensor:
    """Elementwise composed product of W-bit codes (broadcastable
    shapes) as an int64 holding the exact uint32, truncated to the
    netlist's 2W output bits."""
    def pp(x, y):
        return flat_lut[(x * 256 + y).long()].to(torch.int64)
    a0, a1 = qa & 255, qa >> 8
    w0, w1 = qw & 255, qw >> 8
    return composed_reduce(pp(a0, w0), pp(a0, w1), pp(a1, w0),
                           pp(a1, w1), reduce) & product_mask(bits)


def composed_forward(qa: torch.Tensor, qw: torch.Tensor, lut: torch.Tensor,
                     mask, reduce: tuple, block_m: int) -> torch.Tensor:
    """Blocked composed matmul on codes (the ``lut`` datapath's core):
    (M,K) x (K,N) -> (M,N) f32.

    Wide products are truncated to the lane's ``mask`` (the netlist's
    2W output bits), split into two 16-bit limbs accumulated exactly in
    int32 (``K <= MAX_COMPOSED_K``), then recombined in f32.
    ``mask == 0`` marks a narrow lane, which takes the plain 8-bit tile
    sum (``pp00`` alone)."""
    if qa.shape[1] > MAX_COMPOSED_K:
        raise ValueError(
            f"K={qa.shape[1]} exceeds int32-safe composed limb "
            f"accumulation bound {MAX_COMPOSED_K}")
    lo, hi = composed_limbs(qa, qw, lut.reshape(-1).to(torch.int32),
                            int(mask), *encode_reduce(reduce),
                            max(1, min(block_m, qa.shape[0])))
    return lo.to(torch.float32) + 65536.0 * hi.to(torch.float32)


# ----------------------------------------------------------------------
# Built-in datapaths
# ----------------------------------------------------------------------
@register_datapath("int8")
class Int8Datapath(Datapath):
    """Exact Σ qa·qw (golden 8-bit datapath).  CUDA has no integer
    matmul, so the card multiplies in float64, which is exact here
    (255² · K < 2^53 for every K <= MAX_LUT_K); the CPU uses int64."""

    exact_int32 = True
    needs_library = False
    spec_fields = ()

    def forward_q(self, qa, qw, consts):
        return _exact_product(qa, qw)

    def forward_q_experts(self, qa, qw, consts):
        """qa (..., X, C, K) codes, qw (E, K, N), E dividing X ->
        (..., X, C, N) int32: one batched product, slice s against
        ``qw[s % E]``."""
        return experts_product(qa, qw, _exact_product)


def _exact_product(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Σ_k qa·qw exactly, as int32 (broadcasting over leading dims)."""
    wide = torch.float64 if qa.is_cuda else torch.int64
    return torch.matmul(qa.to(wide), qw.to(wide)).to(torch.int32)


def _lut_gather_block(qa_blk: torch.Tensor, qw: torch.Tensor,
                      flat_lut: torch.Tensor) -> torch.Tensor:
    """Σ_k LUT[qa, qw] for one row block. (mb,K) x (K,N) -> (mb,N) i32
    (one ``index_select`` on int32 indices)."""
    idx = (qa_blk.to(torch.int32) << 8)[:, :, None] + qw.to(torch.int32)
    prods = flat_lut.index_select(0, idx.view(-1))
    return torch.sum(prods.view(idx.shape), dim=1, dtype=torch.int32)


def lut_gather(qa: torch.Tensor, qw: torch.Tensor, lut: torch.Tensor,
               block_m: int) -> torch.Tensor:
    """Blocked bit-true LUT matmul on codes: (M,K) x (K,N) -> (M,N) i32,
    ``block_m`` rows at a time so the (rows, K, N) gather fits."""
    m, k = qa.shape
    if k > MAX_LUT_K:
        raise ValueError(f"K={k} exceeds int32-safe LUT accumulation bound")
    flat = lut.reshape(-1).to(torch.int32)
    mb = max(1, min(block_m, m))
    out = torch.empty((m, qw.shape[1]), dtype=torch.int32, device=qa.device)
    for start in range(0, m, mb):
        out[start:start + mb] = _lut_gather_block(qa[start:start + mb],
                                                  qw, flat)
    return out


@register_datapath("lut")
class LutDatapath(Datapath):
    """Blocked bit-true LUT matmul on codes, width-generic: 8-bit
    (M,K) x (K,N) -> (M,N) i32; composed wide (``consts["composed"]``)
    -> (M,N) f32 through ``composed_forward``.  A banked backend's
    ``luts``, or codes with a lane axis, run lane by lane through the
    same gather."""

    spec_fields = ("multiplier", "block_m", "bit_width", "reduce_adder")
    bankable = True

    def pack(self, spec, library) -> dict:
        return pack_lut(spec, library)

    def forward_q(self, qa, qw, consts):
        block_m = consts["block_m"]
        luts = consts.get("luts")
        composed = consts.get("composed", False)

        def one(i, a, w):
            lut = consts["lut"] if luts is None else luts[i]
            if not composed:
                return lut_gather(a, w, lut, block_m)
            mask = consts["mask"] if luts is None else consts["masks"][i]
            return composed_forward(a, w, lut, mask, consts["reduce"],
                                    block_m)

        if luts is None and qa.ndim == 2:
            return one(0, qa, qw)
        n = qa.shape[0] if luts is None else luts.shape[0]
        return torch.stack([
            one(i, qa[i] if qa.ndim == 3 else qa,
                qw[i] if qw.ndim == 3 else qw) for i in range(n)])


def lowrank_gather(qa: torch.Tensor, qw: torch.Tensor, u: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Σ_r U_r(qa) @ V_r(qw) in f32: qa (M,K), qw (K,N) int32 codes,
    u, v (R,256) f32 -> (M,N) f32 (the reference's gathers and
    ``einsum("rmk,rkn->mn")``).  Stacked (E,K,N) weights: qa (B,E,M,K)
    -> (B,E,M,N), slice (b, e) against ``qw[e]``, one rank at a time (the
    gathered (E,K,N) table is the largest temporary: 5 GB at
    deepseek-v2-236b's expert widths)."""
    if qw.ndim == 3:
        qa, qw = qa.long(), qw.long()
        y = torch.matmul(u[0][qa], v[0][qw])
        for r in range(1, u.shape[0]):
            y = y + torch.matmul(u[r][qa], v[r][qw])
        return y
    ua = u[:, qa.long()]                 # (R,M,K)
    vw = v[:, qw.long()]                 # (R,K,N)
    return torch.einsum("rmk,rkn->mn", ua, vw)


@register_datapath("lowrank")
class LowRankDatapath(Datapath):
    """Σ_k Σ_r U[r,qa]V[r,qw]  ==  Σ_r tableU_r(qa) @ tableV_r(qw).
    (M,K) x (K,N) -> (M,N) f32, in plain PyTorch."""

    spec_fields = ("multiplier", "rank")

    def pack(self, spec, library) -> dict:
        return pack_lowrank(spec, library)

    def forward_q(self, qa, qw, consts):
        return lowrank_gather(qa, qw, consts["u"], consts["v"])

    def forward_q_experts(self, qa, qw, consts):
        """qa (..., X, C, K) codes, qw (E, K, N) -> (..., X, C, N) f32:
        the gathers and batched products (``lowrank_gather``)."""
        return experts_product(qa, qw, lambda a, w: lowrank_gather(
            a, w, consts["u"], consts["v"]))

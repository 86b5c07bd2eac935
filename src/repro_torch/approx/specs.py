"""Serializable backend specs + cached materialization (port of
``repro.approx.specs``).

``BackendSpec`` is the *name* of an accelerator datapath configuration:
a frozen, value-hashable, JSON round-trippable record.  Its fields,
defaults, validation and ``to_dict``/JSON form are the reference's, so
a policy JSON moves between the two packages unchanged.

``variant`` names the implementation: ``"ref"`` is the plain PyTorch
datapath; ``"pallas"`` names the hand-written-kernel datapaths
(``lut_pallas``, ``lowrank_pallas``), which in this package run the
CUDA kernels of ``repro_torch.kernels`` — LUT gathers, K9 for lowrank
(the name is kept so policies stay interchangeable with the reference,
whose ``pallas`` variant runs Pallas kernels); ``"fused"`` names the single-kernel datapath
(``lut_fused``: quantize, gather, accumulate and code sums in one CUDA
kernel, at 8 bits and at composed 12/16 bits).  Under ``"pallas"``
composed widths run the two-step composed kernels (K5/K6).

``materialize`` binds a spec to an ``ApproxLibrary`` and returns a
``MaterializedBackend`` holding the packed numpy constants; equal specs
get the same object back (LRU cache), and each backend keeps one tensor
copy of its constants per device.
"""
from __future__ import annotations

import json
import weakref
from collections import OrderedDict
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .. import obs
from ..core.families import parse_reduce
from .quant import TRACED_WIDTHS
from .registry import Datapath, encode_reduce, get_datapath, lane_mask_np

_EXACT_MODES = ("f32", "bf16")
_VARIANTS = ("ref", "pallas", "fused")


@dataclass(frozen=True)
class BackendSpec:
    """Value-hashable description of one emulated datapath.

    ``mode`` selects the registered datapath ("f32"/"bf16" bypass
    quantization entirely); ``variant`` selects the implementation
    ("ref" = plain PyTorch, "pallas" = the CUDA-kernel datapath
    ``lut_pallas`` / ``lowrank_pallas``, "fused" = the fused CUDA
    datapath ``lut_fused``).
    ``rank=None`` means auto.
    ``bit_width`` / ``reduce_adder`` describe composed wide datapaths
    and are validated as in the reference."""

    mode: str = "bf16"
    multiplier: str = "mul8u_exact"
    rank: Optional[int] = None
    block_m: int = 512
    ste: bool = True
    variant: str = "ref"
    bit_width: Optional[int] = None
    reduce_adder: Optional[str] = None

    def __post_init__(self):
        if self.variant not in _VARIANTS:
            raise ValueError(f"variant must be one of {_VARIANTS}, "
                             f"got {self.variant!r}")
        if self.bit_width is not None and not 8 <= self.bit_width <= 16:
            raise ValueError(
                f"bit_width must be in [8, 16] (8-bit direct LUTs, "
                f"composed tiles above), got {self.bit_width}")
        if self.reduce_adder is not None:
            parse_reduce(self.reduce_adder)   # raises on bad tokens

    # -- constructors ---------------------------------------------------
    @staticmethod
    def exact(mode: str = "bf16") -> "BackendSpec":
        return BackendSpec(mode=mode)

    @staticmethod
    def golden() -> "BackendSpec":
        """The paper's exact 8-bit reference datapath."""
        return BackendSpec(mode="int8")

    @staticmethod
    def from_library(multiplier: str, mode: str = "lut",
                     rank: Optional[int] = None,
                     variant: str = "ref",
                     bit_width: Optional[int] = None) -> "BackendSpec":
        return BackendSpec(mode=mode, multiplier=multiplier, rank=rank,
                           variant=variant, bit_width=bit_width)

    # -- derived --------------------------------------------------------
    @property
    def is_quantized(self) -> bool:
        return self.mode not in _EXACT_MODES

    @property
    def datapath_name(self) -> str:
        return (self.mode if self.variant == "ref"
                else f"{self.mode}_{self.variant}")

    def with_(self, **changes) -> "BackendSpec":
        return replace(self, **changes)

    # -- serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "BackendSpec":
        known = {f for f in BackendSpec.__dataclass_fields__}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown BackendSpec fields: {sorted(extra)}")
        return BackendSpec(**dict(d))

    @staticmethod
    def from_json(s: str) -> "BackendSpec":
        return BackendSpec.from_dict(json.loads(s))

    # -- materialization ------------------------------------------------
    def materialize(self, library=None) -> "MaterializedBackend":
        """Bind to ``library`` through the process-wide LRU cache."""
        return materialize(self, library)


@dataclass(frozen=True, eq=False)  # id-hash: cache guarantees uniqueness
class MaterializedBackend:
    """A spec bound to packed constants.  ``consts`` holds host arrays
    (numpy or CPU tensors) and plain values; ``device_consts(device)``
    returns them as tensors on ``device``, copied once per device.  A
    *banked* backend (``layers.bank_backend``) carries ``luts``
    (n, 256, 256) and evaluates every lane of a ``LutBank`` at once.
    ``canonical`` marks instances built by ``materialize`` (only those
    are identified by spec alone in policy cache keys)."""

    spec: BackendSpec
    datapath: Optional[Datapath]       # None for f32/bf16
    consts: Mapping[str, Any] = field(default_factory=dict)
    canonical: bool = False
    _on_device: dict = field(default_factory=dict, repr=False)

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def ste(self) -> bool:
        return self.spec.ste

    @property
    def multiplier(self) -> str:
        return self.spec.multiplier

    @property
    def rank(self) -> int:
        """Effective rank after auto-resolution (0 if not low-rank)."""
        u = self.consts.get("u")
        return int(u.shape[0]) if u is not None else int(self.spec.rank or 0)

    @property
    def lanes(self) -> Optional[int]:
        """Bank lane count of a banked backend, None otherwise."""
        luts = self.consts.get("luts")
        return None if luts is None else int(luts.shape[0])

    def device_consts(self, device: torch.device) -> dict:
        key = str(device)
        out = self._on_device.get(key)
        if out is None:
            with obs.span("bank.upload"):
                out = {k: _to_device(v, device)
                       for k, v in self.consts.items()}
            self._on_device[key] = out
        return out


def _to_device(v, device: torch.device):
    """``v`` as a tensor on ``device`` (plain values as they are); its
    bytes count as ``bytes_to_device`` of the open span."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, torch.Tensor):
        obs.count("bytes_to_device", v.numel() * v.element_size())
        return v.to(device)
    return v


# ----------------------------------------------------------------------
# Materialization cache
# ----------------------------------------------------------------------
_CACHE: "OrderedDict[tuple[int, BackendSpec], MaterializedBackend]" = \
    OrderedDict()
_CACHE_MAX = 256
_FINALIZED: set[int] = set()
_STATS = {"hits": 0, "misses": 0}


def _evict_library(lid: int) -> None:
    _FINALIZED.discard(lid)
    for k in [k for k in _CACHE if k[0] == lid]:
        del _CACHE[k]
    for k in [k for k in _BANK_CACHE if k[0] == lid]:
        del _BANK_CACHE[k]


def _library_key(library) -> int:
    lid = id(library)
    if lid not in _FINALIZED:
        _FINALIZED.add(lid)
        # evict on library GC so a recycled id can never alias
        weakref.finalize(library, _evict_library, lid)
    return lid


def _default_library():
    from ..core.library import get_default_library
    return get_default_library()


_SPEC_FIELD_DEFAULTS = {"multiplier": "mul8u_exact", "rank": None,
                        "block_m": 512, "bit_width": None,
                        "reduce_adder": None}


def canonicalize(spec: BackendSpec) -> BackendSpec:
    """Reset fields the spec's datapath never reads to their defaults,
    so equivalent configurations share one materialization / cache key
    (every int8 spec collapses to ``BackendSpec.golden()``)."""
    if not spec.is_quantized:
        return replace(spec, variant="ref", **_SPEC_FIELD_DEFAULTS)
    try:
        dp = get_datapath(spec.datapath_name)
    except (KeyError, NotImplementedError):
        return spec
    relevant = getattr(dp, "spec_fields", tuple(_SPEC_FIELD_DEFAULTS))
    changes = {f: d for f, d in _SPEC_FIELD_DEFAULTS.items()
               if f not in relevant and getattr(spec, f) != d}
    return replace(spec, **changes) if changes else spec


def materialize(spec: BackendSpec, library=None) -> MaterializedBackend:
    """Pack ``spec`` against ``library`` (default library if None),
    LRU-cached on the canonicalized spec so equal specs share one
    backend object."""
    spec = canonicalize(spec)
    if not spec.is_quantized:
        key = (0, spec)
        datapath = None
    else:
        datapath = get_datapath(spec.datapath_name)
        if datapath.needs_library:
            if library is None:
                library = _default_library()
            key = (_library_key(library), spec)
        else:
            key = (0, spec)
    hit = _CACHE.get(key)
    if hit is not None:
        _STATS["hits"] += 1
        _CACHE.move_to_end(key)
        return hit
    _STATS["misses"] += 1
    consts = datapath.pack(spec, library) if datapath is not None else {}
    mb = MaterializedBackend(spec=spec, datapath=datapath, consts=consts,
                             canonical=True)
    _CACHE[key] = mb
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)
    return mb


# ----------------------------------------------------------------------
# LutBank: the library axis as one constant (DESIGN.md §2.4)
# ----------------------------------------------------------------------
@dataclass(frozen=True, eq=False)  # id-hash: cache guarantees uniqueness
class LutBank:
    """A stack of tile LUTs — the *multiplier axis* of a resilience
    sweep as one ``(n_mult, 256, 256)`` int32 array.  Lane ``i`` of a
    banked evaluation runs ``luts[i]``, bit-identical to materializing
    ``spec(i)`` and evaluating sequentially.  Build through ``bank_for``
    to share banks across sweeps.

    Width-generic (DESIGN.md §2.6): lanes may MIX operand widths.  An
    8-bit lane's slice is its own product LUT; a composed wide lane's
    slice is its composition TILE's LUT, with the lane's operand width
    in ``bit_widths``.  Wide lanes share the static ``reduce`` tree
    unless ``reduces`` records one tree per lane, which only the
    ``fused`` variant evaluates (its kernel takes the tree as runtime
    data)."""

    names: tuple[str, ...]
    luts: np.ndarray                  # (n_mult, 256, 256) int32 tiles
    block_m: int = 512
    bit_widths: Optional[tuple[int, ...]] = None   # None = all 8-bit
    reduce: str = "exact"
    reduces: Optional[tuple[str, ...]] = None

    def __post_init__(self):
        if self.luts.ndim != 3 or self.luts.shape[1:] != (256, 256):
            raise ValueError(
                f"LutBank wants (n, 256, 256) LUTs, got {self.luts.shape}")
        if len(self.names) != self.luts.shape[0]:
            raise ValueError("one name per LUT slice required")
        if self.bit_widths is not None:
            if len(self.bit_widths) != len(self.names):
                raise ValueError("one bit width per lane required")
            bad = sorted(set(self.bit_widths) - set(TRACED_WIDTHS))
            if bad:
                raise ValueError(
                    f"unsupported lane widths {bad}; banked engines "
                    f"run per-lane widths from {TRACED_WIDTHS}")
        if self.reduces is not None and len(self.reduces) != len(self.names):
            raise ValueError("one reduce per lane required")

    @property
    def n_mult(self) -> int:
        return len(self.names)

    @property
    def is_mixed_reduce(self) -> bool:
        """True when lanes carry more than one distinct reduction tree
        — only the runtime-tree ``fused`` engines can bank such a set."""
        if self.reduces is None:
            return False
        return len({parse_reduce(r) for r in self.reduces}) > 1

    @property
    def lane_reduce_codes(self) -> np.ndarray:
        """(n_mult, 2) int32 ``encode_reduce`` codes, one per lane
        (uniform banks repeat the shared ``reduce``)."""
        rs = (self.reduces if self.reduces is not None
              else (self.reduce,) * self.n_mult)
        return np.asarray([encode_reduce(parse_reduce(r)) for r in rs],
                          dtype=np.int32).reshape(-1, 2)

    @property
    def lane_bits(self) -> np.ndarray:
        """(n_mult,) per-lane operand widths (int32)."""
        if self.bit_widths is None:
            return np.full(self.n_mult, 8, dtype=np.int32)
        return np.asarray(self.bit_widths, dtype=np.int32)

    @property
    def any_wide(self) -> bool:
        """True when any lane runs the composed (>8-bit) datapath."""
        return bool((self.lane_bits > 8).any())

    @property
    def lane_masks(self) -> np.ndarray:
        """(n_mult,) uint32 per-lane 2W-bit product masks (0 marks a
        narrow lane)."""
        return lane_mask_np(self.lane_bits)

    def spec(self, i: int, mode: str = "lut",
             variant: str = "ref") -> BackendSpec:
        """The serializable spec lane ``i`` of a banked sweep stands
        for."""
        return BackendSpec(mode=mode, multiplier=self.names[i],
                           block_m=self.block_m, variant=variant)

    @staticmethod
    def from_library(names, library=None, block_m: int = 512,
                     mixed_reduce: bool = False) -> "LutBank":
        """Pack a (possibly mixed-width) candidate set: 8-bit entries
        contribute their own LUT, composed wide entries their tile's.
        Raises when wide lanes disagree on the reduction tree unless
        ``mixed_reduce=True``, which records per-lane trees for the
        runtime-tree ``fused`` engines."""
        if library is None:
            library = _default_library()
        names = tuple(names)
        luts, widths, reduces = [], [], {}
        for n in names:
            entry = library.entry(n)
            comp = library.composition_of(n)
            if entry.width not in TRACED_WIDTHS:
                raise ValueError(
                    f"bank lane {n!r} is {entry.width}-bit; banked "
                    f"sweeps support widths {TRACED_WIDTHS}")
            luts.append(np.asarray(library.tile_lut(n), dtype=np.int32))
            widths.append(int(entry.width))
            if comp is not None:
                reduces[n] = comp["reduce"]
        reduce = "exact"
        per_lane: Optional[tuple] = None
        if reduces:
            if len({parse_reduce(r) for r in reduces.values()}) > 1:
                if not mixed_reduce:
                    raise ValueError(
                        "mixed reduction trees in one bank: "
                        f"{sorted(set(reduces.values()))}; sweep each "
                        "reduction family in its own bank, or pass "
                        "mixed_reduce=True to bank them through the "
                        "runtime-tree fused engines")
                per_lane = tuple(reduces.get(n, "exact") for n in names)
            else:
                reduce = next(iter(reduces.values()))
        return LutBank(names=names, luts=np.stack(luts), block_m=block_m,
                       bit_widths=tuple(widths), reduce=reduce,
                       reduces=per_lane)


# ----------------------------------------------------------------------
# PolicyBank: heterogeneous per-layer assignments over one LutBank
# (DESIGN.md §2.5)
# ----------------------------------------------------------------------
@dataclass(frozen=True, eq=False)  # id-hash: ndarray field
class PolicyBank:
    """K heterogeneous per-layer multiplier assignments sharing one
    ``LutBank`` — the *policy axis* of a heterogeneous sweep.

    ``assign[p, j]`` is the index into ``bank.names`` of the multiplier
    policy ``p`` uses in layer ``layers[j]``; layers not named here run
    the evaluation's base backend (golden int8 by default).  Row ``p``
    therefore stands for the serializable
    ``ApproxPolicy(default=base, overrides=spec_overrides(p))``, and
    ``approx.layers.policy_bank_eval`` evaluates every row in one pass
    of the model: layer ``j`` runs one banked call over the tables
    ``luts[assign[:, j]]``, equal to K sequential override evaluations.
    """

    bank: LutBank
    layers: tuple[str, ...]
    assign: np.ndarray                # (n_policies, n_layers) int32

    def __post_init__(self):
        a = np.asarray(self.assign, dtype=np.int32)
        if a.ndim != 2 or a.shape[1] != len(self.layers):
            raise ValueError(
                f"assign must be (n_policies, {len(self.layers)}), "
                f"got {a.shape}")
        if a.size and (a.min() < 0 or a.max() >= self.bank.n_mult):
            raise ValueError(
                f"assign indices must be in [0, {self.bank.n_mult}); "
                f"got range [{a.min()}, {a.max()}]")
        object.__setattr__(self, "assign", a)

    @property
    def n_policies(self) -> int:
        return int(self.assign.shape[0])

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def assignment(self, p: int) -> dict[str, str]:
        """Row ``p`` as a layer-name -> multiplier-name mapping."""
        return {layer: self.bank.names[self.assign[p, j]]
                for j, layer in enumerate(self.layers)}

    def spec_overrides(self, p: int, mode: str = "lut",
                       variant: str = "ref"
                       ) -> list[tuple[str, BackendSpec]]:
        """Serializable ``ApproxPolicy`` overrides for row ``p`` (layer
        order preserved; layer names are exact, disjoint patterns)."""
        return [(layer, BackendSpec(mode=mode, multiplier=name,
                                    block_m=self.bank.block_m,
                                    variant=variant))
                for layer, name in self.assignment(p).items()]

    @staticmethod
    def from_assignments(assignments, library=None,
                         layers=None, block_m: int = 512,
                         fill: Optional[str] = None) -> "PolicyBank":
        """Pack layer->multiplier mappings into one shared bank.

        ``assignments`` is a sequence of dicts; ``layers`` defaults to
        the union of their keys in first-appearance order.  Every
        mapping must cover every layer unless ``fill`` names a
        multiplier, which then runs in a row's unassigned layers
        (``fill="mul8u_exact"`` computes the golden int8 products).  The
        distinct multiplier names form one ``bank_for``-cached
        ``LutBank``."""
        assignments = list(assignments)
        if layers is None:
            layers = []
            for a in assignments:
                for name in a:
                    if name not in layers:
                        layers.append(name)
        layers = tuple(layers)
        names: list[str] = []
        rows: list[Mapping[str, str]] = []
        for a in assignments:
            missing = [l for l in layers if l not in a]
            if missing and fill is None:
                raise ValueError(
                    f"assignment {a!r} misses layers {missing} "
                    "(pass fill=<multiplier name> to pad partial rows)")
            row = dict(a) if not missing else {
                **{l: fill for l in missing}, **a}
            rows.append(row)
            for l in layers:
                if row[l] not in names:
                    names.append(row[l])
        bank = bank_for(names, library, block_m=block_m)
        index = {n: i for i, n in enumerate(bank.names)}
        assign = np.asarray([[index[r[l]] for l in layers]
                             for r in rows], dtype=np.int32)
        return PolicyBank(bank=bank, layers=layers, assign=assign)

    @staticmethod
    def uniform(names, layers, library=None,
                block_m: int = 512) -> "PolicyBank":
        """One row per multiplier name, assigned to every layer — the
        heterogeneous engine restricted to uniform policies (the
        equal-assignment consistency check)."""
        return PolicyBank.from_assignments(
            [{l: n for l in layers} for n in names],
            library=library, layers=layers, block_m=block_m)

    @staticmethod
    def from_policies(policies, layers, library=None,
                      block_m: int = 512, mode: str = "lut"
                      ) -> "PolicyBank":
        """Bank assembly from request policies (DESIGN.md §2.8): each
        ``ApproxPolicy`` resolves over ``layers`` through
        ``policy_assignment``, and row ``p`` is policy ``p``'s per-layer
        lane assignment."""
        assignments = [policy_assignment(p, layers, mode=mode,
                                         block_m=block_m)
                       for p in policies]
        return PolicyBank.from_assignments(assignments, library=library,
                                           layers=tuple(layers),
                                           block_m=block_m)


def policy_assignment(policy, layers, *, mode: str = "lut",
                      block_m: int = 512) -> dict[str, str]:
    """Resolve an ``ApproxPolicy`` to a layer-tag -> multiplier-name
    mapping over ``layers``.  Every layer must resolve to a ``mode``
    spec with the bank's ``block_m``; anything else cannot ride a
    LUT-bank lane and raises with the layer named."""
    from .layers import spec_of   # runtime import: layers imports us
    out: dict[str, str] = {}
    for layer in layers:
        spec = spec_of(policy.backend_for(layer))
        if spec.mode != mode:
            raise ValueError(
                f"policy resolves layer {layer!r} to mode "
                f"{spec.mode!r}; mixed-policy serving batches every "
                f"request through the banked {mode!r} datapath — "
                f"express the request as a {mode!r}-mode policy "
                "(multiplier='mul8u_exact' emulates the exact product)")
        if spec.block_m != block_m:
            raise ValueError(
                f"policy resolves layer {layer!r} with block_m="
                f"{spec.block_m}, but the shared bank blocks at "
                f"{block_m} — one banked program compiles one blocking")
        out[layer] = spec.multiplier
    return out


_BANK_CACHE: "OrderedDict[tuple, LutBank]" = OrderedDict()
_BANK_CACHE_MAX = 16


def bank_for(names, library=None, block_m: int = 512,
             mixed_reduce: bool = False) -> LutBank:
    """LRU-cached ``LutBank.from_library``: repeated sweeps over the
    same candidate set reuse one packed bank."""
    if library is None:
        library = _default_library()
    key = (_library_key(library), tuple(names), int(block_m),
           bool(mixed_reduce))
    hit = _BANK_CACHE.get(key)
    if hit is not None:
        _BANK_CACHE.move_to_end(key)
        return hit
    bank = LutBank.from_library(names, library, block_m=block_m,
                                mixed_reduce=mixed_reduce)
    _BANK_CACHE[key] = bank
    while len(_BANK_CACHE) > _BANK_CACHE_MAX:
        _BANK_CACHE.popitem(last=False)
    return bank


def materialize_cache_stats() -> dict:
    return {"hits": _STATS["hits"], "misses": _STATS["misses"],
            "size": len(_CACHE)}


def clear_materialize_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0

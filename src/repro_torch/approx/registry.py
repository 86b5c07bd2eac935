"""Pluggable datapath registry (port of ``repro.approx.registry``).

A *datapath* is the arithmetic core of the accelerator being emulated:
given uint8 operand codes it returns the raw accumulated products
``Σ_k mul(qa[m,k], qw[k,n])``.  Zero-point correction, scaling and the
straight-through gradient live in ``repro_torch.approx.backend`` and are
shared by every datapath.

Built-in datapaths registered here:

  * ``int8`` — exact uint8 datapath (the paper's golden reference),
               int32-exact correction arithmetic
  * ``lut``  — bit-true 256x256 LUT emulation, a blocked gather in
               plain PyTorch (the reference's ``jnp.take`` path)

The hand-written CUDA variant (``lut_pallas``, named after the
reference's Pallas datapath it replaces) is registered by
``repro_torch.kernels.datapaths`` and resolved lazily on first lookup.

``forward_q`` takes codes as int32 tensors: ``qa`` is ``(M, K)`` or,
inside a banked evaluation, ``(n, M, K)`` with one lane per bank entry;
``consts`` holds the backend's constants as tensors on the codes'
device (``MaterializedBackend.device_consts``).  A banked backend
carries ``luts`` (n, 256, 256) instead of ``lut`` and returns
``(n, M, N)``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

MAX_LUT_K = 33030  # int32-safe accumulation bound: 2^31 / 255^2

#: The ROADMAP.md item that ports each datapath this package does not
#: have yet.
_NOT_PORTED = {
    "lowrank": "ROADMAP.md Queue 2, lowrank (kernel K9, lowrank_matmul)",
    "fused": "ROADMAP.md Queue 2, the fused variant (kernels K3/K4, "
             "fused_matmul)",
    "composed": "ROADMAP.md Queue 2, composed widths (kernels K5-K8, "
                "composed_matmul)",
}


class Datapath:
    """Base class for registered datapaths.

    ``pack(spec, library)`` runs once per (spec, library) on the host and
    returns the numpy constant dict ``forward_q`` consumes (as tensors);
    the result is cached by ``repro_torch.approx.specs.materialize``.
    ``exact_int32`` datapaths return int32 sums whose zero-point
    correction stays in int32; the rest are corrected in float32.
    ``bankable`` datapaths accept a banked ``luts`` constant and run a
    whole LUT bank in one call (the batched resilience engine)."""

    name: str = "?"
    exact_int32: bool = False
    needs_library: bool = True
    spec_fields: tuple = ("multiplier", "rank", "block_m")
    bankable: bool = False

    def pack(self, spec, library) -> dict:
        return {}

    def bank_consts(self, bank) -> dict:
        """Numpy constants of a banked backend over ``bank`` (a
        ``LutBank``); only ``bankable`` datapaths are asked."""
        return {"luts": bank.luts, "block_m": bank.block_m}

    def forward_q(self, qa: torch.Tensor, qw: torch.Tensor, consts: dict
                  ) -> torch.Tensor:
        raise NotImplementedError


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
    if name not in _REGISTRY and name.endswith("_pallas"):
        # the CUDA-kernel variants live in the kernel layer
        import repro_torch.kernels.datapaths  # noqa: F401  (registers)
    if name not in _REGISTRY:
        for key, item in _NOT_PORTED.items():
            if key in name:
                raise NotImplementedError(
                    f"datapath {name!r} is not ported yet ({item})")
        raise KeyError(
            f"unknown datapath {name!r}; available: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_datapaths() -> list[str]:
    return sorted(_REGISTRY)


def pack_lut(spec, library) -> dict:
    """Numpy constants of the 8-bit LUT datapaths: the entry's own
    256x256 int32 product LUT and the row blocking.  Composed wide
    entries (12/16-bit, executed through a tile LUT) are not ported."""
    entry = library.entry(spec.multiplier,
                          bit_width=getattr(spec, "bit_width", None))
    if library.composition_of(spec.multiplier) is not None:
        raise NotImplementedError(
            f"{spec.multiplier!r} is a composed {entry.width}-bit entry; "
            f"composed datapaths are not ported yet "
            f"({_NOT_PORTED['composed']})")
    if getattr(spec, "reduce_adder", None) is not None:
        raise ValueError(
            f"reduce_adder={spec.reduce_adder!r} is only meaningful "
            f"for composed wide entries; {spec.multiplier!r} is "
            f"{entry.width}-bit and materializes directly")
    lut = np.asarray(library.tile_lut(spec.multiplier), dtype=np.int32)
    return {"lut": lut, "block_m": int(spec.block_m)}


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
        wide = torch.float64 if qa.is_cuda else torch.int64
        return torch.matmul(qa.to(wide), qw.to(wide)).to(torch.int32)


def _lut_gather_block(qa_blk: torch.Tensor, qw: torch.Tensor,
                      flat_lut: torch.Tensor) -> torch.Tensor:
    """Σ_k LUT[qa, qw] for one row block. (mb,K) x (K,N) -> (mb,N) i32."""
    idx = qa_blk[:, :, None].long() * 256 + qw[None, :, :].long()
    return torch.sum(flat_lut[idx], dim=1, dtype=torch.int32)


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
    """Blocked bit-true LUT matmul on codes (8-bit):
    (M,K) x (K,N) -> (M,N) i32.  A banked backend's ``luts``, or codes
    with a lane axis, run lane by lane through the same gather."""

    spec_fields = ("multiplier", "block_m", "bit_width", "reduce_adder")
    bankable = True

    def pack(self, spec, library) -> dict:
        return pack_lut(spec, library)

    def forward_q(self, qa, qw, consts):
        block_m = consts["block_m"]
        luts = consts.get("luts")
        if luts is None and qa.ndim == 2:
            return lut_gather(qa, qw, consts["lut"], block_m)
        n = qa.shape[0] if luts is None else luts.shape[0]
        return torch.stack([
            lut_gather(qa[i] if qa.ndim == 3 else qa, qw,
                       consts["lut"] if luts is None else luts[i], block_m)
            for i in range(n)])

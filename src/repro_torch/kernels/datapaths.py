"""CUDA-kernel datapath registration (port of
``repro.kernels.datapaths``).

Imported lazily by ``repro_torch.approx.registry.get_datapath`` the
first time a ``*_pallas`` datapath is requested.  The name is the
reference's (``BackendSpec(variant="pallas")``), so policies move
between the packages unchanged; here the datapath runs the hand-written
CUDA kernels through ``kernels.ops``.
"""
from __future__ import annotations

import torch

from ..approx.registry import Datapath, pack_lut, register_datapath
from .approx_matmul import lut_to_uint16
from .ops import approx_matmul_lut, approx_matmul_lut_bank


@register_datapath("lut_pallas")
class LutPallasDatapath(Datapath):
    """Bit-true 8-bit LUT emulation through the CUDA LUT-gather kernels:
    K1 (``approx_matmul_lut``) for one multiplier, K2
    (``approx_matmul_lut_bank``) for a banked backend — one launch per
    layer for the whole bank.  The product tables are packed once as
    uint16 (range-checked on the host), so no launch re-checks them."""

    # kernel does its own blocking, so block_m is not a spec field
    spec_fields = ("multiplier", "bit_width", "reduce_adder")
    bankable = True

    def pack(self, spec, library) -> dict:
        consts = pack_lut(spec, library)
        consts["lut16"] = lut_to_uint16(torch.from_numpy(consts["lut"]))
        return consts

    def bank_consts(self, bank) -> dict:
        return {**super().bank_consts(bank),
                "luts16": lut_to_uint16(torch.from_numpy(bank.luts))}

    def forward_q(self, qa, qw, consts):
        if "luts16" in consts:
            return approx_matmul_lut_bank(qa, qw, consts["luts16"])
        if qa.ndim == 3:
            # lane-carrying codes through one table: the banked kernel
            # with the table repeated per lane, as the reference's vmap
            # rule does
            luts = consts["lut16"].expand(qa.shape[0], 256, 256)
            return approx_matmul_lut_bank(qa, qw, luts.contiguous())
        return approx_matmul_lut(qa, qw, consts["lut16"])

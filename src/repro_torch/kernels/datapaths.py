"""CUDA-kernel datapath registration (port of
``repro.kernels.datapaths``).

Imported lazily by ``repro_torch.approx.registry.get_datapath`` the
first time a ``*_pallas`` or ``*_fused`` datapath is requested.  The
names are the reference's (``BackendSpec(variant="pallas")`` and
``variant="fused"``), so policies move between the packages unchanged;
here the datapaths run the hand-written CUDA kernels through
``kernels.ops``.

``lut_pallas`` runs the two-step kernels on codes at every width: K1/K2
for 8-bit entries and banks, K5/K6 for composed 12/16-bit entries and
banks with wide lanes.  ``lut_fused`` runs the single-kernel path.
``lowrank_pallas`` runs the rank-R factored product on K9.

Every datapath here also runs an MoE projection's stacked expert weights
in one call (``forward_q_experts``, ``forward_fused_experts``): one
launch for every expert and bank lane, as the reference's
``pallas_call`` batched over them — K1/K2 or K5/K6 under
``lut_pallas``, K3/K4 or K7/K8 under ``lut_fused`` (a composed entry or
a mixed-width bank at each lane's width), K9 under ``lowrank_pallas``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..approx.quant import (calibrate, calibrate_slices, pair_scalars,
                            scalar_params)
from ..approx.registry import (Datapath, encode_reduce, pack_lowrank,
                               pack_lut, register_datapath)
from .approx_matmul import lut_to_uint16
from .ops import (approx_matmul_lut, approx_matmul_lut_bank,
                  composed_matmul_lut, composed_matmul_lut_bank,
                  fused_composed_matmul_lut, fused_composed_matmul_lut_bank,
                  fused_matmul_lut, fused_matmul_lut_bank, lowrank_matmul)


def _bank_tables(consts: dict, lanes: int):
    """The banked tables a call runs: the bank's, the one table repeated
    for codes that carry a lane axis of ``lanes`` (the reference's vmap
    rule), or None (one table)."""
    luts = consts.get("luts16")
    if luts is None and lanes:
        return consts["lut16"].expand(lanes, 256, 256).contiguous()
    return luts


@register_datapath("lut_pallas")
class LutPallasDatapath(Datapath):
    """Bit-true LUT emulation through the CUDA gather kernels on codes,
    width-generic.  8-bit entries: K1 (``approx_matmul_lut``) for one
    multiplier, K2 (``approx_matmul_lut_bank``) for a banked backend —
    one launch per layer for the whole bank.  Composed 12/16-bit
    entries: K5 (``composed_matmul_lut``) on the entry's tile LUT, and
    K6 (``composed_matmul_lut_bank``) for a bank with wide lanes (8-bit
    lanes ride along with mask 0) under the bank's one static reduce
    tree; both return f32 (limbs recombined).  The tables are packed once
    as uint16 (range-checked on the host), so no launch re-checks them.
    Codes that carry a lane axis through one table run the banked kernel
    with the table repeated per lane, as the reference's vmap rule
    does."""

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
        return self._call(qa, qw, consts, False)

    def forward_q_experts(self, qa, qw, consts):
        """qa (X,C,K) codes, or (n,X,C,K) with a lane axis; qw (E,K,N)
        codes of the stacked expert weights (a mixed-width bank's
        (n,E,K,N), per lane), E dividing X -> (X,C,N), or (n,X,C,N) when
        ``qa`` or the backend is banked: one K1 (K2) launch, or K5 (K6)
        for a composed entry or a bank with wide lanes (f32, limbs
        recombined), slice s against expert ``s % E``."""
        return self._call(qa, qw, consts, True)

    @staticmethod
    def _call(qa, qw, consts, experts: bool):
        lanes = qa.ndim == 3 + experts
        luts = _bank_tables(consts, qa.shape[0] if lanes else 0)
        if consts.get("composed"):
            if luts is None:
                return composed_matmul_lut(qa, qw, consts["lut16"],
                                           consts["mask"], consts["reduce"])
            masks = consts["masks"] if "luts16" in consts else consts["mask"]
            return composed_matmul_lut_bank(qa, qw, luts, masks,
                                            consts["reduce"], experts=experts)
        if luts is None:
            return approx_matmul_lut(qa, qw, consts["lut16"])
        return approx_matmul_lut_bank(qa, qw, luts)


@register_datapath("lut_fused")
class LutFusedDatapath(Datapath):
    """Single-kernel LUT emulation: the backend hands this datapath the
    FLOAT operands; calibration (min/max, outside the kernel) yields the
    quantization scalars, and one CUDA kernel quantizes, gathers,
    accumulates and sums the codes — K3 for one 8-bit multiplier, K4
    for an 8-bit bank, K7 for one composed 12/16-bit multiplier, K8 for
    a bank with wide lanes (per-lane widths, masks and reduce codes, so
    one launch mixes widths and reduce trees).  The f32 epilogue runs in
    ``kernels.ops``.  Bit-identical to ``lut`` at every width."""

    spec_fields = ("multiplier", "bit_width", "reduce_adder")
    bankable = True
    fused = True

    def pack(self, spec, library) -> dict:
        consts = pack_lut(spec, library)
        consts["lut16"] = lut_to_uint16(torch.from_numpy(consts["lut"]))
        if consts.get("composed"):
            # device-resident once per device, so no launch copies it
            consts["reduce_code"] = np.asarray(
                [encode_reduce(consts["reduce"])], dtype=np.int32)
        return consts

    def bank_consts(self, bank) -> dict:
        return {**super().bank_consts(bank),
                "luts16": lut_to_uint16(torch.from_numpy(bank.luts))}

    def forward_fused(self, x, w, consts, lanes: bool = False):
        """x (M,K), or (n,M,K) with ``lanes``; w (K,N) -> (M,N), or
        (n,M,N) when ``x`` or the backend is banked."""
        bits = consts.get("bits", 8)
        with obs.span("datapath.calibrate"):
            sp = scalar_params(calibrate(x, bits, lanes=lanes),
                               calibrate(w, bits))
        return self._call(x, w, consts, _bank_tables(
            consts, x.shape[0] if x.ndim == 3 else 0), sp)

    def forward_fused_experts(self, x, w, consts):
        """x (X,C,K), or (n,X,C,K) with a lane axis; w (E,K,N) the stacked
        expert weights, E dividing X -> (X,C,N), or (n,X,C,N) when ``x``
        or the backend is banked: one K3 (K4) launch, or K7 (K8) for a
        composed entry or a bank with wide lanes, each (lane, slice) pair
        calibrated on its own at its lane's width (``calibrate_slices``)
        and quantized with its own scalars against ``w[s % E]``, whose
        scalars are its expert's at that width."""
        bits = consts.get("bits", 8)
        luts = _bank_tables(consts, x.shape[0] if x.ndim == 4 else 0)
        with obs.span("datapath.calibrate"):
            sp = pair_scalars(calibrate_slices(x, bits),
                              calibrate_slices(w, bits),
                              1 if luts is None else luts.shape[0],
                              x.shape[-3])
        return self._call(x, w, consts, luts, sp)

    @staticmethod
    def _call(x, w, consts, luts, sp):
        """K3/K7 on one table (``luts`` None), else K4/K8; lane-carrying x
        through one table runs the banked kernel with the table repeated
        per lane (``_bank_tables``, the reference's vmap rule)."""
        composed = consts.get("composed", False)
        if luts is None:
            if composed:
                return fused_composed_matmul_lut(
                    x, w, consts["lut16"], consts["mask"],
                    consts["reduce_code"], *sp)
            return fused_matmul_lut(x, w, consts["lut16"], *sp)
        if composed:
            banked = "luts16" in consts
            masks = consts["masks"] if banked else consts["mask"]
            codes = (consts["reduce_codes"] if banked
                     else consts["reduce_code"])
            return fused_composed_matmul_lut_bank(x, w, luts, masks, codes,
                                                  *sp)
        return fused_matmul_lut_bank(x, w, luts, *sp)

    def forward_q(self, qa, qw, consts):
        raise TypeError(
            "lut_fused is a fused datapath: the backend routes float "
            "operands through forward_fused, never quantized codes")


@register_datapath("lowrank_pallas")
class LowRankPallasDatapath(Datapath):
    """Rank-R factored emulation through the CUDA kernel K9
    (``ops.lowrank_matmul``): (M,K) x (K,N) codes -> (M,N) f32."""

    spec_fields = ("multiplier", "rank")

    def pack(self, spec, library) -> dict:
        return pack_lowrank(spec, library)

    def forward_q(self, qa, qw, consts):
        return lowrank_matmul(qa, qw, consts["u"], consts["v"])

    def forward_q_experts(self, qa, qw, consts):
        """qa (..., X, C, K) codes, qw (E, K, N), E dividing X ->
        (..., X, C, N) f32: one K9 launch, any lane axis folded into the
        slices, slice s against ``qw[s % E]``."""
        y = lowrank_matmul(qa.reshape(-1, *qa.shape[-2:]), qw, consts["u"],
                           consts["v"])
        return y.reshape(*qa.shape[:-1], qw.shape[-1])

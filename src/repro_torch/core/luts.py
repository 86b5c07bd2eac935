"""LUT construction and low-rank decomposition of approximate multipliers.

The TFApprox-style emulation of an 8-bit approximate multiplier is a
256x256 int32 lookup table.  On TPU we additionally support a *low-rank
decomposition* of that table (DESIGN.md §4.2):

    L[a, b] ≈ sum_r U[r, a] * V[r, b]        (rank-R, via SVD)

which converts the emulated matmul into R per-element 256-entry table
lookups followed by R MXU matmuls.  An exact multiplier is exactly rank
1 (L = a bᵀ); truncation is rank 1; BAM is near-rank-2; evolved circuits
are numerically near-low-rank because their error surfaces are highly
structured.  ``rank_profile`` quantifies, per circuit, the decomposition
MAE as a function of R so callers can pick R such that emulation error
is negligible next to the circuit's own error.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .netlist import Netlist

#: Widest operand a full product LUT is ever materialized for.  A W-bit
#: LUT holds 2^(2W) int32 entries — 64 MiB at W=12, 16 TiB at W=16 —
#: so wider multipliers must execute through the composed datapath
#: (tiled 8x8 LUT partial products, DESIGN.md §2.6) instead.
MAX_LUT_WIDTH = 12


class LutWidthError(ValueError):
    """Raised when a full product LUT would exceed ``MAX_LUT_WIDTH``.

    Wide multipliers are *executable* — just not as a monolithic table.
    The actionable fix is the composed datapath: register a composed
    entry (``ApproxLibrary.add_composed(tile, width, reduce)``) or name
    one in a ``BackendSpec(multiplier=..., bit_width=W)``; its 8-bit
    tile LUT then drives the tiled 8x8 partial-product engine
    (``repro.kernels.composed_matmul``, DESIGN.md §2.6).
    """

    def __init__(self, name: str, width: int):
        self.circuit = name
        self.width = width
        super().__init__(
            f"cannot materialize a full {width}-bit product LUT for "
            f"{name!r} (2^{2 * width} entries; cap is "
            f"{MAX_LUT_WIDTH}-bit operands).  Wide multipliers run "
            "through the composed datapath instead: register a "
            "composed entry via ApproxLibrary.add_composed(tile, "
            f"width={width}, reduce=...) (tiled 8x8 LUT partial "
            "products reduced by a shift/add tree, DESIGN.md §2.6) "
            "and reference it from a BackendSpec, which packs only "
            "the 256x256 tile LUT.")


def exact_mul_lut(width: int = 8) -> np.ndarray:
    if width > MAX_LUT_WIDTH:
        raise LutWidthError(f"mul{width}u_exact", width)
    n = 1 << width
    a = np.arange(n, dtype=np.int64)
    return (a[:, None] * a[None, :]).astype(np.int32)


def lut_from_netlist(nl: Netlist, width: int = 8) -> np.ndarray:
    """Exhaustive (2^w x 2^w) LUT for a 2w-input multiplier-like netlist.
    Row index = operand A (low input bits), column = operand B."""
    if width > MAX_LUT_WIDTH:
        raise LutWidthError(nl.name or "<netlist>", width)
    if nl.n_i != 2 * width:
        raise ValueError("netlist is not a two-operand circuit of this width")
    n = 1 << width
    a = np.arange(n, dtype=np.uint64)
    A, B = np.meshgrid(a, a, indexing="ij")
    vals = nl.eval_ints(A.reshape(-1), B.reshape(-1), widths=[width, width])
    return vals.reshape(n, n).astype(np.int64).astype(np.int32)


@dataclass(frozen=True)
class LowRankFactors:
    """L ≈ U^T V with U: (R, n) and V: (R, n), float32."""
    u: np.ndarray  # (R, n)
    v: np.ndarray  # (R, n)

    @property
    def rank(self) -> int:
        return int(self.u.shape[0])

    def reconstruct(self) -> np.ndarray:
        return (self.u.T @ self.v).astype(np.float64)

    def mae_vs(self, lut: np.ndarray) -> float:
        return float(np.abs(self.reconstruct() - lut.astype(np.float64)).mean())


def decompose_lut(lut: np.ndarray, rank: int) -> LowRankFactors:
    """Best rank-R factorization (Eckart-Young, SVD) of the LUT."""
    L = lut.astype(np.float64)
    w, s, vt = np.linalg.svd(L, full_matrices=False)
    r = int(min(rank, s.shape[0]))
    scale = np.sqrt(s[:r])
    u = (w[:, :r] * scale[None, :]).T.astype(np.float32)
    v = (vt[:r, :] * scale[:, None]).astype(np.float32)
    return LowRankFactors(u=u, v=v)


def rank_profile(lut: np.ndarray, max_rank: int = 16) -> list[dict]:
    """Decomposition MAE for R = 1..max_rank (one SVD, truncated views)."""
    L = lut.astype(np.float64)
    w, s, vt = np.linalg.svd(L, full_matrices=False)
    out = []
    recon = np.zeros_like(L)
    for r in range(1, min(max_rank, s.shape[0]) + 1):
        recon += np.outer(w[:, r - 1] * s[r - 1], vt[r - 1, :])
        err = np.abs(recon - L)
        out.append({
            "rank": r,
            "mae": float(err.mean()),
            "wce": float(err.max()),
            "sigma": float(s[r - 1]),
        })
    return out


def rank_for_tolerance(lut: np.ndarray, mae_tol: float, max_rank: int = 64) -> int:
    """Smallest R whose decomposition MAE <= mae_tol (capped at max_rank)."""
    prof = rank_profile(lut, max_rank=max_rank)
    for row in prof:
        if row["mae"] <= mae_tol:
            return int(row["rank"])
    return int(max_rank)

"""Rank statistics for predicted-vs-measured fidelity (port of
``repro.approx.ranking``, DESIGN.md §2.11).

The surrogate predict stage is judged by how well it RANKS candidates,
not by absolute error: the beam only consumes orderings, so the
fidelity gates report Spearman's rho and Kendall's tau between
predicted and measured quality.  One implementation serves the
surrogate fidelity gates (``launch/dse_surrogate.py``), the library rank
analysis (``launch/rank_analysis.py``) and the surrogate's held-out
diagnostics.  Pure float64 numpy: the results equal the reference's bit
for bit, ``nan`` cases included.

All functions are tie-aware: ranks are midranks (average of the
positions a tied group spans, scipy's ``rankdata(method="average")``),
Spearman is the Pearson correlation of midranks, and Kendall is
tau-b (tie-corrected denominator).  Constant inputs have no defined
correlation; both return ``nan`` then (scipy's convention) — callers
gating on a correlation should filter or map those explicitly.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def rankdata(values: Sequence[float]) -> np.ndarray:
    """Midranks (1-based): ties share the average of the positions
    they span — ``rankdata([10, 20, 20, 30]) == [1, 2.5, 2.5, 4]``."""
    v = np.asarray(values, dtype=np.float64)
    if v.ndim != 1:
        raise ValueError(f"rankdata expects a 1-d array, got {v.shape}")
    order = np.argsort(v, kind="stable")
    ranks = np.empty(v.size, dtype=np.float64)
    i = 0
    while i < v.size:
        j = i
        while j + 1 < v.size and v[order[j + 1]] == v[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def _as_pair(x, y) -> tuple[np.ndarray, np.ndarray]:
    xa = np.asarray(x, dtype=np.float64).reshape(-1)
    ya = np.asarray(y, dtype=np.float64).reshape(-1)
    if xa.size != ya.size:
        raise ValueError(f"length mismatch: {xa.size} vs {ya.size}")
    return xa, ya


def spearman(x, y) -> float:
    """Spearman's rho: Pearson correlation of midranks.  ``nan`` when
    either input is constant (or shorter than 2) — there is no
    ordering to correlate then."""
    xa, ya = _as_pair(x, y)
    if xa.size < 2:
        return float("nan")
    rx, ry = rankdata(xa), rankdata(ya)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return float("nan")
    return float(((rx - rx.mean()) * (ry - ry.mean())).mean() / (sx * sy))


def kendall(x, y) -> float:
    """Kendall's tau-b (tie-corrected): (concordant − discordant) /
    sqrt((n0 − tx)(n0 − ty)) over all pairs.  O(n²) — fidelity gates
    correlate tens-to-hundreds of candidates, not millions.  ``nan``
    when either input is constant."""
    xa, ya = _as_pair(x, y)
    n = xa.size
    if n < 2:
        return float("nan")
    dx = np.sign(xa[:, None] - xa[None, :])
    dy = np.sign(ya[:, None] - ya[None, :])
    iu = np.triu_indices(n, k=1)
    sx, sy = dx[iu], dy[iu]
    concordant_minus_discordant = float((sx * sy).sum())
    n0 = n * (n - 1) / 2.0
    tx = float((sx == 0).sum())
    ty = float((sy == 0).sum())
    denom = np.sqrt((n0 - tx) * (n0 - ty))
    if denom == 0.0:
        return float("nan")
    return concordant_minus_discordant / denom


def per_layer_spearman(predicted: np.ndarray, measured: np.ndarray,
                       layers: Sequence[str]) -> dict[str, float]:
    """Row-wise Spearman between two (n_layers, n_candidates) quality
    matrices, keyed by layer name — the per-layer fidelity report of
    the surrogate gates (ApproxGNN's evaluation protocol).  Layers
    whose measured column is constant come back ``nan``."""
    p = np.asarray(predicted, dtype=np.float64)
    m = np.asarray(measured, dtype=np.float64)
    if p.shape != m.shape or p.shape[0] != len(layers):
        raise ValueError(
            f"shape mismatch: predicted {p.shape}, measured {m.shape}, "
            f"{len(layers)} layers")
    return {name: spearman(p[j], m[j]) for j, name in enumerate(layers)}

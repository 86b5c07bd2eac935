"""Low-rank decomposability of the case-study multipliers (the port's
counterpart of ``benchmarks/rank_analysis.py``, DESIGN.md §4.2): for each
selected multiplier, the rank at which the factored LUT's emulation
error (decomposition MAE) falls below 10% of the circuit's own MAE — the
knob of the rank-R factored datapath (``mode="lowrank"``, kernel K9) —
and how well the circuit's own error ranks how hard its LUT is to
factor (Spearman and Kendall, ``approx.ranking``).

Host only (a float64 SVD a LUT); runs no kernel.

Run: ``PYTHONPATH=src python -m repro_torch.launch.rank_analysis``.
Prints ``name,us,derived`` lines as the reference does.
"""
from __future__ import annotations

import time
from typing import Callable

from ..approx.ranking import kendall, spearman
from ..core.library import get_default_library
from ..core.luts import rank_profile


def run(lib=None, log: Callable[[str], None] = print) -> dict:
    """The analysis on ``lib`` (default: the default library); returns
    each circuit's MAE, rank-1 and rank-4 decomposition MAE and needed
    rank, and the two correlations."""
    lib = lib if lib is not None else get_default_library()
    sel = lib.case_study_selection(per_metric=10)
    rows = []
    for e in sel:
        t0 = time.time()
        prof = rank_profile(lib.lut(e.name), 8)
        us = (time.time() - t0) * 1e6
        tol = max(0.25, 0.1 * e.errors.mae)
        need = next((p["rank"] for p in prof if p["mae"] <= tol), ">8")
        rows.append({"name": e.name, "circuit_mae": e.errors.mae,
                     "rank_needed": need, "mae_r1": prof[0]["mae"],
                     "mae_r4": prof[3]["mae"]})
        log(f"rank/{e.name},{us:.1f},circuit_mae={e.errors.mae:.3f};"
            f"rank_needed={need};mae_r1={prof[0]['mae']:.3f};"
            f"mae_r4={prof[3]['mae']:.3f}")
    # does the circuit's own error rank-predict how hard its LUT is to
    # decompose?
    circuit_mae = [r["circuit_mae"] for r in rows]
    r1_mae = [r["mae_r1"] for r in rows]
    out = {"circuits": rows,
           "spearman": spearman(circuit_mae, r1_mae),
           "kendall": kendall(circuit_mae, r1_mae)}
    log(f"rank/error_vs_rank1_correlation,0.0,"
        f"spearman={out['spearman']:.4f};kendall={out['kendall']:.4f};"
        f"n={len(sel)}")
    return out


if __name__ == "__main__":
    run()

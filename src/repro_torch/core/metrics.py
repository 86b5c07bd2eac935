"""Error metrics for approximate circuits (paper Sec. II-A, eqs. 1-6).

All metrics compare an approximate circuit's outputs against the exact
circuit over the full input space (exhaustive, used for <= 20 input
bits) or over a deterministic uniform sample (wider circuits, as in the
library's 32..128-bit entries where exhaustive simulation is infeasible
and the paper points to SAT/BDD analysis — we use sampling and label it).
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Optional

import numpy as np

from .netlist import (Netlist, exhaustive_inputs, random_input_planes,
                      unpack_outputs, unpack_outputs_object)

EXHAUSTIVE_LIMIT_BITS = 20
DEFAULT_SAMPLES = 1 << 18

METRIC_NAMES = ("er", "mae", "mse", "mre", "wce", "wcre")


@dataclass(frozen=True)
class ErrorReport:
    er: float      # error rate / error probability (eq. 1)
    mae: float     # mean absolute error (eq. 2)
    mse: float     # mean square error (eq. 3)
    mre: float     # mean relative error (eq. 4)
    wce: float     # worst-case error (eq. 5)
    wcre: float    # worst-case relative error (eq. 6)
    exhaustive: bool = True

    def as_dict(self) -> dict:
        return asdict(self)

    def get(self, name: str) -> float:
        return float(getattr(self, name))

    def as_vector(self) -> np.ndarray:
        """The six error statistics as a float64 vector in METRIC_NAMES
        order — the error-statistics block of the surrogate feature
        vector (DESIGN.md §2.11)."""
        return np.array([self.get(n) for n in METRIC_NAMES], dtype=np.float64)


def error_report_from_values(
    approx: np.ndarray, exact: np.ndarray, exhaustive: bool = True
) -> ErrorReport:
    if approx.dtype == object or exact.dtype == object:
        # exact big-int path (wide circuits): compute diffs exactly, then
        # convert to float for the statistics.
        diff_i = np.abs(approx - exact)
        diff = diff_i.astype(np.float64)
        denom = np.array([max(1, int(e)) for e in exact], dtype=np.float64)
    else:
        approx = np.asarray(approx, dtype=np.float64)
        exact = np.asarray(exact, dtype=np.float64)
        diff = np.abs(approx - exact)
        denom = np.maximum(1.0, exact)
    rel = diff / denom
    n = diff.size
    return ErrorReport(
        er=float((diff != 0).sum() / n),
        mae=float(diff.mean()),
        mse=float((diff * diff).mean()),
        mre=float(rel.mean()),
        wce=float(diff.max(initial=0.0)),
        wcre=float(rel.max(initial=0.0)),
        exhaustive=exhaustive,
    )


def _sample_inputs(n_i: int, num: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hi = 1 << min(n_i, 63)
    return rng.integers(0, hi, size=num, dtype=np.uint64)


def evaluate_errors(
    approx: Netlist,
    exact: Netlist,
    samples: Optional[int] = None,
    seed: int = 0,
) -> ErrorReport:
    """Compare two netlists with identical interfaces."""
    if approx.n_i != exact.n_i or approx.n_o != exact.n_o:
        raise ValueError("interface mismatch")
    n_i = approx.n_i
    if n_i <= EXHAUSTIVE_LIMIT_BITS and samples is None:
        planes = exhaustive_inputs(n_i)
        num = 1 << n_i
        a_out = unpack_outputs(approx.eval_words(planes), approx.n_o, num)
        e_out = unpack_outputs(exact.eval_words(planes), exact.n_o, num)
        return error_report_from_values(a_out, e_out, exhaustive=True)
    num = samples or DEFAULT_SAMPLES
    if n_i <= 63:
        vecs = _sample_inputs(n_i, num, seed)
        a_out = approx.eval_ints(vecs, widths=[n_i])
        e_out = exact.eval_ints(vecs, widths=[n_i])
        return error_report_from_values(a_out, e_out, exhaustive=False)
    # wide circuits (up to 2x128-bit operands): sample random bit planes
    # and compare with exact big-int arithmetic.
    num = min(num, 1 << 14)  # big-int unpack is python-speed
    rng = np.random.default_rng(seed)
    planes = random_input_planes(n_i, num, rng)
    a_out = unpack_outputs_object(approx.eval_words(planes), approx.n_o, num)
    e_out = unpack_outputs_object(exact.eval_words(planes), exact.n_o, num)
    return error_report_from_values(a_out, e_out, exhaustive=False)


def evaluate_errors_lut(lut_approx: np.ndarray, lut_exact: np.ndarray) -> ErrorReport:
    """Error report for full LUTs (exhaustive by construction)."""
    return error_report_from_values(
        lut_approx.reshape(-1), lut_exact.reshape(-1), exhaustive=True
    )


def wce_within(report: ErrorReport, e_min: float, e_max: float) -> bool:
    """Target error-range check used by single-objective CGP (Sec. II-C)."""
    return e_min <= report.wce <= e_max

"""Cartesian Genetic Programming engine (paper Sec. II-B/II-C).

(1+lambda) evolutionary strategy over integer netlists:
  (i)   select the best-scored circuit (the parent),
  (ii)  create lambda offspring by mutating h genes,
  (iii) evaluate, repeat.

Single-objective mode (Sec. II-C): minimize circuit cost (weighted gate
area) subject to the chosen error metric staying within [e_min, e_max].
Running the engine across a ladder of e_max values yields the library's
power x error trade-off curve; a Pareto archive collects all
non-dominated (power, error) points seen during every run.

Evaluation cost is dominated by circuit simulation, so during the search
we simulate a fixed subsample of the input space (fast, fitness-rank
faithful) and re-evaluate exhaustively before a circuit is admitted to
the archive — mirroring how the paper separates search-time fitness from
final verification.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from . import gates
from .cost import evaluate_cost
from .metrics import (ErrorReport, error_report_from_values,
                      evaluate_errors, METRIC_NAMES)
from .netlist import (Netlist, exhaustive_inputs, pack_operands,
                      random_input_planes, unpack_outputs,
                      unpack_outputs_object)


@dataclass
class CgpParams:
    lam: int = 4                  # lambda offspring per generation
    h: int = 5                    # mutated genes per offspring (paper: h=5)
    generations: int = 300
    metric: str = "mae"           # error metric constrained during search
    e_max: float = 0.0            # upper bound on the metric
    e_min: float = 0.0
    search_samples: int = 8192    # subsampled vectors during search
    seed: int = 0


@dataclass
class EvolvedCircuit:
    netlist: Netlist
    errors: ErrorReport
    cost_area: float
    cost_power: float


def search_planes(n_i: int, search_samples: int,
                  rng: np.random.Generator):
    """Search-time input sample as bit-planes: ``(planes, num)``.

    Exhaustive when the 2^n_i space fits ``search_samples`` (n_i <= 24),
    a sorted without-replacement subsample when it doesn't, and for
    wider circuits uniform random *bit-planes* over exactly the n_i-bit
    domain.  The plane-based wide path replaces the old 63-bit integer
    draw, which never exercised input bits >= 63 (bit 63 of a 64-bit
    operand pair was constant zero, and every plane past bit 63 was
    silently dropped by the uint64 shift in ``pack_operands``).
    """
    space = 1 << n_i if n_i <= 24 else None
    if space is not None and space <= search_samples:
        vecs = np.arange(space, dtype=np.uint64)
        return pack_operands([vecs], [n_i]), space
    if space is not None:
        vecs = rng.choice(space, size=search_samples, replace=False)
        vecs = np.sort(vecs).astype(np.uint64)
        return pack_operands([vecs], [n_i]), search_samples
    return random_input_planes(n_i, search_samples, rng), search_samples


def unpack_values(planes: np.ndarray, n_o: int, num: int) -> np.ndarray:
    """Output planes -> float64 values; exact uint64 unpack for
    n_o <= 64, big-int (object) unpack beyond that."""
    if n_o <= 64:
        return unpack_outputs(planes, n_o, num).astype(np.float64)
    return unpack_outputs_object(planes, n_o, num).astype(np.float64)


class _Evaluator:
    """Caches exact outputs; scores candidates on a fixed vector subset."""

    def __init__(self, exact: Netlist, params: CgpParams):
        self.exact = exact
        self.n_i = exact.n_i
        self.metric = params.metric
        if self.metric not in METRIC_NAMES:
            raise ValueError(f"unknown metric {self.metric}")
        rng = np.random.default_rng(params.seed + 7919)
        self.planes, self.num = search_planes(
            self.n_i, params.search_samples, rng)
        self.exact_vals = unpack_values(
            exact.eval_words(self.planes), exact.n_o, self.num)

    def error_of(self, cand: Netlist) -> float:
        vals = unpack_values(
            cand.eval_words(self.planes), cand.n_o, self.num)
        rep = error_report_from_values(vals, self.exact_vals, exhaustive=False)
        return rep.get(self.metric)


def mutate(nl: Netlist, rng: np.random.Generator, h: int) -> Netlist:
    """Point-mutate h genes; always produces a valid netlist."""
    funcs = nl.funcs.copy()
    in0 = nl.in0.copy()
    in1 = nl.in1.copy()
    outputs = nl.outputs.copy()
    n, n_i, n_o = nl.n_nodes, nl.n_i, nl.n_o
    n_genes = 3 * n + n_o
    for g in rng.integers(0, n_genes, size=h):
        g = int(g)
        if g < n:  # function gene
            funcs[g] = rng.integers(0, gates.N_FUNCS)
        elif g < 2 * n:  # in0 gene
            j = g - n
            in0[j] = rng.integers(0, n_i + j) if (n_i + j) > 0 else 0
        elif g < 3 * n:  # in1 gene
            j = g - 2 * n
            in1[j] = rng.integers(0, n_i + j) if (n_i + j) > 0 else 0
        else:  # output gene
            outputs[g - 3 * n] = rng.integers(0, n_i + n)
    return Netlist(n_i=n_i, n_o=n_o, funcs=funcs, in0=in0, in1=in1,
                   outputs=outputs, name=nl.name)


@dataclass(order=True)
class _Score:
    """Lexicographic: feasibility first, then cost (feasible) or error."""
    infeasible: float
    primary: float


def _score(error: float, cost_area: float, e_min: float, e_max: float) -> _Score:
    if e_min <= error <= e_max:
        return _Score(0.0, cost_area)
    # infeasible: drive error toward the window
    gap = error - e_max if error > e_max else e_min - error
    return _Score(1.0, gap)


def evolve(
    seed_netlist: Netlist,
    exact: Netlist,
    params: CgpParams,
    on_candidate: Optional[Callable[[Netlist, float, float], None]] = None,
) -> EvolvedCircuit:
    """Single-objective (1+lambda) run. Returns the best feasible circuit
    (falls back to the seed if nothing feasible was found).

    on_candidate(netlist, error, area) is called for every *improved*
    parent — the Pareto archive hooks in here.
    """
    rng = np.random.default_rng(params.seed)
    ev = _Evaluator(exact, params)

    parent = seed_netlist
    p_err = ev.error_of(parent)
    p_cost = evaluate_cost(parent)
    p_score = _score(p_err, p_cost.area, params.e_min, params.e_max)
    best_feasible: Optional[Netlist] = parent if p_score.infeasible == 0 else None

    for _gen in range(params.generations):
        improved = False
        for _k in range(params.lam):
            child = mutate(parent, rng, params.h)
            c_err = ev.error_of(child)
            c_area = evaluate_cost(child).area
            c_score = _score(c_err, c_area, params.e_min, params.e_max)
            if c_score <= p_score:  # allow neutral drift
                if c_score < p_score:
                    improved = True
                parent, p_err, p_score = child, c_err, c_score
                if c_score.infeasible == 0:
                    best_feasible = child
        if improved and on_candidate is not None and p_score.infeasible == 0:
            on_candidate(parent, p_err, evaluate_cost(parent).area)

    final = best_feasible if best_feasible is not None else seed_netlist
    final = final.compact()
    errors = evaluate_errors(final, exact)
    cost = evaluate_cost(final)
    return EvolvedCircuit(netlist=final, errors=errors,
                          cost_area=cost.area, cost_power=cost.power)


def pad_nodes(nl: Netlist, n_total: int, seed: int = 0) -> Netlist:
    """Append inactive random nodes up to ``n_total`` (CGP benefits from
    neutral genetic material; compacted seeds would otherwise starve)."""
    n, n_i = nl.n_nodes, nl.n_i
    if n >= n_total:
        return nl
    rng = np.random.default_rng(seed)
    extra = n_total - n
    funcs = np.concatenate([nl.funcs,
                            rng.integers(0, gates.N_FUNCS, extra)])
    lim = n_i + n + np.arange(extra)
    in0 = np.concatenate([nl.in0, rng.integers(0, lim)])
    in1 = np.concatenate([nl.in1, rng.integers(0, lim)])
    return Netlist(n_i=n_i, n_o=nl.n_o, funcs=funcs.astype(np.int32),
                   in0=in0.astype(np.int32), in1=in1.astype(np.int32),
                   outputs=nl.outputs, name=nl.name)


def dominates(p: tuple, q: tuple) -> bool:
    """p dominates q (minimization, paper Sec. II-C definition)."""
    return all(a <= b for a, b in zip(p, q)) and any(a < b for a, b in zip(p, q))


class ParetoArchive:
    """Archive of non-dominated points (minimization on every objective)."""

    def __init__(self):
        self.points: list[tuple] = []
        self.payloads: list = []

    def add(self, point: tuple, payload) -> bool:
        for q in self.points:
            if dominates(q, point) or q == point:
                return False
        keep = [i for i, q in enumerate(self.points) if not dominates(point, q)]
        self.points = [self.points[i] for i in keep] + [point]
        self.payloads = [self.payloads[i] for i in keep] + [payload]
        return True

    def __len__(self) -> int:
        return len(self.points)

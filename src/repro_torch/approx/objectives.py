"""Objective registry: named DSE axes with direction and provenance
(DESIGN.md §2.7).

The paper's library "forms Pareto fronts with respect to several error
metrics, power consumption and other circuit parameters" — an axis of a
design-space exploration is therefore a *named* quantity with a
direction (maximize or minimize) and a provenance:

  * ``workload`` — measured by running the model (accuracy, logit MAE,
    perplexity, ...; a ``repro.approx.workload.Workload`` registers its
    metrics here when constructed).  Surrogate/predicted metrics (the
    ApproxGNN discipline) register exactly the same way — provenance is
    a label, not a dispatch mechanism, so predicted axes slot in where
    measured ones go.
  * ``cost`` — derived from the library's gate-level cost model
    (``power``, ``area``, ``delay``; DESIGN.md §4.4), threaded onto
    design points by the resilience sweeps.
  * ``library`` — the library's circuit-level error statistics
    (``er``/``mae``/``mse``/``mre``/``wce``/``wcre``, paper Sec. II-A),
    read off the design point's ``errors`` dict.

``pareto_points`` computes the non-dominated front over ANY tuple of
registered axes (N-dimensional); for the legacy 2-axis
``("accuracy", "power")`` case it is bit-identical — values AND order —
to the historical accuracy-max/power-min sweep in ``repro.approx.dse``.
``select`` is the declarative endpoint:

    select(result, constraints={"accuracy": MaxDrop(0.01)},
           minimize="power")

Everything here is duck-typed over design points (``metrics``/
``costs``/``errors`` dicts plus the legacy ``accuracy``/
``network_rel_power`` scalars), so it imports nothing from the DSE
layer and surrogate result types can participate unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional, Sequence, Union

DIRECTIONS = ("max", "min")
SOURCES = ("workload", "cost", "library")


class UnknownObjectiveError(KeyError):
    """Objective name not in the registry (carries the known names)."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(
            f"unknown objective {name!r}; registered axes: "
            f"{available_objectives()} — workload metrics register "
            "automatically when the Workload is constructed, or call "
            "repro_torch.approx.objectives.ensure_objective(name, direction)")

    def __str__(self) -> str:  # KeyError.__str__ would repr() the message
        return self.args[0]


@dataclass(frozen=True)
class Objective:
    """One named DSE axis.

    ``getter`` extracts the axis value from a design point; it is the
    FALLBACK — a value measured into the point's ``metrics`` dict under
    this name always wins (see ``value_of``), which is how a workload
    metric that shadows a library statistic name stays the measured
    quantity."""

    name: str
    direction: str                       # "max" | "min"
    source: str                          # "workload" | "cost" | "library"
    getter: Optional[Callable[[Any], float]] = None

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction must be one of {DIRECTIONS}, "
                             f"got {self.direction!r}")
        if self.source not in SOURCES:
            raise ValueError(f"source must be one of {SOURCES}, "
                             f"got {self.source!r}")

    @property
    def sign(self) -> float:
        """Multiplier turning the axis into minimize-convention."""
        return 1.0 if self.direction == "min" else -1.0


_REGISTRY: dict[str, Objective] = {}


def register_objective(obj: Objective, overwrite: bool = False) -> Objective:
    if not overwrite and obj.name in _REGISTRY:
        existing = _REGISTRY[obj.name]
        if existing.direction != obj.direction:
            raise ValueError(
                f"objective {obj.name!r} already registered with "
                f"direction {existing.direction!r} (tried "
                f"{obj.direction!r}); pass overwrite=True to replace")
        return existing
    _REGISTRY[obj.name] = obj
    return obj


def ensure_objective(name: str, direction: str,
                     source: str = "workload") -> Objective:
    """Idempotent registration — the hook Workload adapters (and
    surrogate models) use to declare their metric axes.  Re-ensuring
    with a conflicting direction raises; a matching one is a no-op."""
    return register_objective(Objective(name=name, direction=direction,
                                        source=source))


def get_objective(name: str) -> Objective:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownObjectiveError(name) from None


def available_objectives() -> list[str]:
    return sorted(_REGISTRY)


def value_of(point: Any, name: str) -> float:
    """Extract axis ``name`` from a design point.

    Resolution order: (1) the point's workload-measured ``metrics``
    dict (a measured value always wins), (2) the registered objective's
    source-specific getter.  Raises ``UnknownObjectiveError`` for
    unregistered names and a descriptive ``KeyError`` when the point
    simply does not carry the axis."""
    metrics = getattr(point, "metrics", None)
    if metrics and name in metrics:
        return float(metrics[name])
    obj = get_objective(name)
    if obj.getter is None:
        raise KeyError(
            f"objective {obj.name!r} ({obj.source}) was not measured "
            f"into this point's metrics ({sorted(metrics or {})}) and "
            "has no derived getter")
    return float(obj.getter(point))


# ----------------------------------------------------------------------
# Built-in axes
# ----------------------------------------------------------------------
def _accuracy_getter(point):
    metrics = getattr(point, "metrics", None)
    if metrics:
        # the point WAS measured, by a workload that produced no
        # "accuracy" metric — its scalar ``accuracy`` column aliases a
        # DIFFERENT (possibly minimize-direction) primary, and reading
        # it as accuracy-max would silently invert the axis
        raise KeyError(
            "'accuracy' was not among this point's measured metrics "
            f"({sorted(metrics)}); name the workload's own metrics as "
            "objectives instead")
    # pre-§2.7 points (no metrics dict) carry accuracy in the scalar
    return point.accuracy


def _power_getter(point):
    return point.network_rel_power


def _cost_getter(name: str):
    def get(point):
        costs = getattr(point, "costs", None) or {}
        if name not in costs:
            raise KeyError(
                f"cost axis {name!r} is not on this point (has "
                f"{sorted(costs)}); area/delay are threaded by the "
                "resilience sweeps — points built by hand or loaded "
                "from pre-§2.7 JSON lack them")
        return costs[name]
    return get


def _library_getter(name: str):
    def get(point):
        errors = getattr(point, "errors", None) or {}
        if name not in errors:
            raise KeyError(
                f"library error statistic {name!r} is not on this "
                f"point (has {sorted(errors)}); heterogeneous points "
                "mix circuits and carry no single-circuit error stats")
        return errors[name]
    return get


register_objective(Objective("accuracy", "max", "workload",
                             getter=_accuracy_getter))
register_objective(Objective("power", "min", "cost", getter=_power_getter))
register_objective(Objective("area", "min", "cost",
                             getter=_cost_getter("area")))
register_objective(Objective("delay", "min", "cost",
                             getter=_cost_getter("delay")))
for _stat in ("er", "mae", "mse", "mre", "wce", "wcre"):
    register_objective(Objective(_stat, "min", "library",
                                 getter=_library_getter(_stat)))


# ----------------------------------------------------------------------
# N-dimensional Pareto front
# ----------------------------------------------------------------------
def _resolve(objectives) -> list[Objective]:
    out = []
    for o in objectives:
        out.append(o if isinstance(o, Objective) else get_objective(o))
    if not out:
        raise ValueError("need at least one objective")
    return out


def pareto_points(points: Sequence[Any],
                  objectives: Sequence[Union[str, Objective]] = (
                      "accuracy", "power")) -> list:
    """Non-dominated subset of ``points`` over named ``objectives``.

    Dominance is the standard weak form: ``q`` dominates ``p`` when it
    is at least as good on every axis and strictly better on one, each
    axis compared in its registered direction.  Ties on ALL axes are
    mutually non-dominating and all kept.

    The returned front is ordered by the signed axis values from the
    LAST objective to the first — for the legacy 2-axis
    ``("accuracy", "power")`` call this is (power ascending, accuracy
    descending), bit-identical (membership AND order) to the historical
    sweep in ``repro.approx.dse.pareto_points``.  Complexity is
    O(n² · k); sweep fronts are hundreds of points, not millions.
    """
    objs = _resolve(objectives)
    pts = list(points)
    vals = [tuple(o.sign * value_of(p, o.name) for o in objs)
            for p in pts]

    def dominated(i: int) -> bool:
        vi = vals[i]
        for j, vj in enumerate(vals):
            if j == i:
                continue
            if all(a <= b for a, b in zip(vj, vi)) \
                    and any(a < b for a, b in zip(vj, vi)):
                return True
        return False

    front = [i for i in range(len(pts)) if not dominated(i)]
    front.sort(key=lambda i: tuple(reversed(vals[i])))
    return [pts[i] for i in front]


# ----------------------------------------------------------------------
# Declarative selection
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class MaxDrop:
    """Within ``drop`` of the exploration's baseline value for the
    axis, in the axis's own direction: a max-axis value may fall at
    most ``drop`` below the baseline, a min-axis value may rise at most
    ``drop`` above it (the paper's accuracy-budget constraint,
    generalized)."""
    drop: float


@dataclass(frozen=True)
class AtLeast:
    bound: float


@dataclass(frozen=True)
class AtMost:
    bound: float


Constraint = Union[MaxDrop, AtLeast, AtMost, float, int]


def _baseline_value(result, name: str) -> float:
    if result is None:
        raise ValueError(
            f"MaxDrop({name!r}) is relative to an exploration baseline "
            "— pass the ExploreResult (satisfies(..., result=...)) or "
            "use the absolute AtLeast/AtMost constraints")
    baseline = getattr(result, "baseline_metrics", None) or {}
    if name in baseline:
        return float(baseline[name])
    primary = getattr(result, "primary", "accuracy")
    if name in ("accuracy", primary):
        return float(result.baseline_accuracy)
    if name == "power":
        return 1.0          # golden datapath power, by convention
    raise ValueError(
        f"MaxDrop({name!r}) needs a baseline value, but the result's "
        f"baseline_metrics has only {sorted(baseline)} — use "
        "AtLeast/AtMost for axes the baseline run does not measure")


def satisfies(point: Any, name: str, constraint: Constraint,
              result=None) -> bool:
    """True when ``point`` meets ``constraint`` on axis ``name``.  A
    bare number is shorthand for ``MaxDrop(number)``."""
    if isinstance(constraint, (int, float)):
        constraint = MaxDrop(float(constraint))
    v = value_of(point, name)
    if isinstance(constraint, AtLeast):
        return v >= constraint.bound
    if isinstance(constraint, AtMost):
        return v <= constraint.bound
    if isinstance(constraint, MaxDrop):
        base = _baseline_value(result, name)
        if get_objective(name).direction == "max":
            return v >= base - constraint.drop
        return v <= base + constraint.drop
    raise TypeError(f"not a constraint: {constraint!r}")


def select(result, constraints: Optional[Mapping[str, Constraint]] = None,
           minimize: Optional[str] = None,
           maximize: Optional[str] = None,
           axis: str = "combined"):
    """Declarative DSE endpoint over an ``ExploreResult``-shaped object:
    among the points of ``axis`` ("all_layers", "per_layer",
    "heterogeneous", or "combined" = uniform ∪ heterogeneous) that
    satisfy every constraint, the one optimizing ``minimize`` /
    ``maximize`` (exactly one must be given).  Ties break toward better
    constraint-axis values in declaration order — with
    ``constraints={"accuracy": MaxDrop(d)}, minimize="power"`` this
    reproduces the paper's ``select_multiplier`` endpoint exactly.
    Returns ``None`` when no point qualifies.
    """
    if (minimize is None) == (maximize is None):
        raise ValueError("pass exactly one of minimize= / maximize=")
    target = get_objective(minimize if minimize is not None else maximize)
    sign = 1.0 if minimize is not None else -1.0
    constraints = dict(constraints or {})
    for name in constraints:
        get_objective(name)             # fail fast on unknown axes

    if axis == "combined":
        points = list(result.all_layers) + list(result.heterogeneous)
    else:
        points = list(getattr(result, axis))
    ok = [p for p in points
          if all(satisfies(p, n, c, result)
                 for n, c in constraints.items())]
    if not ok:
        return None

    tie_axes = [get_objective(n) for n in constraints if n != target.name]

    def key(p):
        return ((sign * value_of(p, target.name),)
                + tuple(o.sign * value_of(p, o.name) for o in tie_axes))

    return min(ok, key=key)

"""autoAx-style design-space exploration facade (port of
``repro.approx.dse``, DESIGN.md §2.3).

The paper's workflow — library → Pareto selection → per-layer resilience
sweep → pick the multiplier for the application — as one call, in the
spirit of autoAx (Mrazek et al., 2019: automated search of approximate
circuits for a quality bound):

    result = explore(eval_fn, layer_counts, library,
                     quality_bound=0.01)
    point = select_multiplier(result, max_accuracy_drop=0.01)
    policy = point.policy()          # ship it: policy.to_json()

``explore`` runs the per-layer (Fig. 4) and all-layers (Table II)
sweeps on top of ``approx.resilience`` with a policy-keyed eval
cache, so repeated explorations (and the shared exact baseline) never
re-evaluate the same configuration; backend materialization is cached
per (library, spec).

The heterogeneous two-stage search (``explore_heterogeneous``) is
not ported yet (ROADMAP.md Queue 1); ``ExploreResult`` keeps its
``heterogeneous`` axis so results move between the packages as JSON.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence

from . import objectives as objectives_mod
from .layers import ApproxPolicy
from .objectives import get_objective
from .resilience import (ResilienceRow, all_layers_sweep, can_bank,
                         per_layer_sweep)
from .specs import BackendSpec
from .workload import Workload, as_workload

DEFAULT_OBJECTIVES = ("accuracy", "power")


@dataclass(frozen=True)
class DesignPoint:
    """One evaluated configuration of the design space.

    Uniform points set ``layer`` to a layer name or "all";
    heterogeneous points set ``layer="hetero"`` and carry the full
    per-layer composition in ``assignment`` (layer name -> multiplier
    name, ordered).

    ``metrics`` holds every named workload quality metric measured at
    this point; ``accuracy`` is the legacy scalar alias for the
    workload's PRIMARY metric (DESIGN.md §2.7).  ``costs`` holds the
    library-derived area/delay axes next to the power columns, so
    objective tuples like ``("accuracy", "power", "delay")`` resolve
    off the point alone."""
    multiplier: str
    layer: str                  # layer name, "all", or "hetero"
    accuracy: float
    network_rel_power: float
    multiplier_rel_power: float
    mult_share: float
    spec: Optional[BackendSpec] = None
    errors: dict = field(default_factory=dict)
    assignment: Optional[tuple[tuple[str, str], ...]] = None
    # datapath the assignment was VERIFIED under; policy() reproduces it
    mode: str = "lut"
    variant: str = "ref"
    metrics: dict = field(default_factory=dict)
    costs: dict = field(default_factory=dict)

    @staticmethod
    def from_row(r: ResilienceRow) -> "DesignPoint":
        return DesignPoint(
            multiplier=r.multiplier, layer=r.layer, accuracy=r.accuracy,
            network_rel_power=r.network_rel_power,
            multiplier_rel_power=r.multiplier_rel_power,
            mult_share=r.mult_share, spec=r.spec, errors=dict(r.errors),
            metrics=dict(r.metrics), costs=dict(r.costs))

    def policy(self, base: Optional[BackendSpec] = None) -> ApproxPolicy:
        """Deployable policy for this point: the multiplier everywhere
        ("all"), one override per assigned layer ("hetero", on the
        ``mode``/``variant`` datapath the point was verified under), or
        only the swept layer over an exact base."""
        if self.assignment is not None:
            return ApproxPolicy(
                default=base or BackendSpec.golden(),
                overrides=[(layer, BackendSpec(mode=self.mode,
                                               multiplier=m,
                                               variant=self.variant))
                           for layer, m in self.assignment])
        spec = self.spec or BackendSpec(mode="lut",
                                        multiplier=self.multiplier)
        if self.layer == "all":
            return ApproxPolicy(default=spec)
        return ApproxPolicy(default=base or BackendSpec.golden(),
                            overrides=[(self.layer, spec)])

    def to_dict(self) -> dict:
        return {
            "multiplier": self.multiplier, "layer": self.layer,
            "accuracy": self.accuracy,
            "network_rel_power": self.network_rel_power,
            "multiplier_rel_power": self.multiplier_rel_power,
            "mult_share": self.mult_share,
            "spec": self.spec.to_dict() if self.spec else None,
            "errors": dict(self.errors),
            "assignment": (dict(self.assignment)
                           if self.assignment is not None else None),
            "mode": self.mode, "variant": self.variant,
            "metrics": dict(self.metrics),
            "costs": dict(self.costs),
        }

    @staticmethod
    def from_dict(d: Mapping) -> "DesignPoint":
        """Inverse of ``to_dict`` (accepts pre-§2.7 dicts without
        metrics/costs)."""
        assignment = d.get("assignment")
        return DesignPoint(
            multiplier=d["multiplier"], layer=d["layer"],
            accuracy=float(d["accuracy"]),
            network_rel_power=float(d["network_rel_power"]),
            multiplier_rel_power=float(d["multiplier_rel_power"]),
            mult_share=float(d["mult_share"]),
            spec=(BackendSpec.from_dict(d["spec"])
                  if d.get("spec") else None),
            errors=dict(d.get("errors") or {}),
            assignment=(tuple(assignment.items())
                        if assignment is not None else None),
            mode=d.get("mode", "lut"), variant=d.get("variant", "ref"),
            metrics=dict(d.get("metrics") or {}),
            costs=dict(d.get("costs") or {}))


def pareto_points(points: list[DesignPoint],
                  objectives: Optional[Sequence[str]] = None
                  ) -> list[DesignPoint]:
    """Non-dominated front over named ``objectives`` (default: the
    legacy accuracy-max / network-power-min pair).  Delegates to the
    N-dimensional ``objectives.pareto_points``, whose
    2-axis default is bit-identical — membership AND order — to the
    historical sweep here (ties on all axes are mutually
    non-dominating and all kept, matching
    ``ApproxLibrary.pareto_front`` semantics)."""
    return objectives_mod.pareto_points(
        points, objectives if objectives is not None
        else DEFAULT_OBJECTIVES)


@dataclass
class ExploreResult:
    """DSE result: axes of measured design points over one workload.

    ``baseline_metrics`` carries EVERY metric the workload measured on
    the golden datapath; ``baseline_accuracy`` is the legacy scalar
    alias for the PRIMARY one (``primary``, direction-aware through
    the objectives registry).  ``objectives`` records the axis tuple
    the exploration was asked to Pareto over — ``pareto()`` uses it by
    default."""

    baseline_accuracy: float            # exact int8 golden datapath
    all_layers: list[DesignPoint] = field(default_factory=list)
    per_layer: list[DesignPoint] = field(default_factory=list)
    heterogeneous: list[DesignPoint] = field(default_factory=list)
    selected: Optional[DesignPoint] = None
    baseline_metrics: dict = field(default_factory=dict)
    objectives: tuple = DEFAULT_OBJECTIVES
    primary: str = "accuracy"
    # surrogate predict-stage record (DESIGN.md §2.11): training split,
    # calibration band, fidelity diagnostics.  None on exact-predict
    # explorations — and absent from their JSON, so pre-surrogate
    # round-trips stay byte-identical.
    surrogate: Optional[dict] = None

    def _primary_direction(self) -> str:
        try:
            return get_objective(self.primary).direction
        except KeyError:
            return "max"

    def _primary_value(self, p: DesignPoint) -> float:
        return float(p.metrics.get(self.primary, p.accuracy))

    def pareto(self, axis: str = "all_layers",
               objectives: Optional[Sequence[str]] = None
               ) -> list[DesignPoint]:
        """Non-dominated front of one axis ("all_layers",
        "heterogeneous") or of their union ("combined"), over
        ``objectives`` (default: the exploration's own tuple)."""
        objs = tuple(objectives) if objectives is not None \
            else self.objectives
        if axis == "combined":
            return pareto_points(self.all_layers + self.heterogeneous,
                                 objs)
        return pareto_points(getattr(self, axis), objs)

    def within(self, max_accuracy_drop: float,
               axis: str = "all_layers") -> list[DesignPoint]:
        """Points whose PRIMARY metric stays within
        ``max_accuracy_drop`` of the baseline, in the primary's own
        direction (a min-primary like logit-MAE may RISE at most that
        much)."""
        pts = (self.all_layers + self.heterogeneous
               if axis == "combined" else getattr(self, axis))
        if self._primary_direction() == "min":
            ceiling = self.baseline_accuracy + max_accuracy_drop
            return [p for p in pts if self._primary_value(p) <= ceiling]
        floor = self.baseline_accuracy - max_accuracy_drop
        return [p for p in pts if self._primary_value(p) >= floor]

    def to_json_dict(self) -> dict:
        # persist the DIRECTIONS of the axes this result reasons with:
        # workload metrics only register when their Workload is
        # constructed, so a restoring process would otherwise fall
        # back to "max" for a min-primary (logit MAE, perplexity) and
        # silently invert every quality bound
        directions = {}
        for name in (*self.objectives, self.primary,
                     *self.baseline_metrics):
            try:
                directions[name] = get_objective(name).direction
            except KeyError:
                pass
        out = {
            "baseline_accuracy": self.baseline_accuracy,
            "all_layers": [p.to_dict() for p in self.all_layers],
            "per_layer": [p.to_dict() for p in self.per_layer],
            "heterogeneous": [p.to_dict() for p in self.heterogeneous],
            "selected": self.selected.to_dict() if self.selected else None,
            "baseline_metrics": dict(self.baseline_metrics),
            "objectives": list(self.objectives),
            "primary": self.primary,
            "objective_directions": directions,
        }
        if self.surrogate is not None:
            out["surrogate"] = dict(self.surrogate)
        return out

    @staticmethod
    def from_json_dict(d: Mapping) -> "ExploreResult":
        """Inverse of ``to_json_dict`` (accepts pre-§2.7 dicts):
        ``ExploreResult.from_json_dict(json.loads(blob))`` restores a
        shipped exploration, round-tripping every design point and
        re-registering the axes' directions so ``pareto``/``within``/
        ``select`` behave identically in a fresh process (a conflicting
        live registration raises rather than silently winning)."""
        from .objectives import ensure_objective
        for name, direction in (d.get("objective_directions")
                                or {}).items():
            ensure_objective(name, direction)
        return ExploreResult(
            baseline_accuracy=float(d["baseline_accuracy"]),
            all_layers=[DesignPoint.from_dict(p)
                        for p in d.get("all_layers", [])],
            per_layer=[DesignPoint.from_dict(p)
                       for p in d.get("per_layer", [])],
            heterogeneous=[DesignPoint.from_dict(p)
                           for p in d.get("heterogeneous", [])],
            selected=(DesignPoint.from_dict(d["selected"])
                      if d.get("selected") else None),
            baseline_metrics=dict(d.get("baseline_metrics") or {}),
            objectives=tuple(d.get("objectives") or DEFAULT_OBJECTIVES),
            primary=d.get("primary", "accuracy"),
            surrogate=(dict(d["surrogate"])
                       if d.get("surrogate") is not None else None))


def _seed_cache(cache: dict, rows: list[ResilienceRow], golden) -> None:
    """Store batched-sweep results under the SAME policy cache keys the
    sequential path would use, so later sequential (or widened)
    explorations over the same cache dict hit instead of re-running.
    Cache values are metric DICTS (the ``Workload.cached`` convention,
    DESIGN.md §2.7)."""
    for r in rows:
        if r.spec is None:
            continue
        if r.layer == "all":
            policy = ApproxPolicy(default=r.spec)
        else:
            policy = ApproxPolicy(default=golden,
                                  overrides=[(r.layer, r.spec)])
        cache.setdefault(policy.cache_key(), dict(r.metrics))


def explore(
    eval_fn: Optional[Callable[[ApproxPolicy], float]] = None,
    layer_counts: Optional[dict[str, int]] = None,
    library=None,
    multipliers: Optional[list[str]] = None,
    mode: str = "lut",
    variant: str = "ref",
    quality_bound: Optional[float] = None,
    per_layer: bool = True,
    all_layers: bool = True,
    cache: Optional[dict] = None,
    batch: bool = False,
    rel_power=None,
    workload: Optional[Workload] = None,
    objectives: Optional[Sequence[str]] = None,
) -> ExploreResult:
    """One-call DSE: baseline + Table II + Fig. 4 sweeps over the
    library's case-study multipliers (or ``multipliers``), with cached
    evaluations.

    Sequential (default) evaluation runs one ``eval_fn`` call per design
    point through a policy-keyed cache: pass the same ``cache`` dict
    across calls to resume or widen an exploration without re-running
    finished points.

    ``batch=True`` switches to the batched resilience engine: the
    multiplier axis is packed into a ``LutBank`` and each sweep runs as
    one banked pass of the model (``approx.layers.bank_eval``), with
    accuracies equal to the sequential path's.  Batching needs an eval
    with a tensor core (a ``Workload`` or ``BankableEval``) and a
    bankable datapath; anything else falls back to the sequential path,
    as in the reference.  A batched sweep writes every result back into
    ``cache`` under sequential-compatible keys.

    Pass a ``workload=`` instead of ``eval_fn`` and optionally
    ``objectives=`` naming the axes to Pareto over; ``layer_counts``
    defaults to the workload's own.  If ``quality_bound`` is given,
    ``result.selected`` is the lowest-power all-layers point whose
    PRIMARY metric stays within that drop (direction-aware).
    """
    wl = as_workload(workload if workload is not None else eval_fn)
    if layer_counts is None:
        layer_counts = wl.layer_counts
        if layer_counts is None:
            raise TypeError(
                "explore() needs layer_counts (the workload carries "
                "none)")
    if objectives is not None:
        for name in objectives:
            get_objective(name)             # fail fast on unknown axes
    if library is None:
        from ..core.library import get_default_library
        library = get_default_library()
    if multipliers is None:
        multipliers = [e.name for e in library.case_study_selection()]
    cache = cache if cache is not None else {}
    run = wl.cached(cache)
    batch = batch and can_bank(wl, mode, variant)

    golden = BackendSpec.golden().materialize()
    baseline_metrics = run.measure(ApproxPolicy(default=golden))

    result = ExploreResult(
        baseline_accuracy=baseline_metrics[wl.primary],
        baseline_metrics=baseline_metrics,
        objectives=(tuple(objectives) if objectives is not None
                    else (wl.primary, "power")),
        primary=wl.primary)
    if all_layers:
        rows = all_layers_sweep(wl if batch else run, layer_counts,
                                multipliers, library, mode=mode,
                                variant=variant, batch=batch,
                                rel_power=rel_power)
        if batch:
            _seed_cache(cache, rows, golden)
        result.all_layers = [DesignPoint.from_row(r) for r in rows]
    if per_layer:
        rows = per_layer_sweep(wl if batch else run, layer_counts,
                               multipliers, library, mode=mode,
                               base=golden, variant=variant, batch=batch,
                               rel_power=rel_power)
        if batch:
            _seed_cache(cache, rows, golden)
        result.per_layer = [DesignPoint.from_row(r) for r in rows]
    if quality_bound is not None and result.all_layers:
        result.selected = select_multiplier(result, quality_bound)
    return result


def select_multiplier(result: ExploreResult,
                      max_accuracy_drop: float,
                      baseline: Optional[float] = None
                      ) -> Optional[DesignPoint]:
    """The paper's endpoint: the lowest-power circuit whose all-layers
    PRIMARY metric stays within ``max_accuracy_drop`` of the golden
    int8 baseline (direction-aware: a min-primary may rise at most
    that much).  Returns None when no candidate meets the bound.  The
    declarative generalization is ``objectives.select``,
    which this delegates to.
    """
    return objectives_mod.select(
        result,
        constraints={result.primary: _budget(result, max_accuracy_drop,
                                             baseline)},
        minimize="power", axis="all_layers")


def _budget(result: ExploreResult, drop: float,
            baseline: Optional[float] = None):
    """``max_accuracy_drop`` as an absolute constraint on the result's
    primary axis, in its own direction (absolute — not ``MaxDrop`` —
    so an explicit ``baseline`` override is honored)."""
    base = (baseline if baseline is not None
            else result.baseline_accuracy)
    if result._primary_direction() == "min":
        return objectives_mod.AtMost(base + drop)
    return objectives_mod.AtLeast(base - drop)


def select_point(result: ExploreResult, max_accuracy_drop: float,
                 axis: str = "combined") -> Optional[DesignPoint]:
    """Generalized endpoint over any result axis (default: uniform ∪
    heterogeneous): the lowest-power verified point within the
    (direction-aware) primary-metric budget."""
    return objectives_mod.select(
        result,
        constraints={result.primary: _budget(result, max_accuracy_drop)},
        minimize="power", axis=axis)

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

``explore_heterogeneous`` goes beyond the paper's single-multiplier
endpoint: a two-stage autoAx-style search that composes a DIFFERENT
multiplier per layer (prediction from per-layer component models +
layer-wise Pareto pruning + beam composition, then exact batched
verification of the shortlist through ``policy_bank_eval``), filling
``ExploreResult``'s ``heterogeneous`` axis with points that carry full
per-layer assignments (DESIGN.md §2.5).  Its predict stage is the
exact per-layer sweep or, with ``predictor="surrogate"``, the learned
QoR surrogate of ``approx.surrogate`` (DESIGN.md §2.11).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from ..device import DeviceLike
from . import objectives as objectives_mod
from .layers import ApproxPolicy, policy_bank_eval, policy_for_lane
from .objectives import get_objective
from .power import (auto_rel_power, cost_axes_map,
                    network_costs_for_assignment,
                    network_power_for_assignment, rel_power_map)
from .resilience import (LayerComponents, ResilienceRow, _unstack_metrics,
                         all_layers_sweep, can_bank, per_layer_sweep)
from .specs import BackendSpec, PolicyBank
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

    @staticmethod
    def from_assignment(assignment: Mapping[str, str], accuracy: float,
                        network_rel_power: float,
                        mode: str = "lut",
                        variant: str = "ref",
                        metrics: Optional[Mapping[str, float]] = None,
                        costs: Optional[Mapping[str, float]] = None
                        ) -> "DesignPoint":
        """A verified heterogeneous composition as a design point; the
        distinct multipliers are summarized in ``multiplier``, the
        exact per-layer mapping preserved in ``assignment``, and the
        datapath it was measured under in ``mode``/``variant``."""
        distinct = tuple(dict.fromkeys(assignment.values()))
        label = (distinct[0] if len(distinct) == 1
                 else f"hetero[{len(distinct)}]")
        return DesignPoint(
            multiplier=label, layer="hetero", accuracy=accuracy,
            network_rel_power=network_rel_power,
            multiplier_rel_power=network_rel_power, mult_share=1.0,
            spec=None, assignment=tuple(assignment.items()),
            mode=mode, variant=variant,
            metrics=dict(metrics or {}), costs=dict(costs or {}))

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
    sharding=None,
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
    ``cache`` under sequential-compatible keys.  ``sharding``
    (``launch.mesh.bank_sharding``) splits the bank's lanes across
    devices.

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
                                sharding=sharding, rel_power=rel_power)
        if batch:
            _seed_cache(cache, rows, golden)
        result.all_layers = [DesignPoint.from_row(r) for r in rows]
    if per_layer:
        rows = per_layer_sweep(wl if batch else run, layer_counts,
                               multipliers, library, mode=mode,
                               base=golden, variant=variant, batch=batch,
                               sharding=sharding, rel_power=rel_power)
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


# ----------------------------------------------------------------------
# Heterogeneous two-stage DSE (DESIGN.md §2.5)
# ----------------------------------------------------------------------
def compose_assignments(components: LayerComponents,
                        quality_bound: Optional[float] = None,
                        power_budget: Optional[float] = None,
                        beam_width: int = 8,
                        top_k: int = 8) -> list[np.ndarray]:
    """Prediction-stage composition: layer-wise Pareto pruning followed
    by a beam search over layers (largest multiplication counts first).

    Beam states accumulate predicted quality drop (additive model) and
    assigned power; states past the drop threshold are cut, and the beam
    keeps both the lowest-power and the lowest-drop frontiers so a
    cheap-but-damaged prefix cannot starve the search.  The beam runs at
    a ladder of thresholds around ``quality_bound`` (0.5x, 1x, 2x) and
    unions the results: the additive model is pessimistic, so verifying
    a band around the predicted bound recovers compositions the
    prediction would wrongly cut.  Returns up to ``top_k`` distinct
    assignment rows (indices into ``components.multipliers``) ordered by
    predicted power — the shortlist the verification stage measures.
    """
    thresholds = ([quality_bound * 0.5, quality_bound, quality_bound * 2]
                  if quality_bound is not None else [None])
    out, seen = [], set()
    for threshold in thresholds:
        for row in _beam_once(components, threshold, beam_width, top_k):
            if power_budget is not None and \
                    components.predict_power(row) > power_budget:
                continue
            key = tuple(row.tolist())
            if key not in seen:
                seen.add(key)
                out.append(row)
    # tie-break toward better predicted quality in the primary's own
    # direction (a min-primary's predict_accuracy is higher-is-worse)
    sign = 1.0 if components.direction == "min" else -1.0
    out.sort(key=lambda r: (components.predict_power(r),
                            sign * components.predict_accuracy(r)))
    return out[:top_k]


def _beam_once(components: LayerComponents, threshold: Optional[float],
               beam_width: int, top_k: int) -> list[np.ndarray]:
    fronts = components.layer_pareto()
    d = components.drop()
    order = sorted(range(len(components.layers)),
                   key=lambda j: -components.counts[j])
    # state: (assigned_power_sum, drop_sum, {layer_idx: mult_idx})
    states: list[tuple[float, float, dict]] = [(0.0, 0.0, {})]
    for j in order:
        nxt = []
        for pw, dr, part in states:
            for i in fronts[j]:
                dr2 = dr + float(d[j, i])
                if threshold is not None and dr2 > threshold:
                    continue
                nxt.append((pw + components.counts[j]
                            * float(components.rel_power[i]), dr2,
                            {**part, j: i}))
        if not nxt:
            # bound infeasible at this layer: keep the least-damaging
            # candidate so the search always returns something
            for pw, dr, part in states:
                i = min(fronts[j],
                        key=lambda i: (float(d[j, i]),
                                       float(components.rel_power[i])))
                nxt.append((pw + components.counts[j]
                            * float(components.rel_power[i]),
                            dr + float(d[j, i]), {**part, j: i}))
        by_power = sorted(nxt, key=lambda s: (s[0], s[1]))[:beam_width]
        by_drop = sorted(nxt, key=lambda s: (s[1], s[0]))[:beam_width]
        seen_ids = set()
        states = []
        for s in by_power + by_drop:
            key = tuple(sorted(s[2].items()))
            if key not in seen_ids:
                seen_ids.add(key)
                states.append(s)
    states.sort(key=lambda s: (s[0], s[1]))
    out, seen = [], set()
    for pw, dr, part in states:
        row = np.asarray([part[j] for j in range(len(components.layers))],
                         dtype=np.int32)
        key = tuple(row.tolist())
        if key in seen:
            continue
        seen.add(key)
        out.append(row)
        if len(out) >= top_k:
            break
    return out


def verify_assignments(
    eval_fn: Callable[[ApproxPolicy], float],
    assignments: list[Mapping[str, str]],
    layer_counts: dict[str, int],
    library,
    mode: str = "lut",
    variant: str = "ref",
    batch: bool = True,
    sharding=None,
    assign_sharding=None,
    cache: Optional[dict] = None,
    rel_power=None,
    layers: Optional[tuple] = None,
    fill: Optional[str] = None,
) -> list[DesignPoint]:
    """Verification stage: measure every candidate assignment EXACTLY.

    Batched (default, when the eval and datapath support it): the
    assignments pack into a ``PolicyBank`` and evaluate through
    ``policy_bank_eval`` in one pass of the model (one banked kernel
    call a layer and batch).  Otherwise each candidate's
    ``policy_for_lane`` is evaluated in turn through the policy cache,
    as in the reference.  Either way results land in ``cache`` under
    sequential-compatible policy keys, and power is the exact
    count-weighted ``network_power_for_assignment``.

    ``layers`` pins the bank's layer axis and ``fill`` pads rows that do
    not cover it with a named multiplier (``fill="mul8u_exact"`` equals
    the golden base).  ``assign_sharding`` (``launch.mesh.
    policy_sharding``) splits the assignment rows across devices
    (``policy_bank_eval``).
    """
    if not assignments:
        return []
    wl = as_workload(eval_fn)
    if layers is None:
        layers = tuple(dict.fromkeys(
            l for a in assignments for l in a))
    pbank = PolicyBank.from_assignments(assignments, library,
                                        layers=layers, fill=fill)
    batch = batch and can_bank(wl, mode, variant)
    if batch:
        out = policy_bank_eval(wl.traceable_metrics, pbank, mode=mode,
                               variant=variant, sharding=sharding,
                               assign_sharding=assign_sharding)
        lanes = _unstack_metrics(out, wl.metrics, pbank.n_policies)
    else:
        run = wl.cached(cache) if cache is not None else wl
        lanes = [run.measure(policy_for_lane(pbank, p, mode=mode,
                                             variant=variant))
                 for p in range(pbank.n_policies)]
    if cache is not None:
        for p, metrics in enumerate(lanes):
            cache.setdefault(
                policy_for_lane(pbank, p, mode=mode,
                                variant=variant).cache_key(),
                dict(metrics))
    if rel_power is None:
        rel_power = (auto_rel_power(library, pbank.bank.names)
                     or rel_power_map(library, pbank.bank.names))
    cost_map = cost_axes_map(library, pbank.bank.names)
    points = []
    for p, metrics in enumerate(lanes):
        a = pbank.assignment(p)
        points.append(DesignPoint.from_assignment(
            a, metrics[wl.primary],
            network_power_for_assignment(layer_counts, a, rel_power),
            mode=mode, variant=variant, metrics=metrics,
            costs=network_costs_for_assignment(layer_counts, a,
                                               cost_map)))
    return points


def explore_heterogeneous(
    eval_fn: Callable[[ApproxPolicy], float],
    layer_counts: dict[str, int],
    library=None,
    multipliers: Optional[list[str]] = None,
    mode: str = "lut",
    variant: str = "ref",
    quality_bound: float = 0.01,
    power_budget: Optional[float] = None,
    beam_width: int = 8,
    top_k: int = 8,
    components: Optional[LayerComponents] = None,
    extra_assignments: Optional[list[Mapping[str, str]]] = None,
    cache: Optional[dict] = None,
    batch: bool = True,
    sharding=None,
    assign_sharding=None,
    rel_power=None,
    predictor: str = "exact",
    train_fraction: float = 0.25,
    surrogate_config=None,
    device: DeviceLike = None,
    stage_walls: Optional[dict] = None,
) -> ExploreResult:
    """Two-stage heterogeneous DSE (autoAx-style, DESIGN.md §2.5).

    Width-generic (DESIGN.md §2.6): ``multipliers`` may mix 8-bit and
    composed 12/16-bit entries; mixed sets rebase power onto a common
    reference (``power.auto_rel_power``) in both the component models
    and the verified points — pass ``rel_power`` to pick it yourself.

    Stage 1 (predict): the per-layer sweep (batched when the eval
    supports it), distilled into ``LayerComponents`` — or ``components``
    from an earlier exploration.  Layer-wise Pareto pruning keeps the
    per-layer non-dominated multipliers, and a beam search composes up
    to ``top_k`` full assignments whose predicted (additive-drop)
    quality stays within ``quality_bound`` of the golden baseline,
    optionally under a ``power_budget`` ceiling.

    ``predictor="surrogate"`` (DESIGN.md §2.11) replaces the full exact
    sweep with the learned predict stage (``surrogate_components``): only
    a deterministic power-spread ``train_fraction`` of the candidates is
    measured exactly (those rows land on ``result.per_layer``), an MLP
    fit on ``device`` (the GPU unless ``device="cpu"``) predicts the
    rest, and the beam's quality threshold widens by the surrogate's
    held-out calibration band; the un-widened beam's shortlist is
    unioned in.  The training record rides on ``result.surrogate``.
    Stage 2 and the final selection are exact either way.

    Stage 2 (verify): the shortlist — plus any ``extra_assignments`` —
    is measured exactly by ``verify_assignments`` (one
    ``policy_bank_eval`` pass when batched).  Verified points land on
    ``result.heterogeneous`` with exact count-weighted power, and
    ``result.selected`` is the lowest-power verified point within
    ``quality_bound`` (and ``power_budget`` when given).

    ``sharding`` splits the stage-1 sweep's lanes and
    ``assign_sharding`` the verified rows across devices
    (``launch.mesh.bank_sharding`` / ``policy_sharding``).

    ``stage_walls``, when given, receives the host-clock seconds of each
    stage that ran: ``per_layer_sweep_s``, ``fit_s`` (surrogate only:
    the fit and the prediction), ``beam_s`` and ``verification_s``;
    every stage ends in values on the host.

    Returns an ``ExploreResult`` whose ``per_layer`` axis holds the
    stage-1 sweep (empty when ``components`` was supplied).
    """
    if predictor not in ("exact", "surrogate"):
        raise ValueError(
            f"predictor must be 'exact' or 'surrogate', got {predictor!r}")
    wl = as_workload(eval_fn)
    if library is None:
        from ..core.library import get_default_library
        library = get_default_library()
    if multipliers is None:
        multipliers = [e.name for e in library.case_study_selection()]
    cache = cache if cache is not None else {}
    run = wl.cached(cache)

    walls = stage_walls if stage_walls is not None else {}
    golden = BackendSpec.golden().materialize()
    per_layer_points: list[DesignPoint] = []
    baseline_metrics: dict = {}
    surrogate_record: Optional[dict] = None
    beam_bound = quality_bound
    if components is None:
        baseline_metrics = run.measure(ApproxPolicy(default=golden))
        baseline = baseline_metrics[wl.primary]
        do_batch = batch and can_bank(wl, mode, variant)
        if predictor == "surrogate":
            from .surrogate import surrogate_components
            components, sur, rows = surrogate_components(
                wl if do_batch else run, layer_counts, multipliers,
                library, baseline, direction=wl.primary_direction,
                train_fraction=train_fraction, mode=mode,
                variant=variant, base=golden, batch=do_batch,
                sharding=sharding, rel_power=rel_power,
                config=surrogate_config,
                device=device, stage_walls=walls)
            # predict-then-verify: the beam screens on predictions, so
            # its band absorbs the surrogate's held-out error; the exact
            # verify stage still gates the selection on the un-widened
            # bound
            beam_bound = quality_bound + sur.calibration
            surrogate_record = {**sur.summary(),
                                "train_fraction": train_fraction,
                                "beam_bound": beam_bound}
        else:
            t0 = time.perf_counter()
            rows = per_layer_sweep(wl if do_batch else run, layer_counts,
                                   multipliers, library, mode=mode,
                                   base=golden, variant=variant,
                                   batch=do_batch, sharding=sharding,
                                   rel_power=rel_power)
            walls["per_layer_sweep_s"] = time.perf_counter() - t0
            components = LayerComponents.from_rows(
                rows, layer_counts, baseline,
                direction=wl.primary_direction)
        if do_batch:
            _seed_cache(cache, rows, golden)
        per_layer_points = [DesignPoint.from_row(r) for r in rows]
    baseline = components.baseline

    t0 = time.perf_counter()
    candidates = compose_assignments(components,
                                     quality_bound=beam_bound,
                                     power_budget=power_budget,
                                     beam_width=beam_width, top_k=top_k)
    if beam_bound != quality_bound:
        # the widened band admits cheaper-but-riskier compositions that
        # can crowd the power-ordered shortlist; union in the un-widened
        # beam's shortlist so conservative compositions stay verified
        # (the one banked verification pass takes the extra rows)
        seen_rows = {tuple(r.tolist()) for r in candidates}
        for row in compose_assignments(components,
                                       quality_bound=quality_bound,
                                       power_budget=power_budget,
                                       beam_width=beam_width,
                                       top_k=top_k):
            if tuple(row.tolist()) not in seen_rows:
                seen_rows.add(tuple(row.tolist()))
                candidates.append(row)
    assignments = [
        {l: components.multipliers[i]
         for l, i in zip(components.layers, row)}
        for row in candidates]
    for extra in (extra_assignments or []):
        a = dict(extra)
        if a not in assignments:
            assignments.append(a)
    walls["beam_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hetero = verify_assignments(
        wl, assignments, layer_counts, library, mode=mode,
        variant=variant, batch=batch, sharding=sharding,
        assign_sharding=assign_sharding, cache=cache, rel_power=rel_power)
    walls["verification_s"] = time.perf_counter() - t0

    result = ExploreResult(baseline_accuracy=baseline,
                           per_layer=per_layer_points,
                           heterogeneous=hetero,
                           baseline_metrics=baseline_metrics,
                           objectives=(wl.primary, "power"),
                           primary=wl.primary,
                           surrogate=surrogate_record)
    constraints = {wl.primary: _budget(result, quality_bound)}
    if power_budget is not None:
        constraints["power"] = objectives_mod.AtMost(power_budget)
    result.selected = objectives_mod.select(
        result, constraints, minimize="power", axis="heterogeneous")
    return result

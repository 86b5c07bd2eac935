"""Resilience analysis driver (paper Sec. IV, Fig. 4 and Table II), port
of ``repro.approx.resilience``.

Given an evaluation handle — a ``Workload``, a ``BankableEval``, or a
plain ``eval_fn(policy) -> accuracy`` closure (normalized through
``as_workload``) — and the model's per-layer multiplication counts,
sweeps approximate multipliers

  * one layer at a time (Fig. 4 — layer sensitivity), and
  * across all layers at once (Table II — accuracy vs. power),

reporting the quality metrics together with the network-level relative
multiplier power.  Non-swept layers use the exact int8 datapath.

Both sweeps also run **batched** (``batch=True``): the multiplier axis
is packed into a ``LutBank`` and evaluated in one banked pass of the
model per sweep (all-layers) or per layer (per-layer) —
``approx.layers.bank_eval`` — with accuracies equal to the sequential
path's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .backend import BackendLike
from .layers import ApproxPolicy, bank_eval
from .power import (auto_rel_power, cost_axes_map,
                    network_costs_for_assignment,
                    network_power_for_assignment)
from .registry import get_datapath
from .specs import BackendSpec, MaterializedBackend, bank_for
from .workload import Workload, as_workload


@dataclass
class ResilienceRow:
    """One sweep measurement.  ``metrics`` carries every named quality
    metric the workload measured; ``accuracy`` is the scalar alias for
    the workload's PRIMARY metric.  ``costs`` carries the
    library-derived area/delay axes next to the power columns."""

    multiplier: str
    layer: str                 # layer name or "all"
    accuracy: float            # = metrics[workload.primary]
    network_rel_power: float   # count-weighted multiplier power
    multiplier_rel_power: float
    mult_share: float          # fraction of network mults in this layer
    errors: dict = field(default_factory=dict)
    spec: Optional[BackendSpec] = None
    metrics: dict = field(default_factory=dict)
    costs: dict = field(default_factory=dict)


@dataclass
class BankableEval:
    """An evaluation function in both calling conventions the sweeps
    understand: ``fn(policy) -> float`` (sequential) and
    ``traceable(policy) -> tensor`` (its tensor core, called once with
    a banked policy; returns one value per lane).  Calling the object
    delegates to ``fn``."""

    fn: Callable[[ApproxPolicy], float]
    traceable: Callable[[ApproxPolicy], "object"]

    def __call__(self, policy: ApproxPolicy) -> float:
        return self.fn(policy)


def can_bank(eval_fn, mode: str, variant: str = "ref") -> bool:
    """True when ``(eval_fn, mode, variant)`` supports the batched
    engine: the eval exposes a tensor core and the datapath declares
    ``bankable``."""
    if getattr(eval_fn, "traceable", None) is None:
        return False
    name = mode if variant == "ref" else f"{mode}_{variant}"
    try:
        return bool(get_datapath(name).bankable)
    except (KeyError, NotImplementedError):
        return False


def _backends_for(multiplier_names, library, mode: str, rank=None,
                  variant: str = "ref") -> dict[str, MaterializedBackend]:
    return {name: BackendSpec(mode=mode, multiplier=name, rank=rank,
                              variant=variant).materialize(library)
            for name in multiplier_names}


def _row(library, mname, layer, metrics, primary, layer_counts, spec,
         rel_power=None, cost_map=None) -> ResilienceRow:
    entry = library.entry(mname)
    rp = (rel_power[mname] if rel_power is not None
          else entry.rel_power)
    acc = float(metrics[primary])
    total = sum(layer_counts.values())
    if layer == "all":
        assignment = {l: mname for l in layer_counts}
        return ResilienceRow(
            multiplier=mname, layer="all", accuracy=acc,
            network_rel_power=rp,
            multiplier_rel_power=rp,
            mult_share=1.0, errors=entry.errors.as_dict(), spec=spec,
            metrics=dict(metrics),
            costs=(network_costs_for_assignment(layer_counts, assignment,
                                                cost_map)
                   if cost_map is not None else {}))
    # a per-layer row is the one-layer special case of a heterogeneous
    # assignment; both score power through the same component model
    return ResilienceRow(
        multiplier=mname, layer=layer, accuracy=acc,
        network_rel_power=network_power_for_assignment(
            layer_counts, {layer: mname}, {mname: rp}),
        multiplier_rel_power=rp,
        mult_share=layer_counts[layer] / total,
        errors=entry.errors.as_dict(), spec=spec,
        metrics=dict(metrics),
        costs=(network_costs_for_assignment(layer_counts, {layer: mname},
                                            cost_map)
               if cost_map is not None else {}))


# ----------------------------------------------------------------------
# Per-layer component models (autoAx-style, DESIGN.md §2.5)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class LayerComponents:
    """Per-layer quality/power component models distilled from the
    Fig. 4 per-layer sweep rows.  ``quality[j, i]`` is the measured
    network accuracy with ONLY layer ``layers[j]`` running multiplier
    ``multipliers[i]``; ``rel_power[i]`` is the multiplier's relative
    power.  Composition is additive in quality drops (clipped at zero)
    and exact in power."""

    layers: tuple[str, ...]
    multipliers: tuple[str, ...]
    quality: "np.ndarray"           # (n_layers, n_mult) accuracies
    rel_power: "np.ndarray"         # (n_mult,)
    counts: tuple[int, ...]         # per layers[j] mult counts
    total_count: int                # whole-network mult count
    baseline: float                 # golden int8 accuracy
    direction: str = "max"          # primary metric direction

    @staticmethod
    def from_rows(rows: "list[ResilienceRow]", layer_counts: dict,
                  baseline: float,
                  direction: str = "max") -> "LayerComponents":
        """Distill per-layer sweep rows into component matrices;
        missing (layer, multiplier) cells fall back to the baseline."""
        layers = tuple(dict.fromkeys(
            r.layer for r in rows if r.layer != "all"))
        mults = tuple(dict.fromkeys(
            r.multiplier for r in rows if r.layer != "all"))
        li = {l: j for j, l in enumerate(layers)}
        mi = {m: i for i, m in enumerate(mults)}
        quality = np.full((len(layers), len(mults)), baseline)
        rel_power = np.ones(len(mults))
        for r in rows:
            if r.layer == "all":
                continue
            quality[li[r.layer], mi[r.multiplier]] = r.accuracy
            rel_power[mi[r.multiplier]] = r.multiplier_rel_power
        return LayerComponents(
            layers=layers, multipliers=mults, quality=quality,
            rel_power=rel_power,
            counts=tuple(int(layer_counts[l]) for l in layers),
            total_count=int(sum(layer_counts.values())),
            baseline=float(baseline), direction=direction)

    def drop(self) -> "np.ndarray":
        """(n_layers, n_mult) per-layer quality degradations, >= 0."""
        if self.direction == "min":
            return np.maximum(self.quality - self.baseline, 0.0)
        return np.maximum(self.baseline - self.quality, 0.0)

    def predict_accuracy(self, assign: "np.ndarray") -> float:
        """Additive-drop estimate of the primary metric for one
        assignment row (indices into ``multipliers``)."""
        d = self.drop()
        total = float(sum(d[j, i] for j, i in enumerate(assign)))
        return (self.baseline + total if self.direction == "min"
                else self.baseline - total)

    def predict_power(self, assign: "np.ndarray") -> float:
        """Exact count-weighted power of one assignment row."""
        assigned = sum(c * self.rel_power[i]
                       for c, i in zip(self.counts, assign))
        rest = self.total_count - sum(self.counts)
        if self.total_count == 0:
            return 1.0
        return float((assigned + rest) / self.total_count)

    def layer_pareto(self) -> list[list[int]]:
        """Per layer: multiplier indices non-dominated on (drop min,
        power min), sorted by ascending power."""
        d = self.drop()
        fronts = []
        for j in range(len(self.layers)):
            order = sorted(range(len(self.multipliers)),
                           key=lambda i: (self.rel_power[i], d[j, i]))
            front: list[int] = []
            best = float("inf")
            for i in order:
                if d[j, i] < best:
                    front.append(i)
                    best = d[j, i]
            fronts.append(front)
        return fronts


def per_layer_sweep(
    eval_fn: Callable[[ApproxPolicy], float],
    layer_counts: dict[str, int],
    multiplier_names: list[str],
    library,
    mode: str = "lut",
    base: Optional[BackendLike] = None,
    variant: str = "ref",
    batch: bool = False,
    sharding=None,
    rel_power=None,
) -> list[ResilienceRow]:
    """Fig. 4: one layer approximated at a time.  Sequential: one
    ``eval_fn`` call per (layer, multiplier).  Batched (``batch=True``):
    one banked pass per layer evaluates every candidate; ``sharding``
    (``launch.mesh.bank_sharding``) splits its lanes across devices."""
    wl = as_workload(eval_fn)
    base = base if base is not None else BackendSpec.golden().materialize()
    if rel_power is None:
        rel_power = auto_rel_power(library, multiplier_names)
    cost_map = cost_axes_map(library, multiplier_names)
    backends = _backends_for(multiplier_names, library, mode,
                             variant=variant)
    rows = []
    if batch:
        wl = _require_bankable(wl, mode, variant)
        bank = bank_for(multiplier_names, library)
        for layer in layer_counts:
            lanes = _unstack_metrics(
                bank_eval(wl.traceable_metrics, bank, mode=mode,
                          variant=variant, base=base,
                          layer_pattern=layer, sharding=sharding),
                wl.metrics, len(multiplier_names))
            for mname, metrics in zip(multiplier_names, lanes):
                rows.append(_row(library, mname, layer, metrics,
                                 wl.primary, layer_counts,
                                 backends[mname].spec, rel_power,
                                 cost_map))
        return rows
    for layer in layer_counts:
        for mname, be in backends.items():
            policy = ApproxPolicy(default=base, overrides=[(layer, be)])
            rows.append(_row(library, mname, layer, wl.measure(policy),
                             wl.primary, layer_counts, be.spec,
                             rel_power, cost_map))
    return rows


def all_layers_sweep(
    eval_fn: Callable[[ApproxPolicy], float],
    layer_counts: dict[str, int],
    multiplier_names: list[str],
    library,
    mode: str = "lut",
    variant: str = "ref",
    batch: bool = False,
    sharding=None,
    rel_power=None,
) -> list[ResilienceRow]:
    """Table II: the same multiplier in every layer.  Sequential: one
    ``eval_fn`` call per multiplier.  Batched (``batch=True``): ONE
    banked pass evaluates the whole ``LutBank``, with accuracies equal
    to the sequential path's; ``sharding`` splits its lanes across
    devices."""
    wl = as_workload(eval_fn)
    if rel_power is None:
        rel_power = auto_rel_power(library, multiplier_names)
    cost_map = cost_axes_map(library, multiplier_names)
    backends = _backends_for(multiplier_names, library, mode,
                             variant=variant)
    if batch:
        wl = _require_bankable(wl, mode, variant)
        bank = bank_for(multiplier_names, library)
        lanes = _unstack_metrics(
            bank_eval(wl.traceable_metrics, bank, mode=mode,
                      variant=variant, sharding=sharding),
            wl.metrics, len(multiplier_names))
        return [_row(library, mname, "all", metrics, wl.primary,
                     layer_counts, backends[mname].spec, rel_power,
                     cost_map)
                for mname, metrics in zip(multiplier_names, lanes)]
    rows = []
    for mname, be in backends.items():
        policy = ApproxPolicy(default=be)
        rows.append(_row(library, mname, "all", wl.measure(policy),
                         wl.primary, layer_counts, be.spec, rel_power,
                         cost_map))
    return rows


def _unstack_metrics(out, metric_names, n: int) -> list[dict]:
    """Split a banked evaluation's metric dict ``{metric: (n,) tensor}``
    into one float dict per lane, in workload metric order."""
    arrs = {m: out[m].detach().cpu().numpy() for m in metric_names}
    return [{m: float(arrs[m][i]) for m in metric_names}
            for i in range(n)]


def _require_bankable(eval_fn, mode: str, variant: str) -> Workload:
    wl = as_workload(eval_fn)
    if not can_bank(wl, mode, variant):
        raise ValueError(
            "batch=True needs a bank-traceable evaluation (a Workload "
            "with traceable_metrics, or a BankableEval) and a bankable "
            f"datapath; got {type(eval_fn).__name__} with mode={mode!r} "
            f"variant={variant!r}.  Wrap your eval in "
            "BankableEval/Workload or use explore(batch=True), which "
            "falls back to the sequential path.")
    return wl

"""Per-architecture module-resilience profiles (port of
``repro.approx.profiles``, DESIGN.md §2.12).

The paper's Table II asks, for one CNN, "which layers tolerate which
approximate multipliers".  ``profile_architecture`` asks the 2026
model-zoo version: for each *module family* of an architecture
(attention q/k/v/o, MLP up/gate/down, MoE experts, SSM projections,
cross-attention, conv, ...), how much quality does each library
multiplier cost, and what is the cheapest per-module composition that
stays inside a declarative ``MaxDrop`` bound?

Pipeline (all exact measurements — no surrogate here):

  1. baseline: the workload on the golden int8 datapath;
  2. module sweep: every ``(family, multiplier)`` single-family
     assignment, lowered through ``ModuleMap.lower`` and evaluated as
     ONE ``policy_bank_eval`` program (``verify_assignments`` with the
     full tag axis + exact-LUT ``fill``) — one pass of the model, one
     banked datapath call a call site and batch (an expert's projection
     a call each), bit-identical to sequential golden-base policies;
  3. ranking: families ordered most- to least-tolerant by mean
     direction-aware quality drop across the library;
  4. selection: the sweep rows distill into module-level
     ``LayerComponents`` (families as "layers", MAC-weighted), the
     beam composes candidate per-module assignments, uniform rows are
     added, the shortlist is exactly verified in one more banked
     program, and ``objectives.select`` picks the lowest-power point
     under ``MaxDrop(max_drop)`` on the primary metric.

``profile_zoo`` serializes a zoo of profiles;
``repro_torch.launch.arch_profiles`` runs one on the card.
``sharding=``/``assign_sharding=`` (``launch.mesh.module_sharding``)
split the banked rows across devices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

from .dse import ExploreResult, compose_assignments, verify_assignments
from .layers import ApproxPolicy
from .modules import FILL_EXACT, ModuleMap, module_sweep_assignments
from .objectives import MaxDrop, get_objective, select
from .power import auto_rel_power, rel_power_map
from .resilience import LayerComponents, ResilienceRow
from .specs import BackendSpec
from .workload import Workload, as_workload


@dataclass
class ModuleRow:
    """One module-sweep measurement: ONLY ``module`` runs
    ``multiplier`` (every other call site golden int8)."""
    module: str
    multiplier: str
    quality: float              # primary metric at this point
    quality_drop: float         # direction-aware drop vs baseline, >= 0
    network_rel_power: float
    multiplier_rel_power: float
    mult_share: float           # fraction of network MACs in the family
    metrics: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"module": self.module, "multiplier": self.multiplier,
                "quality": self.quality,
                "quality_drop": self.quality_drop,
                "network_rel_power": self.network_rel_power,
                "multiplier_rel_power": self.multiplier_rel_power,
                "mult_share": self.mult_share,
                "metrics": dict(self.metrics)}

    @staticmethod
    def from_dict(d: dict) -> "ModuleRow":
        return ModuleRow(**d)


@dataclass
class ArchProfile:
    """One architecture's resilience profile over its module families."""
    arch: str
    model_family: str           # dense | moe | ssm | hybrid | encdec |
                                # vlm | resnet
    workload: str
    primary: str
    direction: str
    max_drop: float
    baseline_metrics: dict
    modules: tuple
    module_shares: dict
    rows: list                  # [ModuleRow]
    ranking: tuple              # most -> least tolerant family
    selected: Optional[dict]    # {"modules", "layers", "power",
                                #  "metrics", "quality_drop"}

    def to_dict(self) -> dict:
        return {"arch": self.arch, "model_family": self.model_family,
                "workload": self.workload, "primary": self.primary,
                "direction": self.direction, "max_drop": self.max_drop,
                "baseline_metrics": dict(self.baseline_metrics),
                "modules": list(self.modules),
                "module_shares": dict(self.module_shares),
                "rows": [r.to_dict() for r in self.rows],
                "ranking": list(self.ranking),
                "selected": self.selected}

    @staticmethod
    def from_dict(d: dict) -> "ArchProfile":
        d = dict(d)
        d["rows"] = [ModuleRow.from_dict(r) for r in d["rows"]]
        d["modules"] = tuple(d["modules"])
        d["ranking"] = tuple(d["ranking"])
        return ArchProfile(**d)


def _drop(value: float, baseline: float, direction: str) -> float:
    d = (baseline - value) if direction == "max" else (value - baseline)
    return max(0.0, float(d))


def profile_architecture(
    workload: Workload,
    mmap: ModuleMap,
    library,
    multipliers: Sequence[str],
    *,
    arch: Optional[str] = None,
    model_family: str = "",
    max_drop: float = 0.05,
    mode: str = "lut",
    variant: str = "ref",
    batch: bool = True,
    sharding=None,
    assign_sharding=None,
    beam_width: int = 8,
    top_k: int = 8,
    fill: str = FILL_EXACT,
    stage_walls: Optional[dict] = None,
) -> ArchProfile:
    """Sweep ``multipliers`` over every module family of one model and
    select the cheapest per-module policy under ``MaxDrop(max_drop)``
    on the workload's primary metric.  See the module docstring for the
    pipeline; all measurements are exact.  ``stage_walls``, when given,
    receives the host-clock seconds of each stage (``baseline_s``,
    ``sweep_s``, ``compose_s``, ``verify_s``); each stage ends with its
    metrics on the host, so the device has finished its work."""
    walls = stage_walls if stage_walls is not None else {}
    wl = as_workload(workload)
    direction = wl.primary_direction
    golden = ApproxPolicy(default=BackendSpec.golden().materialize())
    t0 = time.perf_counter()
    baseline = wl.measure(golden)
    walls["baseline_s"] = time.perf_counter() - t0
    base_q = baseline[wl.primary]

    rel_power = (auto_rel_power(library, multipliers)
                 or rel_power_map(library, multipliers))
    shares = mmap.module_shares()

    # -- 2. module sweep: one banked pass over the whole grid ----------
    grid = module_sweep_assignments(mmap, multipliers)
    t0 = time.perf_counter()
    points = verify_assignments(
        wl, [mmap.lower(a) for _f, _m, a in grid], mmap.layer_counts,
        library, mode=mode, variant=variant, batch=batch,
        sharding=sharding, assign_sharding=assign_sharding,
        layers=mmap.layers, fill=fill)
    rows = [
        ModuleRow(
            module=f, multiplier=m,
            quality=float(pt.metrics[wl.primary]),
            quality_drop=_drop(pt.metrics[wl.primary], base_q, direction),
            network_rel_power=float(pt.network_rel_power),
            multiplier_rel_power=float(rel_power[m]),
            mult_share=float(shares[f]),
            metrics=dict(pt.metrics))
        for (f, m, _a), pt in zip(grid, points)]
    walls["sweep_s"] = time.perf_counter() - t0

    # -- 3. tolerance ranking ------------------------------------------
    fams = mmap.modules
    mean_drop = {f: sum(r.quality_drop for r in rows if r.module == f)
                 / max(1, sum(1 for r in rows if r.module == f))
                 for f in fams}
    ranking = tuple(sorted(fams, key=lambda f: (mean_drop[f], f)))

    # -- 4. MaxDrop-constrained per-module selection -------------------
    t0 = time.perf_counter()
    comp_rows = [ResilienceRow(
        multiplier=r.multiplier, layer=r.module, accuracy=r.quality,
        network_rel_power=r.network_rel_power,
        multiplier_rel_power=r.multiplier_rel_power,
        mult_share=r.mult_share, metrics=dict(r.metrics)) for r in rows]
    components = LayerComponents.from_rows(
        comp_rows, mmap.module_counts(), base_q, direction=direction)
    composed = compose_assignments(components, quality_bound=max_drop,
                                   beam_width=beam_width, top_k=top_k)
    candidates = [
        {f: components.multipliers[row[j]]
         for j, f in enumerate(components.layers)} for row in composed]
    candidates += [{f: m for f in fams} for m in multipliers]  # uniforms
    seen: set = set()
    module_assignments = []
    for a in candidates:
        key = tuple(sorted(a.items()))
        if key not in seen:
            seen.add(key)
            module_assignments.append(a)
    walls["compose_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    verified = verify_assignments(
        wl, mmap.lower_many(module_assignments), mmap.layer_counts,
        library, mode=mode, variant=variant, batch=batch,
        sharding=sharding, assign_sharding=assign_sharding,
        layers=mmap.layers, fill=fill)
    walls["verify_s"] = time.perf_counter() - t0
    result = ExploreResult(
        baseline_accuracy=base_q, heterogeneous=list(verified),
        baseline_metrics=dict(baseline), primary=wl.primary)
    chosen = select(result, {wl.primary: MaxDrop(max_drop)},
                    minimize="power", axis="heterogeneous")
    selected = None
    if chosen is not None:
        idx = verified.index(chosen)
        selected = {
            "modules": dict(module_assignments[idx]),
            "layers": {l: m for l, m in (chosen.assignment or ())},
            "power": float(chosen.network_rel_power),
            "metrics": dict(chosen.metrics),
            "quality_drop": _drop(chosen.metrics[wl.primary], base_q,
                                  direction),
        }

    get_objective(wl.primary)       # primary registered — fail fast
    return ArchProfile(
        arch=arch or wl.name, model_family=model_family,
        workload=wl.name, primary=wl.primary, direction=direction,
        max_drop=float(max_drop), baseline_metrics=dict(baseline),
        modules=fams, module_shares=shares, rows=rows, ranking=ranking,
        selected=selected)


def profile_zoo(profiles: Mapping[str, ArchProfile]) -> dict:
    """Serialize a zoo of profiles (arch name -> ``ArchProfile``) into
    one JSON-ready record, plus cross-architecture family aggregates
    (mean quality drop per family over every arch that has it)."""
    fam_drops: dict[str, list] = {}
    for p in profiles.values():
        for r in p.rows:
            fam_drops.setdefault(r.module, []).append(r.quality_drop)
    return {
        "archs": {name: p.to_dict() for name, p in profiles.items()},
        "family_mean_drop": {f: sum(v) / len(v)
                             for f, v in fam_drops.items()},
    }

"""Power model: relative multiplier power aggregated over a network.

The paper reports "power consumption of multipliers in convolutional
layers" relative to the exact 8-bit datapath (Table II / Fig. 4).  Given
per-layer multiplication counts and the per-layer multiplier assignment,
the relative power is the count-weighted mean of the multipliers'
relative powers.

``network_power_for_assignment`` is the heterogeneous-composition entry
point (DESIGN.md §2.5): it scores an arbitrary layer-name -> multiplier
mapping, which is how both the per-layer resilience rows (a one-layer
assignment) and the heterogeneous DSE (a full assignment) account power
through ONE code path.

Cross-width accounting (DESIGN.md §2.6): ``rel_power`` in the library
is *same-width* relative (a 16-bit entry's power over the exact 16-bit
multiplier) — the paper's Table II convention.  Mixed-width sweeps need
a COMMON reference, so ``rel_power_map(..., ref=...)`` rebases every
entry onto one circuit's absolute 45 nm power (typically
``mul8u_exact``, the golden datapath): a composed 16-bit multiplier
then correctly costs ~4x an 8-bit one (four tiles + the reduction
tree) instead of looking same-priced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional


@dataclass(frozen=True)
class LayerPower:
    name: str
    mult_count: int
    multiplier: str
    rel_power: float


def network_relative_power(layers: list[LayerPower]) -> float:
    total = sum(l.mult_count for l in layers)
    if total == 0:
        return 1.0
    return sum(l.mult_count * l.rel_power for l in layers) / total


def per_layer_share(layers: list[LayerPower]) -> dict[str, float]:
    total = sum(l.mult_count for l in layers)
    if total == 0:
        # mirror network_relative_power's zero-mult guard: no
        # multiplications means no layer owns a share of them
        return {l.name: 0.0 for l in layers}
    return {l.name: l.mult_count / total for l in layers}


def rel_power_map(library, names,
                  ref: Optional[str] = None) -> dict[str, float]:
    """Per-multiplier relative power for a candidate set.

    ``ref=None`` reads the library's same-width ``rel_power`` (the
    paper's convention — correct for single-width sweeps).  With
    ``ref`` set (e.g. ``"mul8u_exact"``), every entry is rebased onto
    that circuit's absolute 45 nm power, making MIXED-WIDTH candidate
    sets comparable on one axis: ``power(name) / power(ref)``.
    Raises ``UnknownCircuitError`` on missing names.
    """
    if ref is None:
        return {n: library.entry(n).rel_power for n in names}
    ref_power = library.entry(ref).cost.power
    if ref_power <= 0:
        raise ValueError(f"reference circuit {ref!r} has no power")
    return {n: library.entry(n).cost.power / ref_power for n in names}


def auto_rel_power(library, names) -> Optional[dict[str, float]]:
    """Default power map for a candidate set: None for single-width
    sets (the library's same-width convention applies), a
    common-reference ``rel_power_map`` for MIXED-width sets — without
    this, a 16-bit entry's rel_power (vs exact *16-bit*) would be
    silently compared against 8-bit entries' (vs exact 8-bit) and a
    ~5x-more-expensive circuit could win "lowest power".  The
    reference is the narrowest width's exact multiplier; raises when
    the library lacks it (pass an explicit ``rel_power`` then).
    """
    widths = {library.entry(n).width for n in names}
    if len(widths) <= 1:
        return None
    ref = f"mul{min(widths)}u_exact"
    if ref not in library.entries:
        raise ValueError(
            f"mixed-width candidate set (widths {sorted(widths)}) "
            f"needs a common power reference, but {ref!r} is not in "
            "the library — pass rel_power=rel_power_map(library, "
            "names, ref=<your reference circuit>)")
    return rel_power_map(library, names, ref=ref)


COST_AXES = ("area", "delay")


def cost_axes_map(library, names) -> dict[str, dict[str, float]]:
    """Per-multiplier relative AREA and DELAY for a candidate set — the
    library-derived cost axes beyond power (DESIGN.md §2.7, the paper's
    "other circuit parameters").

    Each entry is normalized against the exact multiplier of ITS OWN
    width (``mul{W}u_exact``), mirroring the library's same-width
    ``rel_power`` convention; when the library lacks that entry (tiny
    demo libraries, composed widths) the reference cost is synthesized
    from an exact array multiplier of that width — the same fallback
    ``ApproxLibrary.add_composed`` uses for ``rel_power`` — so every
    value in one map stays on the same relative scale (never raw
    µm²/ps mixed with ~1.0 ratios).  Resilience sweeps thread these
    onto every row/point so objective tuples like
    ``("accuracy", "power", "delay")`` resolve without re-touching the
    library."""
    refs: dict[int, Any] = {}
    out: dict[str, dict[str, float]] = {}
    for n in names:
        entry = library.entry(n)
        if entry.width not in refs:
            ref_name = f"mul{entry.width}u_exact"
            if ref_name in library.entries:
                refs[entry.width] = library.entry(ref_name).cost
            else:
                from ..core.cost import evaluate_cost
                from ..core.seeds import array_multiplier
                refs[entry.width] = evaluate_cost(
                    array_multiplier(entry.width))
        ref = refs[entry.width]
        out[n] = {
            "area": (entry.cost.area / ref.area if ref.area > 0
                     else entry.cost.area),
            "delay": (entry.cost.delay / ref.delay if ref.delay > 0
                      else entry.cost.delay),
        }
    return out


def network_costs_for_assignment(
    layer_counts: Mapping[str, int],
    assignment: Mapping[str, str],
    cost_map: Mapping[str, Mapping[str, float]],
    base: Optional[Mapping[str, float]] = None,
) -> dict[str, float]:
    """Network-level area/delay of a heterogeneous assignment, through
    the same one-code-path discipline as
    ``network_power_for_assignment``: AREA aggregates like power (the
    count-weighted mean over layers, unassigned layers at the exact
    datapath's 1.0), DELAY is the critical path — the MAX over the
    datapaths in use (an accelerator's multiplier array clocks at its
    slowest circuit)."""
    base = dict(base) if base is not None else {a: 1.0 for a in COST_AXES}
    layers, delays = [], []
    for name, count in layer_counts.items():
        if name in assignment:
            c = cost_map[assignment[name]]
            layers.append(LayerPower(name, count, assignment[name],
                                     c["area"]))
            delays.append(c["delay"])
        else:
            layers.append(LayerPower(name, count, "exact", base["area"]))
            delays.append(base["delay"])
    # the exact datapath's delay only bounds the path when some layer
    # actually runs it; a fully-assigned network clocks at its own
    # slowest circuit, which may beat the exact multiplier
    return {"area": network_relative_power(layers),
            "delay": max(delays, default=base["delay"])}


def network_power_for_assignment(
    layer_counts: Mapping[str, int],
    assignment: Mapping[str, str],
    rel_power: Mapping[str, float],
    base_multiplier: str = "exact",
    base_rel_power: float = 1.0,
) -> float:
    """Count-weighted network power of a heterogeneous assignment.

    ``assignment`` maps layer names to multiplier names and may cover
    any subset of ``layer_counts``; unassigned layers run the base
    (exact) datapath at ``base_rel_power``.  ``rel_power`` maps each
    assigned multiplier name to its relative power (e.g.
    ``{e.name: e.rel_power for e in library.entries.values()}``).
    """
    layers = []
    for name, count in layer_counts.items():
        if name in assignment:
            mult = assignment[name]
            layers.append(LayerPower(name, count, mult, rel_power[mult]))
        else:
            layers.append(LayerPower(name, count, base_multiplier,
                                     base_rel_power))
    return network_relative_power(layers)


def grouped_mult_counts(layer_counts: Mapping[str, int],
                        groups: Mapping[str, str]) -> dict[str, int]:
    """Aggregate per-layer MAC counts by a group key — e.g. module
    families via ``repro.approx.modules.ModuleMap.layer_module``
    (DESIGN.md §2.12).  Grouped counts drop into the same
    ``network_power_for_assignment`` / ``LayerComponents`` arithmetic
    as per-layer counts: power is linear in counts, so summing within
    a group before weighting is exact."""
    out: dict[str, int] = {}
    for layer, count in layer_counts.items():
        g = groups[layer]
        out[g] = out.get(g, 0) + int(count)
    return out

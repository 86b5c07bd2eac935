"""The approximate-circuit library (paper Sec. III, Table I).

``ApproxLibrary`` stores characterized circuits (genome + six error
metrics + 45 nm cost + power relative to the exact same-width circuit),
supports Pareto-front queries per error metric, the paper's selection
rule ("10 circuits evenly distributed along the power axis" per metric,
union + dedup -> the case-study subset), JSON (de)serialization, and
LUT materialization for the NN emulation backends.

``build_default_library`` populates it from:
  * exact seeds (ripple adders, array multipliers),
  * analytic families (truncated / BAM multipliers, LOA / truncated
    adders) across 8..128-bit widths — these fill the wide-bit-width
    rows of Table I where exhaustive evolution is infeasible,
  * CGP-evolved 8-bit (and optionally 12/16-bit) circuits across a
    ladder of error targets, with every improved feasible parent
    admitted to the archive (this is where the "thousands" of Table I
    entries come from at full budget).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .cgp import CgpParams, ParetoArchive, evolve, pad_nodes
from .cost import CostReport, evaluate_cost
from .families import (TILE_BITS, bam_multiplier, composed_multiplier,
                       loa_adder, reduce_tag, truncated_adder,
                       truncated_multiplier)
from .luts import MAX_LUT_WIDTH, LutWidthError, lut_from_netlist, \
    exact_mul_lut
from .metrics import ErrorReport, METRIC_NAMES, evaluate_errors
from .netlist import Netlist
from .seeds import array_multiplier, ripple_carry_adder


class UnknownCircuitError(KeyError):
    """A library lookup named a circuit that is not in the library."""

    def __init__(self, name: str, library: "ApproxLibrary"):
        self.circuit = name
        hint = ""
        close = sorted(n for n in library.entries
                       if n.startswith(name[:6]))[:6]
        if close:
            hint = f"; closest entries: {close}"
        super().__init__(
            f"unknown circuit {name!r} ({len(library.entries)} entries "
            f"in library){hint}")


class WidthMismatchError(ValueError):
    """A spec's ``bit_width`` disagrees with the library entry's width."""

    def __init__(self, name: str, expected: int, actual: int):
        self.circuit = name
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"circuit {name!r} is {actual}-bit but the spec declares "
            f"bit_width={expected}; drop bit_width to infer it from "
            "the library, or name a circuit of the declared width")

_DATA_DIR = os.path.join(os.path.dirname(__file__), "library_data")
DEFAULT_LIBRARY_PATH = os.path.join(_DATA_DIR, "default_library.json")

# metrics the paper pairs with power for Pareto selection (EP == ER)
SELECTION_METRICS = ("er", "mae", "wce", "mse", "mre")


@dataclass
class CircuitEntry:
    name: str
    kind: str          # 'adder' | 'multiplier'
    width: int
    source: str        # 'exact'|'evolved'|'truncation'|'bam'|'loa'|'composed'
    errors: ErrorReport
    cost: CostReport
    rel_power: float   # power / power(exact same kind+width)
    netlist: Netlist
    # composed wide multipliers carry the recipe the executable engine
    # needs: {"tile": <8-bit multiplier entry name>, "reduce": token}
    # (DESIGN.md §2.6).  None for directly-materializable entries.
    composition: Optional[dict] = None

    def as_dict(self) -> dict:
        d = {
            "name": self.name,
            "kind": self.kind,
            "width": self.width,
            "source": self.source,
            "errors": self.errors.as_dict(),
            "cost": self.cost.as_dict(),
            "rel_power": self.rel_power,
            "netlist": self.netlist.to_dict(),
        }
        if self.composition is not None:
            d["composition"] = dict(self.composition)
        return d

    @staticmethod
    def from_dict(d: dict) -> "CircuitEntry":
        return CircuitEntry(
            name=d["name"],
            kind=d["kind"],
            width=int(d["width"]),
            source=d["source"],
            errors=ErrorReport(**d["errors"]),
            cost=CostReport(**d["cost"]),
            rel_power=float(d["rel_power"]),
            netlist=Netlist.from_dict(d["netlist"]),
            composition=d.get("composition"),
        )


class ApproxLibrary:
    def __init__(self):
        self.entries: dict[str, CircuitEntry] = {}
        self._lut_cache: dict[str, np.ndarray] = {}

    # -- population ----------------------------------------------------
    def add(self, entry: CircuitEntry) -> None:
        self.entries[entry.name] = entry

    def add_netlist(
        self, nl: Netlist, kind: str, width: int, source: str,
        exact: Netlist, name: Optional[str] = None,
    ) -> CircuitEntry:
        name = name or nl.name or f"{kind}{width}_{len(self.entries)}"
        errors = evaluate_errors(nl, exact)
        cost = evaluate_cost(nl)
        ref = evaluate_cost(exact).power
        entry = CircuitEntry(
            name=name, kind=kind, width=width, source=source,
            errors=errors, cost=cost,
            rel_power=(cost.power / ref if ref > 0 else 0.0),
            netlist=nl.compact(),
        )
        self.add(entry)
        return entry

    # -- queries ---------------------------------------------------------
    def entry(self, name: str,
              bit_width: Optional[int] = None) -> CircuitEntry:
        """Validated lookup: raises ``UnknownCircuitError`` for missing
        names (instead of a bare ``KeyError``) and
        ``WidthMismatchError`` when ``bit_width`` is given and
        disagrees with the entry — the spec-side width contract of the
        width-generic datapaths (DESIGN.md §2.6)."""
        e = self.entries.get(name)
        if e is None:
            raise UnknownCircuitError(name, self)
        if bit_width is not None and int(bit_width) != e.width:
            raise WidthMismatchError(name, int(bit_width), e.width)
        return e

    def select(self, kind: Optional[str] = None, width: Optional[int] = None,
               source: Optional[str] = None) -> list[CircuitEntry]:
        out = []
        for e in self.entries.values():
            if kind is not None and e.kind != kind:
                continue
            if width is not None and e.width != width:
                continue
            if source is not None and e.source != source:
                continue
            out.append(e)
        return sorted(out, key=lambda e: (e.kind, e.width, -e.rel_power))

    def counts_table(self) -> list[dict]:
        """Paper Table I: #implementations per (kind, width)."""
        buckets: dict[tuple, int] = {}
        for e in self.entries.values():
            buckets[(e.kind, e.width)] = buckets.get((e.kind, e.width), 0) + 1
        return [
            {"circuit": k, "bit_width": w, "n_implementations": c}
            for (k, w), c in sorted(buckets.items())
        ]

    def pareto_front(self, kind: str, width: int, metric: str) -> list[CircuitEntry]:
        """Non-dominated entries on (rel_power, metric), both minimized.

        Sort-by-power sweep, O(n log n): walking power groups in
        ascending order, a group's minimum-metric entries survive iff
        they strictly improve on every lower-power group's best metric
        (ties on both axes are mutually non-dominating and all kept,
        matching the exhaustive-scan semantics)."""
        pts = sorted(self.select(kind=kind, width=width),
                     key=lambda e: (e.rel_power, e.errors.get(metric)))
        front: list[CircuitEntry] = []
        best = float("inf")     # min metric among strictly lower power
        i = 0
        while i < len(pts):
            j = i
            p = pts[i].rel_power
            while j < len(pts) and pts[j].rel_power == p:
                j += 1
            m_min = pts[i].errors.get(metric)
            if m_min < best:
                front.extend(e for e in pts[i:j]
                             if e.errors.get(metric) == m_min)
                best = m_min
            i = j
        return front

    @staticmethod
    def spread_along_power(entries: list[CircuitEntry], k: int = 10) -> list[CircuitEntry]:
        """k circuits evenly distributed along the power axis (Sec. III)."""
        if len(entries) <= k:
            return list(entries)
        entries = sorted(entries, key=lambda e: e.rel_power)
        lo, hi = entries[0].rel_power, entries[-1].rel_power
        targets = np.linspace(lo, hi, k)
        picked: list[CircuitEntry] = []
        for t in targets:
            best = min(entries, key=lambda e: abs(e.rel_power - t))
            if best not in picked:
                picked.append(best)
        return picked

    def case_study_selection(self, kind: str = "multiplier", width: int = 8,
                             per_metric: int = 10) -> list[CircuitEntry]:
        """The paper's 35-multiplier construction: per metric, 10 Pareto
        circuits evenly spread over power; union; dedup."""
        seen: dict[str, CircuitEntry] = {}
        for metric in SELECTION_METRICS:
            front = self.pareto_front(kind, width, metric)
            for e in self.spread_along_power(front, per_metric):
                seen[e.name] = e
        return sorted(seen.values(), key=lambda e: -e.rel_power)

    # -- LUTs ------------------------------------------------------------
    def lut(self, name: str) -> np.ndarray:
        """(2^w, 2^w) int32 product LUT for a multiplier entry
        (w <= ``MAX_LUT_WIDTH``).  Wide netlists raise
        ``LutWidthError`` pointing at the composed datapath, and
        composed entries (any width) raise ``ValueError`` — they
        execute through ``tile_lut`` / ``composition_of`` (tiled 8x8
        partial products), never a full product table."""
        if name in self._lut_cache:
            return self._lut_cache[name]
        e = self.entry(name)
        if e.kind != "multiplier":
            raise ValueError("LUT emulation is defined for multipliers")
        if e.width > MAX_LUT_WIDTH:
            raise LutWidthError(name, e.width)
        if e.composition is not None:
            # a 12-bit composed entry's full LUT would technically fit
            # the cap, but materializing it means minutes of gate-level
            # simulation over 2^24 pairs for a table the engine never
            # reads — composed entries execute through their tile
            raise ValueError(
                f"{name!r} is a composed entry and executes through "
                "its 256x256 tile LUT — use tile_lut()/"
                "composition_of() instead of a full product LUT "
                "(DESIGN.md §2.6)")
        lut = lut_from_netlist(e.netlist, e.width)
        self._lut_cache[name] = lut
        return lut

    def composition_of(self, name: str) -> Optional[dict]:
        """The composed-datapath recipe of ``name`` (DESIGN.md §2.6):
        ``{"tile": <8-bit multiplier entry>, "reduce": token}`` for
        composed entries, None for directly-materializable 8-bit
        entries.  Wide entries WITHOUT a composition recipe are not
        executable: above ``MAX_LUT_WIDTH`` that is the LUT-size cap
        (``LutWidthError``); at 9..12 bits a full LUT *could*
        materialize but the execution engine runs 256x256 tiles only,
        so the error says that instead of blaming a cap that was not
        hit."""
        e = self.entry(name)
        if e.composition is not None:
            return dict(e.composition)
        if e.kind == "multiplier" and e.width > TILE_BITS:
            if e.width > MAX_LUT_WIDTH:
                raise LutWidthError(name, e.width)
            raise ValueError(
                f"circuit {name!r} is a direct {e.width}-bit "
                "multiplier: its full LUT fits the "
                f"{MAX_LUT_WIDTH}-bit materialization cap, but the "
                "execution engine runs 256x256 tile LUTs only "
                "(8-bit entries directly, wider ones through a "
                "composition recipe).  Register an executable "
                f"composed entry via add_composed(tile, "
                f"width={e.width}, reduce=...) — DESIGN.md §2.6.")
        return None

    def tile_lut(self, name: str) -> np.ndarray:
        """The 256x256 tile LUT that executes entry ``name``: the
        entry's own LUT for 8-bit multipliers, the composition tile's
        LUT for composed wide entries."""
        comp = self.composition_of(name)
        return self.lut(comp["tile"] if comp else name)

    # -- composed wide entries (DESIGN.md §2.6) --------------------------
    def add_composed(self, tile: str, width: int, reduce: str = "exact",
                     name: Optional[str] = None,
                     samples: int = 1 << 14) -> CircuitEntry:
        """Register a W-bit multiplier composed from 8x8 ``tile``
        partial products reduced by ``reduce``-family adders.

        The composed gate-level netlist is built (the bitsim ground
        truth of the executable engine), characterized against the
        exact same-width array multiplier (sampled — 2W input bits is
        beyond exhaustive reach), costed with the 45 nm gate model, and
        admitted with ``source="composed"`` plus the composition
        recipe.  Idempotent per (tile, width, reduce): the derived name
        is deterministic and an existing entry is returned as-is.
        """
        tile_entry = self.entry(tile, bit_width=TILE_BITS)
        if tile_entry.kind != "multiplier":
            raise ValueError(f"composition tile {tile!r} must be a "
                             "multiplier entry")
        name = name or f"mul{width}u_c_{tile}_{reduce_tag(reduce)}"
        if name in self.entries:
            from .families import parse_reduce
            e = self.entries[name]
            same = (e.width == width and e.composition is not None
                    and e.composition.get("tile") == tile
                    and parse_reduce(e.composition.get("reduce",
                                                       "exact"))
                    == parse_reduce(reduce))
            if not same:
                raise ValueError(
                    f"entry {name!r} already exists with a different "
                    f"recipe ({e.width}-bit, composition="
                    f"{e.composition}) than requested ({width}-bit, "
                    f"tile={tile!r}, reduce={reduce!r}) — explicit "
                    "names must not collide across recipes")
            return e
        nl = composed_multiplier(tile_entry.netlist, width, reduce,
                                 name=name)
        exact_name = f"mul{width}u_exact"
        if exact_name in self.entries:
            exact = self.entries[exact_name].netlist
        else:
            exact = array_multiplier(width)
        errors = evaluate_errors(nl, exact, samples=samples)
        cost = evaluate_cost(nl)
        ref = evaluate_cost(exact).power
        entry = CircuitEntry(
            name=name, kind="multiplier", width=width, source="composed",
            errors=errors, cost=cost,
            rel_power=(cost.power / ref if ref > 0 else 0.0),
            netlist=nl,
            composition={"tile": tile, "reduce": reduce})
        self.add(entry)
        return entry

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"version": 1,
                   "entries": [e.as_dict() for e in self.entries.values()]}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "ApproxLibrary":
        with open(path) as f:
            payload = json.load(f)
        lib = ApproxLibrary()
        for d in payload["entries"]:
            lib.add(CircuitEntry.from_dict(d))
        return lib


# ----------------------------------------------------------------------
# Library construction
# ----------------------------------------------------------------------
def _genome_tag(nl: Netlist) -> str:
    import zlib
    blob = (nl.funcs.tobytes() + nl.in0.tobytes() + nl.in1.tobytes()
            + nl.outputs.tobytes())
    h = zlib.crc32(blob) % (36 ** 4)  # deterministic across processes
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    s = ""
    for _ in range(4):
        s = digits[h % 36] + s
        h //= 36
    return s


def _evolve_family(
    lib: ApproxLibrary, kind: str, width: int, exact: Netlist,
    e_max_ladder: list[float], metric: str, generations: int, seed: int,
) -> int:
    """Run a ladder of single-objective CGP runs; admit every improved
    feasible parent plus the final circuit of each run."""
    added = 0
    prefix = ("mul" if kind == "multiplier" else "add") + f"{width}u_E"

    parent_seed = exact  # chained ladder: each run starts from the last
    for i, e_max in enumerate(sorted(e_max_ladder)):
        collected: list[Netlist] = []

        def keep(nl: Netlist, err: float, area: float) -> None:
            collected.append(nl)

        params = CgpParams(metric=metric, e_max=e_max,
                           generations=generations, seed=seed + i)
        padded = pad_nodes(parent_seed, exact.n_nodes, seed=seed + 100 + i)
        result = evolve(padded, exact, params, on_candidate=keep)
        parent_seed = result.netlist
        collected.append(result.netlist)
        # thin intermediate parents: keep at most 8 per run, spread over time
        if len(collected) > 8:
            idx = np.linspace(0, len(collected) - 1, 8).astype(int)
            collected = [collected[j] for j in idx]
        for nl in collected:
            nl = nl.compact()
            name = prefix + _genome_tag(nl)
            if name in lib.entries:
                continue
            lib.add_netlist(nl, kind, width, "evolved", exact, name=name)
            added += 1
    return added


def _evolve_family_pop(
    lib: ApproxLibrary, kind: str, width: int, exact: Netlist,
    e_max_ladder: list[float], metric: str, generations: int, seed: int,
    engine: str, device=None, stats: Optional[dict] = None,
    sharding=None,
) -> int:
    """Population-parallel ladder (DESIGN.md §2.9): every rung of the
    e_max ladder runs from the shared seed as one generation-synchronous
    sweep — one fused evaluation per generation scores all
    len(ladder) * λ offspring (one K11 launch on the device engine, one
    a device when ``sharding``, a ``launch.mesh.pop_sharding``, splits
    the population).
    Admits every improved feasible parent of every rung plus each rung's
    final circuit; unlike the legacy chained ladder it does NOT thin
    intermediate parents, which is where the extra archive entries at
    equal generation budget come from.  ``stats``, when given, receives
    this family's timings under its prefix."""
    from .evolve_pop import PopEvaluator, evolve_ladder
    prefix = ("mul" if kind == "multiplier" else "add") + f"{width}u_E"
    collected: list[Netlist] = []

    def keep(_run: int, nl: Netlist, err: float, area: float) -> None:
        collected.append(nl)

    t0 = time.perf_counter()
    params = CgpParams(metric=metric, generations=generations, seed=seed)
    padded = pad_nodes(exact, exact.n_nodes, seed=seed + 100)
    ev = PopEvaluator(exact, params, engine=engine, device=device,
                      sharding=sharding)
    results = evolve_ladder(padded, exact, e_max_ladder, params,
                            on_candidate=keep, evaluator=ev)
    t1 = time.perf_counter()
    collected.extend(r.netlist for r in results)
    added = 0
    for nl in collected:
        nl = nl.compact()
        name = prefix + _genome_tag(nl)
        if name in lib.entries:
            continue
        lib.add_netlist(nl, kind, width, "evolved", exact, name=name)
        added += 1
    if stats is not None:
        stats[prefix[:-2]] = {
            "engine": engine, "rungs": len(e_max_ladder),
            "generations": generations, "lam": params.lam,
            "n_nodes": padded.n_nodes, "search_vectors": ev.num,
            "evaluator_calls": ev.n_calls, "scored": ev.n_scored,
            "evolve_s": t1 - t0, "score_host_s": ev.host_s,
            "score_device_s": ev.device_s,
            "admit_s": time.perf_counter() - t1, "added": added}
    return added


def build_default_library(budget: str = "small",
                          progress: bool = False,
                          engine: str = "legacy",
                          device=None,
                          stats: Optional[dict] = None,
                          sharding=None) -> ApproxLibrary:
    """Budgets: 'tiny' (tests, seconds), 'small' (default artifact,
    ~minutes), 'full' (hours — the paper's scale knob).

    ``engine`` picks the evolutionary search backend: 'legacy' keeps
    the sequential chained-ladder ``cgp.evolve`` (byte-stable default
    artifact); 'numpy' / 'device' run the population-parallel
    generational ladder (``evolve_pop.evolve_ladder``, one fused
    evaluation per generation — one K11 launch on ``device`` for
    'device', default the GPU), admit every improved feasible parent
    without thinning, and additionally register composed 12/16-bit rows
    over the evolved 8-bit Pareto tiles (DESIGN.md §2.9).  ``stats``,
    when given, receives each evolved family's timings
    (``_evolve_family_pop``).  ``sharding`` (a ``launch.mesh.
    pop_sharding``) splits the fused population across devices."""
    cfg = {
        "tiny": dict(gens=40, ladder=3, mult_widths=(8,), add_widths=(8,),
                     wide_samples=4096, comp_tiles=1, comp_widths=(12,)),
        "small": dict(gens=250, ladder=8, mult_widths=(8, 12, 16, 32),
                      add_widths=(8, 9, 12, 16, 32, 64, 128),
                      wide_samples=16384, comp_tiles=2,
                      comp_widths=(12, 16)),
        "full": dict(gens=2500, ladder=12, mult_widths=(8, 12, 16, 32),
                     add_widths=(8, 9, 12, 16, 32, 64, 128),
                     wide_samples=65536, comp_tiles=3,
                     comp_widths=(12, 16)),
    }[budget]
    if engine not in ("legacy", "numpy", "device"):
        raise ValueError(f"unknown engine {engine!r} "
                         "(expected 'legacy', 'numpy' or 'device')")
    if engine == "device":
        from ..device import resolve_device
        device = resolve_device(device)
    lib = ApproxLibrary()

    def log(msg: str) -> None:
        if progress:
            print(f"[library] {msg}", flush=True)

    # ---- multipliers -------------------------------------------------
    for w in cfg["mult_widths"]:
        exact = array_multiplier(w)
        lib.add_netlist(exact, "multiplier", w, "exact", exact,
                        name=f"mul{w}u_exact")
        for k in range(1, min(w, 8)):
            lib.add_netlist(truncated_multiplier(w, k), "multiplier", w,
                            "truncation", exact)
        for h in range(0, min(4, w)):
            for v in range(0, min(2 * w - 1, 10)):
                if h == 0 and v == 0:
                    continue
                try:
                    nl = bam_multiplier(w, h, v)
                except Exception:
                    continue
                lib.add_netlist(nl, "multiplier", w, "bam", exact)
        log(f"mul{w}: families done ({len(lib.select('multiplier', w))})")
        # evolution only where exhaustive evaluation is cheap
        if w == 8:
            max_out = float((2 ** w - 1) ** 2)
            ladder = [max_out * (2.0 ** -e) for e in
                      np.linspace(14, 4, cfg["ladder"])]
            if engine == "legacy":
                n = _evolve_family(lib, "multiplier", w, exact, ladder,
                                   "mae", cfg["gens"], seed=1234)
            else:
                n = _evolve_family_pop(lib, "multiplier", w, exact,
                                       ladder, "mae", cfg["gens"],
                                       seed=1234, engine=engine,
                                       device=device, stats=stats,
                                       sharding=sharding)
            log(f"mul{w}: evolved {n}")

    # composed wide rows over the freshly evolved 8-bit Pareto tiles
    # (population engines only — the legacy build stays byte-stable)
    if engine != "legacy":
        front = [e for e in lib.pareto_front("multiplier", 8, "mae")
                 if e.source == "evolved"]
        for tile in front[:cfg["comp_tiles"]]:
            for cw in cfg["comp_widths"]:
                lib.add_composed(tile.name, cw, reduce="exact",
                                 samples=cfg["wide_samples"])
                log(f"mul{cw}: composed over {tile.name}")

    # ---- adders --------------------------------------------------------
    for w in cfg["add_widths"]:
        exact = ripple_carry_adder(w)
        lib.add_netlist(exact, "adder", w, "exact", exact,
                        name=f"add{w}u_exact")
        for k in range(1, w):
            if k > 16:
                break
            lib.add_netlist(loa_adder(w, k), "adder", w, "loa", exact)
            lib.add_netlist(truncated_adder(w, k), "adder", w, "truncation",
                            exact)
        log(f"add{w}: families done")
        if w == 8:
            max_out = float(2 ** (w + 1) - 1)
            ladder = [max_out * (2.0 ** -e) for e in
                      np.linspace(9, 2, cfg["ladder"])]
            if engine == "legacy":
                n = _evolve_family(lib, "adder", w, exact, ladder, "mae",
                                   cfg["gens"], seed=4321)
            else:
                n = _evolve_family_pop(lib, "adder", w, exact, ladder,
                                       "mae", cfg["gens"], seed=4321,
                                       engine=engine, device=device,
                                       stats=stats, sharding=sharding)
            log(f"add{w}: evolved {n}")

    return lib


_default_library: Optional[ApproxLibrary] = None


def load_default_library() -> ApproxLibrary:
    """A new instance of the default library: the prebuilt artifact, or
    a tiny library built on miss.  For callers that add entries, which
    must not reach the process-wide ``get_default_library()``."""
    if os.path.exists(DEFAULT_LIBRARY_PATH):
        return ApproxLibrary.load(DEFAULT_LIBRARY_PATH)
    return build_default_library("tiny")


def get_default_library() -> ApproxLibrary:
    """The default library (``load_default_library``), loaded once a
    process and shared by every caller."""
    global _default_library
    if _default_library is None:
        _default_library = load_default_library()
    return _default_library

"""CLI: build and save an approximate-circuit library (port of
``repro.core.build_library``).

    PYTHONPATH=src python -m repro_torch.core.build_library \\
        --budget small --engine device

``--engine device`` (the default) evolves the 8-bit multiplier and adder
with the population-parallel generational ladder (DESIGN.md §2.9): each
generation's whole population is scored in one launch of the population
simulator (kernel K11) on the GPU, every improved feasible parent is
admitted, and composed 12/16-bit rows are registered over the evolved
Pareto tiles.  ``--engine numpy`` runs the same search on the host,
``legacy`` the sequential chained ladder; both ignore ``--device``.
``--device cpu`` runs the device engine through the kernel's plain
version.

The library is written to ``--out`` (default
``library_data/library_<budget>_<engine>.json`` beside this module);
``get_default_library`` reads ``library_data/default_library.json``, which
this CLI writes only when ``--out`` names it.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

from ..device import DeviceLike
from .library import DEFAULT_LIBRARY_PATH, build_default_library


def default_out(budget: str, engine: str) -> str:
    return os.path.join(os.path.dirname(DEFAULT_LIBRARY_PATH),
                        f"library_{budget}_{engine}.json")


def run(budget: str = "small", engine: str = "device",
        device: DeviceLike = None, out: Optional[str] = None,
        log: Callable[[str], None] = print) -> tuple:
    """Build the library and save it to ``out`` (when given); returns
    the library and a JSON-able record of it: entry counts, the
    evolution timings per family and the wall time."""
    stats: dict = {}
    t0 = time.perf_counter()
    lib = build_default_library(budget, progress=True, engine=engine,
                                device=device, stats=stats)
    wall = time.perf_counter() - t0
    if out:
        lib.save(out)
    sources: dict = {}
    for e in lib.entries.values():
        sources[e.source] = sources.get(e.source, 0) + 1
    log(f"built {len(lib.entries)} circuits ({sources.get('evolved', 0)} "
        f"evolved) in {wall:.1f}s" + (f" -> {out}" if out else ""))
    for row in lib.counts_table():
        log(f"  {row['circuit']:<12} {row['bit_width']:>4}b : "
            f"{row['n_implementations']}")
    return lib, {"budget": budget, "engine": engine,
                 "entries": len(lib.entries), "sources": sources,
                 "counts": lib.counts_table(), "evolution": stats,
                 "wall_s": wall, "out": out}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget", choices=("tiny", "small", "full"),
                    default="small")
    ap.add_argument("--engine", choices=("legacy", "numpy", "device"),
                    default="device",
                    help="evolutionary search backend: sequential "
                         "chained ladder ('legacy') or the "
                         "population-parallel generational ladder on "
                         "the host ('numpy') or the GPU ('device')")
    ap.add_argument("--device", default=None,
                    help="torch device of the device engine (default: "
                         "the first GPU)")
    ap.add_argument("--out", default=None,
                    help="output JSON (default: library_data/"
                         "library_<budget>_<engine>.json)")
    args = ap.parse_args(argv)
    run(args.budget, args.engine, args.device,
        args.out or default_out(args.budget, args.engine))


if __name__ == "__main__":
    main()

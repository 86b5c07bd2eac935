"""Device-resident CGP library generation study on the GPU (the port's
counterpart of ``benchmarks/evolve_library.py``, DESIGN.md §2.9).

Library growth is bounded by fitness evaluation: the numpy engine
simulates one candidate per ``Netlist.eval_words`` call, while the
device engine scores a whole generation in ONE launch of the population
simulator (K11) with er/mae/wce reduced on the device.  The record:

  * candidate evaluations a second of the device engine and of the
    numpy engine on the same population, and their ratio.  The
    reference gates this ratio at 3x; it is a wall-clock ratio of the
    reference's CPU run, and no JAX speed figure is a target for the
    port, so here it is recorded (``speedup_gate_met``), not gated;
  * metric bit identity: every metric of the device engine equal to the
    numpy engine's float64 values on every candidate (gated);
  * circuits a second and the archive-size-against-wall-clock trajectory
    of a fused ``evolve_ladder`` sweep (4 rungs);
  * library growth at equal budget: the ``tiny`` build under
    ``engine="device"`` (K11 scores, K10 re-verifies) must admit more
    evolved entries than the legacy build (gated).

``--quick`` shrinks populations and generations; every gate is
deterministic (fixed seeds).  Gates raise ``launch.GateError`` after the
record is complete; ``main`` writes it to ``--out`` (and nowhere else)
first.

Run: ``PYTHONPATH=src python -m repro_torch.launch.evolve_library
[--quick] [--out record.json]`` (GPU; ``--device cpu`` runs the
device engine through K11's plain version).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from ..core.cgp import CgpParams, mutate, pad_nodes
from ..core.evolve_pop import DEVICE_METRICS, PopEvaluator, evolve_ladder
from ..core.library import build_default_library
from ..core.metrics import METRIC_NAMES
from ..core.seeds import array_multiplier
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from . import GateError

#: The reference's candidate-evals/sec gate (recorded only).
SPEEDUP_GATE = 3.0


def _population(seed_nl, p: int, seed: int = 11):
    rng = np.random.default_rng(seed)
    return [mutate(seed_nl, rng, 5) for _ in range(p)]


def _throughput(ev: PopEvaluator, pop, iters: int) -> float:
    """Candidate evaluations per second over ``iters`` scoring calls
    (each returns its scores on the host, so it waits for the device)."""
    ev.errors_of(pop)              # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        ev.errors_of(pop)
    dt = time.perf_counter() - t0
    return len(pop) * iters / dt


def run(device: DeviceLike = None, quick: bool = False,
        log: Callable[[str], None] = print) -> dict:
    """The study; returns the record (the reference's keys, the device,
    wall times unrounded and each stage's kernel launches).  Raises
    ``GateError`` (its record attached) when a gate fails."""
    dev = resolve_device(device)
    pop_size = 32 if quick else 64
    samples = 4096 if quick else 8192
    iters = 3 if quick else 5
    gens = 15 if quick else 60

    exact = array_multiplier(8)
    seed_nl = pad_nodes(exact, exact.n_nodes, seed=7)
    pop = _population(seed_nl, pop_size)
    params = CgpParams(metric="mae", e_max=256.0, search_samples=samples,
                       seed=3)

    # -- throughput: device vs sequential numpy ------------------------
    ev_np = PopEvaluator(exact, params, engine="numpy")
    ev_dev = PopEvaluator(exact, params, engine="device", device=dev)
    eps_np = _throughput(ev_np, pop, iters)
    eps_dev, tp_launches = ops.launches_during(
        lambda: _throughput(ev_dev, pop, iters))
    speedup = eps_dev / eps_np
    log(f"throughput: numpy {eps_np:.1f}/s, device {eps_dev:.1f}/s, "
        f"{speedup:.2f}x")

    # -- metric bit-identity across engines ----------------------------
    identity = {}
    for metric in METRIC_NAMES:
        p_m = CgpParams(metric=metric, search_samples=samples, seed=3)
        e_np = PopEvaluator(exact, p_m, engine="numpy").errors_of(pop)
        e_dev = PopEvaluator(exact, p_m, engine="device",
                             device=dev).errors_of(pop)
        identity[metric] = bool(np.array_equal(e_np, e_dev))
    metrics_identical = all(identity.values())
    log(f"metric identity: {identity}")

    # -- fused ladder: circuits/sec + archive trajectory ---------------
    max_out = float((2 ** 8 - 1) ** 2)
    ladder = [max_out * (2.0 ** -e) for e in np.linspace(14, 4, 4)]
    lp = CgpParams(metric="mae", generations=gens, search_samples=samples,
                   seed=5)
    trajectory = []
    t0 = time.perf_counter()

    def stamp(_run, _nl, _err, _area):
        trajectory.append({"t_s": time.perf_counter() - t0,
                           "archive_size": len(trajectory) + 1})

    ev_lad = PopEvaluator(exact, lp, engine="device", device=dev)
    results, ladder_launches = ops.launches_during(lambda: evolve_ladder(
        seed_nl, exact, ladder, lp, engine="device", on_candidate=stamp,
        evaluator=ev_lad))
    ladder_s = time.perf_counter() - t0
    n_circuits = len(trajectory) + len(results)
    log(f"ladder: {n_circuits} circuits in {ladder_s:.3f} s, "
        f"{ev_lad.n_scored} candidate evaluations")

    # -- archive growth at equal budget --------------------------------
    t0 = time.perf_counter()
    lib_legacy = build_default_library("tiny")
    legacy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib_dev, build_launches = ops.launches_during(
        lambda: build_default_library("tiny", engine="device", device=dev))
    device_s = time.perf_counter() - t0
    n_ev_legacy = sum(e.source == "evolved"
                      for e in lib_legacy.entries.values())
    n_ev_dev = sum(e.source == "evolved" for e in lib_dev.entries.values())
    grew = n_ev_dev > n_ev_legacy
    log(f"library tiny: legacy {len(lib_legacy.entries)} entries "
        f"({n_ev_legacy} evolved) in {legacy_s:.3f} s; device "
        f"{len(lib_dev.entries)} ({n_ev_dev} evolved) in {device_s:.3f} s")

    record = {
        "bench": "evolve_library",
        "quick": quick,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "pop_size": pop_size,
        "search_samples": samples,
        "throughput": {
            "evals_per_s_numpy": eps_np,
            "evals_per_s_device": eps_dev,
            "speedup": speedup,
            "gate": SPEEDUP_GATE,
            "speedup_gate_met": speedup >= SPEEDUP_GATE,
            "launches": tp_launches,
        },
        "metric_identity": identity,
        "device_metrics": list(DEVICE_METRICS),
        "ladder": {
            "rungs": len(ladder),
            "generations": gens,
            "wall_s": ladder_s,
            "circuits": n_circuits,
            "circuits_per_s": n_circuits / ladder_s,
            "candidate_evals": ev_lad.n_scored,
            "archive_vs_wall_clock": trajectory,
            "launches": ladder_launches,
        },
        "library_tiny": {
            "legacy": {"entries": len(lib_legacy.entries),
                       "evolved": n_ev_legacy, "wall_s": legacy_s},
            "device": {"entries": len(lib_dev.entries),
                       "evolved": n_ev_dev, "wall_s": device_s,
                       "launches": build_launches},
            "grew": grew,
        },
    }
    if not metrics_identical:
        raise GateError(f"device engine metrics are not bit-identical to "
                        f"the numpy engine: {identity}", "metric_identity",
                        record)
    if not grew:
        raise GateError(f"device-engine tiny build admitted {n_ev_dev} "
                        f"evolved entries vs {n_ev_legacy} legacy",
                        "library_growth", record)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller populations and generations")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = None
    try:
        record = run(args.device, quick=args.quick)
    except GateError as e:
        record = e.record
        raise
    finally:
        # written first, so a failed gate still leaves its numbers
        if args.out and record is not None:
            with open(args.out, "w") as f:
                json.dump(record, f, indent=2)


if __name__ == "__main__":
    main()

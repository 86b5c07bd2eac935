"""Heterogeneous vs. uniform Pareto study on the GPU, through the CUDA
datapaths (the port's counterpart of ``benchmarks/heterogeneous_pareto.py``,
DESIGN.md §2.5).

The paper's Table II picks ONE multiplier for the whole network; the
heterogeneous engine composes a different multiplier per layer
(autoAx-style two-stage DSE: per-layer component models -> layer-wise
Pareto pruning + beam composition -> exact batched verification through
``policy_bank_eval``).  On the trained ResNet-8 (full width) and the
synthetic CIFAR-10 test split, with ``mode="lut"`` and the CUDA datapath
named by ``variant`` — ``"pallas"`` (default; gathers on codes: K1 for
one multiplier, K2 for a bank or a policy bank's layer) or ``"fused"``
(quantize and gather in one kernel: K3, K4):

  1. the uniform Table II sweep, batched (one bank pass);
  2. ``explore_heterogeneous``: the per-layer sweep (one bank pass a
     layer) into ``LayerComponents``, layer-wise Pareto pruning and beam
     composition, then exact batched verification of the shortlist plus
     the downgrades of the best uniform point (``_downgrade_candidates``)
     through ``policy_bank_eval`` — one banked kernel call a layer and
     batch for every candidate at once;
  3. the equal-assignment check: ``policy_bank_eval`` of the uniform
     rows against sequential ``policy_for_lane`` evaluations;
  4. the batched verification against the sequential one, timed.

Gates (each raises): step 3 equal bit for bit; step 4 equal; a verified
heterogeneous point dominates the best uniform point (strictly lower
power at no lower accuracy, within the quality bound).

Run: ``PYTHONPATH=src python -m repro_torch.launch.heterogeneous_pareto
[--variant fused] [--out record.json]`` (GPU; ``--device cpu --quick``
runs the 64-image form on the CPU through the kernels' plain versions).
The record is written only where ``--out`` says.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import torch

from ..approx.dse import (DesignPoint, ExploreResult, explore_heterogeneous,
                          select_multiplier, verify_assignments)
from ..approx.layers import ApproxPolicy, policy_bank_eval, policy_for_lane
from ..approx.resilience import all_layers_sweep
from ..approx.specs import BackendSpec, PolicyBank
from ..approx.workload import classification
from ..core.library import get_default_library
from ..device import DeviceLike, resolve_device
from ..kernels import ops
from ..models import resnet
from ..models.weights import load_resnet8
from . import GateError
from .case_study import _timed, case_study_names

#: Aggressive truncations: uniformly fatal, but the cheap lanes the
#: heterogeneous search mixes into insensitive layers.
TRUNCATION_EXTRAS = ("mul8u_trunc4", "mul8u_trunc3", "mul8u_trunc2")


def _point_dict(p: DesignPoint) -> dict:
    d = {"multiplier": p.multiplier, "accuracy": p.accuracy,
         "network_rel_power": p.network_rel_power}
    if p.assignment is not None:
        d["assignment"] = dict(p.assignment)
    return d


def _downgrade_candidates(lib, names, counts, base_mult: str,
                          cap: int = 14) -> list[dict]:
    """Assignments that keep the uniform pick everywhere but downgrade
    layers to strictly cheaper candidates — power strictly below the
    uniform point by construction, so whichever downgrade the network
    tolerates verifies at >= its accuracy.  Single-layer downgrades
    cover every layer (largest counts first: biggest power win when the
    layer turns out insensitive); pair downgrades cover the smallest
    two layers (likeliest to verify)."""
    base_power = lib.entries[base_mult].rel_power
    cheaper = sorted(
        (m for m in names if lib.entries[m].rel_power < base_power),
        key=lambda m: lib.entries[m].rel_power)
    if not cheaper:
        return []
    big_first = sorted(counts, key=counts.get, reverse=True)
    small_first = big_first[::-1]
    out = []
    # thin but near-certain wins first: downgrade the smallest layer(s)
    for m in cheaper[:3]:
        for k in (1, 2):
            a = {l: base_mult for l in counts}
            for l in small_first[:k]:
                a[l] = m
            if a not in out:
                out.append(a)
    # big wins when tolerated: one large layer at a time
    for l in big_first:
        for m in cheaper[:3]:
            a = {k: base_mult for k in counts}
            a[l] = m
            if a not in out:
                out.append(a)
    return out[:cap]


def study_names(lib, n_mult: int) -> list[str]:
    """The study's multipliers: the case study's ``n_mult`` picks and
    Table II baselines, then ``TRUNCATION_EXTRAS``."""
    names = case_study_names(lib, n_mult)
    for extra in TRUNCATION_EXTRAS:
        if extra in lib.entries and extra not in names:
            names.append(extra)
    return names


def run(device: DeviceLike = None, n_mult: Optional[int] = None,
        quick: bool = False, quality_bound: float = 0.02, top_k: int = 8,
        eval_n: Optional[int] = None, batch: int = 64,
        log: Callable[[str], None] = print,
        variant: str = "pallas") -> dict:
    """Run the study; returns a JSON-able record.  ``n_mult`` defaults to
    8 (12 with ``quick``), ``eval_n`` to 256 (64 with ``quick``; the CPU
    tests run it at 8 images in one batch).  Raises
    ``GateError``, which carries the record, when a gate fails."""
    n_mult = n_mult if n_mult is not None else (12 if quick else 8)
    eval_n = eval_n if eval_n is not None else (64 if quick else 256)
    dev = resolve_device(device)
    lib = get_default_library()
    cfg = resnet.resnet_config(8)
    wl = classification(cfg, load_resnet8(), eval_n=eval_n, batch=batch,
                        device=dev)
    counts = wl.layer_counts
    names = study_names(lib, n_mult)
    for n in names:                    # warm LUTs so no path pays packing
        lib.lut(n)

    # -- uniform axis (Table II, batched) ------------------------------
    baseline = wl(ApproxPolicy(default=BackendSpec.golden()))
    rows_uniform, uniform_s = _timed(lambda: all_layers_sweep(
        wl, counts, names, lib, mode="lut", variant=variant, batch=True),
        dev)
    uniform_result = ExploreResult(
        baseline_accuracy=baseline,
        all_layers=[DesignPoint.from_row(r) for r in rows_uniform])
    uniform_best = select_multiplier(uniform_result, quality_bound)

    # -- heterogeneous axis (two-stage DSE) ----------------------------
    extra = ([] if uniform_best is None else
             _downgrade_candidates(lib, names, counts,
                                   uniform_best.multiplier))
    hetero_result, explore_s = _timed(lambda: explore_heterogeneous(
        wl, counts, lib, multipliers=names, variant=variant,
        quality_bound=quality_bound, top_k=top_k,
        extra_assignments=extra, batch=True), dev)
    log(f"{len(names)} multipliers; uniform sweep {uniform_s:.3f} s; "
        f"explore_heterogeneous (per-layer sweep, beam, batched "
        f"verification) {explore_s:.3f} s, "
        f"{len(hetero_result.heterogeneous)} candidates verified")

    # -- equal-assignment consistency ----------------------------------
    layers = tuple(counts)
    upb = PolicyBank.uniform(names, layers, lib)

    def equal_assignment():
        bank = policy_bank_eval(wl.traceable_metrics, upb, mode="lut",
                                variant=variant)["accuracy"]
        seq = [wl(policy_for_lane(upb, p, variant=variant)
                  .materialize(lib)) for p in range(upb.n_policies)]
        return bank.tolist(), seq

    (accs_bank, accs_seq), equal_s = _timed(equal_assignment, dev)
    equal_assignment_identical = accs_bank == accs_seq
    log(f"equal-assignment check ({upb.n_policies} uniform rows, banked "
        f"and sequential) {equal_s:.3f} s; bit identical: "
        f"{equal_assignment_identical}")

    # -- batched vs sequential verification ----------------------------
    to_verify = [dict(p.assignment) for p in hetero_result.heterogeneous]

    def verify(batched):
        return verify_assignments(wl, to_verify, counts, lib, mode="lut",
                                  variant=variant, batch=batched)

    (pts_bat, bat_launches), bat_s = _timed(
        lambda: ops.launches_during(lambda: verify(True)), dev)
    pts_seq, seq_s = _timed(lambda: verify(False), dev)
    verify_identical = ([p.accuracy for p in pts_bat]
                        == [p.accuracy for p in pts_seq])
    speedup = seq_s / bat_s if bat_s > 0 else float("inf")
    log(f"verification of {len(pts_bat)} assignments: batched "
        f"{bat_s:.3f} s (launches {bat_launches}), sequential "
        f"{seq_s:.3f} s, speedup {speedup:.2f}; bit identical: "
        f"{verify_identical}")

    # -- dominance: hetero beats the best uniform point ----------------
    dominating = None
    if uniform_best is not None:
        floor = baseline - quality_bound
        for p in sorted(hetero_result.heterogeneous,
                        key=lambda p: p.network_rel_power):
            if (p.network_rel_power < uniform_best.network_rel_power
                    and p.accuracy >= uniform_best.accuracy
                    and p.accuracy >= floor):
                dominating = p
                break
    if dominating is not None:
        log(f"dominating point: power {dominating.network_rel_power:.4f} "
            f"< {uniform_best.network_rel_power:.4f}, accuracy "
            f"{dominating.accuracy:.4f} >= {uniform_best.accuracy:.4f}")

    record = {
        "benchmark": "heterogeneous_pareto",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "variant": variant, "eval_n": eval_n, "batch": batch,
        "eval_batches": eval_n // batch,
        "n_mult": len(names), "multipliers": names, "quick": quick,
        "quality_bound": quality_bound, "top_k": top_k,
        "baseline_accuracy": baseline,
        "uniform": [_point_dict(p) for p in sorted(
            uniform_result.all_layers,
            key=lambda p: p.network_rel_power)],
        "uniform_best": (_point_dict(uniform_best)
                         if uniform_best else None),
        "heterogeneous": [_point_dict(p) for p in sorted(
            hetero_result.heterogeneous,
            key=lambda p: p.network_rel_power)],
        "selected": (_point_dict(hetero_result.selected)
                     if hetero_result.selected else None),
        "dominating": (_point_dict(dominating) if dominating else None),
        "equal_assignment_bit_identical": equal_assignment_identical,
        "verification": {
            "k": len(pts_bat),
            "layers": len(layers),
            "sequential_s": seq_s,
            "batched_s": bat_s,
            "speedup": speedup,
            "bit_identical": verify_identical,
            "batched_launches": bat_launches,
        },
        "uniform_sweep_s": uniform_s,
        "explore_heterogeneous_s": explore_s,
        "equal_assignment_s": equal_s,
    }
    if not equal_assignment_identical:
        raise GateError(
            "heterogeneous engine diverged from sequential evaluation at "
            f"equal (uniform) assignments: {accs_bank} != {accs_seq}",
            "equal_assignment", record)
    if not verify_identical:
        raise GateError(
            "batched verification diverged from sequential policy "
            f"evaluation: {[p.accuracy for p in pts_bat]} != "
            f"{[p.accuracy for p in pts_seq]}", "verification", record)
    if uniform_best is not None and dominating is None:
        raise GateError(
            "no heterogeneous point dominates the best uniform point "
            f"under quality bound {quality_bound}: "
            f"{json.dumps(record['heterogeneous'])}", "dominance", record)
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--n-mult", type=int, default=None,
                    help="candidate count (default: 8, or 12 with "
                         "--quick)")
    ap.add_argument("--quick", action="store_true",
                    help="64 evaluation images (one batch)")
    ap.add_argument("--quality-bound", type=float, default=0.02)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--variant", default="pallas",
                    choices=("pallas", "fused"),
                    help="CUDA datapath (pallas: K1/K2, fused: K3/K4)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args()
    record = None
    try:
        record = run(args.device, n_mult=args.n_mult, quick=args.quick,
                     quality_bound=args.quality_bound, top_k=args.top_k,
                     variant=args.variant)
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

"""Objective-first DSE study on the GPU (the port's counterpart of
``benchmarks/objectives_pareto.py``, DESIGN.md §2.7): the
Workload/Objective layer that makes a network-level front's axes
pluggable, through the CUDA datapath named by ``variant`` —
``"pallas"`` (K2 for a bank, K1 for one multiplier) or ``"fused"``
(K4, K3):

  * the trained ResNet-8 on the synthetic CIFAR-10 test split, swept as
    one banked pass and Pareto'd over ``("accuracy", "power")`` and over
    ``("accuracy", "power", "delay")``;
  * the 2-D front bit-identity gate: the generic N-d ``pareto_points``
    restricted to ``(accuracy, power)`` must give exactly the points,
    in order, of the pre-refactor sweep (``_legacy_pareto_2d``, kept
    here verbatim);
  * a decoder-LM scenario: ``lm_fidelity`` on reduced ``qwen1.5-0.5b``
    (random weights from a ``torch.Generator``; the reference's
    ``PRNGKey`` stream differs, so its logit_mae values are not
    comparable), swept banked and sequentially — the two must be equal
    — and Pareto'd over ``("logit_mae", "power", "delay")``, which must
    not be empty;
  * one declarative ``select(...)`` pick on each scenario.

``--quick`` evaluates 64 images instead of 256; the decoder is
smoke-sized either way.  Gates raise ``launch.GateError`` after the
record is complete; ``main`` writes it to ``--out`` (and nowhere else)
first.

Run: ``PYTHONPATH=src python -m repro_torch.launch.objectives_pareto
[--quick] [--variant fused] [--out record.json]`` (GPU; ``--device
cpu --quick`` runs through the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import torch

from ..approx.dse import DesignPoint, explore
from ..approx.objectives import MaxDrop, select, value_of
from ..approx.workload import classification, lm_fidelity
from ..core.library import get_default_library
from ..device import DeviceLike, resolve_device
from ..models import resnet
from ..models.weights import load_resnet8
from . import GateError
from .case_study import case_study_names, timed_launches

DECODER_ARCH = "qwen1.5-0.5b"
#: aggressive truncations keep the accuracy axis from saturating on the
#: synthetic eval set, so the fronts stay non-degenerate
TRUNCATION_EXTRAS = ("mul8u_trunc5", "mul8u_trunc4")


def _legacy_pareto_2d(points):
    """The pre-§2.7 (accuracy max, power min) sweep, verbatim — the
    reference side of the bit-identity gate."""
    pts = sorted(points, key=lambda p: (p.network_rel_power, -p.accuracy))
    front, best_acc, i = [], float("-inf"), 0
    while i < len(pts):
        j = i
        power = pts[i].network_rel_power
        while j < len(pts) and pts[j].network_rel_power == power:
            j += 1
        acc_max = pts[i].accuracy
        if acc_max > best_acc:
            front.extend(p for p in pts[i:j] if p.accuracy == acc_max)
            best_acc = acc_max
        i = j
    return front


def study_names(lib, n_mult: int = 8) -> list[str]:
    """The case-study candidates (``case_study_names``) plus the
    aggressive truncations."""
    names = case_study_names(lib, n_mult)
    for extra in TRUNCATION_EXTRAS:
        if extra in lib.entries and extra not in names:
            names.append(extra)
    return names


def _point_dict(p: DesignPoint, axes) -> dict:
    d = {"multiplier": p.multiplier}
    for a in axes:
        d[a] = round(value_of(p, a), 6)
    return d


def run(device: DeviceLike = None, n_mult: int = 8, quick: bool = False,
        quality_bound: float = 0.02, variant: str = "pallas",
        eval_n: Optional[int] = None,
        log: Callable[[str], None] = print) -> dict:
    """The study; returns the record (the reference's keys, the device
    and variant, and each sweep's kernel launches).  Raises
    ``GateError`` (its record attached) when a gate fails.  ``eval_n``
    exists for the CPU test: it replaces the image count (64 with
    ``quick``, else 256), which goes in BN batches of 64, or of
    ``eval_n`` when that is fewer."""
    dev = resolve_device(device)
    lib = get_default_library()

    # -- ResNet scenario: accuracy x power x delay ---------------------
    cfg = resnet.resnet_config(8)
    eval_n = eval_n or (64 if quick else 256)
    wl = classification(cfg, load_resnet8(), eval_n=eval_n,
                        batch=min(64, eval_n), device=dev)
    names = study_names(lib, n_mult)
    sweep = dict(library=lib, mode="lut", variant=variant, per_layer=False)
    result, sweep_s, sweep_launches = timed_launches(lambda: explore(
        workload=wl, multipliers=names, batch=True,
        objectives=("accuracy", "power", "delay"), **sweep), dev)
    front_2d = result.pareto(objectives=("accuracy", "power"))
    legacy_2d = _legacy_pareto_2d(result.all_layers)
    identical_2d = [id(p) for p in front_2d] == [id(p) for p in legacy_2d]
    front_3d = result.pareto()
    pick = select(result, constraints={"accuracy": MaxDrop(quality_bound)},
                  minimize="power", axis="all_layers")
    log(f"resnet sweep ({variant}, {eval_n} images): {len(names)} "
        f"multipliers in {sweep_s:.3f} s; 2-D front {len(front_2d)}, "
        f"3-D front {len(front_3d)}, bit identical {identical_2d}; "
        f"selected {pick.multiplier if pick else None}")

    # -- decoder-LM scenario: logit_mae x power x delay ----------------
    lm_wl = lm_fidelity(DECODER_ARCH, batch=2, seq_len=16, n_batches=2,
                        device=dev)
    lm_names = names[:min(len(names), 6)]
    lm_kw = dict(workload=lm_wl, multipliers=lm_names,
                 objectives=("logit_mae", "power", "delay"), **sweep)
    lm_result, lm_bat_s, lm_bat_launches = timed_launches(
        lambda: explore(batch=True, **lm_kw), dev)
    lm_seq, lm_seq_s, lm_seq_launches = timed_launches(
        lambda: explore(batch=False, **lm_kw), dev)
    lm_identical = ([p.metrics for p in lm_result.all_layers]
                    == [p.metrics for p in lm_seq.all_layers])
    lm_front = lm_result.pareto()
    lm_speedup = lm_seq_s / lm_bat_s if lm_bat_s > 0 else float("inf")
    lm_pick = select(lm_result, constraints={"logit_mae": MaxDrop(0.05)},
                     minimize="power", axis="all_layers")
    log(f"decoder sweep ({DECODER_ARCH} reduced): {len(lm_names)} "
        f"multipliers banked {lm_bat_s:.3f} s, sequential {lm_seq_s:.3f} "
        f"s; 3-D front {len(lm_front)}, bit identical {lm_identical}")

    axes_rn = ("accuracy", "power", "delay")
    axes_lm = ("logit_mae", "top1_agreement", "power", "delay")
    record = {
        "benchmark": "objectives_pareto",
        "quick": quick,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "variant": variant,
        "quality_bound": quality_bound,
        "resnet": {
            "workload": wl.name,
            "eval_n": eval_n,
            "objectives": list(result.objectives),
            "baseline_metrics": result.baseline_metrics,
            "candidates": names,
            "sweep": [_point_dict(p, axes_rn) for p in result.all_layers],
            "pareto_2d": [_point_dict(p, ("accuracy", "power"))
                          for p in front_2d],
            "pareto_3d": [_point_dict(p, axes_rn) for p in front_3d],
            "bit_identical_2d": identical_2d,
            "selected": _point_dict(pick, axes_rn) if pick else None,
            "sweep_s": sweep_s,
            "launches": sweep_launches,
        },
        "decoder": {
            "workload": lm_wl.name,
            "arch": DECODER_ARCH,
            "objectives": list(lm_result.objectives),
            "baseline_metrics": lm_result.baseline_metrics,
            "candidates": lm_names,
            "sweep": [_point_dict(p, axes_lm)
                      for p in lm_result.all_layers],
            "pareto_3d": [_point_dict(p, axes_lm) for p in lm_front],
            "bit_identical": lm_identical,
            "selected": (_point_dict(lm_pick, axes_lm)
                         if lm_pick else None),
            "batched_s": lm_bat_s,
            "sequential_s": lm_seq_s,
            "speedup": lm_speedup,
            "batched_launches": lm_bat_launches,
            "sequential_launches": lm_seq_launches,
        },
    }
    if not identical_2d:
        raise GateError("generic N-d pareto_points diverged from the "
                        "pre-refactor (accuracy, power) sweep",
                        "bit_identical_2d", record)
    if not lm_identical:
        raise GateError("banked LM fidelity sweep diverged from "
                        "sequential evaluation", "lm_bit_identical", record)
    if not lm_front:
        raise GateError("empty 3-axis decoder fidelity front",
                        "lm_front", record)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--n-mult", type=int, default=8,
                    help="case-study candidate count")
    ap.add_argument("--quick", action="store_true",
                    help="64 evaluation images (one batch)")
    ap.add_argument("--quality-bound", type=float, default=0.02)
    ap.add_argument("--variant", default="pallas",
                    choices=("pallas", "fused"),
                    help="CUDA datapath (pallas: K1/K2, fused: K3/K4)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = None
    try:
        record = run(args.device, n_mult=args.n_mult, quick=args.quick,
                     quality_bound=args.quality_bound,
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

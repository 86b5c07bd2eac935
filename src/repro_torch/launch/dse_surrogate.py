"""Surrogate-guided vs exact-sweep heterogeneous DSE on the GPU (the
port's counterpart of ``benchmarks/dse_surrogate.py``, DESIGN.md §2.11).

The exact predict stage of ``explore_heterogeneous`` measures every
candidate against every layer; the surrogate predict stage
(``predictor="surrogate"``) measures a power-spread ``train_fraction``
of the candidates, fits the QoR MLP on those rows (one Adam step
captured as a CUDA graph and replayed), predicts the rest, and verifies
exactly.  Both paths run end to end on the trained ResNet-8 (full
width) and the synthetic CIFAR-10 test split, over n_circuits >= 100
(the library's 8-bit multipliers plus a widened broken-array grid), with
``mode="lut"`` and the CUDA datapath named by ``variant``: ``"pallas"``
(default; K2 for every banked pass) or ``"fused"`` (K4).  The workload's
primary is ``logit_mae`` against the golden int8 logits
(``classification(fidelity=True)``).  The surrogate path runs first.

Gates (each raises ``GateError`` after the record is complete):

  * **speedup** — the surrogate path's wall is >= 3x below the exact
    path's;
  * **fidelity** — the per-layer Spearman rho between predicted and
    measured quality over the circuits the surrogate never measured
    averages >= 0.9;
  * **front** — every point of the exact path's verified Pareto front
    is matched or dominated by a surrogate-path verified point.

The record also holds each path's walls by stage, the MLP fit eager and
captured on the same rows (GPU only), the kernel launches inside each
path and the peak device memory.  The candidates are widened on a new
instance of the default library (``load_default_library``), never on the
process-wide one.

Run: ``PYTHONPATH=src python -m repro_torch.launch.dse_surrogate
[--quick] [--variant fused] [--out record.json]`` (GPU).  The record is
written only where ``--out`` says, also when a gate fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..approx.dse import explore_heterogeneous, pareto_points
from ..approx.ranking import spearman
from ..approx.surrogate import fit_surrogate, fit_walls, warm_up
from ..approx.workload import classification
from ..core.families import bam_multiplier
from ..core.library import load_default_library
from ..device import DeviceLike, resolve_device
from ..kernels import build, ops
from ..models import resnet
from ..models.weights import load_resnet8
from . import GateError

SPEEDUP_GATE = 3.0
FIDELITY_GATE = 0.9
#: the banked kernel under each variant: every per-layer sweep and
#: verification launches it once a layer and eval batch
BANK_KERNEL = {"pallas": "lut_matmul_bank", "fused": "fused_matmul_bank"}


def widen_candidate_set(lib, n_circuits: int) -> list[str]:
    """All 8-bit multipliers, grown to ``n_circuits`` with a denser
    broken-array grid than the library ships (added to ``lib``)."""
    names = [e.name for e in lib.select(kind="multiplier", width=8)]
    exact = lib.entry("mul8u_exact").netlist
    for h in range(0, 7):
        for v in range(0, 15):
            if len(names) >= n_circuits:
                return names
            if h == 0 and v == 0:
                continue                   # the exact multiplier itself
            nl = bam_multiplier(8, h, v)
            if nl.name in lib.entries:
                continue
            lib.add_netlist(nl, "multiplier", 8, "bam", exact)
            names.append(nl.name)
    return names


def _measured_matrix(points, layers, names) -> np.ndarray:
    """(n_layers, n_names) primary-metric matrix from per-layer
    DesignPoints (NaN where unmeasured)."""
    li = {l: j for j, l in enumerate(layers)}
    ni = {n: i for i, n in enumerate(names)}
    out = np.full((len(layers), len(names)), np.nan)
    for p in points:
        if p.layer in li and p.multiplier in ni:
            out[li[p.layer], ni[p.multiplier]] = p.accuracy
    return out


def _front(points) -> list:
    """Verified (logit_mae min, power min) Pareto front, cheapest
    first."""
    return sorted(pareto_points(points, ("logit_mae", "power")),
                  key=lambda p: p.network_rel_power)


def _front_dict(points) -> list[dict]:
    return [{"multiplier": p.multiplier,
             "logit_mae": round(p.accuracy, 6),
             "network_rel_power": round(p.network_rel_power, 6),
             "accuracy": round(float(p.metrics.get("accuracy", np.nan)),
                               6),
             "assignment": dict(p.assignment)} for p in points]


def _matches_or_dominates(sur_front, exact_front,
                          eps: float = 1e-9) -> tuple[bool, list[dict]]:
    """Every exact-front point must have a surrogate-front point at <=
    its quality (min primary) and <= its power."""
    misses = []
    for e in exact_front:
        if not any(s.accuracy <= e.accuracy + eps
                   and s.network_rel_power <= e.network_rel_power + eps
                   for s in sur_front):
            misses.append({"logit_mae": e.accuracy,
                           "network_rel_power": e.network_rel_power})
    return not misses, misses


def layer_pass(lib, names: list[str], layer: str, variant: str,
               device: DeviceLike = None, batch: int = 32):
    """One per-layer pass of the sweep: the ResNet-8 logits of the first
    ``batch`` test images with ``layer`` banked over ``names`` (one lane
    a multiplier, the rest golden int8), and the kernel launches it
    made."""
    from ..approx.layers import bank_eval
    from ..approx.specs import bank_for
    from ..data.synthetic import CifarBatches
    dev = resolve_device(device)
    cfg = resnet.resnet_config(8)
    model = load_resnet8().to(dev)
    b = next(CifarBatches("test", batch, batch).eval_batches())
    images = torch.from_numpy(b["images"]).to(dev)
    bank = bank_for(names, lib)
    return ops.launches_during(lambda: bank_eval(
        lambda pol: {"logits": resnet.forward(model, images, cfg, pol)},
        bank, variant=variant, layer_pattern=layer)["logits"])


def card(dev: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (None off the GPU)."""
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(dev.index or 0)],
        check=True, capture_output=True, text=True).stdout.strip()


def run(device: DeviceLike = None, n_circuits: int = 108,
        quick: bool = False, train_fraction: float = 0.25,
        quality_bound: float = 1.0, top_k: int = 8,
        variant: str = "pallas", eval_n: Optional[int] = None,
        batch: int = 32, log: Callable[[str], None] = print) -> dict:
    """Run both paths; returns a JSON-able record.  ``eval_n`` defaults
    to 64 (32 with ``quick``).  Raises ``GateError``, which carries the
    record, when a gate fails."""
    dev = resolve_device(device)
    eval_n = eval_n if eval_n is not None else (32 if quick else 64)
    lib = load_default_library()
    names = widen_candidate_set(lib, n_circuits)
    cfg = resnet.resnet_config(8)
    wl = classification(cfg, load_resnet8(), eval_n=eval_n, batch=batch,
                        fidelity=True, device=dev)
    counts = wl.layer_counts
    layers = tuple(counts)
    for n in names:                 # warm LUT packing for both paths
        lib.lut(n)
    t0 = time.perf_counter()
    if dev.type == "cuda":          # built and warm before the walls start
        build.load(BANK_KERNEL[variant])
        warm_up(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    warm_s = time.perf_counter() - t0
    log(f"{len(names)} candidates, {len(layers)} layers, {eval_n} images "
        f"in batches of {batch}, variant {variant}")

    def timed_path(predictor: str):
        walls: dict = {}
        t0 = time.perf_counter()
        res, launches = ops.launches_during(lambda: explore_heterogeneous(
            wl, counts, lib, multipliers=names, variant=variant,
            quality_bound=quality_bound, top_k=top_k, batch=True,
            predictor=predictor, train_fraction=train_fraction,
            device=dev, stage_walls=walls))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0, walls, launches

    # -- surrogate-guided DSE first, then the exact-sweep DSE -----------
    res_sur, t_sur, walls_sur, launches_sur = timed_path("surrogate")
    log(f"surrogate path {t_sur:.3f} s {walls_sur}; launches "
        f"{launches_sur}")
    res_exact, t_exact, walls_exact, launches_exact = timed_path("exact")
    speedup = t_exact / t_sur if t_sur > 0 else float("inf")
    log(f"exact path {t_exact:.3f} s {walls_exact}; launches "
        f"{launches_exact}; speedup {speedup:.2f}")

    # -- predicted-vs-measured fidelity on UNSEEN circuits --------------
    # the surrogate run's per_layer points are its measured training
    # rows; refitting on them repeats the run's fit
    predictor = fit_surrogate(res_sur.per_layer, lib,
                              res_sur.baseline_accuracy, direction="min",
                              device=dev)
    seen = set(predictor.train_names) | set(predictor.val_names)
    unseen = [n for n in names if n not in seen]
    predicted = predictor.predict_quality(unseen, lib)
    measured = _measured_matrix(res_exact.per_layer, layers, unseen)
    rho = {}
    for j, layer in enumerate(layers):
        ok = ~np.isnan(measured[j])
        rho[layer] = spearman(predicted[j][ok], measured[j][ok])
    valid = [v for v in rho.values() if not np.isnan(v)]
    mean_rho = float(np.mean(valid)) if valid else float("nan")
    min_rho = float(np.min(valid)) if valid else float("nan")
    log(f"fidelity on {len(unseen)} unseen circuits: mean rho "
        f"{mean_rho:.4f}, min {min_rho:.4f}")
    fit = (fit_walls(res_sur.per_layer, lib, res_sur.baseline_accuracy,
                     direction="min", device=dev)
           if dev.type == "cuda" else None)
    if fit is not None:
        log(f"MLP fit: eager {fit['eager_s']:.4f} s, captured "
            f"{fit['captured_s']:.4f} s, bit equal {fit['bit_equal']}")

    # -- verified front quality -----------------------------------------
    front_sur = _front(res_sur.heterogeneous)
    front_exact = _front(res_exact.heterogeneous)
    front_ok, front_misses = _matches_or_dominates(front_sur, front_exact)
    log(f"front: surrogate {len(front_sur)} points, exact "
        f"{len(front_exact)}; matches or dominates: {front_ok}")

    n_measured = res_sur.surrogate["n_train"] + res_sur.surrogate["n_val"]
    record = {
        "benchmark": "dse_surrogate",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card(dev),
        "variant": variant,
        "quick": quick,
        "n_circuits": len(names),
        "n_layers": len(layers),
        "eval_n": eval_n,
        "batch": batch,
        "eval_batches": eval_n // batch,
        "train_fraction": train_fraction,
        "quality_bound": quality_bound,
        "top_k": top_k,
        "workload_primary": "logit_mae",
        "surrogate": res_sur.surrogate,
        "end_to_end": {
            "surrogate_s": t_sur,
            "exact_s": t_exact,
            "speedup": speedup,
            "gate": SPEEDUP_GATE,
            "surrogate_stages": walls_sur,
            "exact_stages": walls_exact,
            "evals_surrogate": n_measured * len(layers),
            "evals_exact": len(names) * len(layers),
        },
        "fit": fit,
        "warm_up_s": warm_s,
        "launches": {"surrogate": launches_sur, "exact": launches_exact},
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "fidelity": {
            "protocol": "per-layer Spearman rho, unseen circuits only",
            "n_unseen": len(unseen),
            "per_layer_rho": {k: (None if np.isnan(v) else v)
                              for k, v in rho.items()},
            "mean_rho": mean_rho,
            "min_rho": min_rho,
            "gate": FIDELITY_GATE,
        },
        "front": {
            "surrogate": _front_dict(front_sur),
            "exact": _front_dict(front_exact),
            "matches_or_dominates": front_ok,
            "misses": front_misses,
            "selected_surrogate": (
                round(res_sur.selected.network_rel_power, 6)
                if res_sur.selected else None),
            "selected_exact": (
                round(res_exact.selected.network_rel_power, 6)
                if res_exact.selected else None),
        },
    }
    if speedup < SPEEDUP_GATE:
        raise GateError(
            f"surrogate-guided DSE speedup {speedup:.2f}x is below the "
            f"{SPEEDUP_GATE}x gate", "speedup", record)
    if not (mean_rho >= FIDELITY_GATE):
        raise GateError(
            f"predicted-vs-measured per-layer Spearman (mean "
            f"{mean_rho:.4f}) is below the {FIDELITY_GATE} gate",
            "fidelity", record)
    if not front_ok:
        raise GateError(
            "surrogate-guided verified front fails to match or dominate "
            f"the exact-predict front: misses {front_misses}", "front",
            record)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="32 evaluation images (one batch)")
    ap.add_argument("--n-circuits", type=int, default=108)
    ap.add_argument("--train-fraction", type=float, default=0.25)
    ap.add_argument("--quality-bound", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--variant", default="pallas",
                    choices=tuple(BANK_KERNEL),
                    help="CUDA datapath (pallas: K2, fused: K4)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = None
    try:
        record = run(args.device, n_circuits=args.n_circuits,
                     quick=args.quick, train_fraction=args.train_fraction,
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

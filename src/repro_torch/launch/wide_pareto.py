"""The wide-width (composed 12/16-bit) Pareto study on the GPU, through
the CUDA datapaths (the port's counterpart of
``benchmarks/wide_width_pareto.py``).

The paper's extended library spans wider circuits than the 8-bit rows;
composed W-bit multipliers decompose into tiled 8x8 LUT partial
products reduced by library adder trees (DESIGN.md §2.6), so 12/16-bit
candidates evaluate end to end beside the 8-bit ones.  On the trained
ResNet-8 (full width) and the synthetic CIFAR-10 test split, with
``mode="lut"`` and the CUDA datapath named by ``variant``: ``"fused"``
(default; quantize and gather in one kernel: K3 for 8-bit, K7/K8 for
composed) or ``"pallas"`` (gathers on codes: K1 for 8-bit, K5/K6 for
composed — every lane shares the recipes' one tree, ``loa4``, so K6
takes each bank in one launch):

  1. the candidates: the case-study picks (``case_study_names(lib,
     n_mult)``) plus the composed ``WIDE_RECIPES``, power rebased onto
     ``mul8u_exact`` (``rel_power_map(..., ref="mul8u_exact")``);
  2. the wide candidates sequentially (kernel K7 | K5) and as one bank
     (K8 | K6), timed;
  3. the mixed-width all-layers sweep as one bank (K8 | K6) against the
     sequential rows (8-bit: K3 | K1; wide: step 2) — gate: equal
     accuracies;
  4. the fidelity axis (mean |logit error| vs the f32 model, one more
     banked pass) and the Pareto fronts within the accuracy bound — gate:
     a 12/16-bit point beats every 8-bit point's fidelity.

Run: ``PYTHONPATH=src python -m repro_torch.launch.wide_pareto
[--variant pallas]`` (GPU; ``--device cpu --eval-n 16 --batch 8`` runs a
small version on the CPU through the kernels' plain versions).  Raises
when a gate fails.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch

from ..approx.dse import DesignPoint, ExploreResult, pareto_points
from ..approx.layers import ApproxPolicy
from ..approx.power import rel_power_map
from ..approx.resilience import all_layers_sweep
from ..approx.specs import BackendSpec
from ..approx.workload import classification, logit_fidelity
from ..core.library import get_default_library
from ..data.synthetic import CifarBatches
from ..device import DeviceLike, resolve_device
from ..models import resnet
from ..models.weights import load_resnet8
from .case_study import case_study_names

#: Composed wide candidates (tile, width, reduce): exact tiles probe the
#: pure quantization axis, truncated tiles with LOA reduction the
#: approximate one (the reference benchmark's recipes).
WIDE_RECIPES = (
    ("mul8u_exact", 16, "loa4"),
    ("mul8u_exact", 12, "loa4"),
    ("mul8u_trunc6", 16, "loa4"),
    ("mul8u_trunc5", 12, "loa4"),
    ("mul8u_trunc4", 16, "loa4"),
)


def wide_names(lib) -> list[str]:
    """Register the ``WIDE_RECIPES`` whose tile the library has; their
    names, in recipe order."""
    return [lib.add_composed(tile, width, reduce).name
            for tile, width, reduce in WIDE_RECIPES
            if tile in lib.entries]


def _timed(fn: Callable, device: torch.device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _point_dict(p: DesignPoint, width: int) -> dict:
    return {"multiplier": p.multiplier, "bit_width": width,
            "accuracy": p.accuracy,
            "network_rel_power": p.network_rel_power}


def run(device: DeviceLike = None, eval_n: int = 256, batch: int = 64,
        n_mult: int = 6, quality_bound: float = 0.02,
        log: Callable[[str], None] = print,
        variant: str = "fused") -> dict:
    """Run the study; returns a JSON-able record.  Raises when the banked
    mixed-width accuracies differ from the sequential ones, or when no
    wide point beats every 8-bit point's fidelity within the bound."""
    dev = resolve_device(device)
    lib = get_default_library()
    cfg = resnet.resnet_config(8)
    model = load_resnet8()
    wl = classification(cfg, model, eval_n=eval_n, batch=batch, device=dev)
    counts = wl.layer_counts
    narrow = case_study_names(lib, n_mult)
    wide = wide_names(lib)
    names = narrow + wide
    widths = {n: lib.entry(n).width for n in names}
    for n in names:                    # warm tile LUTs out of the timing
        lib.tile_lut(n)
    rp = rel_power_map(lib, names, ref="mul8u_exact")

    def sweep(workload, cands, batched):
        return all_layers_sweep(workload, counts, cands, lib, mode="lut",
                                variant=variant, batch=batched,
                                rel_power=rp)

    baseline = wl(ApproxPolicy(default=BackendSpec.golden()))
    wide_bat, bat_s = _timed(lambda: sweep(wl, wide, True), dev)
    wide_seq, seq_s = _timed(lambda: sweep(wl, wide, False), dev)
    wide_identical = ([r.accuracy for r in wide_bat]
                      == [r.accuracy for r in wide_seq])
    log(f"{len(wide)} wide candidates: sequential {seq_s:.3f} s, batched "
        f"{bat_s:.3f} s; equal accuracies: {wide_identical}")

    rows_bat, mixed_s = _timed(lambda: sweep(wl, names, True), dev)
    rows_seq = sweep(wl, narrow, False) + wide_seq
    bit_identical = ([r.accuracy for r in rows_bat]
                     == [r.accuracy for r in rows_seq])
    log(f"mixed-width bank of {len(names)} lanes: {mixed_s:.3f} s; equal "
        f"to sequential: {bit_identical}")

    images = [torch.from_numpy(b["images"]).to(dev) for b in
              CifarBatches("test", eval_n, batch).eval_batches()]
    fid_wl = logit_fidelity(
        lambda policy, img: resnet.forward(model, img, cfg, policy),
        images, name="resnet_fidelity")
    fid_rows, fid_s = _timed(lambda: sweep(fid_wl, names, True), dev)
    fidelity = {r.multiplier: r.metrics["logit_mae"] for r in fid_rows}

    result = ExploreResult(
        baseline_accuracy=baseline,
        all_layers=[DesignPoint.from_row(r) for r in rows_bat])
    within = [p for p in result.all_layers
              if p.accuracy >= baseline - quality_bound]
    front = pareto_points(within)
    # fidelity front within the accuracy bound: the Pareto sweep with
    # fidelity negated (pareto_points maximizes accuracy)
    fid_front = pareto_points([DesignPoint(
        multiplier=p.multiplier, layer="all",
        accuracy=-fidelity[p.multiplier],
        network_rel_power=p.network_rel_power,
        multiplier_rel_power=p.multiplier_rel_power, mult_share=1.0)
        for p in within])
    best8 = min((fidelity[p.multiplier] for p in within
                 if widths[p.multiplier] == 8), default=float("inf"))
    wide_beyond_8bit = [p.multiplier for p in within
                        if widths[p.multiplier] > 8
                        and fidelity[p.multiplier] < best8]
    log(f"fidelity sweep {fid_s:.3f} s; accuracy front {len(front)}, "
        f"fidelity front {len(fid_front)}; wide points beyond every "
        f"8-bit fidelity: {wide_beyond_8bit}")

    def sweep_dict(p):
        return {**_point_dict(p, widths[p.multiplier]),
                "logit_mae_vs_f32": fidelity[p.multiplier]}

    record = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "variant": variant, "eval_n": eval_n, "batch": batch,
        "quality_bound": quality_bound, "baseline_accuracy": baseline,
        "candidates": [{"multiplier": n, "bit_width": widths[n],
                        "rel_power_vs_mul8u_exact": rp[n]} for n in names],
        "sweep": [sweep_dict(p) for p in sorted(
            result.all_layers, key=lambda p: p.network_rel_power)],
        "pareto_front_accuracy": [_point_dict(p, widths[p.multiplier])
                                  for p in front],
        "pareto_front_fidelity": [sweep_dict(next(
            q for q in within if q.multiplier == p.multiplier))
            for p in fid_front],
        "wide_beyond_8bit_fidelity": wide_beyond_8bit,
        "mixed_bit_identical": bit_identical,
        "wide_bit_identical": wide_identical,
        "wide_sequential_s": seq_s, "wide_batched_s": bat_s,
        "mixed_batched_s": mixed_s, "fidelity_batched_s": fid_s,
    }
    if not (bit_identical and wide_identical):
        raise RuntimeError("mixed-width banked sweep diverged from the "
                           f"sequential evaluation: {record['sweep']}")
    if wide and not wide_beyond_8bit:
        raise RuntimeError("no composed wide point beat every 8-bit "
                           "candidate's fidelity within the quality bound")
    return record


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--eval-n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-mult", type=int, default=6,
                    help="8-bit case-study picks (wide recipes ride on "
                         "top)")
    ap.add_argument("--quality-bound", type=float, default=0.02)
    ap.add_argument("--variant", default="fused",
                    choices=("fused", "pallas"),
                    help="CUDA datapath: single-kernel (K3/K7/K8) or "
                         "gathers on codes (K1/K5/K6)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args()
    record = run(args.device, eval_n=args.eval_n, batch=args.batch,
                 n_mult=args.n_mult, quality_bound=args.quality_bound,
                 variant=args.variant)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)


if __name__ == "__main__":
    main()

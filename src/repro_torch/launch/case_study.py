"""The paper's case study on the GPU: Table II and Fig. 4 for the trained
ResNet-8 at full width, through the CUDA kernels (the port's
counterpart of ``benchmarks/resilience_full.py`` plus ``dse.explore``).

Steps, all with ``mode="lut"`` and the CUDA datapath named by
``variant``: ``"pallas"`` (default; LUT gathers on codes, kernels K1/K2)
or ``"fused"`` (quantize and gather in one kernel, K3/K4):

  1. the circuit library, the paper's case-study candidate set
     (``case_study_names``: 16 Pareto picks plus the truncation/BAM
     baselines Table II always reports), and the f32 / golden-int8
     accuracies of the committed checkpoint;
  2. the all-layers sweep (Table II) sequentially — one multiplier at a
     time, kernel K1 (K3 fused) — and batched — the whole bank at once,
     kernel K2 (K4 fused) — failing unless both give the same
     accuracies;
  3. ``explore(batch=True)``: the batched all-layers and per-layer
     (Fig. 4, the 9 conv layers) sweeps, and ``select_multiplier`` at a
     1-point accuracy budget.

Run: ``PYTHONPATH=src python -m repro_torch.launch.case_study`` (GPU;
``--device cpu --eval-n 16 --batch 8`` runs a small version on the CPU
through the kernels' plain versions; ``--profile`` breaks one batched
all-layers sweep down by kernel and by the port's own spans under
``torch.profiler``).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch

from .. import obs
from ..approx.dse import ExploreResult, explore
from ..approx.layers import ApproxPolicy
from ..approx.resilience import all_layers_sweep
from ..approx.specs import BackendSpec
from ..approx.workload import classification
from ..core.library import get_default_library
from ..device import DeviceLike, resolve_device
from ..models import resnet
from ..models.weights import load_resnet8

#: Baselines Table II always reports next to the Pareto picks.
TABLE_II_EXTRAS = ("mul8u_trunc7", "mul8u_trunc6", "mul8u_bam_h0_v4")


def case_study_names(lib, n_mult: int = 16) -> list[str]:
    """The paper's candidate set: Pareto selection capped at ``n_mult``,
    plus the truncation/BAM baselines Table II always reports (the same
    rule as ``benchmarks/resilience_common.case_study_names``)."""
    sel = lib.case_study_selection(per_metric=10)
    names = [e.name for e in sel][:n_mult]
    for extra in TABLE_II_EXTRAS:
        if extra in lib.entries and extra not in names:
            names.append(extra)
    return names


def main_path_shapes(cfg: resnet.ResNetConfig, batch: int
                     ) -> dict[str, tuple[int, int, int]]:
    """(M, K, N) of every approximated matmul of one ``batch``-image
    forward: im2col rows x patch features x output channels."""
    shapes = {}
    size = cfg.image_size
    shapes["conv_init"] = (batch * size * size, 27, cfg.widths[0])
    cin = cfg.widths[0]
    for s, width in enumerate(cfg.widths):
        for b in range(cfg.n_blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            out = size // stride
            m = batch * out * out
            shapes[f"s{s}_b{b}_conv1"] = (m, 9 * cin, width)
            shapes[f"s{s}_b{b}_conv2"] = (m, 9 * width, width)
            if cin != width:
                shapes[f"s{s}_b{b}_proj"] = (m, cin, width)
            size, cin = out, width
    shapes["head"] = (batch, cfg.widths[-1], cfg.n_classes)
    return shapes


def _timed(fn: Callable, device: torch.device):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def timed_launches(fn: Callable, device: torch.device):
    """(``fn()``, its wall time in s, the kernel launches it made)."""
    from ..kernels import ops
    (out, launches), wall = _timed(lambda: ops.launches_during(fn), device)
    return out, wall, launches


def _setup(device: DeviceLike, eval_n: int, batch: int, n_mult: int):
    dev = resolve_device(device)
    lib = get_default_library()
    names = case_study_names(lib, n_mult)
    for n in names:                     # warm LUTs so no sweep pays
        lib.lut(n)
    wl = classification(resnet.resnet_config(8), load_resnet8(),
                        eval_n=eval_n, batch=batch, device=dev)
    return dev, lib, names, wl


def run(device: DeviceLike = None, eval_n: int = 256, batch: int = 64,
        n_mult: int = 16, max_accuracy_drop: float = 0.01,
        log: Callable[[str], None] = print,
        variant: str = "pallas") -> dict:
    """Run the case study; returns a JSON-able record (rows, selection,
    wall times).  Raises when the batched sweep disagrees with the
    sequential one."""
    dev, lib, names, wl = _setup(device, eval_n, batch, n_mult)
    counts = wl.layer_counts

    acc_f32 = wl(ApproxPolicy(default=BackendSpec.exact("f32")))
    acc_int8 = wl(ApproxPolicy(default=BackendSpec.golden()))
    log(f"float accuracy {acc_f32:.4f}; golden int8 {acc_int8:.4f}; "
        f"{len(names)} multipliers")

    seq, seq_s = _timed(lambda: all_layers_sweep(
        wl, counts, names, lib, mode="lut", variant=variant), dev)
    bat, bat_s = _timed(lambda: all_layers_sweep(
        wl, counts, names, lib, mode="lut", variant=variant, batch=True),
        dev)
    result, explore_s = _timed(lambda: explore(
        workload=wl, library=lib, multipliers=names, mode="lut",
        variant=variant, batch=True,
        quality_bound=max_accuracy_drop), dev)
    accs = {"sequential": [r.accuracy for r in seq],
            "batched": [r.accuracy for r in bat],
            "explore": [p.accuracy for p in result.all_layers]}
    if not accs["sequential"] == accs["batched"] == accs["explore"]:
        raise RuntimeError(f"batched sweep diverged from the sequential "
                           f"path: {accs}")
    log(f"all-layers sweep: sequential {seq_s:.3f} s, batched "
        f"{bat_s:.3f} s; explore (batched all-layers + per-layer) "
        f"{explore_s:.3f} s")
    _log_table(result, log)
    pick = result.selected
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "variant": variant, "eval_n": eval_n, "batch": batch,
        "multipliers": names,
        "accuracy_f32": acc_f32, "accuracy_int8": acc_int8,
        "all_layers_sequential_s": seq_s, "all_layers_batched_s": bat_s,
        "explore_batched_s": explore_s,
        "result": result.to_json_dict(),
        "selected": pick.multiplier if pick is not None else None,
    }


def profile_batched_sweep(device: DeviceLike = None, eval_n: int = 256,
                          batch: int = 64, n_mult: int = 16, top: int = 15,
                          log: Callable[[str], None] = print,
                          variant: str = "pallas") -> dict:
    """Where the time of the batched all-layers sweep goes: one warm-up
    sweep, then one under ``torch.profiler``.  Reports the wall time,
    the device's busy share (summed kernel time over wall time; one
    stream), the ``top`` kernels by device time and the port's own
    spans (``obs``): stream ms self time by span, stream ms of each
    layer's datapath call and the bytes moved to the device (host ms on
    the CPU)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev, lib, names, wl = _setup(device, eval_n, batch, n_mult)

    def sweep():
        return all_layers_sweep(wl, wl.layer_counts, names, lib,
                                mode="lut", variant=variant, batch=True)

    _timed(sweep, dev)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        _, wall = _timed(sweep, dev)
    events = [e for e in prof.key_averages()     # kernels, not host ops
              if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    rows = [{"name": e.key, "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in events[:top]]
    log(f"batched all-layers sweep under the profiler: wall "
        f"{wall * 1e3:.1f} ms, device busy {device_ms:.1f} ms "
        f"({device_ms / (wall * 1e3):.1%})")
    for r in rows:
        log(f"  {r['device_ms']:9.3f} ms  {r['calls']:6d} calls  "
            f"{r['name'][:90]}")
    spans = _span_table(obs.snapshot(), log)
    return {"wall_ms": wall * 1e3, "device_busy_ms": device_ms,
            "top": rows, "spans": spans}


def _span_table(snap: dict, log) -> dict:
    """Log and return a recording's stream ms self time by span, stream
    ms of the datapath by layer and the bytes moved to the device."""
    by_span = obs.self_ms(snap)
    by_layer = obs.stream_ms_by(snap, "datapath", "layer")
    moved = obs.total(snap, "bytes_to_device")
    log(f"the port's spans ({snap['clock']} clock): self ms by span")
    for name, ms in sorted(by_span.items(), key=lambda kv: -kv[1]):
        log(f"  {ms:9.3f} ms  {name}")
    log("datapath ms by layer")
    for layer, ms in by_layer.items():
        log(f"  {ms:9.3f} ms  {layer}")
    log(f"moved to the device: {moved} bytes; kernel launches "
        f"{snap['launches']}; kernels built or loaded {snap['builds']}")
    return {"self_ms": by_span, "datapath_ms": by_layer,
            "bytes_to_device": moved, "launches": snap["launches"],
            "builds": snap["builds"]}


def _log_table(result: ExploreResult, log) -> None:
    log(f"table_II/8bit_exact_golden acc={result.baseline_accuracy:.4f} "
        "power=1.0")
    for p in sorted(result.all_layers, key=lambda p: -p.network_rel_power):
        log(f"table_II/{p.multiplier} acc={p.accuracy:.4f} "
            f"power={p.network_rel_power:.4f} mae={p.errors['mae']:.3f} "
            f"wce={p.errors['wce']:.0f} er={p.errors['er']:.4f}")
    pick = result.selected
    if pick is None:
        log("table_II/selected none within the budget")
    else:
        log(f"table_II/selected/{pick.multiplier} acc={pick.accuracy:.4f} "
            f"power={pick.network_rel_power:.4f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--eval-n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-mult", type=int, default=16)
    ap.add_argument("--variant", default="pallas",
                    choices=("pallas", "fused"),
                    help="CUDA datapath (pallas: K1/K2, fused: K3/K4)")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--profile", action="store_true",
                    help="profile one batched all-layers sweep instead")
    args = ap.parse_args()
    step = profile_batched_sweep if args.profile else run
    record = step(args.device, eval_n=args.eval_n, batch=args.batch,
                  n_mult=args.n_mult, variant=args.variant)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)


if __name__ == "__main__":
    main()

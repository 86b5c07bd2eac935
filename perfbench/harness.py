"""One run of one cell: load, warm up, measure, check, print one line.

Everything is found by name.  ``BENCHMARK.json`` names the cell; its
traffic mix is ``perfbench/workloads/<cell>.json``, whose ``driver``
names ``perfbench/drivers/<driver>.py`` (the general generator that
reads it) and whose configuration is ``perfbench/configs/<config>.json``;
each metric is read by ``perfbench/metrics/<name before the first
dot>.py``.  A new cell, configuration or metric is new files and
manifest entries.

A run: the driver builds the cell from the seed (weights, inputs, the
bank of multiplier tables) and warms up each shape the traffic uses;
that is set-up.  Then passes run back to back for ``seconds``, each
issued when the last has ended; with ``trace`` the profiler records the
first ``trace_passes`` of them.  After the window the program's state is
freed and the plain reference checks a sample of the passes drawn from
the seed.  The last line of standard output is the result.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import random
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that must end without a result."""


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def guard_modules(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"{when}: forbidden modules loaded: {found}")


def load_manifest(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find(manifest: dict, key: str, name: str) -> dict:
    for entry in manifest[key]:
        if entry["name"] == name:
            return entry
    raise RunError(f"no {key[:-1]} named {name!r} in the manifest")


@dataclass
class Context:
    """What the metric readers take."""
    setup_s: float = 0.0
    window_s: float = 0.0
    pass_s: list = field(default_factory=list)
    units: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    trace: object = None


def worst_of(readings: list, limits: dict) -> dict:
    """Each compared number's worst reading over ``readings`` (dicts of
    name -> value), beside its limit."""
    return {name: {"value": max(r[name] for r in readings),
                   "limit": limits[name]} for name in readings[0]}


def read_metric(name: str, ctx: Context, root: Path = ROOT):
    mod = import_file(root / "perfbench" / "metrics"
                      / f"{name.split('.')[0]}.py")
    return mod.read(ctx)


def import_file(path: Path):
    """The module in ``path`` (a driver or a metric), imported once."""
    key = f"perfbench_{path.parent.name}_{path.stem}".replace("-", "_")
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer
    metrics: those that list it, or that list no cells (a per-layer
    metric without a list goes wherever its ``moves`` metric does)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def device_info(torch, peak_bytes: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, manifest_path: Path = ROOT / "BENCHMARK.json",
        device: str = "cuda", overrides: dict | None = None,
        log=None) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` and
    ``overrides`` (workload parameters) serve the tests, which run the
    cell at a tiny size through the kernels' plain versions."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    root = Path(manifest_path).resolve().parent
    manifest = load_manifest(manifest_path)
    cell = find(manifest, "workloads", workload)
    spec = json.loads((root / "perfbench" / "workloads"
                       / f"{workload}.json").read_text())
    spec.update(overrides or {})
    if spec["config"] != cell["config"]:
        raise RunError(f"{workload}: its file names config "
                       f"{spec['config']!r}, the manifest "
                       f"{cell['config']!r}")
    config_entry = find(manifest, "configs", cell["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    driver = import_file(root / "perfbench" / "drivers"
                         / f"{spec['driver']}.py")
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{workload} needs {cell['chips']} devices, "
                           f"{torch.cuda.device_count()} present")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    dev = torch.device(device)

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_build = time.perf_counter()
    cellrun = driver.build(spec, config, seed, dev, root)
    sync()
    t_warm = time.perf_counter()
    cellrun.warmup()
    sync()
    guard_modules("end of set-up")
    from repro_torch.kernels import build as kbuild
    log(f"[setup] imports and device {t_build - t_start:.3f} s, cell "
        f"{t_warm - t_build:.3f} s, warm-up pass "
        f"{time.perf_counter() - t_warm:.3f} s; kernel builds "
        f"{[e for e in kbuild.EVENTS if e[0] == 'build']}; "
        f"{getattr(cellrun, 'setup_log', {})}")

    trace_passes = int(spec.get("trace_passes", 0)) if trace else 0
    outputs, ends = [], []
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    captured: dict = {}
    prof_cm = None
    t_trace0 = t_trace1 = 0.0
    try:
        while True:
            i = len(outputs)
            if i == 0 and trace_passes:
                from . import trace as tr
                prof_cm = tr.traced()
                captured = prof_cm.__enter__()
                t_trace0 = time.perf_counter()
            outputs.append(cellrun.run_pass(i, traced=prof_cm is not None))
            sync()
            ends.append(time.perf_counter())
            if prof_cm is not None and len(outputs) == trace_passes:
                t_trace1 = ends[-1]
                prof_cm.__exit__(None, None, None)
                prof_cm = None
            if ends[-1] >= deadline and prof_cm is None:
                break
    finally:
        if prof_cm is not None:
            prof_cm.__exit__(None, None, None)
        gc.enable()
    t1 = time.perf_counter()
    window_s = t1 - t0
    apart = [b - a for a, b in zip([t0] + ends[:-1], ends)]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    guard_modules("end of the window")

    ctx = Context(setup_s=setup_s, window_s=window_s, pass_s=apart,
                  units={k: v * len(outputs)
                         for k, v in cellrun.units.items()},
                  work=cellrun.work)
    kind = "per_layer" if trace else "end_to_end"
    if trace:
        from .trace import Trace
        ctx.trace = Trace(kernels=captured.get("kernels", []),
                          spans=captured.get("spans", []),
                          passes=trace_passes, window_s=t_trace1 - t_trace0)
    metrics = {}
    for m in cell_metrics(manifest, workload, kind):
        value = read_metric(m["name"], ctx, root)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check: a sample of the passes, drawn from the seed
    n_check = min(len(outputs), int(spec.get("check_passes", 1)))
    picks = sorted(random.Random(seed).sample(range(len(outputs)), n_check))
    kept = {j: outputs[j] for j in picks}
    del outputs
    cellrun.free_program()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = worst_of([cellrun.numbers_of(got, j)
                       for j, got in kept.items()], spec["limits"])
    log(f"[check] passes {picks} checked in "
        f"{time.perf_counter() - t_check:.1f} s")
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    result = {"correct": correct, "attempted": len(apart), "failed": 0,
              "metrics": metrics,
              "device": (device_info(torch, peak) if on_card else
                         {"platform": "cpu", "kind": "cpu", "count": 1,
                          "memory_peak_bytes": 0})}
    if trace:
        t = ctx.trace
        result["device"]["busy_s"] = t.busy_s
        result["device"]["window_s"] = t.window_s
        top = sorted(t.by_name().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(t.idle_gaps().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                               "idle_gaps": [[n, s] for n, s in gaps]}
    result["checks"] = checks
    log(f"[run] {workload} seed {seed}: {len(apart)} passes in "
        f"{window_s:.3f} s, set-up {setup_s:.3f} s; "
        f"s between pass ends: min {min(apart):.4f} median "
        f"{statistics.median(apart):.4f} max {max(apart):.4f}")
    if on_card:
        from . import peaks
        log(f"[device] {power_limit()}; {peaks.describe()}")
    for name, c in checks.items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    return result

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

  1. build — compile every CUDA kernel from ``src/repro_torch/kernels/
     csrc`` with nvcc for sm_90a (one nvcc per source, in parallel) and
     print the card's name and power limit;
  2. kernel vs plain — each kernel against its plain PyTorch version on
     the card, bit for bit (``torch.equal`` on int32), at every shape
     the main path gives it, shared and banked activations, a 17-table
     bank, ragged shapes and a table with LUT[0,0] != 0;
  3. main path — the full-width ResNet-8 case study
     (``repro_torch.launch.case_study``) with the launch counters zeroed
     just before it; fails unless every kernel ran, the sequential and
     batched sweeps agree, and the CUDA datapath's logits equal the
     plain datapath's on one eval batch;
  4. timings — each kernel and its plain version at the main-path
     shapes (CUDA events after warm-up) beside its bound.

The line before last is the kernels' JSON summary, the last line the
device JSON.  Details go to ``chiprun_out/chip_smoke.json``.  Without a
CUDA device, or without the repository's ``src/`` beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
sys.path.insert(0, os.path.join(ROOT, "src"))

EVAL_N, BATCH, N_LANES = 256, 64, 17
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; shared-memory table
# lookups per SM per clock (one 32-lane LDS a clock, no bank conflicts)
HBM_BYTES_PER_S = 3.35e12
LOOKUPS_PER_SM_CLOCK = 32
RAGGED = ((1000, 37, 10), (777, 100, 50), (129, 577, 65), (1, 1, 1))


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _codes(shape, gen, device):
    import torch
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.int32,
                         device=device)


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] kernels built in {secs:.1f} s")
    return {"build_s": secs}


def _luts(device):
    """The case study's 17 product tables (uint16) plus a random table
    with LUT[0,0] != 0."""
    import numpy as np
    import torch
    from repro_torch.core.library import get_default_library
    from repro_torch.launch.case_study import case_study_names
    lib = get_default_library()
    names = case_study_names(lib)
    bank = np.stack([lib.lut(n) for n in names]).astype(np.int32)
    rand = np.random.default_rng(7).integers(0, 1 << 16, (256, 256))
    rand[0, 0] = 12345
    luts = torch.from_numpy(bank.astype(np.uint16)).to(device)
    rand16 = torch.from_numpy(rand.astype(np.uint16)).to(device)
    return names, luts, rand16


def phase_compare(shapes: dict, device) -> dict:
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(0)
    _, luts, rand16 = _luts(device)
    if luts.shape[0] != N_LANES:
        raise AssertionError(f"case study has {luts.shape[0]} tables, "
                             f"expected {N_LANES}")
    max_err = {"lut_matmul": 0, "lut_matmul_bank": 0}
    cases = 0

    def check(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        max_err[name] = max(max_err[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain at {what} "
                                 f"(max abs err {err})")
        cases += 1

    bank = torch.cat([luts[1:], rand16[None]])     # 17 lanes, LUT00 != 0
    luts32 = bank.to(torch.int32)
    all_shapes = list(shapes.items()) + [(f"ragged{s}", s) for s in RAGGED]
    for label, (m, k, n) in all_shapes:
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        for lut in (luts[0], rand16):
            check("lut_matmul", ops.approx_matmul_lut(qa, qw, lut),
                  ref.approx_matmul_lut_ref(qa, qw, lut.to(torch.int32)),
                  f"{label} {(m, k, n)}")
        check("lut_matmul_bank", ops.approx_matmul_lut_bank(qa, qw, bank),
              ref.approx_matmul_lut_bank_ref(qa, qw, luts32),
              f"{label} {(m, k, n)} shared qa")
        qab = _codes((N_LANES, m, k), gen, device)
        check("lut_matmul_bank", ops.approx_matmul_lut_bank(qab, qw, bank),
              ref.approx_matmul_lut_bank_ref(qab, qw, luts32),
              f"{label} {(m, k, n)} banked qa")
        del qab
    print(f"[compare] {cases} kernel-vs-plain cases bit-exact; max abs "
          f"err {max_err}")
    return {"cases": cases, "max_abs_err": max_err}


def phase_main(device) -> dict:
    import torch
    from repro_torch.approx.layers import ApproxPolicy, bank_backend
    from repro_torch.approx.specs import bank_for
    from repro_torch.core.library import get_default_library
    from repro_torch.kernels import ops
    from repro_torch.launch import case_study
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    record = case_study.run(device, eval_n=EVAL_N, batch=BATCH,
                            log=lambda s: print(f"[main] {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"[main] case study {wall:.2f} s; launches {launches}; "
          f"selected {record['selected']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")
    res = record["result"]
    accs = [p["accuracy"] for p in res["all_layers"] + res["per_layer"]]
    if (len(res["all_layers"]) != N_LANES
            or len(res["per_layer"]) != 9 * N_LANES
            or not all(0.0 <= a <= 1.0 for a in accs)
            or record["selected"] is None):
        raise AssertionError("case study output malformed")

    # the CUDA datapath against the plain datapath through the whole
    # network, on one eval batch: logits equal bit for bit
    lib = get_default_library()
    bank = bank_for(record["multipliers"], lib)
    from repro_torch.data.synthetic import CifarBatches
    b = next(CifarBatches("test", BATCH, BATCH).eval_batches())
    images = torch.from_numpy(b["images"]).to(device)
    model = load_resnet8().to(device)
    cfg = resnet.resnet_config(8)
    with torch.inference_mode():
        got = resnet.forward(model, images, cfg, ApproxPolicy(
            default=bank_backend(bank, "lut", "pallas")))
        want = resnet.forward(model, images, cfg, ApproxPolicy(
            default=bank_backend(bank, "lut", "ref")))
    if not (torch.isfinite(got).all() and torch.equal(got, want)
            and got.shape == (N_LANES, BATCH, cfg.n_classes)):
        raise AssertionError("CUDA datapath logits differ from the plain "
                             "datapath's")
    print("[main] banked logits (17 lanes x 64 images) equal the plain "
          "datapath's")
    record["launches"] = launches
    record["main_path_s"] = wall
    return record


def _time(fn, reps: int, warmup: int) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(shapes: dict, device) -> dict:
    """Per main-path shape: kernel and plain times (ms) and the bound.
    K2 runs the 17-lane bank with the activations the all-layers sweep
    gives it: shared at conv_init, banked after."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(1)
    _, luts, _ = _luts(device)
    luts32 = luts.to(torch.int32)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    lookup_rate = sms * LOOKUPS_PER_SM_CLOCK * clock_hz
    rows = []
    for label, (m, k, n) in shapes.items():
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        qab = qa if label == "conv_init" else _codes((N_LANES, m, k), gen,
                                                     device)
        for kernel, lanes, a, call, plain in (
                ("lut_matmul", 1, qa,
                 lambda: ops.approx_matmul_lut(qa, qw, luts[0]),
                 lambda: ref.approx_matmul_lut_ref(qa, qw, luts32[0])),
                ("lut_matmul_bank", N_LANES, qab,
                 lambda: ops.approx_matmul_lut_bank(qab, qw, luts),
                 lambda: ref.approx_matmul_lut_bank_ref(qab, qw, luts32))):
            lookups = lanes * m * k * n
            nbytes = (a.numel() * 4 + qw.numel() * 4 + lanes * 65536 * 2
                      + lanes * m * n * 4)
            ops_ms = lookups / lookup_rate * 1e3
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({
                "kernel": kernel, "layer": label, "M": m, "K": k, "N": n,
                "lanes": lanes, "lookups": lookups, "bytes": nbytes,
                "ms": _time(call, reps=20, warmup=3),
                "plain_ms": _time(plain, reps=2, warmup=1),
                "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
        del qab
    for r in rows:
        print(f"[timing] {r['kernel']:16s} {r['layer']:12s} "
              f"M={r['M']:6d} K={r['K']:4d} N={r['N']:3d} x{r['lanes']:2d}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%})")
    return {"lookup_rate_per_s": lookup_rate, "rows": rows}


SOURCES = {
    "lut_matmul": ("src/repro_torch/kernels/csrc/lut_matmul.cu",
                   "src/repro/kernels/approx_matmul.py:55"),
    "lut_matmul_bank": ("src/repro_torch/kernels/csrc/lut_matmul_bank.cu",
                        "src/repro/kernels/lut_bank.py:63"),
}


def summary(compare: dict, main: dict, timing: dict) -> dict:
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in timing["rows"] if r["kernel"] == name]
        ops_ms = sum(r["ops_ms"] for r in rows)
        bytes_ms = sum(r["bytes_ms"] for r in rows)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": compare["max_abs_err"][name],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None})
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.launch.case_study import main_path_shapes
    from repro_torch.models import resnet
    device = resolve_device(None)
    card = _smi("name,power.limit")
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    shapes = main_path_shapes(resnet.resnet_config(8), BATCH)
    details = {"card": card, **phase_build()}
    details["compare"] = phase_compare(shapes, device)
    details["main"] = phase_main(device)
    details["timing"] = phase_timing(shapes, device)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(card)
    print(json.dumps(summary(details["compare"], details["main"],
                             details["timing"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

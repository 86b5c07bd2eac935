#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

  1. build — compile every CUDA kernel from ``src/repro_torch/kernels/
     csrc`` with nvcc for sm_90a (one nvcc per source, in parallel) and
     print the card's name and power limit;
  2. kernel vs plain — each kernel against its plain PyTorch version on
     the card, bit for bit (``torch.equal`` on the int32 outputs, and on
     the f32 results of the fused kernels after the eager epilogue), at
     every shape the main paths give it: shared and banked activations,
     the 17-table case-study bank, the mixed-width wide-study bank
     (8/12/16-bit lanes), a bank mixing exact/trunc/loa trees, ragged
     shapes and a table with LUT[0,0] != 0;
  3. main paths, each with the launch counters zeroed just before it and
     read just after: the full-width ResNet-8 case study under
     ``variant="pallas"`` (K1/K2) and ``variant="fused"`` (K3/K4), whose
     accuracies must be equal list for list, and the wide-width Pareto
     study (``repro_torch.launch.wide_pareto``, K3/K7/K8), which fails
     unless its two gates hold; fails unless every kernel ran, and unless
     the CUDA datapaths' banked logits equal the plain datapath's;
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
# composed entries of a bank that mixes reduction trees (K8 compare)
MIXED_REDUCE = (("mul8u_exact", 16, "trunc3"), ("mul8u_trunc6", 12, "exact"),
                ("mul8u_exact", 16, "loa4"))

SOURCES = {
    "lut_matmul": ("lut_matmul.cu", "approx_matmul.py:55"),
    "lut_matmul_bank": ("lut_matmul_bank.cu", "lut_bank.py:63"),
    "fused_matmul": ("fused_matmul.cu", "fused_matmul.py:446"),
    "fused_matmul_bank": ("fused_matmul_bank.cu", "fused_matmul.py:487"),
    "fused_composed_matmul": ("fused_composed_matmul.cu",
                              "fused_matmul.py:539"),
    "fused_composed_matmul_bank": ("fused_composed_matmul_bank.cu",
                                   "fused_matmul.py:590"),
}


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _codes(shape, gen, device):
    import torch
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.int32,
                         device=device)


def _floats(shape, gen, device, scale=1.0):
    import torch
    return torch.randn(shape, generator=gen, device=device) * scale


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} kernels built in {secs:.1f} s")
    return {"build_s": secs}


def _tables(device) -> dict:
    """Every table set the compare and timing phases use: the case
    study's 17 product tables (uint16), a random table with LUT[0,0] !=
    0, the wide study's mixed-width bank and a mixed-reduce bank."""
    import numpy as np
    import torch
    from repro_torch.approx.specs import bank_for
    from repro_torch.core.library import get_default_library
    from repro_torch.launch.case_study import case_study_names
    from repro_torch.launch.wide_pareto import wide_names
    lib = get_default_library()

    def u16(a):
        return torch.from_numpy(np.asarray(a).astype(np.uint16)).to(device)

    def lanes(bank):
        bits = torch.from_numpy(bank.lane_bits).to(device)
        return {"luts": u16(bank.luts), "bits": bits,
                "masks": torch.from_numpy(bank.lane_masks.astype(
                    np.int64)).to(device),
                "codes": torch.from_numpy(bank.lane_reduce_codes).to(device)}

    rand = np.random.default_rng(7).integers(0, 1 << 16, (256, 256))
    rand[0, 0] = 12345
    case = case_study_names(lib)
    wide = bank_for(case_study_names(lib, 6) + wide_names(lib), lib)
    mixed_names = [lib.add_composed(*r).name for r in MIXED_REDUCE]
    mixed = bank_for(["mul8u_bam_h0_v4"] + mixed_names, lib,
                     mixed_reduce=True)
    out = {"case": u16(np.stack([lib.lut(n) for n in case])),
           "rand": u16(rand), "wide": lanes(wide), "mixed": lanes(mixed),
           "wide_names": wide.names}
    # the mixed-reduce bank's first (narrow) lane gets the random table
    out["mixed"]["luts"][0] = out["rand"]
    if out["case"].shape[0] != N_LANES:
        raise AssertionError(f"case study has {out['case'].shape[0]} "
                             f"tables, expected {N_LANES}")
    return out


def _fused_cases(t: dict, x, xb17, xbw, w):
    """(kernel, op, plain, args, bits) of every fused compare case at
    one shape: the op's operands, and the widths to calibrate them at
    (an int, or the bank's per-lane widths)."""
    from repro_torch.kernels import ops, ref
    case, rand, wide, mixed = t["case"], t["rand"], t["wide"], t["mixed"]
    bank17 = case.clone()
    bank17[-1] = rand                                   # LUT00 != 0 lane
    return [
        ("fused_matmul", ops.fused_matmul_lut, ref.fused_matmul_ref,
         (x, w, case[0]), (), 8),
        ("fused_matmul", ops.fused_matmul_lut, ref.fused_matmul_ref,
         (x, w, rand), (), 8),
        ("fused_matmul_bank", ops.fused_matmul_lut_bank,
         ref.fused_matmul_bank_ref, (x, w, bank17), (), 8),
        ("fused_matmul_bank", ops.fused_matmul_lut_bank,
         ref.fused_matmul_bank_ref, (xb17, w, bank17), (), 8),
        ("fused_composed_matmul", ops.fused_composed_matmul_lut,
         ref.fused_composed_matmul_ref, (x, w, wide["luts"][-5]),
         (wide["masks"][-5:-4], wide["codes"][-5:-4]), 16),
        ("fused_composed_matmul", ops.fused_composed_matmul_lut,
         ref.fused_composed_matmul_ref, (x, w, rand),
         (mixed["masks"][1:2], mixed["codes"][1:2]), 16),
        ("fused_composed_matmul_bank", ops.fused_composed_matmul_lut_bank,
         ref.fused_composed_matmul_bank_ref, (xbw, w, wide["luts"]),
         (wide["masks"], wide["codes"]), wide["bits"]),
        ("fused_composed_matmul_bank", ops.fused_composed_matmul_lut_bank,
         ref.fused_composed_matmul_bank_ref, (x, w, mixed["luts"]),
         (mixed["masks"], mixed["codes"]), mixed["bits"]),
    ]


def _scalars(x, w, bits):
    from repro_torch.approx.quant import calibrate, scalar_params
    return scalar_params(calibrate(x, bits, lanes=x.ndim == 3),
                         calibrate(w, bits))


def phase_compare(shapes: dict, device) -> dict:
    import torch
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(0)
    t = _tables(device)
    max_err = {name: 0.0 for name in SOURCES}
    cases = 0

    def check(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        for g, v in zip(got, want):
            v = v.reshape(g.shape)
            if g.numel():
                err = float((g.double() - v.double()).abs().max())
                max_err[name] = max(max_err[name], err)
            if not torch.equal(g, v):
                raise AssertionError(f"{name} != plain at {what} "
                                     f"(max abs err {max_err[name]})")
        cases += 1

    bank = torch.cat([t["case"][1:], t["rand"][None]])  # LUT00 != 0 lane
    luts32 = bank.to(torch.int32)
    n_wide = t["wide"]["luts"].shape[0]
    all_shapes = list(shapes.items()) + [(f"ragged{s}", s) for s in RAGGED]
    for label, (m, k, n) in all_shapes:
        what = f"{label} {(m, k, n)}"
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        for lut in (t["case"][0], t["rand"]):
            check("lut_matmul", [ops.approx_matmul_lut(qa, qw, lut)],
                  [ref.approx_matmul_lut_ref(qa, qw, lut.to(torch.int32))],
                  what)
        check("lut_matmul_bank", [ops.approx_matmul_lut_bank(qa, qw, bank)],
              [ref.approx_matmul_lut_bank_ref(qa, qw, luts32)],
              f"{what} shared qa")
        qab = _codes((N_LANES, m, k), gen, device)
        check("lut_matmul_bank", [ops.approx_matmul_lut_bank(qab, qw, bank)],
              [ref.approx_matmul_lut_bank_ref(qab, qw, luts32)],
              f"{what} banked qa")
        del qa, qw, qab
        x = _floats((m, k), gen, device)
        w = _floats((k, n), gen, device, 0.2)
        xb17 = _floats((N_LANES, m, k), gen, device)
        xbw = _floats((n_wide, m, k), gen, device)
        for name, op, plain, args, codes, bits in _fused_cases(
                t, x, xb17, xbw, w):
            sp = _scalars(args[0], w, bits)
            lanes = args[2].shape[0] if args[2].ndim == 3 else 1
            fp, ip = fm.pack_scalars(lanes, device, *sp)
            packed = fm.pack_codes(lanes, device, *codes) if codes else ()
            plain_args = (args[0], w, args[2].to(torch.int32))
            want = plain(*plain_args, *packed, fp, ip)
            got = op(*args, *codes, *sp, raw=True)
            check(name, got, want, f"{what} x{tuple(args[0].shape)}")
            s = (fm.limbs_to_f32(*want[:2]) if codes
                 else want[0].to(torch.float32))
            check(name, [op(*args, *codes, *sp)],
                  [fm.dequant(s, want[-2], want[-1], fp, ip, k)],
                  f"{what} f32")
        del x, w, xb17, xbw
    print(f"[compare] {cases} kernel-vs-plain cases bit-exact; max abs "
          f"err {max_err}")
    return {"cases": cases, "max_abs_err": max_err}


def _drive(name: str, fn, kernels: tuple):
    """Run one main path with the launch counters zeroed just before it;
    fails unless each of ``kernels`` launched."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    record = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"[main] {name}: {wall:.2f} s; launches {launches}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels of its path never ran: "
                             f"{missing}")
    return record, wall, launches


def _case_accuracies(record) -> dict:
    res = record["result"]
    return {"all_layers": [p["accuracy"] for p in res["all_layers"]],
            "per_layer": [p["accuracy"] for p in res["per_layer"]],
            "baseline": res["baseline_accuracy"],
            "selected": record["selected"]}


def _check_banked_logits(record, variant, device):
    """The CUDA datapath against the plain datapath through the whole
    network, on one eval batch: banked logits equal bit for bit."""
    import torch
    from repro_torch.approx.layers import ApproxPolicy, bank_backend
    from repro_torch.approx.specs import bank_for
    from repro_torch.core.library import get_default_library
    from repro_torch.data.synthetic import CifarBatches
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8
    bank = bank_for(record["multipliers"], get_default_library())
    b = next(CifarBatches("test", BATCH, BATCH).eval_batches())
    images = torch.from_numpy(b["images"]).to(device)
    model = load_resnet8().to(device)
    cfg = resnet.resnet_config(8)
    with torch.inference_mode():
        got = resnet.forward(model, images, cfg, ApproxPolicy(
            default=bank_backend(bank, "lut", variant)))
        want = resnet.forward(model, images, cfg, ApproxPolicy(
            default=bank_backend(bank, "lut", "ref")))
    if not (torch.isfinite(got).all() and torch.equal(got, want)
            and got.shape == (N_LANES, BATCH, cfg.n_classes)):
        raise AssertionError(f"{variant} datapath logits differ from the "
                             "plain datapath's")
    print(f"[main] {variant} banked logits (17 lanes x 64 images) equal "
          "the plain datapath's")


def phase_main(device) -> dict:
    from repro_torch.launch import case_study, wide_pareto

    def log(s):
        print(f"[main] {s}")

    out = {"launches": {name: 0 for name in SOURCES}}
    accs = {}
    for variant, kernels in (("pallas", ("lut_matmul", "lut_matmul_bank")),
                             ("fused", ("fused_matmul",
                                        "fused_matmul_bank"))):
        record, wall, launches = _drive(
            f"case study ({variant})",
            lambda: case_study.run(device, eval_n=EVAL_N, batch=BATCH,
                                   log=log, variant=variant), kernels)
        res = record["result"]
        accs[variant] = _case_accuracies(record)
        if (len(res["all_layers"]) != N_LANES
                or len(res["per_layer"]) != 9 * N_LANES
                or not all(0.0 <= a <= 1.0
                           for a in accs[variant]["all_layers"]
                           + accs[variant]["per_layer"])
                or record["selected"] is None):
            raise AssertionError(f"{variant} case study output malformed")
        _check_banked_logits(record, variant, device)
        out[f"case_study_{variant}"] = {**record, "main_path_s": wall,
                                        "launches": launches}
        for k, v in launches.items():
            out["launches"][k] += v
    if accs["fused"] != accs["pallas"]:
        raise AssertionError(f"fused case study differs from the pallas "
                             f"one: {accs}")
    print("[main] fused case study accuracies equal the pallas ones, "
          "list for list")
    record, wall, launches = _drive(
        "wide-width Pareto study",
        lambda: wide_pareto.run(device, eval_n=EVAL_N, batch=BATCH,
                                log=log),
        ("fused_matmul", "fused_composed_matmul",
         "fused_composed_matmul_bank"))
    out["wide_pareto"] = {**record, "main_path_s": wall,
                          "launches": launches}
    for k, v in launches.items():
        out["launches"][k] += v
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main paths: "
                             f"{out['launches']}")
    return out


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
    The banked kernels run the activations the all-layers sweeps give
    them: shared at conv_init, banked after; K4 the 17-lane case-study
    bank, K7 one 16-bit composed multiplier, K8 the wide study's
    mixed-width bank."""
    import torch
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(1)
    t = _tables(device)
    luts, wide = t["case"], t["wide"]
    luts32 = luts.to(torch.int32)
    n_wide = wide["luts"].shape[0]
    n_narrow = int((wide["masks"] == 0).sum())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    lookup_rate = sms * LOOKUPS_PER_SM_CLOCK * clock_hz
    rows = []

    def row(kernel, label, mkn, lanes, lookups, nbytes, call, plain):
        ops_ms = lookups / lookup_rate * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        reps, plain_reps = (20, 2) if kernel.startswith("lut") else (10, 1)
        rows.append({
            "kernel": kernel, "layer": label, "M": mkn[0], "K": mkn[1],
            "N": mkn[2], "lanes": lanes, "lookups": lookups,
            "bytes": nbytes, "ms": _time(call, reps=reps, warmup=3),
            "plain_ms": _time(plain, reps=plain_reps, warmup=1),
            "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})

    for label, (m, k, n) in shapes.items():
        mkn = (m, k, n)
        shared = label == "conv_init"
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        qab = qa if shared else _codes((N_LANES, m, k), gen, device)
        out_b = m * n * 4
        lut_b = 65536 * 2
        row("lut_matmul", label, mkn, 1, m * k * n,
            qa.numel() * 4 + qw.numel() * 4 + lut_b + out_b,
            lambda: ops.approx_matmul_lut(qa, qw, luts[0]),
            lambda: ref.approx_matmul_lut_ref(qa, qw, luts32[0]))
        row("lut_matmul_bank", label, mkn, N_LANES, N_LANES * m * k * n,
            qab.numel() * 4 + qw.numel() * 4 + N_LANES * (lut_b + out_b),
            lambda: ops.approx_matmul_lut_bank(qab, qw, luts),
            lambda: ref.approx_matmul_lut_bank_ref(qab, qw, luts32))
        del qa, qw, qab
        # fused: f32 operands in; acc (or two limbs) and code sums out
        x = _floats((m, k), gen, device)
        w = _floats((k, n), gen, device, 0.2)
        sums_b = (m + n) * 4
        fused = [("fused_matmul", 1, x, luts[0], (), 8, 1),
                 ("fused_matmul_bank", N_LANES,
                  x if shared else _floats((N_LANES, m, k), gen, device),
                  luts, (), 8, N_LANES),
                 ("fused_composed_matmul", 1, x, wide["luts"][-5],
                  (wide["masks"][-5:-4], wide["codes"][-5:-4]), 16, 4),
                 ("fused_composed_matmul_bank", n_wide,
                  x if shared else _floats((n_wide, m, k), gen, device),
                  wide["luts"], (wide["masks"], wide["codes"]),
                  wide["bits"], 4 * (n_wide - n_narrow) + n_narrow)]
        for name, lanes, xin, tab, codes, bits, per_product in fused:
            op = getattr(ops, {"fused_matmul": "fused_matmul_lut",
                               "fused_matmul_bank": "fused_matmul_lut_bank",
                               "fused_composed_matmul":
                                   "fused_composed_matmul_lut",
                               "fused_composed_matmul_bank":
                                   "fused_composed_matmul_lut_bank"}[name])
            plain = getattr(ref, f"{name}_ref")
            sp = _scalars(xin, w, bits)
            fp, ip = fm.pack_scalars(lanes, device, *sp)
            packed = fm.pack_codes(lanes, device, *codes) if codes else ()
            tab32 = tab.to(torch.int32)
            limbs = 2 if codes else 1
            nbytes = (xin.numel() * 4 + w.numel() * 4
                      + lanes * (lut_b + limbs * out_b + sums_b))
            row(name, label, mkn, lanes, per_product * m * k * n, nbytes,
                lambda: op(xin, w, tab, *codes, *sp, raw=True),
                lambda: plain(xin, w, tab32, *packed, fp, ip))
        del x, w, fused
    for r in rows:
        print(f"[timing] {r['kernel']:26s} {r['layer']:12s} "
              f"M={r['M']:6d} K={r['K']:4d} N={r['N']:3d} x{r['lanes']:2d}: "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%})")
    return {"lookup_rate_per_s": lookup_rate, "wide_bank": t["wide_names"],
            "rows": rows}


def summary(compare: dict, main: dict, timing: dict) -> dict:
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in timing["rows"] if r["kernel"] == name]
        ops_ms = sum(r["ops_ms"] for r in rows)
        bytes_ms = sum(r["bytes_ms"] for r in rows)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": main["launches"][name],
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
    t0 = time.perf_counter()
    device = resolve_device(None)
    card = _smi("name,power.limit")
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    shapes = main_path_shapes(resnet.resnet_config(8), BATCH)
    details = {"card": card, **phase_build()}
    details["compare"] = phase_compare(shapes, device)
    details["main"] = phase_main(device)
    details["timing"] = phase_timing(shapes, device)
    details["total_s"] = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(f"[done] {details['total_s']:.1f} s")
    print(card)
    print(json.dumps(summary(details["compare"], details["main"],
                             details["timing"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

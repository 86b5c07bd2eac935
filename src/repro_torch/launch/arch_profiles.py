"""Model-zoo module-resilience profiler (the port's counterpart of
``benchmarks/arch_profiles.py``, DESIGN.md §2.12).

For each architecture it runs ``approx.profiles.profile_architecture``:
a single-family sweep of the library's multipliers over every module
family (attention q/k/v/o, MLP up/gate/down, MoE experts, SSM
projections, cross-attention, the image projection) as ONE banked pass
of the model, a most-to-least-tolerant family ranking, and a per-module
policy selected under a ``MaxDrop`` bound on ``lm_fidelity``'s logit
MAE.  Its record holds the zoo, the
identity checks and four gates; a failed gate raises ``GateError``
once the record is complete (``main`` writes ``--out`` first):

  * ``coverage`` — >= 4 architectures beyond ResNet are profiled,
    including at least one MoE and one SSM-bearing model with
    ``ssm.in_proj`` (computed, as in the reference, on what was
    profiled);
  * ``selection`` — every profiled architecture yields a selected
    per-module policy whose measured drop stays inside ``MaxDrop``;
  * ``bit_identity`` — on the MoE and SSM reference archs, the banked
    module sweep (exact-LUT ``fill`` padding) equals the sequential
    golden-base evaluation metric for metric;
  * ``single_program`` — the reference counts XLA programs traced
    (``trace_audit``), which has no torch counterpart; the port counts
    banked datapath calls (K2 under ``pallas``, K4 under ``fused``): the
    full identity sweep and a 2-row truncated one must make equally
    many, and exactly one a call site (a routed-expert projection is one
    call for all its experts), times the eval batches — the same
    whatever the number of rows (``banked_calls_per_forward``).

Every architecture of both modes is profiled: ``--quick``'s five
(whisper-large-v3 included) and full mode's eight and ResNet-8.

Run (GPU; reduced configs, random weights from seed 0):
``PYTHONPATH=src python -m repro_torch.launch.arch_profiles --quick
[--variant fused] [--out profiles.json]``.  Nothing is written unless
``--out`` says where.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from typing import Callable, Optional

import torch

from ..approx.dse import verify_assignments
from ..approx.modules import FILL_EXACT, ModuleMap, module_sweep_assignments
from ..approx.profiles import profile_architecture, profile_zoo
from ..approx.workload import classification, lm_fidelity
from ..configs import get_config
from ..core.library import get_default_library
from ..device import DeviceLike, resolve_device
from ..kernels import datapaths
from ..models import resnet
from ..models.decoder import block_pattern
from . import GateError
from .case_study import case_study_names

#: MaxDrop bound on the primary metric (logit_mae vs the f32 model).
#: The all-exact uniform always satisfies it (drop == 0), so an arch
#: failing the selection gate means the selector broke.
MAX_DROP = 0.05
MIN_ARCHS_GATE = 4

#: The reference's reduced zoo slices per mode: (arch, family label).
QUICK_ARCHS = [
    ("qwen1.5-0.5b", "dense"),
    ("qwen3-moe-30b-a3b", "moe"),
    ("mamba2-780m", "ssm"),
    ("jamba-v0.1-52b", "hybrid"),
    ("whisper-large-v3", "encdec"),
]
FULL_EXTRA_ARCHS = [
    ("deepseek-v2-236b", "moe"),
    ("llava-next-34b", "vlm"),
    ("nemotron-4-15b", "dense"),
]
#: The bit-identity / banked-call reference archs, checked on a
#: 2-multiplier sub-grid.
IDENTITY_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-780m")
#: The workload's shape: 2 sequences of 8 tokens, one batch.
BATCH, SEQ_LEN, N_BATCHES = 2, 8, 1
#: The banked datapath entry point counted under each variant.
BANKED = {"pallas": "approx_matmul_lut_bank",
          "fused": "fused_matmul_lut_bank"}


def _multipliers(lib, quick: bool) -> list[str]:
    if quick:
        return ["mul8u_exact", "mul8u_trunc6", "mul8u_trunc3"]
    names = case_study_names(lib, 5)
    if "mul8u_exact" not in names:
        names.insert(0, "mul8u_exact")
    return names


@contextlib.contextmanager
def counting_banked_calls():
    """Counts calls of the banked datapath entry points
    (``kernels.datapaths.approx_matmul_lut_bank`` /
    ``fused_matmul_lut_bank``; on a GPU each call is one K2 / K4
    launch).  Yields a dict of counts by entry point."""
    counts = {name: 0 for name in BANKED.values()}
    originals = {name: getattr(datapaths, name) for name in counts}

    def wrap(name):
        def counted(*args, **kw):
            counts[name] += 1
            return originals[name](*args, **kw)
        return counted

    for name in counts:
        setattr(datapaths, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in originals.items():
            setattr(datapaths, name, fn)


#: Projections of each mixer slot (``mla``: wdq, wuq, wqr, wdkv, wkr,
#: wuk, wuv, wo; ``mamba``: in_proj, out_proj).
MIXER_CALLS = {"attn": 4, "mla": 8, "mamba": 2}


def banked_calls_per_forward(cfg) -> int:
    """Banked datapath calls one banked prefill makes when every call
    site is banked: 1 a projection, a routed-expert projection
    (``moe.wi``/``wg``/``wo``) included — one call, one K2 (K4) launch,
    for all its experts (``models.moe._expert_matmul``); the shared
    experts are one FFN.  An FFN is 3 projections when gated (silu), 2
    else.  A vlm adds its ``img_proj``; an encdec makes ``n_enc_layers x
    (4 + ffn)`` in the encoder and ``n_layers x (4 + 4 + ffn)`` in the
    decoder (self-attention, then cross-attention's wk/wv over the
    frames and wq/wo over the tokens).  Leading dense layers
    (``cfg.first_dense``) make the pattern's mixer and one FFN each."""
    ffn = 3 if cfg.act == "silu" else 2
    if cfg.family == "encdec":
        return cfg.n_enc_layers * (4 + ffn) + cfg.n_layers * (8 + ffn)
    pattern = block_pattern(cfg)
    per_group = 0
    for mixer, ffn_kind in pattern:
        per_group += MIXER_CALLS[mixer]
        if ffn_kind == "ffn":
            per_group += ffn
        elif ffn_kind == "moe":
            per_group += ffn
            if cfg.n_shared_experts > 0:
                per_group += ffn
    lead = cfg.first_dense * (MIXER_CALLS[pattern[0][0]] + ffn)
    return (per_group * ((cfg.n_layers - cfg.first_dense) // len(pattern))
            + lead + (1 if cfg.family == "vlm" else 0))


def _lm_workload(cfg, device: DeviceLike = None, seed: int = 0):
    """``(lm_fidelity workload, ModuleMap)`` of one LM config (or an arch
    name: its ``reduced()`` config) at the profile's shape, random
    weights from a ``torch.Generator`` seeded ``seed`` on the device."""
    if isinstance(cfg, str):
        cfg = get_config(cfg).reduced()
    wl = lm_fidelity(cfg, batch=BATCH, seq_len=SEQ_LEN,
                     n_batches=N_BATCHES, seed=seed, device=device)
    mmap = ModuleMap.for_config(cfg, batch=BATCH, seq_len=SEQ_LEN)
    return wl, mmap


def identity_check(wl, mmap, lib, mults, cfg, variant: str) -> dict:
    """The banked module sweep over ``mults`` against its sequential
    golden-base evaluation, row for row and bit for bit, and the banked
    calls of the full sweep and of its first two rows against
    ``banked_calls_per_forward`` x the eval batches."""
    grid = module_sweep_assignments(mmap, mults)
    lowered = [mmap.lower(a) for _f, _m, a in grid]
    kw = dict(layers=mmap.layers, fill=FILL_EXACT, variant=variant)
    t0 = time.perf_counter()
    with counting_banked_calls() as full:
        banked = verify_assignments(wl, lowered, mmap.layer_counts, lib,
                                    **kw)
    banked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sequential = verify_assignments(wl, lowered, mmap.layer_counts, lib,
                                    batch=False, **kw)
    sequential_s = time.perf_counter() - t0
    with counting_banked_calls() as half:
        verify_assignments(wl, lowered[:2], mmap.layer_counts, lib, **kw)
    mismatches = [{"row": i, "banked": b.metrics, "sequential": s.metrics}
                  for i, (b, s) in enumerate(zip(banked, sequential))
                  if b.metrics != s.metrics
                  or b.network_rel_power != s.network_rel_power]
    name = BANKED[variant]
    return {"bit_identical": not mismatches, "rows": len(lowered),
            "mismatches": mismatches[:3],
            "banked_calls_full": full[name],
            "banked_calls_truncated": half[name],
            "banked_calls_expected": banked_calls_per_forward(cfg)
            * N_BATCHES,
            "banked_s": banked_s, "sequential_s": sequential_s,
            "metrics": [b.metrics for b in banked]}


def profile_config(cfg, family: str, lib, mults, *, variant: str,
                   device: DeviceLike = None, arch: Optional[str] = None,
                   seed: int = 0) -> tuple:
    """One config's profile: ``(ArchProfile, stats, workload,
    ModuleMap)``, the stats holding each stage's wall and the banked
    calls of the whole profile."""
    t0 = time.perf_counter()
    wl, mmap = _lm_workload(cfg, device, seed)
    setup_s = time.perf_counter() - t0
    walls: dict = {}
    with counting_banked_calls() as calls:
        prof = profile_architecture(wl, mmap, lib, mults,
                                    arch=arch or cfg.name,
                                    model_family=family, max_drop=MAX_DROP,
                                    variant=variant, stage_walls=walls)
    return prof, {"setup_s": setup_s, **walls,
                  "banked_calls": calls[BANKED[variant]]}, wl, mmap


def _resnet_profile(lib, mults, variant: str, dev, log) -> tuple:
    """ResNet-8 with random weights (a ``torch.Generator`` seeded 0) on
    the paper's own classification workload, 32 images."""
    cfg = resnet.resnet_config(8)
    model = resnet.ResNet(cfg, generator=torch.Generator().manual_seed(0))
    wl = classification(cfg, model, eval_n=32, batch=32, fidelity=True,
                        device=dev)
    mmap = ModuleMap.for_config(cfg, batch=32)
    t0 = time.perf_counter()
    prof = profile_architecture(wl, mmap, lib, mults, arch="resnet8-cifar",
                                model_family="resnet", max_drop=MAX_DROP,
                                variant=variant)
    dt = time.perf_counter() - t0
    log(f"[arch_profiles] resnet8-cifar: {dt:.2f} s, "
        f"modules={len(prof.modules)}")
    return prof, dt


def run(device: DeviceLike = None, quick: bool = False,
        variant: str = "pallas",
        log: Callable[[str], None] = print) -> dict:
    """The zoo's profiles and the four gates; returns the record, or
    raises ``GateError`` (carrying it) when a gate fails."""
    if variant not in BANKED:
        raise ValueError(f"variant must be one of {sorted(BANKED)}")
    dev = resolve_device(device)
    lib = get_default_library()
    mults = _multipliers(lib, quick)
    for n in mults:
        lib.lut(n)              # LUT packing outside the timers

    zoo = QUICK_ARCHS + ([] if quick else FULL_EXTRA_ARCHS)
    profiles, stats, workloads = {}, {}, {}
    for arch, family in zoo:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        prof, st, wl, mmap = profile_config(
            get_config(arch).reduced(), family, lib, mults,
            variant=variant, device=dev, arch=arch)
        workloads[arch] = (wl, mmap)
        st["total_s"] = time.perf_counter() - t0
        if dev.type == "cuda":
            st["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        sel = (f"power={prof.selected['power']:.3f}"
               if prof.selected else "none")
        log(f"[arch_profiles] {arch}: {st['total_s']:.2f} s, modules="
            f"{len(prof.modules)}, most tolerant {prof.ranking[0]}, {sel}, "
            f"banked calls {st['banked_calls']}")
        profiles[arch], stats[arch] = prof, st

    if not quick:                       # the paper's family, full mode
        prof, dt = _resnet_profile(lib, mults, variant, dev, log)
        profiles["resnet8-cifar"], stats["resnet8-cifar"] = (
            prof, {"total_s": dt})

    identity = {}
    for arch in IDENTITY_ARCHS:
        if arch not in workloads:
            continue
        wl, mmap = workloads[arch]
        identity[arch] = identity_check(wl, mmap, lib, mults[1:3],
                                        get_config(arch).reduced(), variant)
        c = identity[arch]
        log(f"[arch_profiles] identity {arch}: bit {c['bit_identical']}, "
            f"banked calls {c['banked_calls_full']} / "
            f"{c['banked_calls_truncated']} (expected "
            f"{c['banked_calls_expected']})")

    beyond_resnet = [a for a in profiles if a != "resnet8-cifar"]
    fam_of = dict(zoo)
    gates = {
        "coverage": (len(beyond_resnet) >= MIN_ARCHS_GATE
                     and any(fam_of[a] == "moe" for a in beyond_resnet)
                     and any(fam_of[a] in ("ssm", "hybrid")
                             and "ssm.in_proj" in profiles[a].modules
                             for a in beyond_resnet)),
        "selection": all(
            p.selected is not None
            and p.selected["quality_drop"] <= p.max_drop + 1e-9
            for p in profiles.values()),
        "bit_identity": all(c["bit_identical"] for c in identity.values()),
        "single_program": all(
            c["banked_calls_full"] == c["banked_calls_truncated"]
            == c["banked_calls_expected"] for c in identity.values()),
    }
    record = {
        "benchmark": "arch_profiles", "quick": quick, "variant": variant,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "max_drop": MAX_DROP, "multipliers": mults,
        "zoo": profile_zoo(profiles), "stats": stats,
        "identity_checks": {a: {k: v for k, v in c.items()
                                if k != "metrics"}
                            for a, c in identity.items()},
        "gates": gates,
    }
    failed = sorted(g for g, ok in gates.items() if not ok)
    log(f"[arch_profiles] gates {gates}")
    if failed:
        raise GateError(f"arch_profiles gates failed: {failed}",
                        failed[0], record)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="the reference's CI slice: 5 reduced archs, 3 "
                         "multipliers")
    ap.add_argument("--variant", default="pallas",
                    choices=sorted(BANKED),
                    help="datapath: pallas = K2 (K1 sequential), fused = "
                         "K4 (K3)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = None
    try:
        record = run(args.device, quick=args.quick, variant=args.variant)
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

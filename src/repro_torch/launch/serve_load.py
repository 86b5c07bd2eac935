"""Continuous-batching serve load generator (the port's counterpart of
``benchmarks/serve_load.py``, DESIGN.md §2.8).

Drives one ``ContinuousEngine`` with Poisson request arrivals whose
``ServeConfig`` policies are drawn from a mixed set of approximate
multiplier selections (uniform per-tenant picks plus, from four
policies up, a heterogeneous per-layer policy — every application ships
its own selected accelerator), at 1/2/4[/8] distinct policies: the
reference's multipliers, prompt lengths, policy sets, arrival process
and seeds, a fixed 8-multiplier bank, 4 slots, a 16-row cache in
4-row blocks.

Its record holds, per level, tokens/s, p50/p99 request latency and the
decode steps, and the two gates (each raises ``GateError`` once the
record is complete):

  * ``bit_identity``: every request's tokens equal the port's own
    sequential ``Engine(cfg, params, engine.lane_policy(serve))
    .generate``, token for token (the replay runs the single-table
    datapath: K1 under ``pallas``, K3 under ``fused``);
  * ``banked_per_step`` (the port's form of the reference's
    O(1)-compiled-programs gate): every prefill and every decode step,
    the warm-up's included, made exactly one banked datapath call a
    projection (7 x n_layers) and no single-table call, whatever the
    number of policies, and the bank was built once.  On a GPU each
    such step must also have launched the banked kernel (K2 under
    ``pallas``, K4 under ``fused``) exactly 7 x n_layers times and no
    other kernel.

Run (GPU; qwen1.5-0.5b at full width, random weights from seed 0):
``PYTHONPATH=src python -m repro_torch.launch.serve_load --quick
[--variant fused] [--out serve_load.json]``; on the CPU: ``--device cpu
--reduced --quick``.  Nothing is written unless ``--out`` says where.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from ..approx.layers import ApproxPolicy
from ..approx.specs import BackendSpec
from ..core.library import get_default_library
from ..device import DeviceLike
from ..kernels import ops
from ..models.registry import input_extras
from ..serve.engine import ContinuousEngine, Engine, ServeConfig
from . import GateError
from .serve import setup

MULTIPLIERS = ["mul8u_exact", "mul8u_trunc7", "mul8u_trunc6",
               "mul8u_trunc5", "mul8u_bam_h0_v4", "mul8u_bam_h1_v4",
               "mul8u_trunc4", "mul8u_bam_h0_v2"]
PROMPT_LENS = (4, 6, 8)
N_SLOTS, BLOCK_SIZE = 4, 4
CAPACITY = max(PROMPT_LENS) + 8
#: the banked and the single-table kernel under each variant
KERNELS = {"pallas": ("lut_matmul_bank", "lut_matmul"),
           "fused": ("fused_matmul_bank", "fused_matmul")}


def _uniform_policy(mult: str) -> str:
    return ApproxPolicy(default=BackendSpec(
        mode="lut", multiplier=mult, ste=False)).to_json()


def _hetero_policy(attn_mult: str, rest_mult: str) -> str:
    """Different multiplier on attention vs everything else — one
    request carrying a per-layer (explore_heterogeneous-style)
    selection."""
    return ApproxPolicy(
        default=BackendSpec(mode="lut", multiplier=rest_mult, ste=False),
        overrides=[("*attn*", BackendSpec(mode="lut",
                                          multiplier=attn_mult,
                                          ste=False))]).to_json()


def _policy_set(n: int) -> list:
    """n distinct policies: None (engine default) + uniform picks, the
    last replaced by a heterogeneous per-layer policy when n >= 4."""
    policies: list = [None]
    policies += [_uniform_policy(m) for m in MULTIPLIERS[1:n]]
    if n >= 4:
        policies[-1] = _hetero_policy(MULTIPLIERS[1], MULTIPLIERS[2])
    return policies[:n]


def _drive(engine, requests, mean_interarrival_steps: float, seed: int
           ) -> dict:
    """Submit ``requests`` (prompt, ServeConfig) on a Poisson arrival
    process measured in decode-step units and run the engine dry."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_steps, len(requests))
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    start_step = engine.step_count
    rids, i = [], 0
    t0 = time.perf_counter()
    while i < len(requests) or not engine.scheduler.idle:
        while i < len(requests) and \
                engine.step_count - start_step >= arrivals[i]:
            prompt, serve = requests[i]
            rids.append(engine.submit(prompt, serve))
            i += 1
        engine.step()
        if engine.step_count - start_step > 100_000:
            raise RuntimeError("load did not drain")
    wall = time.perf_counter() - t0
    finished = engine.scheduler.finished
    lat_ms = [(finished[r].finished_at - finished[r].submitted_at) * 1e3
              for r in rids]
    n_tokens = sum(len(finished[r].tokens) for r in rids)
    return {"rids": rids, "wall_s": wall, "n_tokens": n_tokens,
            "steps": engine.step_count - start_step,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99))}


def _make_requests(n_requests: int, policies: list, vocab: int,
                   seed: int) -> list:
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        prompt = rng.integers(
            0, vocab, (int(rng.choice(PROMPT_LENS)),)).astype(np.int32)
        temp = 0.0 if i % 2 == 0 else 0.8
        serve = ServeConfig(
            max_new_tokens=int(rng.integers(3, 8)), temperature=temp,
            seed=int(rng.integers(0, 1 << 16)),
            policy=policies[i % len(policies)])
        reqs.append((prompt, serve))
    return reqs


def _banked_per_step(engine, per_step: int, kernels: tuple,
                     on_gpu: bool) -> bool:
    """Every logged prefill and decode step: ``per_step`` banked calls,
    no single-table call, and on a GPU exactly ``per_step`` launches of
    the banked kernel and nothing else."""
    want = {kernels[0]: per_step} if on_gpu else {}
    return bool(engine.step_log) and all(
        e["banked"] == per_step and e["single"] == 0
        and e["launches"] == want for e in engine.step_log)


def run(device: DeviceLike = None, quick: bool = False,
        arch: str = "qwen1.5-0.5b", reduced: bool = False,
        variant: str = "pallas",
        log: Callable[[str], None] = print) -> dict:
    """The load sweep and its gates; returns the record, or raises
    ``GateError`` (carrying it) when a gate fails."""
    lib = get_default_library()
    dev, cfg, params, _ = setup(device, arch, reduced)
    on_gpu = dev.type == "cuda"
    levels = [1, 2, 4] if quick else [1, 2, 4, 8]
    n_requests = 8 if quick else 24
    # ONE engine, bank fixed to the multiplier superset: every level
    # (and every distinct-policy count) runs through the same bank
    engine = ContinuousEngine(cfg, params, library=lib,
                              multipliers=MULTIPLIERS, n_slots=N_SLOTS,
                              capacity=CAPACITY, block_size=BLOCK_SIZE,
                              variant=variant)
    per_step = len(engine.layers) * cfg.n_layers
    t0 = time.perf_counter()
    for plen in PROMPT_LENS:
        engine.submit(np.zeros(plen, np.int32),
                      ServeConfig(max_new_tokens=2))
    engine.run()
    warmup_s = time.perf_counter() - t0

    results, all_reqs = [], []
    for n_pol in levels:
        reqs = _make_requests(n_requests, _policy_set(n_pol), cfg.vocab,
                              seed=100 + n_pol)
        start_log = len(engine.step_log)
        stats = _drive(engine, reqs, mean_interarrival_steps=2.0,
                       seed=200 + n_pol)
        all_reqs.extend(zip(stats.pop("rids"), reqs))
        level = {"n_policies": n_pol, "n_requests": n_requests,
                 "n_tokens": stats["n_tokens"], "wall_s": stats["wall_s"],
                 "tokens_per_s": stats["n_tokens"] / stats["wall_s"],
                 "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                 "decode_steps": stats["steps"],
                 "steps": engine.step_summary(start_log)}
        results.append(level)
        log(f"[serve_load] {n_pol} policies: {stats['steps']} steps, "
            f"{level['tokens_per_s']:.1f} tok/s, p50 {stats['p50_ms']:.1f} "
            f"ms, p99 {stats['p99_ms']:.1f} ms, wall {stats['wall_s']:.3f} s")

    banked_gate = (_banked_per_step(engine, per_step, KERNELS[variant],
                                    on_gpu)
                   and engine.trace_counts["bank_builds"] == 1)

    # bit identity: replay every request sequentially under the
    # equivalent materialized policy
    finished = engine.scheduler.finished
    extras = input_extras(cfg, 1) or None

    def replay() -> list:
        ref_engines: dict = {}
        mismatches = []
        for rid, (prompt, serve) in all_reqs:
            if serve.policy not in ref_engines:
                ref_engines[serve.policy] = Engine(
                    cfg, params, engine.lane_policy(serve), library=lib)
            ref = ref_engines[serve.policy].generate(prompt[None], serve,
                                                     extras=extras)[0]
            got = np.asarray(finished[rid].tokens, np.int32)
            if not np.array_equal(ref, got):
                mismatches.append({"rid": rid, "got": got.tolist(),
                                   "ref": ref.tolist()})
        return mismatches

    t0 = time.perf_counter()
    mismatches, replay_launches = ops.launches_during(replay)
    replay_s = time.perf_counter() - t0

    record = {
        "benchmark": "serve_load", "arch": arch, "reduced": reduced,
        "device": (torch.cuda.get_device_name(dev) if on_gpu else "cpu"),
        "variant": variant, "quick": quick, "n_slots": N_SLOTS,
        "capacity": CAPACITY, "block_size": BLOCK_SIZE,
        "multiplier_bank": MULTIPLIERS, "layer_tags": list(engine.layers),
        "warmup_s": warmup_s, "levels": results,
        "bank_builds": engine.trace_counts["bank_builds"],
        "banked_per_step_expected": per_step,
        "steps": engine.step_summary(),
        "banked_per_step_gate": banked_gate,
        "bit_identity": not mismatches,
        "bit_identity_requests": len(all_reqs),
        "mismatches": mismatches[:5],
        "replay_s": replay_s, "replay_launches": replay_launches,
        "tokens": {rid: finished[rid].tokens for rid, _ in all_reqs},
    }
    log(f"[serve_load] banked calls a step {per_step}: {banked_gate}; "
        f"bit identity over {len(all_reqs)} requests: {not mismatches} "
        f"(replay {replay_s:.2f} s, launches {replay_launches})")
    if mismatches:
        raise GateError(
            "continuous-batched mixed-policy decode diverged from "
            f"sequential generate on {len(mismatches)} request(s): "
            f"{mismatches[:2]}", "bit_identity", record)
    if not banked_gate:
        raise GateError(
            f"a prefill or decode step did not make exactly {per_step} "
            f"banked calls and nothing else: {record['steps']} "
            f"(bank builds {record['bank_builds']})", "banked_per_step",
            record)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="levels 1/2/4 and 8 requests a level (else "
                         "1/2/4/8 and 24); gates are identical")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() form (CPU smoke runs)")
    ap.add_argument("--variant", default="pallas",
                    choices=("ref", "pallas", "fused"),
                    help="datapath: pallas = K2 (K1 in the replay), "
                         "fused = K4 (K3), ref = plain PyTorch")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = None
    try:
        record = run(args.device, quick=args.quick, arch=args.arch,
                     reduced=args.reduced, variant=args.variant)
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

"""Continuous-batching serve load generator (the port's counterpart of
``benchmarks/serve_load.py``, DESIGN.md §2.8).

Drives one ``ContinuousEngine`` with Poisson request arrivals whose
``ServeConfig`` policies are drawn from a mixed set of approximate
multiplier selections (uniform per-tenant picks plus, from four
policies up, a heterogeneous per-layer policy — every application ships
its own selected accelerator), at 1/2/4[/8] distinct policies: the
reference's multipliers, prompt lengths, policy sets, arrival process
and seeds, a fixed 8-multiplier bank, 4 slots, a 16-row cache (and a
vlm's image rows) in 4-row blocks.  Any arch of the registry serves:
each request carries the family's stub extras (encoder frames, image
embeddings), and ``levels``, ``n_requests`` and config ``overrides``
(a depth cut) size a run to the model.

Its record holds, per level, tokens/s, p50/p99 request latency, the
decode steps and a decode step's median wall, and the two gates (each
raises ``GateError`` once the record is complete):

  * ``bit_identity``: every request's tokens equal the port's own
    sequential ``Engine(cfg, params, engine.lane_policy(serve))
    .generate``, token for token (the replay runs the single-table
    datapath: K1 under ``pallas``, K3 under ``fused``);
  * ``banked_per_step`` (the port's form of the reference's
    O(1)-compiled-programs gate): every prefill and every decode step,
    the warm-up's included, made exactly the call-site formula's banked
    datapath calls (``banked_calls_per_step``: one a projection, an MoE
    layer's for all its experts; 7 x n_layers for a dense model) and no single-table call, whatever the number of policies,
    and the bank was built once.  On a GPU each such step must also have
    launched the banked kernel (K2 under ``pallas``, K4 under
    ``fused``) exactly as many times and no other kernel.

Run (GPU; qwen1.5-0.5b at full width, random weights from seed 0):
``PYTHONPATH=src python -m repro_torch.launch.serve_load --quick
[--variant fused] [--arch mamba2-780m] [--n-layers 4] [--out
serve_load.json]``; on the CPU: ``--device cpu --reduced --quick [--arch
any]``.  Nothing is written unless ``--out`` says where.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..approx.layers import ApproxPolicy
from ..approx.specs import BackendSpec
from ..configs import ARCHS
from ..core.library import get_default_library
from ..device import DeviceLike
from ..kernels import ops
from ..models.registry import input_extras, prompt_extra_len
from ..serve.engine import ContinuousEngine, Engine, ServeConfig
from . import GateError
from .arch_profiles import banked_calls_per_forward
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


def capacity(cfg) -> int:
    """Cache rows a slot: the longest prompt, a vlm's image rows and the
    most new tokens a request draws (7)."""
    return CAPACITY + prompt_extra_len(cfg, input_extras(cfg, 1))


def banked_calls_per_step(cfg) -> dict:
    """The call-site formula: banked datapath calls of one prefill and
    one decode step, ``{"prefill": .., "decode": ..}``.  A decode step
    makes one a projection of every decoder layer (``block_pattern``:
    4 an attention slot, 8 an MLA slot, 2 a mamba slot, 3 a gated FFN
    and 2 another, one for each projection of an MoE layer's routed
    experts, all experts at once, and one FFN for its shared ones); an
    encdec's decoder layer makes 4 self-attention, 2 cross-attention
    (``wq``, ``wo``) and its FFN's.  A prefill adds a vlm's ``img_proj``, an encdec's encoder and its
    cross-KV's ``wk``/``wv`` (``arch_profiles.banked_calls_per_forward``,
    one banked forward)."""
    prefill = banked_calls_per_forward(cfg)
    if cfg.family == "encdec":
        ffn = 3 if cfg.act == "silu" else 2
        return {"prefill": prefill, "decode": cfg.n_layers * (6 + ffn)}
    return {"prefill": prefill,
            "decode": prefill - (1 if cfg.family == "vlm" else 0)}


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


def _banked_per_step(engine, per_step: dict, kernels: tuple,
                     on_gpu: bool) -> bool:
    """Every logged prefill and decode step: ``per_step[kind]`` banked
    calls, no single-table call, and on a GPU exactly as many launches
    of the banked kernel and nothing else."""
    return bool(engine.step_log) and all(
        e["banked"] == per_step[e["kind"]] and e["single"] == 0
        and e["launches"] == ({kernels[0]: per_step[e["kind"]]}
                              if on_gpu else {})
        for e in engine.step_log)


def run(device: DeviceLike = None, quick: bool = False,
        arch: str = "qwen1.5-0.5b", reduced: bool = False,
        variant: str = "pallas", log: Callable[[str], None] = print, *,
        overrides: Optional[dict] = None, levels: Optional[list] = None,
        n_requests: Optional[int] = None, warmup: bool = True) -> dict:
    """The load sweep and its gates; returns the record, or raises
    ``GateError`` (carrying it) when a gate fails.  ``overrides``:
    config fields replaced (``serve.setup``: a depth cut); ``levels``
    and ``n_requests`` replace ``quick``'s (or the full run's) policy
    counts and requests a level; ``warmup``: one request a prompt
    length first, outside the levels."""
    lib = get_default_library()
    dev, cfg, params, _ = setup(device, arch, reduced, overrides=overrides)
    on_gpu = dev.type == "cuda"
    levels = levels or ([1, 2, 4] if quick else [1, 2, 4, 8])
    n_requests = n_requests or (8 if quick else 24)
    # ONE engine, bank fixed to the multiplier superset: every level
    # (and every distinct-policy count) runs through the same bank
    engine = ContinuousEngine(cfg, params, library=lib,
                              multipliers=MULTIPLIERS, n_slots=N_SLOTS,
                              capacity=capacity(cfg),
                              block_size=BLOCK_SIZE, variant=variant)
    per_step = banked_calls_per_step(cfg)
    t0 = time.perf_counter()
    if warmup:
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
        walls = [e["wall_s"] for e in engine.step_log[start_log:]
                 if e["kind"] == "decode"]
        level = {"n_policies": n_pol, "n_requests": n_requests,
                 "n_tokens": stats["n_tokens"], "wall_s": stats["wall_s"],
                 "tokens_per_s": stats["n_tokens"] / stats["wall_s"],
                 "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                 "decode_steps": stats["steps"],
                 "decode_step_ms": float(np.median(walls)) * 1e3,
                 "steps": engine.step_summary(start_log)}
        results.append(level)
        log(f"[serve_load] {n_pol} policies: {stats['steps']} steps, "
            f"{level['tokens_per_s']:.1f} tok/s, p50 {stats['p50_ms']:.1f} "
            f"ms, p99 {stats['p99_ms']:.1f} ms, wall {stats['wall_s']:.3f} s, "
            f"decode step {level['decode_step_ms']:.1f} ms (median)")

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
        "overrides": overrides or {}, "n_layers": cfg.n_layers,
        "device": (torch.cuda.get_device_name(dev) if on_gpu else "cpu"),
        "variant": variant, "quick": quick, "n_slots": N_SLOTS,
        "capacity": engine.capacity, "block_size": BLOCK_SIZE,
        "multiplier_bank": MULTIPLIERS, "layer_tags": list(engine.layers),
        "warmup_s": warmup_s, "levels": results,
        "bank_builds": engine.trace_counts["bank_builds"],
        "banked_per_step_expected": per_step["decode"],
        "banked_per_prefill_expected": per_step["prefill"],
        "steps": engine.step_summary(),
        "banked_per_step_gate": banked_gate,
        "bit_identity": not mismatches,
        "bit_identity_requests": len(all_reqs),
        "mismatches": mismatches[:5],
        "replay_s": replay_s, "replay_launches": replay_launches,
        "tokens": {rid: finished[rid].tokens for rid, _ in all_reqs},
    }
    log(f"[serve_load] banked calls a prefill / decode step "
        f"{per_step['prefill']} / {per_step['decode']}: {banked_gate}; "
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
            f"banked calls (prefill, decode) and nothing else: "
            f"{record['steps']} "
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
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced() form (CPU smoke runs)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers (widths "
                         "stay the config's)")
    ap.add_argument("--variant", default="pallas",
                    choices=("ref", "pallas", "fused"),
                    help="datapath: pallas = K2 (K1 in the replay), "
                         "fused = K4 (K3), ref = plain PyTorch")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = None
    try:
        record = run(args.device, quick=args.quick, arch=args.arch,
                     reduced=args.reduced, variant=args.variant,
                     overrides=({"n_layers": args.n_layers}
                                if args.n_layers else None))
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

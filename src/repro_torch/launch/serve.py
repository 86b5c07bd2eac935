"""Serving CLI (port of ``repro.launch.serve``): batched generation with
the approximate-multiplier datapath.

    PYTHONPATH=src python -m repro_torch.launch.serve            # GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --reduced --batch 2 --prompt-len 8 --max-new 4

The defaults serve ``qwen1.5-0.5b`` at full width (random weights from a
fixed seed, as the reference serves a randomly initialised model) with
every projection on the auto-picked approximate multiplier, emulated by
the rank-4 factored LUT through kernel K9 (``--mode lowrank --variant
pallas``).  Without ``--device`` the run needs a CUDA device.

As in the reference, a warm-up ``generate`` pair (the timed shapes and a
prefill-only one) runs first, then the timed run reports the end-to-end
rate and the steady-state decode rate (end-to-end minus a prefill-only
``generate``).  Nothing is compiled here, so the warm-up measures
first-call costs only.  ``--compile-cache`` is JAX-only.

``--continuous`` serves the same prompts through the multi-tenant
``ContinuousEngine`` instead (paged KV cache, mixed-policy banked
decode, DESIGN.md §2.8), for any ``--arch``: ``min(batch, 8)`` slots, a
cache of ``prompt_len + max_new`` rows a slot (plus a vlm's image
rows), each request with the family's stub extras (encoder frames,
image embeddings), ``mode="lut"`` with the engine's default
``mul8u_exact`` policy on ``--variant``'s datapath (K2 under
``pallas``, K4 under ``fused``); a one-request warm-up, then the timed
run:

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous \
        [--arch deepseek-v2-236b --n-layers 1]

``--n-layers`` cuts the model's depth (for a hybrid, to a multiple of
its block period); the widths stay the config's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..approx.layers import ApproxPolicy
from ..configs import ARCHS, get_config
from ..device import DeviceLike, resolve_device
from ..models.registry import input_extras, model_fns, prompt_extra_len
from ..serve.engine import ContinuousEngine, Engine, ServeConfig
from .steps import pick_case_multiplier, serve_policy, train_policy


def setup(device: DeviceLike = None, arch: str = "qwen1.5-0.5b",
          reduced: bool = False, batch: int = 4, prompt_len: int = 32,
          overrides: Optional[dict] = None):
    """(device, cfg, params, prompts) of a serve run: random f32
    parameters from a ``torch.Generator`` seeded 0 on the device (the
    reference uses ``PRNGKey(0)``), prompts from numpy's generator
    seeded 0 (the reference's).  ``overrides``: config fields replaced
    after ``reduced`` (e.g. ``{"n_layers": 1}``, a depth cut)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model_fns(cfg).init_params(gen, cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(
        np.int32)
    return dev, cfg, params, prompts


def make_policy(mode: str = "lowrank", multiplier: str = "auto",
                rank: Optional[int] = 4, variant: str = "pallas",
                policy_json: Optional[str] = None) -> ApproxPolicy:
    """The CLI's policy: a serialized ``ApproxPolicy`` file when given,
    else ``train_policy`` for bf16 and ``serve_policy`` otherwise."""
    if policy_json:
        with open(policy_json) as f:
            return ApproxPolicy.from_json(json.load(f))
    if mode == "bf16":
        return train_policy()
    return serve_policy(multiplier, mode, rank, variant)


def run(device: DeviceLike = None, arch: str = "qwen1.5-0.5b",
        reduced: bool = False, batch: int = 4, prompt_len: int = 32,
        max_new: int = 16, mode: str = "lowrank", multiplier: str = "auto",
        rank: Optional[int] = 4, variant: str = "pallas",
        policy_json: Optional[str] = None, warmup: bool = True,
        continuous: bool = False, overrides: Optional[dict] = None,
        log: Callable[[str], None] = print) -> dict:
    """Serve one static batch and return what was measured: the
    generated tokens, the warm-up, end-to-end and prefill-only wall
    times (s) and the end-to-end and steady-state decode rates
    (tokens/s).  ``continuous``: serve the prompts through the
    ``ContinuousEngine`` (``run_continuous``; the mode, multiplier, rank
    and policy arguments do not apply).  ``overrides``: config fields
    replaced (``setup``)."""
    dev, cfg, params, prompts = setup(device, arch, reduced, batch,
                                      prompt_len, overrides)
    if continuous:
        return run_continuous(dev, cfg, params, prompts, arch, reduced,
                              max_new, variant, warmup, log, overrides)
    if multiplier == "auto" and not policy_json and mode not in (
            "bf16", "int8"):
        multiplier = pick_case_multiplier()
    policy = make_policy(mode, multiplier, rank, variant, policy_json)
    engine = Engine(cfg, params, policy)
    extras = input_extras(cfg, batch) or None
    serve_cfg = ServeConfig(max_new_tokens=max_new)
    prefill_cfg = ServeConfig(max_new_tokens=1)
    warmup_s = None
    if warmup:
        t0 = time.perf_counter()
        engine.generate(prompts, serve_cfg, extras=extras)
        engine.generate(prompts, prefill_cfg, extras=extras)
        warmup_s = time.perf_counter() - t0
        log(f"[serve] warmup {warmup_s:.2f}s")
    # generate returns host arrays, so each timed region ends on the
    # device's last step
    t0 = time.perf_counter()
    out = engine.generate(prompts, serve_cfg, extras=extras)
    e2e = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate(prompts, prefill_cfg, extras=extras)
    prefill_s = time.perf_counter() - t0
    n_decode = batch * max(max_new - 1, 1)
    decode_s = max(e2e - prefill_s, 1e-9)
    record = {
        "arch": arch, "reduced": reduced, "overrides": overrides or {},
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "mode": mode, "multiplier": multiplier, "rank": rank,
        "variant": variant, "policy": engine.policy.to_json_dict(),
        "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
        "tokens": out.tolist(), "warmup_s": warmup_s, "e2e_s": e2e,
        "tok_per_s": batch * max_new / e2e, "prefill_s": prefill_s,
        "decode_tok_per_s": n_decode / decode_s}
    log(f"[serve] {arch} mode={mode} variant={variant} generated "
        f"{out.shape} tokens; end-to-end {e2e:.2f}s "
        f"({record['tok_per_s']:.1f} tok/s), steady-state decode "
        f"{record['decode_tok_per_s']:.1f} tok/s")
    return record


def run_continuous(dev, cfg, params, prompts, arch: str, reduced: bool,
                   max_new: int, variant: str, warmup: bool,
                   log: Callable[[str], None],
                   overrides: Optional[dict] = None) -> dict:
    """The reference's ``_serve_continuous``: every prompt a request of
    one ``ContinuousEngine`` (``min(batch, 8)`` slots, capacity
    ``prompt_len + max_new`` and a vlm's image rows, the family's stub
    extras, the default ``mul8u_exact`` lut policy).  Returns the tokens
    by request, the warm-up and end-to-end walls (s), tokens/s, the
    decode steps, the bank builds and the timed run's ``step_summary``
    (matmul calls and kernel launches per prefill and decode step)."""
    batch, prompt_len = prompts.shape
    n_slots = min(batch, 8)
    extra = prompt_extra_len(cfg, input_extras(cfg, 1))
    engine = ContinuousEngine(cfg, params, n_slots=n_slots,
                              capacity=prompt_len + extra + max_new,
                              variant=variant)
    serve_cfg = ServeConfig(max_new_tokens=max_new)
    warmup_s = None
    if warmup:
        t0 = time.perf_counter()
        engine.submit(prompts[0], serve_cfg)
        engine.run()
        warmup_s = time.perf_counter() - t0
        log(f"[serve] warmup {warmup_s:.2f}s")
    start_step, start_log = engine.step_count, len(engine.step_log)
    # run() returns host tokens, so the timed region ends on the
    # device's last step
    t0 = time.perf_counter()
    rids = [engine.submit(row, serve_cfg) for row in prompts]
    out = engine.run()
    e2e = time.perf_counter() - t0
    tokens = {r: out[r].tolist() for r in rids}  # drop the warm-up's
    n_toks = sum(len(t) for t in tokens.values())
    record = {
        "arch": arch, "reduced": reduced, "overrides": overrides or {},
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "continuous": True, "mode": engine.mode, "variant": variant,
        "policy": engine.default_policy.to_json_dict(),
        "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
        "n_slots": n_slots, "capacity": engine.capacity,
        "tokens": tokens, "warmup_s": warmup_s, "e2e_s": e2e,
        "tok_per_s": n_toks / e2e,
        "decode_steps": engine.step_count - start_step,
        "bank_builds": engine.trace_counts["bank_builds"],
        "steps": engine.step_summary(start_log)}
    log(f"[serve] {arch} continuous n_slots={n_slots} variant={variant} "
        f"generated {n_toks} tokens; end-to-end {e2e:.2f}s "
        f"({record['tok_per_s']:.1f} tok/s), decode steps="
        f"{record['decode_steps']} bank_builds={record['bank_builds']} "
        f"launches per decode step "
        f"{record['steps']['decode']['launches']}")
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers (widths "
                         "stay the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--mode", default="lowrank",
                    choices=("bf16", "int8", "lut", "lowrank"))
    ap.add_argument("--multiplier", default="auto")
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--variant", default="pallas",
                    choices=("ref", "pallas", "fused"),
                    help="datapath implementation: pallas = the CUDA "
                         "kernels (K9 for lowrank), ref = plain PyTorch")
    ap.add_argument("--policy-json", default=None,
                    help="path to a serialized ApproxPolicy (overrides "
                         "--mode/--multiplier/--rank/--variant)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous-batching "
                         "mixed-policy engine (forces --mode lut)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up generate pair")
    args = ap.parse_args(argv)
    record = run(args.device, args.arch, args.reduced, args.batch,
                 args.prompt_len, args.max_new, args.mode, args.multiplier,
                 args.rank, args.variant, args.policy_json,
                 warmup=not args.no_warmup, continuous=args.continuous,
                 overrides=({"n_layers": args.n_layers}
                            if args.n_layers else None))
    tokens = record["tokens"]
    print(np.asarray(next(iter(tokens.values())) if args.continuous
                     else tokens[:2]))


if __name__ == "__main__":
    main()

"""End-to-end LM training CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train            # GPU
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --steps 10 --batch 2 --seq 16

Any arch of ``configs.ARCHS`` (``--reduced``: the smoke-scale config,
f32) trains on the synthetic token stream (``data.synthetic.
token_stream``; a vlm gets stub image embeddings, an encoder-decoder stub
audio frames, both filled with 0.1 as in the reference) under the
training policy (``launch.steps.train_policy``: bf16 operands, f32
sums), through the port's ``Trainer``: AdamW with warmup over
``steps // 10`` steps and cosine decay, a checkpoint every
``max(10, steps // 5)`` steps into ``--ckpt-dir``, and the NaN guard.
Parameters are f32, drawn from a ``torch.Generator`` seeded 0 on the
device (the reference uses ``PRNGKey(0)``; the streams differ).
``--resume`` continues from the latest checkpoint in ``--ckpt-dir``.
Prints the reference's line of the mean loss over the first and the last
five steps.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..data.synthetic import token_stream
from ..device import DeviceLike, resolve_device
from ..models.registry import input_extras, model_fns
from ..train.loop import Trainer, TrainLoopConfig
from ..train.optimizer import OptimizerConfig, tree_leaves
from .steps import train_policy

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_train_ckpt")


def batches(cfg, batch: int, seq: int, microbatches: int, device):
    """The reference's batch stream: step ``i``'s tokens and targets
    from ``token_stream``, the family's stub inputs, reshaped to
    (microbatches, batch / microbatches, ...) when microbatched."""
    extras = {k: torch.from_numpy(v).to(device)
              for k, v in input_extras(cfg, batch).items()}
    step = 0
    while True:
        toks, tgts = token_stream(cfg.vocab, batch, seq, step)
        b = {"tokens": torch.from_numpy(toks).to(device),
             "targets": torch.from_numpy(tgts).to(device), **extras}
        if microbatches > 1:
            b = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                              *v.shape[1:]) for k, v in b.items()}
        yield b
        step += 1


def make_trainer(cfg, params, steps: int, lr: float, microbatches: int,
                 ckpt_dir: str, keep: int = 3) -> Trainer:
    fns = model_fns(cfg)
    policy = train_policy()
    loop_cfg = TrainLoopConfig(
        total_steps=steps, microbatches=microbatches,
        ckpt_every=max(10, steps // 5), ckpt_dir=ckpt_dir, ckpt_keep=keep,
        log_every=5)
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=steps // 10,
                              total_steps=steps)
    return Trainer(lambda p, b: fns.forward_train(p, b, cfg, policy),
                   params, opt_cfg, loop_cfg)


def init_params(cfg, device: torch.device, seed: int = 0) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    return model_fns(cfg).init_params(gen, cfg)


def run(device: DeviceLike = None, arch: str = "qwen1.5-0.5b",
        reduced: bool = False, steps: int = 50, batch: int = 8,
        seq: int = 128, microbatches: int = 1, lr: float = 3e-4,
        ckpt_dir: str = DEFAULT_CKPT_DIR, resume: bool = False,
        keep: int = 3, log: Callable[[str], None] = print) -> dict:
    """Train; returns a record (the loss history, step times, tokens a
    second at the median step, over all steps and over the whole run
    with its checkpoint saves, peak device memory) with the ``Trainer``
    under ``"trainer"``."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, dev)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    log(f"[train] {arch} ({'reduced' if reduced else 'full'}) "
        f"params={n_params / 1e6:.1f}M")
    trainer = make_trainer(cfg, params, steps, lr, microbatches, ckpt_dir,
                           keep)
    if resume and trainer.maybe_resume():
        log(f"[train] resumed from step {trainer.step}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = trainer.run(batches(cfg, batch, seq, microbatches, dev), log=log)
    wall = time.perf_counter() - t0
    record = {"arch": arch, "reduced": reduced, "n_params": n_params,
              "steps": steps, "batch": batch, "seq": seq,
              "microbatches": microbatches, "run_s": wall,
              "history": hist, "trainer": trainer,
              "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                             if dev.type == "cuda" else None)}
    if hist:
        first = float(np.mean([h["loss"] for h in hist[:5]]))
        last = float(np.mean([h["loss"] for h in hist[-5:]]))
        # the first step pays first-call costs; later ones are steady
        ms = [h["ms"] for h in hist[1:]] or [hist[0]["ms"]]
        tokens = batch * seq * len(hist)
        steps_s = sum(h["ms"] for h in hist) / 1e3
        record.update(first_loss=first, last_loss=last,
                      step_ms=float(np.median(ms)),
                      step_ms_max=float(np.max(ms)),
                      tokens_per_s=batch * seq / (np.median(ms) / 1e3),
                      # every step, the first included, then with the
                      # checkpoint saves: what a user waits for
                      tokens_per_s_steps=tokens / steps_s,
                      tokens_per_s_run=tokens / wall)
        log(f"[train] loss {first:.4f} -> {last:.4f} over {len(hist)} "
            f"steps")
    return record


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    args = ap.parse_args(argv)
    run(args.device, arch=args.arch, reduced=args.reduced,
        steps=args.steps, batch=args.batch, seq=args.seq,
        microbatches=args.microbatches, lr=args.lr, ckpt_dir=args.ckpt_dir,
        resume=args.resume)


if __name__ == "__main__":
    main()

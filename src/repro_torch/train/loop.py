"""Fault-tolerant training loop (port of ``repro.train.loop``,
DESIGN.md §6).

* microbatched gradient accumulation: loss and gradients summed in f32
  in microbatch order, then scaled by ``1 / microbatches``;
* NaN/Inf guard: a non-finite loss restores the last checkpoint into
  the same parameter and optimizer tensors and skips a window of
  batches (the poisoned batches are never replayed);
* straggler monitor: per-step wall times, flags steps slower than
  ``straggler_factor`` x the running median (here it logs);
* periodic atomic checkpoints through ``CheckpointManager``.

The step is eager PyTorch: ``loss_fn(params, batch)`` builds the graph,
``torch.autograd.grad`` takes the gradients of every leaf of the
parameter tree (``optimizer.tree_leaves``), and ``adamw_update`` writes
the parameters and the optimizer state in place (the reference donates
them to its jitted step).  A step's wall time includes ``float(loss)``,
which waits for the device, as the reference's does.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .optimizer import (OptimizerConfig, OptState, adamw_update,
                        init_opt_state, nest, tree_leaves)


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    log_every: int = 10
    nan_skip_window: int = 8           # batches skipped after a NaN event
    straggler_factor: float = 3.0
    async_checkpoint: bool = False


def tree_add(a, b) -> dict:
    """Leafwise a + b of two trees with the same paths."""
    bs = dict(tree_leaves(b))
    return nest({k: x + bs[k] for k, x in tree_leaves(a)})


def tree_scale(a, s) -> dict:
    return nest({k: x * s for k, x in tree_leaves(a)})


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the loss detached, the gradients a dict keyed by
    the parameters' paths.  Every parameter becomes a leaf that requires
    grad (the first call marks them)."""
    leaves = tree_leaves(params)
    for _, p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [p for _, p in leaves])
    return loss.detach(), nest({k: g for (k, _), g in zip(leaves, grads)})


def _microbatch(batch, i: int):
    return {k: v[i] for k, v in batch.items()}


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    microbatches: int = 1) -> Callable:
    """loss_fn(params, batch) -> scalar.  Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    which updates ``params`` and ``opt_state`` in place.

    With microbatches > 1 every batch leaf must be shaped
    (microbatches, mb, ...); gradients are accumulated in f32.
    """

    def train_step(params, opt_state: OptState, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32)
            grads = None
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params,
                                      _microbatch(batch, i))
                g = {k: x.to(torch.float32) for k, x in tree_leaves(g)}
                loss = loss.to(l.device) + l
                grads = (nest(g) if grads is None
                         else tree_add(grads, nest(g)))
            loss = loss / microbatches
            grads = tree_scale(grads, 1.0 / microbatches)
        params, opt_state, metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.times: list[float] = []
        self.window = window
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) >= 8:
            med = float(np.median(hist[:-1]))
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                return True
        return False


class Trainer:
    """Host-side orchestration: data, the step, guard, checkpoints.
    ``params`` (a tree, ``optimizer.tree_leaves``) is trained in place;
    ``self.params`` stays the same object."""

    def __init__(self, loss_fn: Callable, params: Any,
                 opt_cfg: OptimizerConfig, loop_cfg: TrainLoopConfig):
        self.loop_cfg = loop_cfg
        self.params = params
        self.opt_state = init_opt_state(params)
        self.step_fn = make_train_step(loss_fn, opt_cfg,
                                       loop_cfg.microbatches)
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir,
                                      keep=loop_cfg.ckpt_keep,
                                      async_save=loop_cfg.async_checkpoint)
        self.monitor = StragglerMonitor(loop_cfg.straggler_factor)
        self.step = 0
        self.nan_events: list[int] = []
        self.history: list[dict] = []

    def maybe_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        _, meta = self.ckpt.restore((self.params, self.opt_state))
        self.step = int(meta.get("step", latest))
        return True

    def _save(self) -> None:
        self.ckpt.save(self.step, (self.params, self.opt_state),
                       metadata={"step": self.step},
                       block=not self.loop_cfg.async_checkpoint)

    def run(self, batch_iter, log: Optional[Callable[[str], None]] = None
            ) -> list[dict]:
        log = log or (lambda s: print(s, flush=True))
        cfg = self.loop_cfg
        self._save()  # step-0 baseline for NaN recovery
        skip_until = -1
        while self.step < cfg.total_steps:
            batch = next(batch_iter)
            if self.step <= skip_until:
                self.step += 1
                continue
            t0 = time.perf_counter()
            _, _, metrics = self.step_fn(self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if not np.isfinite(loss):
                # fault path: restore last good state, skip the window
                self.nan_events.append(self.step)
                log(f"[guard] non-finite loss at step {self.step}; "
                    f"restoring + skipping {cfg.nan_skip_window} batches")
                self.ckpt.wait()
                self.ckpt.restore((self.params, self.opt_state))
                skip_until = self.step + cfg.nan_skip_window
                self.step += 1
                continue
            if self.monitor.record(self.step, dt):
                log(f"[straggler] step {self.step} took {dt * 1e3:.0f}ms "
                    f"(>{cfg.straggler_factor}x median)")
            rec = {"step": self.step, "loss": loss, "ms": dt * 1e3,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"])}
            self.history.append(rec)
            if self.step % cfg.log_every == 0:
                log(f"step {rec['step']:>6} loss {rec['loss']:.4f} "
                    f"gnorm {rec['grad_norm']:.3f} {rec['ms']:.0f}ms")
            self.step += 1
            if self.step % cfg.ckpt_every == 0:
                self._save()
        self._save()
        self.ckpt.wait()
        return self.history

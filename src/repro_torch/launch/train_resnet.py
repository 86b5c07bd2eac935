"""The paper's case study end to end, training included (the port's
counterpart of ``examples/train_resnet_approx.py`` and of the recipe of
``benchmarks/resilience_common.trained_resnet``): train a CIFAR ResNet
on the synthetic CIFAR-10, run the resilience analysis with library
multipliers — all layers (Table II), per layer (Fig. 4) — compose a
different multiplier per layer (the two-stage heterogeneous DSE), and
fine-tune under that heterogeneous datapath with straight-through (STE)
gradients.

    PYTHONPATH=src python -m repro_torch.launch.train_resnet        # GPU
    PYTHONPATH=src python -m repro_torch.launch.train_resnet \\
        --device cpu --steps 20 --train-n 256 --eval-n 64 --n-mult 3

Steps:

  1. training: ``ResNet`` from a ``torch.Generator`` seeded 0 (He-normal
     convs; the reference's ``PRNGKey(0)`` stream differs), AdamW (lr
     3e-3, 20 warmup steps, cosine decay, weight decay 1e-4) on
     ``CifarBatches("train", train_n, batch)`` through the port's
     ``Trainer``, a checkpoint every 100 steps into ``--ckpt-dir``;
     ``--from-checkpoint`` skips it and loads the committed trained
     ResNet-8 instead;
  2. the float accuracy, then ``explore`` with ``mode="lut"`` on the
     ``--variant`` datapath (``pallas``: K1 for one multiplier, K2 for a
     bank; ``fused``: K3, K4): the batched all-layers sweep and its
     golden int8 baseline, ``select_multiplier`` within one point, and
     the per-layer sweep of the worst multiplier;
  3. ``explore_heterogeneous`` at a quality bound of one point;
  4. the fine-tune: ``max(20, steps // 10)`` steps of ``resnet.loss_fn``
     under the selected heterogeneous policy (lr 3e-4, 5 warmup steps):
     every assigned layer's forward runs the approximate datapath (one
     K1 — K3 under ``fused`` — launch a layer and step on the GPU) and
     its backward the exact f32 matmul; the accuracy under that policy
     before and after;
  5. the fine-tuned weights saved with the policy in the checkpoint's
     metadata (``--ckpt-dir`` + ``_hetero``).

Returns (``run``) a JSON-able record, with each stage's wall time and,
on the GPU, the kernel launches of the fine-tune and of its
evaluations.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..approx.dse import explore, explore_heterogeneous, select_multiplier
from ..approx.layers import ApproxPolicy
from ..approx.specs import BackendSpec
from ..approx.workload import classification
from ..core.library import get_default_library
from ..data.synthetic import CifarBatches
from ..device import DeviceLike, resolve_device
from ..models import resnet
from ..models.weights import load_resnet8
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer, TrainLoopConfig
from ..train.optimizer import OptimizerConfig
from .case_study import timed_launches

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_resnet_ckpt")


def train_batches(data: CifarBatches, device):
    """Endless epochs of ``data`` as tensors on ``device``."""
    while True:
        for b in data.epoch():
            yield {"images": torch.from_numpy(b["images"]).to(device),
                   "labels": torch.from_numpy(b["labels"]).to(device)}


def train(device: DeviceLike = None, depth: int = 8, steps: int = 300,
          batch: int = 64, train_n: int = 4096, seed: int = 0,
          ckpt_dir: str = DEFAULT_CKPT_DIR,
          log: Callable[[str], None] = print):
    """Step 1: (cfg, model, loss history, train data) — the
    ``trained_resnet`` recipe at ``steps=320, batch=64,
    train_n=4096``."""
    dev = resolve_device(device)
    cfg = resnet.resnet_config(depth)
    model = resnet.ResNet(cfg, torch.Generator().manual_seed(seed)).to(dev)
    data = CifarBatches("train", train_n, batch)
    trainer = Trainer(lambda m, b: resnet.loss_fn(m, b, cfg), model,
                      OptimizerConfig(lr=3e-3, warmup_steps=20,
                                      total_steps=steps, weight_decay=1e-4),
                      TrainLoopConfig(total_steps=steps, ckpt_every=100,
                                      ckpt_dir=ckpt_dir, log_every=25))
    hist = trainer.run(train_batches(data, dev), log=log)
    return cfg, model, hist, data


def accuracy_under(model, cfg, policy: ApproxPolicy, eval_n: int,
                   batch: int, device) -> float:
    """Mean over the eval batches of the top-1 accuracy, one sequential
    forward a batch (the example's ``acc_under``)."""
    accs = []
    with torch.inference_mode():
        for b in CifarBatches("test", eval_n, batch).eval_batches():
            logits = resnet.forward(
                model, torch.from_numpy(b["images"]).to(device), cfg,
                policy)
            accs.append(float(torch.mean((torch.argmax(logits, -1).cpu()
                                          == torch.from_numpy(b["labels"]))
                                         .to(torch.float32))))
    return float(np.mean(accs))


def fine_tune(model, cfg, policy: ApproxPolicy, steps: int,
              data: CifarBatches, device, ckpt_dir: str,
              log: Callable[[str], None] = lambda s: None) -> list:
    """Step 4's training: ``steps`` STE steps of ``resnet.loss_fn`` under
    ``policy`` (lr 3e-4, 5 warmup steps, weight decay 1e-4); the model
    is updated in place.  Returns the loss history."""
    trainer = Trainer(lambda m, b: resnet.loss_fn(m, b, cfg, policy), model,
                      OptimizerConfig(lr=3e-4, warmup_steps=5,
                                      total_steps=steps, weight_decay=1e-4),
                      TrainLoopConfig(total_steps=steps,
                                      ckpt_every=10 ** 9,
                                      ckpt_dir=ckpt_dir, log_every=10 ** 9))
    return trainer.run(train_batches(data, device), log=log)


def run(device: DeviceLike = None, depth: int = 8, steps: int = 300,
        batch: int = 64, train_n: int = 4096, eval_n: int = 512,
        n_mult: int = 6, full: bool = False,
        ckpt_dir: str = DEFAULT_CKPT_DIR, variant: str = "pallas",
        from_checkpoint: bool = False,
        log: Callable[[str], None] = print) -> dict:
    """Steps 1-5; returns the record (module docstring)."""
    dev = resolve_device(device)
    record: dict = {"variant": variant, "depth": depth, "steps": steps,
                    "eval_n": eval_n, "from_checkpoint": from_checkpoint}
    t0 = time.perf_counter()
    if from_checkpoint:
        if depth != 8:
            raise ValueError("only ResNet-8's trained checkpoint is "
                             "committed")
        cfg = resnet.resnet_config(8)
        model = load_resnet8().to(dev)
        data = CifarBatches("train", train_n, batch)
    else:
        log(f"[resnet] training resnet{depth} on synthetic CIFAR-10")
        cfg, model, hist, data = train(dev, depth, steps, batch, train_n,
                                       ckpt_dir=ckpt_dir, log=log)
        record["train_losses"] = [h["loss"] for h in hist]
        record["train_step_ms"] = float(np.median(
            [h["ms"] for h in hist[1:]] or [hist[0]["ms"]]))
    record["train_s"] = time.perf_counter() - t0

    eval_fn = classification(cfg, model, eval_n=eval_n, batch=batch,
                             device=dev)
    acc_f32 = eval_fn(ApproxPolicy(default=BackendSpec.exact("f32")))
    log(f"[resnet] accuracy: float={100 * acc_f32:.2f}%")
    lib = get_default_library()
    mults = [e.name for e in lib.case_study_selection(per_metric=10)]
    if not full:
        mults = mults[:: max(1, len(mults) // n_mult)][:n_mult]
    counts = resnet.layer_mult_counts(cfg)
    cache: dict = {}
    kw = dict(mode="lut", variant=variant, batch=True, cache=cache)
    result, table_s, _ = timed_launches(lambda: explore(
        eval_fn, counts, lib, multipliers=mults, per_layer=False, **kw),
        dev)
    acc_int8 = result.baseline_accuracy
    log(f"[resnet] 8-bit exact (golden) accuracy: {100 * acc_int8:.2f}%")
    rows = result.all_layers
    for r in sorted(rows, key=lambda r: -r.network_rel_power):
        log(f"  {r.multiplier:<20}{100 * r.network_rel_power:>8.1f}"
            f"{r.errors['mae']:>10.2f}{100 * r.accuracy:>8.2f}")
    pick = select_multiplier(result, max_accuracy_drop=0.01)
    worst = min(rows, key=lambda r: r.accuracy)
    layer_result, fig4_s, _ = timed_launches(lambda: explore(
        eval_fn, counts, lib, multipliers=[worst.multiplier],
        all_layers=False, **kw), dev)
    hetero, hetero_s, _ = timed_launches(lambda: explore_heterogeneous(
        eval_fn, counts, lib, multipliers=mults, quality_bound=0.01, **kw),
        dev)
    record.update(
        accuracy_f32=acc_f32, accuracy_int8=acc_int8, multipliers=mults,
        table_ii=[{"multiplier": r.multiplier, "accuracy": r.accuracy,
                   "network_rel_power": r.network_rel_power} for r in rows],
        selected=pick.multiplier if pick is not None else None,
        fig4=[{"layer": r.layer, "multiplier": r.multiplier,
               "accuracy": r.accuracy, "mult_share": r.mult_share}
              for r in layer_result.per_layer],
        heterogeneous=[{"assignment": dict(p.assignment),
                        "accuracy": p.accuracy,
                        "network_rel_power": p.network_rel_power}
                       for p in hetero.heterogeneous],
        table_ii_s=table_s, fig4_s=fig4_s, heterogeneous_s=hetero_s)
    pick_h = hetero.selected
    if pick_h is None:
        log("  no heterogeneous point within the bound; skipping "
            "fine-tune")
        record["fine_tune"] = None
        return record
    hetero_policy = pick_h.policy().materialize(lib)
    log(f"[heterogeneous DSE] selected (power "
        f"{100 * pick_h.network_rel_power:.1f}%, acc "
        f"{100 * pick_h.accuracy:.2f}%): {dict(pick_h.assignment)}")

    def acc():
        return accuracy_under(model, cfg, hetero_policy, eval_n, batch, dev)
    ft_steps = max(20, steps // 10)
    acc_pre, pre_s, pre_launches = timed_launches(acc, dev)
    hist, ft_s, ft_launches = timed_launches(lambda: fine_tune(
        model, cfg, hetero_policy, ft_steps, data, dev,
        ckpt_dir + "_hetero"), dev)
    acc_post, post_s, post_launches = timed_launches(acc, dev)
    log(f"[heterogeneous fine-tune] {ft_steps} steps in {ft_s:.1f}s: "
        f"accuracy under the heterogeneous datapath {100 * acc_pre:.2f}% "
        f"-> {100 * acc_post:.2f}%")
    mgr = CheckpointManager(ckpt_dir + "_hetero", keep=1)
    mgr.save(ft_steps, model, policy=pick_h.policy())
    record["fine_tune"] = {
        "assignment": dict(pick_h.assignment),
        "policy": pick_h.policy().to_json_dict(),
        "verified_accuracy": pick_h.accuracy,
        "network_rel_power": pick_h.network_rel_power,
        "steps": ft_steps, "losses": [h["loss"] for h in hist],
        "step_ms": float(np.median([h["ms"] for h in hist[1:]])),
        "accuracy_before": acc_pre, "accuracy_after": acc_post,
        "eval_batches": eval_n // batch, "wall_s": ft_s,
        "eval_s": pre_s + post_s, "launches": ft_launches,
        "eval_launches": pre_launches,
        "eval_launches_after": post_launches,
        "checkpoint": mgr._step_dir(ft_steps)}
    return record


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--train-n", type=int, default=4096)
    ap.add_argument("--eval-n", type=int, default=512)
    ap.add_argument("--n-mult", type=int, default=6,
                    help="case-study multipliers to sweep")
    ap.add_argument("--full", action="store_true",
                    help="sweep ALL case-study multipliers per layer")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--variant", default="pallas",
                    choices=("pallas", "fused"),
                    help="CUDA datapath (pallas: K1/K2, fused: K3/K4)")
    ap.add_argument("--from-checkpoint", action="store_true",
                    help="skip training: the committed ResNet-8")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first GPU)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    record = run(args.device, depth=args.depth, steps=args.steps,
                 batch=args.batch, train_n=args.train_n,
                 eval_n=args.eval_n, n_mult=args.n_mult, full=args.full,
                 ckpt_dir=args.ckpt_dir, variant=args.variant,
                 from_checkpoint=args.from_checkpoint)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)


if __name__ == "__main__":
    main()

"""Banked resilience sweeps of a CIFAR ResNet: the paper's Table II
analysis.  One pass is what ``approx.resilience.all_layers_sweep(...,
batch=True)`` runs: one ``bank_eval`` over the classification workload's
``traceable_metrics``, which evaluates every candidate multiplier of the
bank (a lane each, in every approximated layer) on every batch of the
eval set and returns each lane's accuracy and logit MAE.

Parameters (the workload file): ``lanes`` ("all" or names of
``data/mult8.npz``), ``batch`` images a BN batch, ``eval_batches``
batches an eval set, ``pool_sets`` distinct eval sets made from
``pool_seed`` and swept in an order drawn from the run's seed, ``mode``
and ``variant`` of the banked datapath, ``check_passes``,
``trace_passes`` and ``limits``.  Every seed sweeps the same pool, each
set equally often: the lookup kernel's speed depends on the codes it
gathers, so a pool drawn anew from each seed changed the work from seed
to seed.

The images and the tables are the benchmark's, the weights the committed
checkpoint, read by the program's loader and, separately, by the
reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import counts, tables
from perfbench.spans import pass_scope
from perfbench.reference import resnet as ref


def cifar_like(n: int, seed: int, device, size: int = 32,
               classes: int = 10):
    """(images (n, size, size, 3) f32 in [0, 1], labels (n,) int64) drawn
    on ``device`` from ``seed``: per class a fixed texture (gratings, a
    coloured blob), per image jitter and noise, so that the trained
    ResNet-8 classifies them as it does the program's test set (98-100%
    top-1 at the exact 8-bit datapath).
    The recipe of the program's synthetic CIFAR-10 (its class
    parameters, amplitudes and noise levels), with its draws made in
    bulk on the device."""
    prng = np.random.default_rng(1234)
    freqs = prng.uniform(2.0, 6.0, size=(classes, 3))
    angles = prng.uniform(0, np.pi, size=(classes, 3))
    phases = prng.uniform(0, 2 * np.pi, size=(classes, 3))
    centers = prng.uniform(0.25, 0.75, size=(classes, 2))
    colors = prng.uniform(0.4, 1.0, size=(classes, 3))

    def const(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(std, *shape):
        return torch.randn(shape, generator=gen, device=device) * std

    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    axis = torch.arange(size, dtype=torch.float32, device=device) / size
    yy, xx = torch.meshgrid(axis, axis, indexing="ij")
    centre = const(centers)[labels] + normal(0.22, n, 2)
    blob = torch.exp(-((xx - centre[:, 0, None, None]) ** 2
                       + (yy - centre[:, 1, None, None]) ** 2) / 0.04)
    angle = (const(angles)[labels] + normal(0.35, n, 3))[:, None, None, :]
    freq = (const(freqs)[labels]
            * (1.0 + normal(0.15, n, 3)))[:, None, None, :]
    phase = (const(phases)[labels] + normal(0.8, n, 3))[:, None, None, :]
    grating = torch.sin(2 * math.pi * freq
                        * (xx[..., None] * torch.cos(angle)
                           + yy[..., None] * torch.sin(angle)) + phase)
    colour = const(colors)[labels]
    img = (0.5 + 0.10 * grating * colour[:, None, None, :]
           + 0.16 * blob[..., None] * colour[:, None, None, [1, 2, 0]])
    img = img + normal(0.16, n, size, size, 3)
    return torch.clamp(img, 0.0, 1.0), labels


class ResNetBank:
    def __init__(self, spec, config, seed, device, root):
        from repro_torch.approx.layers import ApproxPolicy, bank_eval
        from repro_torch.approx.specs import BackendSpec, LutBank
        from repro_torch.approx.workload import classification
        from repro_torch.models import resnet, weights

        self.spec, self.device = spec, device
        self.names, self.luts = tables.load(root, spec["lanes"])
        self.ckpt = root / "perfbench" / config["weights"]
        model = weights.load_resnet8(self.ckpt).to(device)
        cfg = model.cfg
        self.bank = LutBank(names=tuple(self.names), luts=self.luts)
        b, nb, sets = spec["batch"], spec["eval_batches"], spec["pool_sets"]
        side, ch = config["image_size"], config["channels"]
        images, labels = cifar_like(sets * nb * b, spec["pool_seed"],
                                    device, side, config["n_classes"])
        self.images = images.view(sets, nb, b, side, side, ch)
        self.labels = labels.view(sets, nb, b)
        self.order = np.random.default_rng(seed).permutation(sets)
        # the classification workload's tensor core (``DeviceForms``) over
        # each eval set, with the golden 8-bit logits its fidelity term
        # reads, computed as ``classification(fidelity=True)`` does
        golden = ApproxPolicy(default=BackendSpec.golden().materialize())
        make = classification(cfg, model, eval_n=b, batch=b,
                              device=device).traceable_metrics._make
        self.forms = []
        for k in range(sets):
            with torch.inference_mode():
                gold = [resnet.forward(model, x, cfg, golden)
                        for x in self.images[k]]
            self.forms.append(make((model, self.images[k], self.labels[k],
                                    gold), device))
        n = len(self.names)
        self.units = {"lane_images": n * nb * b}
        projs = counts.resnet_projections(nb * b, side, config["widths"],
                                          config["n_classes"])
        self.work = counts.pass_work(projs, n, shared_input=projs[0].name)
        self._eval = bank_eval
        self._ref_params = None

    def set_of(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def run_pass(self, i: int, traced: bool = False) -> dict:
        form = self.forms[self.set_of(i)]
        wrap, scope = pass_scope(traced)
        with scope:
            return self._eval(lambda p: form(wrap(p)), self.bank,
                              mode=self.spec["mode"],
                              variant=self.spec["variant"])

    def warmup(self):
        self.run_pass(0)

    def free_program(self):
        self.forms = None
        self.bank = None

    def reference(self, i: int, lower: bool = False) -> dict:
        """The reference's accuracy and logit MAE of pass ``i``, every
        lane; ``lower``: the control, its float32 parts in bfloat16."""
        if self._ref_params is None:
            self._ref_params = ref.load_checkpoint(self.ckpt, self.device)
        k = self.set_of(i)
        lane_tables = torch.from_numpy(self.luts).to(self.device)
        with torch.inference_mode():
            return ref.sweep_metrics(
                self._ref_params, self.images[k], self.labels[k],
                lane_tables, torch.bfloat16 if lower else torch.float32)

    def numbers_of(self, got: dict, i: int) -> dict:
        """``acc_gap``: the widest gap between a lane's accuracy in ``got``
        (pass ``i``'s outputs) and the reference's; ``mae_gap``: the
        widest gap between a lane's logit MAE and the reference's, as a
        share of the larger of that lane's and the median lane's MAE."""
        want = self.reference(i)
        acc = (got["accuracy"].to(torch.float32) - want["accuracy"]).abs()
        mae = want["logit_mae"]
        scale = torch.clamp_min(mae, torch.median(mae))
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        rel = (got["logit_mae"].to(torch.float32) - mae).abs() / scale
        return {name: float(v) if torch.isfinite(v) else float("inf")
                for name, v in (("acc_gap", acc.amax()),
                                ("mae_gap", rel.amax()))}

    def control(self, i: int) -> dict:
        """The compared numbers of the control put in the program's
        place on pass ``i``."""
        return self.numbers_of(self.reference(i, lower=True), i)


def build(spec, config, seed, device, root):
    return ResNetBank(spec, config, seed, device, root)

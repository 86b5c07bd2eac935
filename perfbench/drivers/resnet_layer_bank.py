"""Per-layer resilience sweeps of a CIFAR ResNet: the paper's Fig. 4
analysis.  One pass is what ``approx.resilience.per_layer_sweep(...,
batch=True)`` runs: for each approximated convolution in turn, one
``bank_eval(..., layer_pattern=<layer>)`` over the classification
workload's ``traceable_metrics``, that layer banked (every candidate a
lane) and every other on the exact 8-bit datapath (golden int8), which
returns each lane's accuracy and logit MAE.

Parameters (the workload file) are ``resnet_bank``'s (``lanes``,
``batch``, ``eval_batches``, ``pool_sets``, ``pool_seed``, ``mode``,
``variant``, ``check_passes``, ``trace_passes``, ``limits``) and
``layers``, the banked layers in the order a pass sweeps them.
"""
from __future__ import annotations

from pathlib import Path

import torch

from perfbench import counts, layer_counts
from perfbench.harness import import_file
from perfbench.reference import resnet as ref
from perfbench.reference.resnet_layers import layer_sweep_metrics
from perfbench.spans import pass_scope

resnet_bank = import_file(Path(__file__).resolve().with_name(
    "resnet_bank.py"))


class ResNetLayerBank(resnet_bank.ResNetBank):
    def __init__(self, spec, config, seed, device, root):
        super().__init__(spec, config, seed, device, root)
        self.layers = list(spec["layers"])
        n, nb, b = len(self.names), spec["eval_batches"], spec["batch"]
        self.units = {"lane_images": n * nb * b * len(self.layers)}
        projs = {p.name: p for p in counts.resnet_projections(
            nb * b, config["image_size"], config["widths"],
            config["n_classes"])}
        self.work = layer_counts.one_layer_at_a_time(
            [projs[name] for name in self.layers], n)

    def run_pass(self, i: int, traced: bool = False) -> dict:
        """Each lane's accuracy and logit MAE, (layers, lanes) each."""
        form = self.forms[self.set_of(i)]
        wrap, scope = pass_scope(traced)
        with scope:
            outs = [self._eval(lambda p: form(wrap(p)), self.bank,
                               mode=self.spec["mode"],
                               variant=self.spec["variant"],
                               layer_pattern=layer)
                    for layer in self.layers]
        return {key: torch.stack([o[key] for o in outs])
                for key in ("accuracy", "logit_mae")}

    def reference(self, i: int, lower: bool = False) -> dict:
        """The reference's accuracy and logit MAE of pass ``i``, (layers,
        lanes) each; ``lower``: the control, its float32 parts in
        bfloat16."""
        if self._ref_params is None:
            self._ref_params = ref.load_checkpoint(self.ckpt, self.device)
        k = self.set_of(i)
        lane_tables = torch.from_numpy(self.luts).to(self.device)
        with torch.inference_mode():
            return layer_sweep_metrics(
                self._ref_params, self.images[k], self.labels[k],
                lane_tables, self.layers,
                torch.bfloat16 if lower else torch.float32)

    def numbers_of(self, got: dict, i: int) -> dict:
        """``acc_gap``: the widest gap between a (layer, lane) accuracy in
        ``got`` and the reference's; ``mae_gap``: the widest gap between
        a (layer, lane) logit MAE and the reference's, as a share of the
        larger of that MAE and the median lane's MAE in its layer."""
        want = self.reference(i)
        acc = (got["accuracy"].to(torch.float32) - want["accuracy"]).abs()
        mae = want["logit_mae"]
        scale = torch.clamp_min(
            mae, torch.median(mae, dim=-1, keepdim=True).values)
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        rel = (got["logit_mae"].to(torch.float32) - mae).abs() / scale
        return {name: float(v) if torch.isfinite(v) else float("inf")
                for name, v in (("acc_gap", acc.amax()),
                                ("mae_gap", rel.amax()))}


def build(spec, config, seed, device, root):
    return ResNetLayerBank(spec, config, seed, device, root)

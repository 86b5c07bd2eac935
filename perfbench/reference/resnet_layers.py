"""The paper's Fig. 4 analysis on the plain CIFAR ResNet
(``resnet.forward``): one approximated layer at a time, every other
layer on the exact 8-bit datapath."""
from __future__ import annotations

import torch

from .resnet import forward


def layer_sweep_metrics(params, images, labels, lane_tables, layers,
                        work_dtype=torch.float32) -> dict:
    """``{"accuracy": (L, n), "logit_mae": (L, n)}`` of the eval set
    ``images`` (batches, B, H, W, 3) with ``labels`` (batches, B): row
    ``j`` runs ``lane_tables[i]`` in layer ``layers[j]`` alone, as
    ``resnet.sweep_metrics`` reads each lane (accuracy, logit MAE
    against the exact 8-bit logits, means of the per-batch means)."""
    golden = [forward(params, x, lambda name: None, work_dtype)
              for x in images]
    accs, maes = [], []
    for layer in layers:
        for table in lane_tables:
            def tables(name, table=table, layer=layer):
                return table if name == layer else None
            acc, mae = [], []
            for x, y, g in zip(images, labels, golden):
                logits = forward(params, x, tables, work_dtype)
                acc.append(torch.mean((torch.argmax(logits, dim=-1) == y)
                                      .to(torch.float32)))
                mae.append(torch.mean(torch.abs(logits - g)))
            accs.append(torch.mean(torch.stack(acc)))
            maes.append(torch.mean(torch.stack(mae)))
    shape = (len(layers), len(lane_tables))
    return {"accuracy": torch.stack(accs).view(shape),
            "logit_mae": torch.stack(maes).view(shape)}

"""CIFAR ResNet (He et al. 2016, 6n+2 layers, widths 16/32/64) in plain
PyTorch, every convolution and the head through the emulated datapath.

NHWC activations, HWIO kernels.  A convolution is im2col with SAME
padding (the extra row and column go high) and patch features ordered
(cin, kh, kw), then ``datapath.approx_matmul`` over all of the batch's
patch rows.  BN uses the batch's own statistics (population variance,
eps 1e-5), as the paper's Table II evaluation does; the head takes the
spatial mean.  One multiplier table a call: lane by lane.

``sweep_metrics`` is what a Table II sweep reads of each lane, as the
classification workload computes it: top-1 accuracy, the mean of the
per-batch accuracies, and the logit MAE against the exact 8-bit
datapath's logits, the mean of the per-batch mean |logits - golden|.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .datapath import approx_matmul

EPS = 1e-5


def load_checkpoint(path, device) -> dict:
    """The checkpoint's parameters, ``{"conv_init.w": tensor, ...}``:
    leaves ``0/<layer>/<name>`` of its manifest, read from its npz
    shards."""
    path = Path(path)
    leaves = json.loads((path / "manifest.json").read_text())["leaves"]
    arrays = {}
    for shard in sorted(path.glob("shard-*.npz")):
        with np.load(shard) as z:
            arrays.update({k: z[k] for k in z.files})
    return {".".join(key.split("/")[1:]):
            torch.from_numpy(np.asarray(arrays[key], np.float32)).to(device)
            for key in leaves if key.startswith("0/")}


def _same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride, table, work_dtype):
    b, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    pt, pb = _same_pads(h, kh, stride)
    pl, pr = _same_pads(wd, kw, stride)
    x = F.pad(x, (0, 0, pl, pr, pt, pb))
    ho, wo = -(-h // stride), -(-wd // stride)
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)  # b,ho,wo,cin,kh,kw
    patches = win.reshape(b * ho * wo, cin * kh * kw)
    w2d = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    y = approx_matmul(patches, w2d, table, work_dtype)
    return y.reshape(b, ho, wo, cout)


def bn(x, g, bias, work_dtype):
    mu = torch.mean(x, dim=(0, 1, 2), keepdim=True)
    var = torch.var(x, dim=(0, 1, 2), keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + EPS) * g + bias
    return y.to(work_dtype).to(torch.float32)


def layer_names(depth: int = 8) -> list[str]:
    """The approximated layers in the order a forward pass meets them."""
    n = (depth - 2) // 6
    names = ["conv_init"]
    for s in range(3):
        for b in range(n):
            names += [f"s{s}_b{b}_conv1", f"s{s}_b{b}_conv2"]
            if s > 0 and b == 0:
                names.append(f"s{s}_b{b}_proj")
    return names + ["head"]


def forward(params: dict, images, tables, work_dtype=torch.float32,
            depth: int = 8):
    """Logits (B, classes) of ``images`` (B, H, W, 3).  ``tables(name)``
    gives the product table of approximated layer ``name`` (None: the
    exact datapath)."""
    p = params
    x = conv(images, p["conv_init.w"], 1, tables("conv_init"), work_dtype)
    x = torch.relu(bn(x, p["conv_init.bn_g"], p["conv_init.bn_b"],
                      work_dtype))
    n = (depth - 2) // 6
    for s in range(3):
        for b in range(n):
            name = f"s{s}_b{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            y = conv(x, p[f"{name}.conv1.w"], stride,
                     tables(f"{name}_conv1"), work_dtype)
            y = torch.relu(bn(y, p[f"{name}.conv1.bn_g"],
                              p[f"{name}.conv1.bn_b"], work_dtype))
            y = conv(y, p[f"{name}.conv2.w"], 1, tables(f"{name}_conv2"),
                     work_dtype)
            y = bn(y, p[f"{name}.conv2.bn_g"], p[f"{name}.conv2.bn_b"],
                   work_dtype)
            sc = (conv(x, p[f"{name}.proj.w"], stride,
                       tables(f"{name}_proj"), work_dtype)
                  if f"{name}.proj.w" in p else x)
            x = torch.relu(y + sc)
    pooled = torch.mean(x, dim=(1, 2))
    logits = approx_matmul(pooled, p["head.w"], tables("head"), work_dtype)
    return logits + p["head.b"]


def sweep_metrics(params, images, labels, lane_tables,
                  work_dtype=torch.float32) -> dict:
    """``{"accuracy": (n,), "logit_mae": (n,)}`` of the eval set
    ``images`` (batches, B, H, W, 3) with ``labels`` (batches, B), lane
    ``i`` running ``lane_tables[i]`` in every approximated layer; BN
    statistics are each batch's own."""
    golden = [forward(params, x, lambda name: None, work_dtype)
              for x in images]
    accs, maes = [], []
    for table in lane_tables:
        acc, mae = [], []
        for x, y, g in zip(images, labels, golden):
            logits = forward(params, x, lambda name: table, work_dtype)
            acc.append(torch.mean((torch.argmax(logits, dim=-1) == y)
                                  .to(torch.float32)))
            mae.append(torch.mean(torch.abs(logits - g)))
        accs.append(torch.mean(torch.stack(acc)))
        maes.append(torch.mean(torch.stack(mae)))
    return {"accuracy": torch.stack(accs), "logit_mae": torch.stack(maes)}

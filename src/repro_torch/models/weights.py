"""Weights carried across from the reference.

``params_from_numpy`` turns the reference's nested ResNet param dict
(numpy arrays, HWIO conv kernels) into the port's ``ResNet`` module —
the one conversion the tests use to make both packages compute the
same network; ``lm_params_from_numpy`` does the same for the
reference's LM parameter tree.  ``load_resnet8_checkpoint`` reads the committed trained
ResNet-8 checkpoint (``benchmarks/results/resnet8_ckpt_v2``, written by
the reference's ``CheckpointManager``) with numpy alone, read-only.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from .resnet import ResNet, ResNetConfig

#: The trained ResNet-8 the resilience benchmarks evaluate (320 steps
#: on synthetic CIFAR, data version 2).
RESNET8_CKPT = (Path(__file__).resolve().parents[3] / "benchmarks"
                / "results" / "resnet8_ckpt_v2" / "step-000000320")


def _config_of(tree: dict) -> ResNetConfig:
    n_blocks = sum(1 for k in tree if k.startswith("s0_b"))
    widths = tuple(int(tree[f"s{s}_b0"]["conv1"]["w"].shape[-1])
                   for s in range(3))
    return ResNetConfig(n_blocks=n_blocks, widths=widths,
                        n_classes=int(tree["head"]["b"].shape[0]))


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def params_from_numpy(tree: dict, cfg: Optional[ResNetConfig] = None
                      ) -> ResNet:
    """The reference's ResNet param tree -> a ``ResNet`` on the CPU
    (move it with ``.to(device)``).  Raises on a missing, extra or
    mis-shaped parameter."""
    cfg = cfg or _config_of(tree)
    model = ResNet(cfg)
    state = {}
    for key, arr in _flatten(tree).items():
        if key.startswith("s"):              # s{s}_b{b}.conv1.w -> blocks.
            key = "blocks." + key
        state[key] = torch.from_numpy(np.array(arr, dtype=np.float32))
    model.load_state_dict(state, strict=True)
    return model


def lm_params_from_numpy(tree, device="cpu"):
    """The reference's LM parameter tree — nested dicts of numpy arrays,
    as ``jax.tree.map(np.asarray, params)`` gives them — as the same
    nested dicts of tensors on ``device``: same keys, same stacked
    layer-group axis, same dtypes (f32 parameters stay f32)."""
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


def load_resnet8_checkpoint(path: Union[str, Path] = RESNET8_CKPT) -> dict:
    """The committed checkpoint's params as the reference's nested dict
    of numpy arrays.  Leaves are stored as ``0/<layer>/<name>``: ``0``
    is the params half of the ``(params, params)`` state the trainer
    saved."""
    path = Path(path)
    with open(path / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    arrays: dict[str, np.ndarray] = {}
    for shard in sorted(path.glob("shard-*.npz")):
        with np.load(shard) as z:
            arrays.update({k: z[k] for k in z.files})
    tree: dict = {}
    for key in leaves:
        head, *rest = key.split("/")
        if head != "0":
            continue
        node = tree
        for part in rest[:-1]:
            node = node.setdefault(part, {})
        node[rest[-1]] = arrays[key]
    return tree


def load_resnet8(path: Union[str, Path] = RESNET8_CKPT) -> ResNet:
    """The trained ResNet-8 as a ``ResNet`` module (on the CPU)."""
    return params_from_numpy(load_resnet8_checkpoint(path))

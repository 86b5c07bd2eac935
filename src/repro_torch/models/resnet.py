"""CIFAR-style ResNet family (paper Sec. IV, Fig. 3), port of
``repro.models.resnet``: 3 stages of n residual blocks with widths
16/32/64 — depth = 6n+2 (ResNet-8 ... 50).

Every convolution runs through ``repro_torch.approx.layers.conv2d``
(im2col + backend matmul), so any conv layer can be switched to any
approximate multiplier.  Normalization is batch-statistics BN (no
running stats).  Weights keep the reference's layout — conv kernels
HWIO, activations NHWC — so parameters move between the packages as
they are (``repro_torch.models.weights``).

Activations may carry a leading bank lane axis (``approx.layers.
bank_eval``); every op here accepts it, and float reductions run lane
by lane (``approx.layers.per_lane``) so a banked lane equals the
sequential evaluation bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from .. import obs
from ..approx.layers import ApproxPolicy, EXACT_POLICY, conv2d, per_lane
from ..approx.workload import layer_mult_counts as _unified_mult_counts


@dataclass(frozen=True)
class ResNetConfig:
    n_blocks: int = 1                   # blocks per stage; depth = 6n+2
    widths: tuple = (16, 32, 64)
    n_classes: int = 10
    image_size: int = 32
    norm_eps: float = 1e-5

    @property
    def depth(self) -> int:
        return 6 * self.n_blocks + 2

    @property
    def name(self) -> str:
        return f"resnet{self.depth}"


def resnet_config(depth: int) -> ResNetConfig:
    if (depth - 2) % 6 != 0:
        raise ValueError("CIFAR ResNet depth must be 6n+2")
    return ResNetConfig(n_blocks=(depth - 2) // 6)


class _ConvBN(nn.Module):
    """A conv kernel (HWIO) with optional BN affine parameters."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int, bn: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        std = math.sqrt(2.0 / (kh * kw * cin))
        self.w = nn.Parameter(torch.randn(kh, kw, cin, cout,
                                          generator=generator) * std)
        if bn:
            self.bn_g = nn.Parameter(torch.ones(cout))
            self.bn_b = nn.Parameter(torch.zeros(cout))


class _Head(nn.Module):
    def __init__(self, cin: int, n_classes: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.w = nn.Parameter(torch.randn(cin, n_classes,
                                          generator=generator)
                              / math.sqrt(cin))
        self.b = nn.Parameter(torch.zeros(n_classes))


class ResNet(nn.Module):
    """Parameters of a CIFAR ResNet, named like the reference's param
    tree (``conv_init``, ``s{s}_b{b}.conv1`` / ``conv2`` / ``proj``,
    ``head``).  ``forward(images, policy)`` runs ``forward`` below.
    Random initialization draws from ``generator`` (He-normal convs);
    trained weights come from ``repro_torch.models.weights``."""

    def __init__(self, cfg: ResNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.conv_init = _ConvBN(3, 3, 3, cfg.widths[0], True, generator)
        self.blocks = nn.ModuleDict()
        cin = cfg.widths[0]
        for s, width in enumerate(cfg.widths):
            for b in range(cfg.n_blocks):
                blk = nn.Module()
                blk.conv1 = _ConvBN(3, 3, cin, width, True, generator)
                blk.conv2 = _ConvBN(3, 3, width, width, True, generator)
                if cin != width:
                    blk.proj = _ConvBN(1, 1, cin, width, False, generator)
                self.blocks[f"s{s}_b{b}"] = blk
                cin = width
        self.head = _Head(cfg.widths[-1], cfg.n_classes, generator)

    def forward(self, images: torch.Tensor,
                policy: ApproxPolicy = EXACT_POLICY) -> torch.Tensor:
        return forward(self, images, policy=policy)

    def param_tree(self) -> dict:
        """The parameters as the reference's nested param dict
        (``conv_init``, ``s{s}_b{b}``, ``head``; the tensors are this
        module's own), the tree the trainer and the checkpoints walk."""
        tree: dict = {}
        for name, p in self.named_parameters():
            *parents, last = name.removeprefix("blocks.").split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = p
        return tree


def _bn(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    """Batch-statistics BN over (B, H, W), per lane; population
    variance (``correction=0``) as ``jnp.var``."""
    lanes = x.ndim == 5
    with obs.span("model.bn"):
        mu = per_lane(lambda t: torch.mean(t, dim=(0, 1, 2), keepdim=True),
                      x, lanes)
        var = per_lane(lambda t: torch.var(t, dim=(0, 1, 2), keepdim=True,
                                           correction=0), x, lanes)
        return (x - mu) * torch.rsqrt(var + eps) * g + b


def forward(model: ResNet, images: torch.Tensor,
            cfg: Optional[ResNetConfig] = None,
            policy: ApproxPolicy = EXACT_POLICY) -> torch.Tensor:
    """images: (B,H,W,3) f32 -> logits (B, n_classes); (n, B, n_classes)
    when the policy banks a layer."""
    cfg = cfg or model.cfg
    p = model.conv_init
    x = conv2d(policy, "conv_init", images, p.w)
    x = torch.relu(_bn(x, p.bn_g, p.bn_b, cfg.norm_eps))
    for s, width in enumerate(cfg.widths):
        for b in range(cfg.n_blocks):
            name = f"s{s}_b{b}"
            blk = model.blocks[name]
            stride = 2 if (s > 0 and b == 0) else 1
            y = conv2d(policy, f"{name}_conv1", x, blk.conv1.w,
                       stride=stride)
            y = torch.relu(_bn(y, blk.conv1.bn_g, blk.conv1.bn_b,
                               cfg.norm_eps))
            y = conv2d(policy, f"{name}_conv2", y, blk.conv2.w)
            y = _bn(y, blk.conv2.bn_g, blk.conv2.bn_b, cfg.norm_eps)
            if hasattr(blk, "proj"):
                sc = conv2d(policy, f"{name}_proj", x, blk.proj.w,
                            stride=stride)
            else:
                sc = x
            x = torch.relu(y + sc)
    lanes = x.ndim == 5
    x = per_lane(lambda t: torch.mean(t, dim=(1, 2)), x, lanes)
    return (policy.matmul("head", x, model.head.w, lanes=lanes)
            + model.head.b)


def layer_mult_counts(cfg: ResNetConfig, batch: int = 1) -> dict[str, int]:
    """Per-conv-layer multiplication counts (the paper's Fig. 4
    shares); the unified ``approx.workload.layer_mult_counts`` also
    counts the ``head`` matmul."""
    counts = _unified_mult_counts(cfg, batch=batch)
    counts.pop("head", None)
    return counts


def loss_fn(model: ResNet, batch: dict, cfg: Optional[ResNetConfig] = None,
            policy: ApproxPolicy = EXACT_POLICY) -> torch.Tensor:
    logits = forward(model, batch["images"], cfg, policy)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None]))


def accuracy(model: ResNet, batch: dict, cfg: Optional[ResNetConfig] = None,
             policy: ApproxPolicy = EXACT_POLICY) -> torch.Tensor:
    """Top-1 accuracy; shape (n,) when the policy banks a layer."""
    logits = forward(model, batch["images"], cfg, policy)
    return torch.mean((torch.argmax(logits, dim=-1) == batch["labels"]
                       ).to(torch.float32), dim=-1)

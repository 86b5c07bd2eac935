"""Gradient compression (port of ``repro.train.compression``,
DESIGN.md §6): int8 symmetric uniform quantization with a per-leaf scale
and *error feedback* (the round-trip error is carried to the next step,
Karimireddy et al. 2019).

``compressed_psum`` is the reference's ``shard_map`` all-reduce of
int8-quantized gradients, over a ``torch.distributed`` process group
(the codes are summed as int32, as the reference's ``psum`` sums them).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .optimizer import _like, nest, tree_leaves


def quantize_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 codes, scale).  Symmetric uniform quantization."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Any, residual: Any
                           ) -> tuple[dict, dict]:
    """Quantize (grads + residual); return (dequantized grads, new
    residual), each a dict keyed like ``grads``.  Round-trip error is
    carried, not dropped."""
    res = dict(tree_leaves(residual))
    deqs, new_res = {}, {}
    for path, g in tree_leaves(grads):
        target = g.to(torch.float32) + res[path]
        q, s = quantize_leaf(target)
        deqs[path] = dequantize_leaf(q, s)
        new_res[path] = target - deqs[path]
    return nest(deqs), nest(new_res)


def init_residual(params: Any) -> dict:
    return _like(params, lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device))


def compressed_psum(tree: Any, group=None) -> dict:
    """All-reduce a gradient tree over ``group`` (a ``torch.distributed``
    process group; None: the default one) in int8 and return each leaf's
    mean over the participants, as a dict keyed like ``tree``: a common
    scale (the largest participant's, ``all_reduce(MAX)``), the int8 codes
    at that scale summed as int32 (``all_reduce(SUM)``), then ``total *
    s_max / n`` in f32 with n the group's size — the reference's order of
    operations."""
    n = float(dist.get_world_size(group))
    out = {}
    for path, g in tree_leaves(tree):
        g = g.to(torch.float32)
        _q, s = quantize_leaf(g)
        # common scale across participants so summed codes are coherent
        s_max = s.clone()
        dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(g / s_max), -127, 127).to(torch.int8)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        out[path] = total.to(torch.float32) * s_max / n
    return nest(out)

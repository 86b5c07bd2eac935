"""Gradient compression (port of ``repro.train.compression``,
DESIGN.md §6): int8 symmetric uniform quantization with a per-leaf scale
and *error feedback* (the round-trip error is carried to the next step,
Karimireddy et al. 2019).

``compressed_psum``, the reference's ``shard_map`` all-reduce in int8,
needs a device mesh and raises here.
"""
from __future__ import annotations

from typing import Any

import torch

from .optimizer import _like, nest, tree_leaves

#: The ROADMAP.md item that ports the mesh and its collectives.
MESH_ITEM = 'ROADMAP.md Queue 1, "Launch tooling and multi-device"'


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


def compressed_psum(tree: Any, axis_name: str) -> Any:
    """The reference all-reduces a gradient tree in int8 over a mesh
    axis inside ``shard_map``; one card has no mesh."""
    raise NotImplementedError(f"compressed_psum needs a device mesh, which "
                              f"is not ported yet ({MESH_ITEM})")

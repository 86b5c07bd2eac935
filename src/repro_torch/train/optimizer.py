"""AdamW + schedules + global-norm clipping (port of
``repro.train.optimizer``), written out in float32 in the reference's
operation order: clip, ``step + 1``, the bias corrections
``1 - b ** step``, then m, v, the update and the decay.

A parameter tree is a nested dict of tensors (the LM trees), an
``nn.Module`` (ResNet), or a tuple / list / NamedTuple of those.  Its
leaves are visited in the order ``jax.tree_util`` flattens the
reference's tree (dict keys sorted, NamedTuple fields in order), and
each leaf has the reference's path (``tree_leaves``): dict keys joined
by ``/``; a module's parameters as its ``param_tree()`` names them
(``models.resnet.ResNet``: the reference's param dict); a NamedTuple
field as ``.name``, as ``str`` of a ``GetAttrKey`` gives it.  ``_decayable`` reads the last component of a path.

The optimizer state's m and v mirror the parameter tree as nested dicts
keyed like it.  ``adamw_update`` updates the parameters and the state in
place under ``torch.no_grad()`` (the reference donates its buffers).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor          # () int32
    m: dict
    v: dict


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in the reference's flatten
    order, with the reference's paths (module docstring)."""
    if isinstance(tree, nn.Module):
        if not hasattr(tree, "param_tree"):
            raise TypeError(
                f"{type(tree).__name__} has no param_tree(): pass its "
                "parameters as a nested dict of tensors")
        tree = tree.param_tree()
    sep = "/" if prefix else ""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves(tree[k], f"{prefix}{sep}{k}")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in tree_leaves(getattr(tree, f),
                                      f"{prefix}{sep}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_leaves(v, f"{prefix}{sep}{i}")]
    if tree is None:
        return []
    raise TypeError(f"not a tree node: {type(tree).__name__}")


def nest(flat: dict) -> dict:
    """``{path: leaf}`` -> the nested dict those paths name."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = out
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _like(tree, fn) -> dict:
    """A nested dict with ``tree``'s leaf paths, each ``fn(leaf)``."""
    return nest({path: fn(leaf) for path, leaf in tree_leaves(tree)})


def init_opt_state(params) -> OptState:
    """Zero f32 m and v beside every parameter, step 0, on the
    parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0][1].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=_like(params, zeros), v=_like(params, zeros))


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio (f32, as the
    reference computes it)."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=s.device)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
        * (1 + torch.cos(pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (f32), the per-leaf
    sums added in the reference's leaf order."""
    total = 0
    for _, leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(clipped grads as a dict keyed like ``grads``, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return _like(grads, lambda g: g * scale), norm


_DECAY_EXEMPT = ("norm", "bn_g", "bn_b", "bias", "b", "dt_bias", "a_log",
                 "d_skip", "qn", "kvn", "qnorm", "knorm")


def _decayable(path: str) -> bool:
    last = path.split("/")[-1]
    return not any(last.startswith(e) or last == e for e in _DECAY_EXEMPT)


def adamw_update(params, grads, state: OptState, cfg: OptimizerConfig):
    """One AdamW step.  ``grads``: a tree with the parameters' paths
    (dict keyed like them, or the leaves' ``.grad``).  Updates the
    parameters and ``state`` in place; returns (params, state,
    metrics)."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        state.step.add_(1)
        b1, b2 = cfg.betas
        lr = lr_at(cfg, state.step)
        s = state.step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=s.device), s)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=s.device), s)
        g_of = dict(tree_leaves(grads))
        m_of = dict(tree_leaves(state.m))
        v_of = dict(tree_leaves(state.v))
        for path, p in tree_leaves(params):
            g = g_of[path].to(torch.float32)
            m, v = m_of[path], v_of[path]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            wd = cfg.weight_decay if _decayable(path) else 0.0
            p32 = p.to(torch.float32)
            p.copy_((p32 - lr * (u + wd * p32)).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}

"""The four assigned input shapes (seq_len x global_batch) and the batch
specs of every (arch x shape) dry-run cell (port of
``repro.configs.shapes``).

``decode_*`` / ``long_*`` cells are one new token against a KV cache of
seq_len; ``prefill_32k`` is the prefill serve step; ``train_4k`` the
train step.  Where the reference builds ``jax.ShapeDtypeStruct``s,
``batch_specs`` gives ``(shape, torch dtype)`` pairs, or tensors on the
``meta`` device (shapes and dtypes, no memory) with ``meta=True``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.common import LMConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# long_500k needs sub-quadratic attention: run only for SSM/hybrid
# (DESIGN.md §5 — the 8 pure full-attention archs skip it).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: LMConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True


def batch_specs(cfg: LMConfig, shape: ShapeSpec, meta: bool = False
                ) -> dict:
    """The data batch of this (arch, shape) cell: ``{name: (shape,
    dtype)}``, or ``{name: meta tensor}`` with ``meta=True``."""
    b, s = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        if cfg.family == "vlm":
            s_tok = s - cfg.n_img_tokens
            out = {"tokens": ((b, s_tok), i32)}
            if train:
                out["targets"] = ((b, s_tok), i32)
            out["img_embeds"] = ((b, cfg.n_img_tokens, cfg.d_model), f32)
        elif cfg.family == "encdec":
            out = {"frames": ((b, cfg.enc_frames, cfg.d_model), f32),
                   "tokens": ((b, s), i32)}
            if train:
                out["targets"] = ((b, s), i32)
        else:
            out = {"tokens": ((b, s), i32)}
            if train:
                out["targets"] = ((b, s), i32)
    else:
        # decode: one token against a cache of seq_len
        out = {"token": ((b,), i32)}
    if meta:
        return {k: torch.empty(shp, dtype=dt, device="meta")
                for k, (shp, dt) in out.items()}
    return out

"""Architecture registry (port of ``repro.configs``):
``get_config(arch_id)`` for every architecture ID of the reference
(``ARCHS``), field for field.

Dry-run cells = ARCHS x SHAPES, minus the long_500k skips recorded in
``configs.shapes`` / DESIGN.md §5 (``all_cells``).
"""
from __future__ import annotations

import importlib

from ..models.common import LMConfig
from .shapes import SHAPES, ShapeSpec, batch_specs, shape_applicable

ARCHS = {
    "llava-next-34b": "llava_next_34b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mamba2-780m": "mamba2_780m",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "nemotron-4-15b": "nemotron_4_15b",
    "yi-34b": "yi_34b",
    "qwen3-14b": "qwen3_14b",
    "whisper-large-v3": "whisper_large_v3",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def get_config(arch: str) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list(ARCHS)}")
    mod = importlib.import_module(f"{__name__}.{ARCHS[arch]}")
    return mod.config()


# §Perf-winning production settings (EXPERIMENTS.md §Perf), the
# reference's: moe_blocks should equal the data-parallel shard count of
# the mesh.
TUNED_OVERRIDES = {
    "qwen3-moe-30b-a3b": {"moe_blocks": 16, "capacity_factor": 1.0},
    "deepseek-v2-236b": {"moe_blocks": 16, "attn_impl": "chunked"},
    "jamba-v0.1-52b": {"moe_blocks": 16},
    # dense 32k-prefill cells: chunked attention removes the S^2 HBM term
    "yi-34b": {"attn_impl": "chunked"},
    "llava-next-34b": {"attn_impl": "chunked"},
    "qwen3-14b": {"attn_impl": "chunked"},
    "nemotron-4-15b": {"attn_impl": "chunked"},
}


def all_cells():
    """(cells, skips): ``(arch, shape_name)`` for every applicable
    dry-run cell and ``(arch, shape_name, reason)`` for each skip."""
    cells, skips = [], []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, spec in SHAPES.items():
            if shape_applicable(cfg, spec):
                cells.append((arch, sname))
            else:
                skips.append((arch, sname,
                              "full-attention arch skips long_500k "
                              "(needs sub-quadratic attention)"))
    return cells, skips

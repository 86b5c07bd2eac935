"""Architecture registry (port of ``repro.configs``):
``get_config(arch_id)`` for every architecture ID of the reference
(``ARCHS``), field for field.

The reference's dry-run shapes (``configs/shapes.py``, ``all_cells``)
and its ``TUNED_OVERRIDES`` wait for ROADMAP.md Queue 1, "Launch tooling
and multi-device".
"""
from __future__ import annotations

import importlib

from ..models.common import LMConfig

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

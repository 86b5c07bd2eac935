"""Architecture registry (port of ``repro.configs``):
``get_config(arch_id)`` for the architectures the port serves.

``ARCHS`` lists every architecture ID of the reference; the port has
the dense, MoE, SSM and hybrid decoders, so the MLA, encoder-decoder
and VLM IDs raise ``NotImplementedError`` naming the ROADMAP.md item
that ports them.
"""
from __future__ import annotations

import importlib

from ..models.common import MLA_ITEM, LMConfig

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

#: Architectures whose config module the port has.
PORTED = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "mamba2-780m",
          "jamba-v0.1-52b", "qwen3-14b", "yi-34b", "nemotron-4-15b")


def get_config(arch: str) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {list(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet ({MLA_ITEM})")
    mod = importlib.import_module(f"{__name__}.{ARCHS[arch]}")
    return mod.config()

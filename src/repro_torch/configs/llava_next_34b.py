"""llava-next-34b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone = yi-34b dims (60L / 7168 / 56H kv8 / 20480 / 64000).  The
vision frontend is a stub: the prefill takes precomputed patch
embeddings at d_model (anyres tiling happens upstream of the backbone);
a learned projection fuses them into the sequence.
"""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
        act="silu",
        rope_theta=5_000_000.0,
        n_img_tokens=576,   # one anyres base tile of 24x24 patches
    )

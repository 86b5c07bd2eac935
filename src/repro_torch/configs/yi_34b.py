"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
        act="silu",
        rope_theta=5_000_000.0,
    )

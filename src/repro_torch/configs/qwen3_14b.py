"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=17408,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        act="silu",
        rope_theta=1_000_000.0,
    )

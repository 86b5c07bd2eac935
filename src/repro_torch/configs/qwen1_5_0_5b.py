"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        head_dim=64,
        qkv_bias=True,
        act="silu",
    )

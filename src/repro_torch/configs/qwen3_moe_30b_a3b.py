"""qwen3-moe-30b-a3b [moe] — 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf].  d_ff=768 is the per-expert hidden dim;
qwen3 family uses per-head qk RMSNorm."""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_ff=768,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        act="silu",
        n_experts=128,
        top_k=8,
        moe_d_ff=768,
        rope_theta=1_000_000.0,
    )

"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

32 layers in 4 groups of 8: attention at slot 4 of each group, Mamba
elsewhere; MoE FFN on odd slots (every other layer), dense FFN on even.
Jamba's SSM uses d_state=16.
"""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=65536,
        head_dim=128,
        act="silu",
        n_experts=16,
        top_k=2,
        moe_d_ff=14336,
        attn_period=8,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
    )

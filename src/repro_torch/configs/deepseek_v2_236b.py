"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed
top-6 [arXiv:2405.04434; hf].

d_ff=1536 is the per-expert (and per-shared-expert) hidden dim.  The
listed 128H/kv=128 maps to MLA with 128 query heads over a 512-dim
compressed KV latent + 64-dim shared rope key.
"""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=1536,
        vocab=102400,
        head_dim=128,           # qk nope dim
        act="silu",
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        use_mla=True,
        kv_lora=512,
        q_lora=1536,
        rope_head_dim=64,
        v_head_dim=128,
    )

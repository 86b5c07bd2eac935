"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed
top-6 [arXiv:2405.04434; hf].

d_ff=1536 is the per-expert (and per-shared-expert) hidden dim.  The
listed 128H/kv=128 maps to MLA with 128 query heads over a 512-dim
compressed KV latent + 64-dim shared rope key.

These are the reference's values, kept so that the parity tests against
it hold.  Against the published config (hf:deepseek-ai/DeepSeek-V2) this
entry still lacks: the leading dense layer (``first_k_dense_replace`` 1,
``intermediate_size`` 12 288), group-limited routing (``n_group`` 8,
``topk_group`` 3), ``norm_topk_prob`` false with
``routed_scaling_factor`` 16, and YaRN RoPE (factor 40).  The port's
``LMConfig`` fields for them (``first_dense``, ``n_group``,
``topk_group``, ``norm_topk_prob``, ``routed_scaling``,
``rope_scaling``, and one chip's share of the experts) are set by the
benchmark's configuration, ``perfbench/configs/deepseek-v2-236b.json``.
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

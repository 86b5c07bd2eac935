"""mamba2-780m [ssm] — SSD (state-space duality)
[arXiv:2405.21060; unverified].  Attention-free: 48 SSD blocks,
d_model=1536, ssm_state=128, expand 2, head_dim 64 (d_ff=0)."""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=1,            # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,
        vocab=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        conv_width=4,
    )

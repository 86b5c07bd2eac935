"""whisper-large-v3 [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

The mel/conv frontend is a stub: the prefill takes precomputed frame
embeddings (B, 1500, d_model).  Backbone: 32-layer encoder + 32-layer
decoder with cross-attention, sinusoidal absolute positions (no RoPE),
GELU FFN.
"""
from ..models.common import LMConfig


def config() -> LMConfig:
    return LMConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,           # decoder layers
        n_enc_layers=32,
        enc_frames=1500,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        head_dim=64,
        act="gelu",
        use_rope=False,
    )

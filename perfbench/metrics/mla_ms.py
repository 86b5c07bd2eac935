"""Stream ms a pass in latent attention's exact part (``model.mla``:
``models/mla.mla_attention`` less its projections' ``datapath`` spans:
the norms, RoPE and the attention core lane by lane), self time.
Nothing where the program records no such span."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "model.mla") or None

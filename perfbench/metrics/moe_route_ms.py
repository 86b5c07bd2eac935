"""Stream ms a pass in the MoE's routing, dispatch and combine, lane by
lane (``model.moe.route``, ``.dispatch``, ``.combine``), self time."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "model.moe.route", "model.moe.dispatch",
                   "model.moe.combine")

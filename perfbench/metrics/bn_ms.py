"""Stream ms a pass in BN's batch statistics and normalisation, lane by
lane (``model.bn``: ``models/resnet._bn``), self time."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "model.bn")

"""Stream ms a pass in the exact model parts outside every other span:
``bank_eval``'s self time (im2col, pooling, norms, attention, the
unembedding, the workload's metrics, and the idle between them)."""
from perfbench.recording import self_ms


def read(ctx):
    return self_ms(ctx, "bank_eval")

"""Device kernels a pass, as the profiler counts them (memsets and
copies left out): exact, and it moves with fusion and graphs."""
from perfbench.trace import is_memory_op


def read(ctx):
    t = ctx.trace
    n = sum(1 for k in t.kernels if not is_memory_op(k.name))
    return n / t.passes if n else None

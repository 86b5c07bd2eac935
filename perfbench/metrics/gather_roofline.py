"""The gather kernels' share of their roofline: the least time the
traced passes' table lookups need (``peaks.gather_floor_s``: lookups at
the lookup peak, or the integer ops or bytes if those take longer) over
the device time of the kernels that run the shared gather body of K1-K8
(``csrc/fused_gather.cuh``).  Nothing when no such kernel ran."""
from perfbench.peaks import gather_floor_s

#: the kernels of the shared gather body, by the names the profiler gives
GATHER_KERNELS = ("quant8_kernel", "fused_kernel")


def read(ctx):
    t = ctx.trace
    busy = sum(k.seconds for k in t.kernels
               if any(g in k.name for g in GATHER_KERNELS))
    if busy <= 0 or not ctx.work["lookups"]:
        return None
    floor = t.passes * gather_floor_s(ctx.work["lookups"], ctx.work["bytes"])
    return 100.0 * floor / busy

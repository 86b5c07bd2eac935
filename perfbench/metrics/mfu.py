"""The whole pass's share of the chip's lookup peak: the traced passes'
table lookups at the peak rate over the traced window's wall.  It bounds
every kernel's share, and it still reads when a change removes or
renames a kernel."""
from perfbench.peaks import LOOKUPS_PER_S


def read(ctx):
    t = ctx.trace
    if not t.kernels or not ctx.work["lookups"] or t.window_s <= 0:
        return None      # no device work seen (a run on the CPU)
    return 100.0 * t.passes * ctx.work["lookups"] / (LOOKUPS_PER_S
                                                     * t.window_s)

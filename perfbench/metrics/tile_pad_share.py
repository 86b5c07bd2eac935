"""Percent of the table lookups the K3/K4 tiles gather over the traced
passes that lie on padded rows or columns: the program's counters
``gather.pad_lookups`` over ``gather.lookups``, counted from each call's
tile plan.  Nothing where the program counts neither."""
from perfbench.recording import counter


def read(ctx):
    looked = counter(ctx, "gather.lookups")
    pad = counter(ctx, "gather.pad_lookups")
    if not looked or pad is None:
        return None
    return 100.0 * pad / looked

"""Percent of the routed experts' capacity rows that carry a token: the
program's counters ``moe.held_slots`` (routed slots kept on the experts
this chip holds) over ``moe.capacity_rows`` (held experts x capacity, a
lane and layer), counted in ``models/moe.dispatch``.  The rest of K4's
expert-form rows gather zeros.  Nothing where the program counts
neither."""
from perfbench.recording import counter


def read(ctx):
    rows = counter(ctx, "moe.capacity_rows")
    held = counter(ctx, "moe.held_slots")
    if not rows or held is None:
        return None
    return 100.0 * held / rows

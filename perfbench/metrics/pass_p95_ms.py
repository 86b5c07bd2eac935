"""The 95th percentile of a pass's wall (ms): the wait for one sweep's
answers, on the host's clock from the end of the pass before to the
synchronise that ends this one, over every pass of the window."""
import statistics


def read(ctx):
    walls = ctx.pass_s
    if len(walls) < 2:
        return 1000.0 * walls[0] if walls else None
    return 1000.0 * statistics.quantiles(walls, n=20)[-1]

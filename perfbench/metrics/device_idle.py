"""The device's idle share of the traced window: 1 - busy / wall."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

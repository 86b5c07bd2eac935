"""Set-up: from the start of the process to the first timed pass
(imports, the device, weights and inputs, the kernels loaded or built,
and one warm-up pass of each shape the traffic uses)."""


def read(ctx):
    return ctx.setup_s

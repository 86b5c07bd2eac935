"""Images evaluated a second, counted once for each bank lane (each
candidate multiplier): all the window's passes over its whole wall."""


def read(ctx):
    done = ctx.units.get("lane_images")
    return done / ctx.window_s if done else None

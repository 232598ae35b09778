"""device.idle: 1 − (union of the device's activity intervals) / (the
traced stretch's host-clock length)."""


def read(ctx):
    if ctx.trace["window_s"] <= 0 or ctx.trace["busy_s"] <= 0:
        return None
    return 1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"]

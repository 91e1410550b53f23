"""device_idle_share: the share of the traced window in which no
operation ran on the device, in percent: 1 - (union of device activity /
window)."""


def read(ctx):
    if ctx.span.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.span.busy_s / ctx.span.window_s)

"""The device's idle share of the traced window: 1 - (the union of its
kernel and copy intervals) / (the window on the host clock), in %."""


def read(ctx):
    if not ctx.device_events:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

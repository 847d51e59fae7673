"""Device operations (kernels, copies, fills) the profiler saw per
committed epoch of the traced window."""


def read(ctx):
    if not ctx.device_events:
        return None
    return len(ctx.device_events) / ctx.epochs

"""Device ms per epoch of hand-written kernels that the frozen table of
yardstick/kernels does not name (a kernel added, moved or renamed by a
later change to the program); 0 while every kernel that runs is listed.
The same time is charged to the cell's roofline, never to the glue."""
from ..yardstick import kernels


def read(ctx):
    if not ctx.device_events:
        return None
    return kernels.device_us(ctx.device_events, kernels.unlisted()) / 1e3 / ctx.epochs

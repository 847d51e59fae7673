"""Device ms per epoch of every kernel and copy that is no hand-written
kernel of the program (yardstick/kernels: the frozen table's and any
unlisted one): the sim tier's and the op wrappers' tensor operations,
gathers, selects, copies."""
from ..yardstick import kernels


def read(ctx):
    if not ctx.device_events:
        return None
    own = kernels.listed() + kernels.unlisted()
    glue_us = sum(e.end - e.start for e in ctx.device_events
                  if not kernels.matches(e.name, own))
    return glue_us / 1e3 / ctx.epochs

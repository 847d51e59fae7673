"""Kernel B1's share of its roofline on the RS epoch, in %: the bound of
the epoch's encode [p x k] and reconstruct [k x k] over B * N * L columns
(yardstick/work_rs, at the published peaks) over the device ms per epoch
of B1's launches (the frozen table's B1 kernels) and of any unlisted
hand-written kernel, so that B1's work moved to a new kernel still
counts."""
from ..yardstick import kernels, work_rs


def read(ctx):
    us = kernels.device_us(ctx.device_events, kernels.listed("B1") + kernels.unlisted())
    if not us:
        return None
    return 100.0 * work_rs.epoch(ctx.config, ctx.traffic)["bound_ms"] / (us / 1e3 / ctx.epochs)

"""Kernels B2, B3 and B4 together, their share of the roofline of the
verified threshold-decrypt epoch, in %: the bound of the work model
(yardstick/work_verify: the decrypt, every share and ciphertext check as
two Miller loops and a final exponentiation, W's G2 ladder, the affine
conversions and the forged shares, at the published peaks) over the
device ms per epoch of every launch of the frozen table's B2, B3 and B4
kernels and of any unlisted hand-written kernel, so work moved between
kernels, or into a new one, reads the same."""
from ..yardstick import kernels, work_verify


def read(ctx):
    if "faulty" not in ctx.config:
        return None
    us = kernels.device_us(ctx.device_events,
                           kernels.listed("B2", "B3", "B4") + kernels.unlisted())
    if not us:
        return None
    return 100.0 * work_verify.epoch(ctx.config, ctx.traffic)["bound_ms"] / (us / 1e3 / ctx.epochs)

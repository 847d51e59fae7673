"""Kernels B2 and B3 together, their share of the roofline of the
threshold-decrypt epoch, in %: the bound of the work model
(yardstick/work_tpke: q + 1 scalar multiplications and one q-term
combine per ciphertext, at the published peaks) over the device ms per
epoch of every launch of the frozen table's B2 and B3 kernels and of any
unlisted hand-written kernel, so work moved between kernels, or into a
new one, reads the same."""
from ..yardstick import kernels, work_tpke


def read(ctx):
    us = kernels.device_us(ctx.device_events, kernels.listed("B2", "B3") + kernels.unlisted())
    if not us:
        return None
    return 100.0 * work_tpke.epoch(ctx.config, ctx.traffic)["bound_ms"] / (us / 1e3 / ctx.epochs)

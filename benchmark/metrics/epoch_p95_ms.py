"""Commit latency's 95th percentile over every epoch of the window (host
clock): an epoch runs from the previous epoch's return to its own, the
return coming when its verdict reaches the host.  Nearest rank."""
import math


def read(ctx):
    lat = sorted(ctx.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3

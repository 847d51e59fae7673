"""Set-up: process start to the first timed epoch (host clock)."""


def read(ctx):
    return ctx.setup_s

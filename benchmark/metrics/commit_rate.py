"""Contributions committed per second: every epoch the window completed,
times the contributions each commits (instances x nodes), over the
window's seconds (host clock)."""


def read(ctx):
    return ctx.epochs * ctx.contributions_per_epoch / ctx.window_s

"""Seconds from the process start to the end of the warm-up batch."""


def read(ctx):
    return ctx.setup_s

"""Read bases of every read of the window's batches, over the window's
host-clock seconds (kbp/s)."""


def read(ctx):
    return ctx.window_kbp / ctx.window_s

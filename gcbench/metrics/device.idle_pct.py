"""Share (%) of the traced stretch in which no operation ran on the card."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.stretch_s)

"""Seconds of the index spans (minimizer and MPC index load or build)."""


def read(ctx):
    s = ctx.spans_setup.get("index")
    return None if s is None else s[0]

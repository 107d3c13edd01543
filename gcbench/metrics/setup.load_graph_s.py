"""Seconds of the load_graph span (GFA parse and alignment graph build)."""


def read(ctx):
    s = ctx.spans_setup.get("load_graph")
    return None if s is None else s[0]

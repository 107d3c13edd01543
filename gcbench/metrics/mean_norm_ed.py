"""Mean over the window's aligned reads of (NM + unaligned read bases) /
read length, from the GAF lines: a clipped base counts as an edit."""


def read(ctx):
    if not ctx.rows:
        return None
    return sum((nm + qs + ql - qe) / ql
               for _, _, ql, qs, qe, nm, _, _ in ctx.rows) / len(ctx.rows)

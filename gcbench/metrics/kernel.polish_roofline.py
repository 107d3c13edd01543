"""Share (%) of the byte bound of one polish of every read aligned in the
traced stretch (gcbench/rooflines.polish_bytes from its GAF line) in the
device time of the polish fill and walk kernels."""

from gcbench import rooflines
from gcbench.readers import kernel_seconds


def read(ctx):
    secs = kernel_seconds(ctx, "polish_core", "polish_walk")
    rows = ctx.trace.gaf_rows if ctx.trace is not None else []
    if secs is None or not rows:
        return None
    nbytes = sum(rooflines.polish_bytes(ql, ps, blk)
                 for _, _, ql, _, _, _, ps, blk in rows)
    return 100.0 * rooflines.bound_s(nbytes) / secs

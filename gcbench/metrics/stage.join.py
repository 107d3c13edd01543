"""Thread-summed milliseconds per kbp of read of the join span over
the window."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, 'join')

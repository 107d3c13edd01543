"""Thread-summed milliseconds per kbp of read of the frag_kernel span over
the window."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, 'frag_kernel')

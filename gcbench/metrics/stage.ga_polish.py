"""Thread-summed milliseconds per kbp of read of the ga_polish span over
the window."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, 'ga_polish')

"""Thread-summed milliseconds per kbp of read of the ga_window span over
the window."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, 'ga_window')

"""Thread-summed milliseconds per kbp of read of the chain_scan span over
the window."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, 'chain_scan')

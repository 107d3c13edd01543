"""Thread-summed milliseconds per kbp of read of the escalate span over
the window (inclusive of the stages it runs again)."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, 'escalate')

"""Milliseconds per kbp of the rescue span less the GA windows and GA
polish nested in it."""

from gcbench.readers import stage_ms_per_kbp


def read(ctx):
    return stage_ms_per_kbp(ctx, "rescue", minus=("ga_window", "ga_polish"))

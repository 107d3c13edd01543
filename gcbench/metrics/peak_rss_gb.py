"""The run's maximum resident set (ru_maxrss) when the window closes, GB."""


def read(ctx):
    return ctx.peak_rss_gb

"""Reads sent to the GA rescue (counter rescued_reads) per 100 reads of
the window."""


def read(ctx):
    return 100.0 * ctx.counters_window.get("rescued_reads", 0) / ctx.window_reads

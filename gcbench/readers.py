"""Shared arithmetic of the per-layer metric readers (gcbench/metrics/).

Each reader gets the run's context (run.Context) and returns a number or
None when it finds nothing to read; the harness then leaves the metric out
of the result line.  Stage spans are the program's `utils.timers` spans,
summed over its worker threads: a stage that did not run in the window
reads 0, which is a reading, not a missing one.
"""
from __future__ import annotations

from gcbench import rooflines


def span_s(ctx, name: str) -> float:
    return ctx.spans_window.get(name, 0.0)


def stage_ms_per_kbp(ctx, *names: str, minus=()) -> float:
    """Thread-summed milliseconds of the spans `names` (less `minus`) over
    the window, per kbp of the window's reads."""
    s = sum(span_s(ctx, n) for n in names) - sum(span_s(ctx, n)
                                                 for n in minus)
    return 1000.0 * s / ctx.window_kbp


def kernel_seconds(ctx, *patterns: str):
    """Device seconds of the traced stretch's kernels whose names hold one
    of the patterns, or None without a trace or without such a kernel."""
    if ctx.trace is None:
        return None
    t = sum(dur for name, _, dur in ctx.trace.device_ops
            if any(p in name for p in patterns))
    return t if t > 0 else None


def frag_roofline(ctx, kind: str, pattern: str):
    """Share (%) of the fragment DP's byte bound in its kernel time over
    the traced stretch, for the launches of `kind` ("fresh" / "carried")
    made in it."""
    secs = kernel_seconds(ctx, pattern)
    if secs is None:
        return None
    launches = [l for l in ctx.trace.frag_launches if l["kind"] == kind]
    if not launches:
        return None
    nbytes = sum(rooflines.frag_core_bytes(
        l["F"], l["B"], l["S"], l["max_in"], kind == "carried",
        l.get("per_slot", False), l.get("want_state", False),
        l.get("want_xcells", False)) for l in launches)
    return 100.0 * rooflines.bound_s(nbytes) / secs

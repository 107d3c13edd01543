"""Per-stage wall-clock counters (reference src/Aligner.cpp:537-567,
998-1002 keeps ad-hoc per-thread timers around seeding / extension /
chaining and a cellsProcessed counter; here a process-global thread-safe
accumulator surfaced by the pipeline under --verbose).

Timers measure host wall-time per stage; note that on an async device the
dispatching stage absorbs device wait time at its first blocking
download.

Copy of graphchainer_tpu/utils/timers.py: the port keeps its own
accumulator, so a process that runs both packages times them apart."""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_acc: dict = {}


@contextmanager
def stage(name: str, items: int = 0):
    """Accumulate wall time (and an optional item count) under `name`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            sec, cnt = _acc.get(name, (0.0, 0))
            _acc[name] = (sec + dt, cnt + items)


def add(name: str, seconds: float, items: int = 0):
    with _lock:
        sec, cnt = _acc.get(name, (0.0, 0))
        _acc[name] = (sec + seconds, cnt + items)


def snapshot() -> dict:
    """{stage: (seconds, items)} copy."""
    with _lock:
        return dict(_acc)


def reset():
    with _lock:
        _acc.clear()
        _counters.clear()


def report(out=None) -> str:
    """Human-readable per-stage table (seconds are summed across threads,
    so overlapped batches can total more than wall-clock)."""
    snap = snapshot()
    lines = ["Per-stage time (thread-summed):"]
    for name in sorted(snap, key=lambda k: -snap[k][0]):
        sec, cnt = snap[name]
        extra = f"  ({cnt} items, {cnt / sec:.1f}/s)" if cnt and sec else ""
        lines.append(f"  {name:<18} {sec:8.2f}s{extra}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


_counters: dict = {}


def count(name: str, n: int):
    """Accumulate a plain counter (e.g. DP cells processed — reference
    src/Aligner.cpp:998-1002 cellsProcessed)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def report_counters(out=None) -> str:
    snap = counters()
    if not snap:
        return ""
    lines = ["Counters:"]
    for name in sorted(snap):
        lines.append(f"  {name:<18} {snap[name]:>14,}")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text

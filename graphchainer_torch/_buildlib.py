"""Build a shared library once into graphchainer_torch/_build/.

Both the CUDA kernels (ops/_cuda.py) and the C++ host runtime (native.py)
are compiled at first use into a file named by a hash of their sources and
flags, behind a file lock of its own (<library>.lock), so concurrent
processes build each once, two different libraries build side by side,
and a changed source never loads a stale library.
"""
from __future__ import annotations

import hashlib
import os
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")


def hashed_path(stem: str, sources, flags) -> str:
    """BUILD_DIR/lib<stem>_<hash of the sources' bytes and the flags>.so"""
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_once(so: str, make) -> float:
    """Run make(tmp_path) under `so`'s own lock unless `so` exists, then
    move the result into place.  Returns the build's wall seconds (0.0
    when another process had built it)."""
    import fcntl
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(so):
            return 0.0
        t0 = time.perf_counter()
        tmp = f"{so}.{os.getpid()}.tmp"
        make(tmp)
        os.replace(tmp, so)
        return time.perf_counter() - t0

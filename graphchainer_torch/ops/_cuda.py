"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

The kernels are compiled at first use with nvcc for sm_90a into one
shared library with a plain C interface and loaded with ctypes: no
PyTorch headers, so the build takes seconds.  Each source is compiled by
an nvcc of its own, all started together, and the objects are linked
into graphchainer_torch/_build/ under a name keyed by a hash of the
sources, behind a file lock, so concurrent processes build it once.

Each wrapper counts the launches of its kernel here (thread-safe: the
pipeline runs batches from a thread pool), in total and under the shard
of a multi-device stage that made them (parallel/device.run_shards sets
it per thread), and launches on its tensors' device.  A run resets the
counts, drives the main path and reads them back to show the path went
through the kernels.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

from graphchainer_torch import _buildlib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("frag_core.cu", "frag_wide.cu", "polish_core.cu",
           "polish_walk.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None        # wall time of the build that produced the
                            # loaded library (0.0 when it was already built)

_count_lock = threading.Lock()
_launches = {"frag_core": 0, "frag_core_carried": 0, "frag_wide": 0,
             "polish_core": 0, "polish_walk": 0, "polish_core_any": 0,
             "polish_walk_any": 0}
_by_shard: dict = {}            # shard index -> {kernel: launches}
_shard = threading.local()      # .index: this thread's current shard


def count_launch(name: str) -> None:
    with _count_lock:
        _launches[name] += 1
        per = _by_shard.setdefault(getattr(_shard, "index", 0),
                                   dict.fromkeys(_launches, 0))
        per[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in _launches:
            _launches[k] = 0
        _by_shard.clear()


def launches() -> dict:
    with _count_lock:
        return dict(_launches)


def launches_by_shard() -> dict:
    """{shard index: {kernel: launches}} since the last reset; a
    single-device stage counts under shard 0."""
    with _count_lock:
        return {k: dict(v) for k, v in sorted(_by_shard.items())}


@contextlib.contextmanager
def shard(index: int):
    """Count this thread's launches under shard `index` inside."""
    prev = getattr(_shard, "index", 0)
    _shard.index = index
    try:
        yield
    finally:
        _shard.index = prev


def device_of(t):
    """t's CUDA device as the current one: a launch (and the shared-memory
    attribute it sets) goes to the device its tensors are on."""
    import torch
    return torch.cuda.device(t.device)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> str:
    return _buildlib.hashed_path(
        "gct_kernels", [os.path.join(CSRC, s) for s in SOURCES], NVCC_FLAGS)


def compile_sources(out: str, sources) -> str:
    """Build the .cu files `sources` (paths) into the shared library
    `out`: one nvcc per source, side by side, then the link.  Returns
    nvcc's output (ptxas' report of every kernel)."""
    nvcc = _nvcc()
    os.makedirs(_buildlib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_buildlib.BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{i}.o") for i in range(len(sources))]
        procs = [subprocess.Popen(
            [nvcc] + NVCC_FLAGS + ["-c", "-o", o, s],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        bad = [f"{s} ({p.returncode}):\n{log}"
               for s, p, log in zip(sources, procs, logs) if p.returncode]
        if bad:
            raise RuntimeError("nvcc failed: " + "\n".join(bad))
        r = subprocess.run([nvcc, "-shared", "-o", out] + objs,
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
    return "".join(f"== {os.path.basename(s)}\n{log}"
                   for s, log in zip(sources, logs))


def _make(out: str) -> None:
    log = compile_sources(out, [os.path.join(CSRC, s) for s in SOURCES])
    with open(library_path() + ".log", "w") as fh:
        fh.write(log)


def ptxas_log() -> str:
    """nvcc's output of the build of the loaded library: per kernel,
    ptxas' registers, stack frame and spill bytes ('' if not built here)."""
    try:
        with open(library_path() + ".log") as fh:
            return fh.read()
    except OSError:
        return ""


def bind(so: str) -> ctypes.CDLL:
    """Load a library built from these sources and declare its entries'
    argument types (every pointer and the stream a c_void_p)."""
    L = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    L.frag_core_launch.restype = I
    L.frag_core_launch.argtypes = [P] * 8 + [I] * 6 + [P] * 4 + [P]
    L.frag_core_carried_launch.restype = I
    L.frag_core_carried_launch.argtypes = ([P] * 11 + [I] * 7
                                           + [P] * 10 + [P])
    L.frag_wide_launch.restype = I
    L.frag_wide_launch.argtypes = [P] * 9 + [I] * 8 + [P] * 8
    for fn in (L.polish_core_launch, L.polish_core_any_launch):
        fn.restype = I
        fn.argtypes = [P] * 4 + [I] * 4 + [P] * 4 + [P]
    L.polish_walk_any_launch.restype = I
    L.polish_walk_any_launch.argtypes = [P] * 8 + [I] * 6 + [P] + [P]
    L.gct_error_string.restype = ctypes.c_char_p
    L.gct_error_string.argtypes = [I]
    return L


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        secs = (_buildlib.build_once(so, _make) if not os.path.exists(so)
                else 0.0)
        L = bind(so)
        build_seconds = secs
        _lib = L
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib().gct_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({msg})")


def stream_ptr(t) -> int:
    """PyTorch's current CUDA stream on t's device, as a raw pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t, shape=None, dtype=None):
    """Check a kernel argument: its dtype (int32 unless given), shape and
    contiguity, then that it lies on a CUDA device."""
    require_cuda_all([(name, t, shape, dtype)])


def require_cuda_all(specs):
    """require_cuda over (name, tensor, shape, dtype) specs: every dtype,
    shape and contiguity first, then every device."""
    import torch
    for name, t, shape, dtype in specs:
        dtype = torch.int32 if dtype is None else dtype
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    for name, t, _, _ in specs:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.device}")

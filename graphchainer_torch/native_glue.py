"""JAX-free ctypes glue for the CLC seed+window stage.

Copy of graphchainer_tpu.native.seed_window_batch (same argtypes, same
call into the C++ runtime) that returns this package's JobCols; the
original imports its JobCols from a module that pulls in jax.
"""
from __future__ import annotations

import ctypes

import numpy as np

from graphchainer_tpu import native
from graphchainer_torch.align.anchors import JobCols

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _ptr(a: np.ndarray):
    assert a.dtype == np.int64 and a.flags.c_contiguous
    return a.ctypes.data_as(_I64P)


def seed_window_batch(index, gx, reads, density: float, flen: int,
                      sep: int, kper: int):
    """Minimizer seeds + fragment windows for a batch in one native call
    that releases the GIL.

    index: MinimizerIndex; gx: GraphTensors; reads: list of (name, seq).
    Returns (JobCols, frags [nfrag,7] int64 rows of (read_idx, l, r,
    fi_fwd, fi_bwd, seed split, seed off), seed_counts list)."""
    lib = native.get_lib()
    if not hasattr(lib, "_sw_sig"):
        lib.seed_window_batch.restype = ctypes.c_void_p
        lib.seed_window_batch.argtypes = (
            [ctypes.c_int64, _I64P, _I64P, _I64P]
            + [ctypes.c_int64] * 3 + [ctypes.c_double]
            + [ctypes.c_int64, _U8P, _I64P]
            + [ctypes.c_int64] + [_I64P] * 4
            + [ctypes.c_int64] * 3 + [_I64P])
        lib.sw_sizes.argtypes = [ctypes.c_void_p, _I64P]
        lib.sw_copy.argtypes = [ctypes.c_void_p] + [_I64P] * 7
        lib.sw_free.argtypes = [ctypes.c_void_p]
        lib._sw_sig = True
    # int64 copies of the index arrays, cached on the index object
    cache = getattr(index, "_native_arrs", None)
    if cache is None:
        cache = (np.ascontiguousarray(index.codes).view(np.int64),
                 np.ascontiguousarray(index.di_node, dtype=np.int64),
                 np.ascontiguousarray(index.offset, dtype=np.int64))
        index._native_arrs = cache
    codes_i64, di_node, offset = cache
    split_keys, split_vals = gx.split_lookup()
    nr = len(reads)
    read_bytes = np.frombuffer("".join(s for _, s in reads).encode("ascii")
                               or b"\0", dtype=np.uint8)
    read_off = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s in reads], out=read_off[1:])
    seed_counts = np.zeros(nr, dtype=np.int64)
    h = lib.seed_window_batch(
        ctypes.c_int64(len(codes_i64)), _ptr(codes_i64), _ptr(di_node),
        _ptr(offset), ctypes.c_int64(int(index.count_cap)),
        ctypes.c_int64(int(index.k)), ctypes.c_int64(int(index.w)),
        ctypes.c_double(float(density)),
        ctypes.c_int64(nr), read_bytes.ctypes.data_as(_U8P), _ptr(read_off),
        ctypes.c_int64(len(split_keys)), _ptr(split_keys),
        _ptr(split_vals), _ptr(gx.node_len64), _ptr(gx.orig_offset64),
        ctypes.c_int64(flen), ctypes.c_int64(sep), ctypes.c_int64(kper),
        _ptr(seed_counts))
    sizes = np.empty(2, dtype=np.int64)
    lib.sw_sizes(h, _ptr(sizes))
    F, nfrag = int(sizes[0]), int(sizes[1])
    seed, trim, rev, read_idx, lo, hi = (np.empty(max(F, 1), dtype=np.int64)
                                         for _ in range(6))
    frags = np.empty(max(nfrag * 7, 1), dtype=np.int64)
    lib.sw_copy(h, _ptr(seed), _ptr(trim), _ptr(rev), _ptr(read_idx),
                _ptr(lo), _ptr(hi), _ptr(frags))
    lib.sw_free(h)
    jc = JobCols(seed=seed[:F], trim=trim[:F], rev=rev[:F].astype(bool),
                 read_idx=read_idx[:F], lo=lo[:F], hi=hi[:F])
    return jc, frags[:nfrag * 7].reshape(nfrag, 7), seed_counts.tolist()

"""Wrappers of the polish kernels (csrc/polish_core.cu, polish_walk.cu).

polish_core() takes the lane-major inputs of linear_align._polish_core_t
and returns its dump (dump_vp, dump_vn, dump_sb (P, bw, R), dump_base
(P, R)); the CUDA kernel replaces the Pallas kernel
graphchainer_tpu/ops/pallas_polish2.py::polish_core_pallas, and its dump
words are int32 bit patterns (the plain consumers read them through
myers.u32).  polish_walk() reads the score and walks the backtrace over
that dump into the packed rows of linear_align._polish_walk_t.  Each runs
its plain torch version on a CPU tensor and launches its kernel on a CUDA
tensor.
"""
from __future__ import annotations

import torch

from graphchainer_torch.ops import _cuda
from graphchainer_torch.ops import linear_align as _la
from graphchainer_torch.ops.myers import to_i32_bits

BAND_WORDS = (1, 2, 4, 8, 16, 32, 64)   # band widths the kernel is built for


def polish_core(planes_t, path_t, read_len, path_len, bw: int):
    """Banded fill of R reads: planes_t (4, RW, R) read plane words,
    path_t (P, R) path char masks, read_len / path_len (R,)."""
    if not planes_t.is_cuda:
        return _la._polish_core_t(planes_t, path_t, read_len, path_len, bw)
    args = (to_i32_bits(planes_t), to_i32_bits(path_t),
            read_len.to(torch.int32), path_len.to(torch.int32))
    return polish_core_cuda(*(a.contiguous() for a in args), bw)


def polish_core_cuda(planes_t, path_t, read_len, path_len, bw: int):
    """Launch the kernel on int32 CUDA tensors (words as bit patterns)."""
    if bw not in BAND_WORDS:
        raise ValueError(f"polish_core: bw={bw} not in {BAND_WORDS}")
    _, RW, R = planes_t.shape
    P = path_t.shape[0]
    chk = _cuda.require_cuda_int32
    chk("planes_t", planes_t, (4, RW, R))
    chk("path_t", path_t, (P, R))
    chk("read_len", read_len, (R,))
    chk("path_len", path_len, (R,))
    dev = planes_t.device
    dvp = torch.empty((P, bw, R), dtype=torch.int32, device=dev)
    dvn = torch.empty((P, bw, R), dtype=torch.int32, device=dev)
    dsb = torch.empty((P, bw, R), dtype=torch.int32, device=dev)
    dbase = torch.empty((P, R), dtype=torch.int32, device=dev)
    if R and P:
        L = _cuda.lib()
        rc = L.polish_core_launch(
            planes_t.data_ptr(), path_t.data_ptr(), read_len.data_ptr(),
            path_len.data_ptr(), R, RW, P, bw, dvp.data_ptr(),
            dvn.data_ptr(), dsb.data_ptr(), dbase.data_ptr(),
            _cuda.stream_ptr(planes_t))
        _cuda.check(rc, "polish_core")
        _cuda.count_launch("polish_core")
    return dvp, dvn, dsb, dbase


def polish_walk(dvp, dvn, dsb, dbase, planes_t, path_t, read_len, path_len,
                bw: int, max_steps: int, ops_cap: int = 0):
    """Score + backtrace + op packing of polish_core's dump: (R, 3 +
    ops_cap/16) int64 rows (see linear_align._polish_walk_t)."""
    if not dvp.is_cuda:
        return _la._polish_walk_t(dvp, dvn, dsb, dbase, planes_t, path_t,
                                  read_len, path_len, bw, max_steps, ops_cap)
    args = (to_i32_bits(dvp), to_i32_bits(dvn), dsb.to(torch.int32),
            dbase.to(torch.int32), to_i32_bits(planes_t),
            to_i32_bits(path_t), read_len.to(torch.int32),
            path_len.to(torch.int32))
    return polish_walk_cuda(*(a.contiguous() for a in args), bw, max_steps,
                            ops_cap)


def polish_walk_cuda(dvp, dvn, dsb, dbase, planes_t, path_t, read_len,
                     path_len, bw: int, max_steps: int, ops_cap: int = 0):
    """Launch the walk kernel on int32 CUDA tensors (words as bit
    patterns)."""
    if not ops_cap or ops_cap > max_steps:
        ops_cap = max_steps
    if ops_cap % 16:
        raise ValueError(f"polish_walk: ops_cap={ops_cap} is not a multiple "
                         "of 16")
    P, _, R = dvp.shape
    RW = planes_t.shape[1]
    chk = _cuda.require_cuda_int32
    for name, t in (("dump_vp", dvp), ("dump_vn", dvn), ("dump_sb", dsb)):
        chk(name, t, (P, bw, R))
    chk("dump_base", dbase, (P, R))
    chk("planes_t", planes_t, (4, RW, R))
    chk("path_t", path_t, (P, R))
    chk("read_len", read_len, (R,))
    chk("path_len", path_len, (R,))
    out = torch.empty((R, 3 + ops_cap // 16), dtype=torch.int64,
                      device=dvp.device)
    if R:
        rc = _cuda.lib().polish_walk_launch(
            dvp.data_ptr(), dvn.data_ptr(), dsb.data_ptr(), dbase.data_ptr(),
            planes_t.data_ptr(), path_t.data_ptr(), read_len.data_ptr(),
            path_len.data_ptr(), R, RW, P, bw, max_steps, ops_cap,
            out.data_ptr(), _cuda.stream_ptr(dvp))
        _cuda.check(rc, "polish_walk")
        _cuda.count_launch("polish_walk")
    return out

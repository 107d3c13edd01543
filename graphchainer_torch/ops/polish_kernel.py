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

The fill has two entries, and the band width alone decides which one a
call takes (entry_for): the template warp-per-read entry is built for bw
8, 16 and 32, the widths of the default polish band ramp; every other
width (bw >= 1: a --polish-band start of 3 ramps 3 -> 6 -> 12 -> 24 -> 48)
takes the run-time-bw entry, which takes the band width as a run-time
argument.  The walk has one entry for every width.  The run-time entries'
launchers pick their route from the width: a warp per read up to 64 band
words (the fill one word a lane up to 32, two beyond; the walk staging
the dump in shared memory), a thread per read past 64.  The walk's
launches count as "polish_walk" at the default ramp's widths and as
"polish_walk_any" at every other width.

The width also decides the dump's memory order, in one place
(read_major, word_stride): up to 64 words, whatever the fill entry, the
dump is read-major, (R, P, ws) and (R, P), with the word stride ws the
band width rounded up to a multiple of 4 (so each column starts on 16
bytes; the padding words are never read); past 64 it is column-major,
(P, bw, R) and (P, R).  polish_core returns (P, bw, R) / (P, R) views
either way, equal element for element, and polish_walk copies a dump
that does not lie the way the walk reads it (never on the pipeline's
path: each fill's dump goes to the walk at the same width).
"""
from __future__ import annotations

import torch

from graphchainer_torch.ops import _cuda
from graphchainer_torch.ops import linear_align as _la
from graphchainer_torch.ops.myers import to_i32_bits

WARP_BAND_WORDS = (8, 16, 32)           # band widths of the template fill
MAX_TILE_BAND_WORDS = 64                # widest read-major (warp) route


def entry_for(bw: int) -> str:
    """The fill entry a band width takes: "warp" (the template warp
    entry) or "any" (the run-time-bw entry, whose launch refuses a width
    below 1; its launcher runs a warp per read up to 64 words and a
    thread per read beyond).  The walk's launches are counted by the
    same split."""
    return "warp" if bw in WARP_BAND_WORDS else "any"


def read_major(bw: int) -> bool:
    """Whether a dump of this band width is stored read-major (R, P, ws)
    (up to 64 words) or column-major (P, bw, R) (beyond)."""
    return bw <= MAX_TILE_BAND_WORDS


def word_stride(bw: int) -> int:
    """The word stride of a read-major dump: bw rounded up to 4."""
    return -(-bw // 4) * 4


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
    entry = entry_for(bw)
    _, RW, R = planes_t.shape
    P = path_t.shape[0]
    chk = _cuda.require_cuda
    chk("planes_t", planes_t, (4, RW, R))
    chk("path_t", path_t, (P, R))
    chk("read_len", read_len, (R,))
    chk("path_len", path_len, (R,))
    dev = planes_t.device
    warp = entry == "warp"
    rm = read_major(bw)
    word_shape = (R, P, word_stride(bw)) if rm else (P, bw, R)
    dvp = torch.empty(word_shape, dtype=torch.int32, device=dev)
    dvn = torch.empty(word_shape, dtype=torch.int32, device=dev)
    dsb = torch.empty(word_shape, dtype=torch.int32, device=dev)
    dbase = torch.empty((R, P) if rm else (P, R), dtype=torch.int32,
                        device=dev)
    if R and P:
        L = _cuda.lib()
        launch = L.polish_core_launch if warp else L.polish_core_any_launch
        with _cuda.device_of(planes_t):
            rc = launch(
                planes_t.data_ptr(), path_t.data_ptr(), read_len.data_ptr(),
                path_len.data_ptr(), R, RW, P, bw, dvp.data_ptr(),
                dvn.data_ptr(), dsb.data_ptr(), dbase.data_ptr(),
                _cuda.stream_ptr(planes_t))
        name = "polish_core" if warp else "polish_core_any"
        _cuda.check(rc, name)
        _cuda.count_launch(name)
    if rm:
        return tuple(x[..., :bw].permute(1, 2, 0) for x in (dvp, dvn, dsb)) \
            + (dbase.permute(1, 0),)
    return dvp, dvn, dsb, dbase


def polish_walk(dvp, dvn, dsb, dbase, planes_t, path_t, read_len, path_len,
                bw: int, max_steps: int, ops_cap: int = 0):
    """Score + backtrace + op packing of polish_core's dump: (R, 3 +
    ops_cap/16) int64 rows (see linear_align._polish_walk_t)."""
    if not dvp.is_cuda:
        return _la._polish_walk_t(dvp, dvn, dsb, dbase, planes_t, path_t,
                                  read_len, path_len, bw, max_steps, ops_cap)
    dump = (to_i32_bits(dvp), to_i32_bits(dvn), dsb.to(torch.int32),
            dbase.to(torch.int32))
    args = (to_i32_bits(planes_t), to_i32_bits(path_t),
            read_len.to(torch.int32), path_len.to(torch.int32))
    return polish_walk_cuda(*dump, *(a.contiguous() for a in args), bw,
                            max_steps, ops_cap)


def _stored(t, bw: int):
    """A (P, bw, R) or (P, R) dump tensor as the walk reads it from memory
    at this width (read_major): a contiguous (R, P, ws) / (R, P) tensor, or
    (P, bw, R) / (P, R).  No copy where polish_core wrote it."""
    if not read_major(bw):
        return t.contiguous()
    if t.dim() == 2:
        return t.permute(1, 0).contiguous()
    P, _, R = t.shape
    ws = word_stride(bw)
    need = (t.storage_offset() + R * P * ws) * t.element_size()
    if (t.stride() == (ws, 1, P * ws) and t.data_ptr() % 16 == 0
            and t.untyped_storage().nbytes() >= need):
        return t.as_strided((R, P, ws), (P * ws, ws, 1))
    out = t.new_zeros((R, P, ws))
    out[..., :bw] = t.permute(2, 0, 1)
    return out


def polish_walk_cuda(dvp, dvn, dsb, dbase, planes_t, path_t, read_len,
                     path_len, bw: int, max_steps: int, ops_cap: int = 0):
    """Launch the walk kernel on int32 CUDA tensors (words as bit
    patterns); the dump tensors are (P, bw, R) / (P, R), in either
    memory order."""
    entry = entry_for(bw)
    if not ops_cap or ops_cap > max_steps:
        ops_cap = max_steps
    if ops_cap % 16:
        raise ValueError(f"polish_walk: ops_cap={ops_cap} is not a multiple "
                         "of 16")
    P, _, R = dvp.shape
    RW = planes_t.shape[1]
    chk = _cuda.require_cuda
    for name, t in (("dump_vp", dvp), ("dump_vn", dvn), ("dump_sb", dsb)):
        if tuple(t.shape) != (P, bw, R):
            raise ValueError(f"{name}: expected shape {(P, bw, R)}, got "
                             f"{tuple(t.shape)}")
    if tuple(dbase.shape) != (P, R):
        raise ValueError(f"dump_base: expected shape {(P, R)}, got "
                         f"{tuple(dbase.shape)}")
    dvp, dvn, dsb, dbase = (_stored(t, bw) for t in (dvp, dvn, dsb, dbase))
    for name, t in (("dump_vp", dvp), ("dump_vn", dvn), ("dump_sb", dsb),
                    ("dump_base", dbase)):
        chk(name, t)
    chk("planes_t", planes_t, (4, RW, R))
    chk("path_t", path_t, (P, R))
    chk("read_len", read_len, (R,))
    chk("path_len", path_len, (R,))
    out = torch.empty((R, 3 + ops_cap // 16), dtype=torch.int64,
                      device=dvp.device)
    if R:
        with _cuda.device_of(dvp):
            rc = _cuda.lib().polish_walk_any_launch(
                dvp.data_ptr(), dvn.data_ptr(), dsb.data_ptr(),
                dbase.data_ptr(),
                planes_t.data_ptr(), path_t.data_ptr(), read_len.data_ptr(),
                path_len.data_ptr(), R, RW, P, bw, max_steps, ops_cap,
                out.data_ptr(), _cuda.stream_ptr(dvp))
        name = "polish_walk" if entry == "warp" else "polish_walk_any"
        _cuda.check(rc, name)
        _cuda.count_launch(name)
    return out

"""Wrapper of the fragment DP kernel (csrc/frag_core.cu).

frag_core() takes the fragment-major batch of the band build in its host
types and returns a FragResult (int32 best_score / best_slot / best_col
(F,), int8 best_in (F, B, S), the layout native.join_anchors reads).  A
CPU tensor runs the plain version, frag_align.lane_major +
frag_align._frag_core_t; a CUDA tensor launches the kernel, which does the
slot gather and the seed trim itself and replaces the Pallas kernel
graphchainer_tpu/ops/pallas_frag.py::frag_core_pallas.
"""
from __future__ import annotations

import torch

from graphchainer_torch.ops import _cuda
from graphchainer_torch.ops import frag_align as _fa

MAX_B = 128       # band slots the kernel takes (band_in is int8)


def frag_core(node_eq, node_len, band_nodes, band_in, band_level,
              seed_shift, req, rows, *, S: int, max_in: int,
              n_levels: int) -> _fa.FragResult:
    """The fragment DP of F fragments of B band slots.

    node_eq (N2, 4) / node_len (N2,): the resident node table;
    band_nodes (F, B) slot node ids into it, -1 = pad; band_in
    (F, B, max_in) in-edge slot ids, -1 = none; band_level (F, B), -1 =
    pad; seed_shift (F,) columns trimmed from slot 0; req (F, S, 4) read
    row planes (32-bit words); rows (F,) fragment rows.  On a CUDA device
    every tensor has the dtype frag_core_cuda names."""
    if not band_nodes.is_cuda:
        bs, bslot, bcol, bin_ = _fa._frag_core_t(
            *_fa.lane_major(node_eq, node_len, band_nodes, band_in,
                            seed_shift, req, rows, band_level),
            S=S, max_in=max_in, n_levels=n_levels)
        return _fa.FragResult(
            best_score=bs[0].to(torch.int32),
            best_slot=bslot[0].to(torch.int32),
            best_col=bcol[0].to(torch.int32),
            best_in=bin_.permute(2, 1, 0).to(torch.int8).contiguous())
    return frag_core_cuda(node_eq, node_len, band_nodes, band_in, band_level,
                          seed_shift, req, rows, S=S, max_in=max_in,
                          n_levels=n_levels)


def frag_core_cuda(node_eq, node_len, band_nodes, band_in, band_level,
                   seed_shift, req, rows, *, S: int, max_in: int,
                   n_levels: int) -> _fa.FragResult:
    """Launch the kernel on CUDA tensors in their host types: node_eq
    int32 bits (N2, 4), node_len int32 (N2,), band_nodes int32 (F, B),
    band_in int8 (F, B, max_in), band_level int8 (F, B), seed_shift int32
    (F,), req uint32 bits in int32 (F, S, 4), rows int32 (F,)."""
    F, B = band_nodes.shape
    N2 = node_eq.shape[0]
    if not 1 <= B <= MAX_B:
        raise ValueError(f"frag_core: B={B} outside 1..{MAX_B}")
    if S < 1 or max_in < 0 or N2 < 1:
        raise ValueError(f"frag_core: bad S={S} / max_in={max_in} / N2={N2}")
    i8 = torch.int8
    _cuda.require_cuda_all([
        ("node_eq", node_eq, (N2, 4), None),
        ("node_len", node_len, (N2,), None),
        ("band_nodes", band_nodes, (F, B), None),
        ("band_in", band_in, (F, B, max_in), i8),
        ("band_level", band_level, (F, B), i8),
        ("seed_shift", seed_shift, (F,), None),
        ("req", req, (F, S, 4), None),
        ("rows", rows, (F,), None)])
    for name, t in (("node_eq", node_eq), ("req", req)):
        if t.data_ptr() % 16:
            raise ValueError(f"frag_core: {name} is not 16-byte aligned")
    out = _result_views(torch.empty(3 * F + -(-F * B * S // 4),
                                    dtype=torch.int32,
                                    device=band_nodes.device), F, B, S)
    if F:
        L = _cuda.lib()
        rc = L.frag_core_launch(
            node_eq.data_ptr(), node_len.data_ptr(), band_nodes.data_ptr(),
            band_in.data_ptr(), band_level.data_ptr(), seed_shift.data_ptr(),
            req.data_ptr(), rows.data_ptr(), N2, F, B, S, max_in, n_levels,
            *(x.data_ptr() for x in out), _cuda.stream_ptr(band_nodes))
        _cuda.check(rc, "frag_core")
        _cuda.count_launch("frag_core")
    return out


def _result_views(buf, F: int, B: int, S: int) -> _fa.FragResult:
    """A FragResult of views of one int32 buffer: best_score, best_slot,
    best_col, then best_in's bytes."""
    return _fa.FragResult(
        best_score=buf[:F], best_slot=buf[F:2 * F], best_col=buf[2 * F:3 * F],
        best_in=buf[3 * F:].view(torch.int8)[:F * B * S].view(F, B, S))


def to_numpy(res: _fa.FragResult) -> _fa.FragResult:
    """A FragResult as numpy arrays, in one copy from the device when its
    outputs share one buffer (as frag_core_cuda returns them)."""
    st = res.best_score.untyped_storage()
    if any(x.untyped_storage().data_ptr() != st.data_ptr() for x in res[1:]):
        return _fa.FragResult(*(x.cpu().numpy() for x in res))
    whole = torch.empty(0, dtype=torch.uint8, device=res.best_score.device)
    raw = whole.set_(st, 0, (st.nbytes(),)).cpu().numpy()
    out = []
    for x in res:
        o = x.storage_offset() * x.element_size()
        n = x.numel() * x.element_size()
        out.append(raw[o:o + n].view(_NP_DTYPE[x.dtype]).reshape(x.shape))
    return _fa.FragResult(*out)


_NP_DTYPE = {torch.int32: "int32", torch.int8: "int8"}

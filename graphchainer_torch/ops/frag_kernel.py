"""Wrappers of the fragment DP kernels (csrc/frag_core.cu,
csrc/frag_wide.cu).

frag_core() takes the fragment-major batch of the band build in its host
types and returns a FragResult (int32 best_score / best_slot / best_col
(F,), int8 best_in (F, B, S), the layout native.join_anchors reads; with
want_state the int32 out_ssb and the bits of out_hp / out_hn (F, B), with
want_xcells the int32 xbest / xslot / xrow (F,)).  A CPU tensor runs the
plain version, frag_align.lane_major + frag_align._frag_core_t; a CUDA
tensor launches the kernel, which does the slot gather and the seed trims
itself.  Its fresh entry (frag_core_cuda, the CLC fragment stage)
replaces the Pallas kernel graphchainer_tpu/ops/pallas_frag.py::
frag_core_pallas; its carried entry (frag_core_carried_cuda, GA mode's
windows: per-slot trims, a carried boundary state, the state and the best
X cell out) replaces the XLA-only variants of the lane-major core that
JAX keeps off that kernel (frag_align._frag_core_t with carried /
want_state / want_xcells).

frag_wide_cuda() is the kernel of frag_align.align_fragments on a CUDA
tensor: the F-major DP of optimal mode and seedless DP (bands of up to
4096 slots, int16 in-edges, full_start), which replaces the XLA-only
graphchainer_tpu/ops/frag_align.py::align_fragments; its plain version is
frag_align.align_fragments_plain.
"""
from __future__ import annotations

import numpy as np
import torch

from graphchainer_torch.ops import _cuda
from graphchainer_torch.ops import frag_align as _fa
from graphchainer_torch.ops.myers import to_i32_bits

MAX_B = 128        # band slots of frag_core's entries (band_in is int8)
MAX_WIDE_B = 4096  # band slots (and levels) of frag_wide
WIDE_THREADS = 128  # slices of a frag_wide round (its widest block)


def frag_core(node_eq, node_len, band_nodes, band_in, band_level,
              seed_shift, req, rows, *, S: int, max_in: int,
              n_levels: int, carry=None, want_state: bool = False,
              want_xcells: bool = False) -> _fa.FragResult:
    """The fragment DP of F fragments of B band slots.

    node_eq (N2, 4) / node_len (N2,): the resident node table;
    band_nodes (F, B) slot node ids into it, -1 = pad; band_in
    (F, B, max_in) in-edge slot ids, -1 = none; band_level (F, B), -1 =
    pad; seed_shift (F,) columns trimmed from slot 0, or (F, B) from every
    slot; req (F, S, 4) read row planes (32-bit words); rows (F,)
    fragment rows; carry (ssb, hp, hn) each (F, B), a previous window's
    state (hp / hn as 32-bit words).  On a CUDA device every tensor has
    the dtype frag_core_cuda names; the fresh entry runs when there is no
    carry, trim per slot or extra output, the carried entry otherwise."""
    if not band_nodes.is_cuda:
        return frag_core_plain(node_eq, node_len, band_nodes, band_in,
                               band_level, seed_shift, req, rows, S=S,
                               max_in=max_in, n_levels=n_levels, carry=carry,
                               want_state=want_state, want_xcells=want_xcells)
    if carry is None and seed_shift.dim() == 1 and not (want_state
                                                        or want_xcells):
        return frag_core_cuda(node_eq, node_len, band_nodes, band_in,
                              band_level, seed_shift, req, rows, S=S,
                              max_in=max_in, n_levels=n_levels)
    return frag_core_carried_cuda(node_eq, node_len, band_nodes, band_in,
                                  band_level, seed_shift, req, rows, S=S,
                                  max_in=max_in, n_levels=n_levels,
                                  carry=carry, want_state=want_state,
                                  want_xcells=want_xcells)


def frag_core_plain(node_eq, node_len, band_nodes, band_in, band_level,
                    seed_shift, req, rows, *, S: int, max_in: int,
                    n_levels: int, carry=None, want_state: bool = False,
                    want_xcells: bool = False) -> _fa.FragResult:
    """The plain version (lane_major + _frag_core_t) on tensors of any
    device, with frag_core's arguments and the kernel's output types."""
    carried = carry is not None
    out = _fa._frag_core_t(
        *_fa.lane_major(node_eq, node_len, band_nodes, band_in, seed_shift,
                        req, rows, band_level),
        S=S, max_in=max_in, n_levels=n_levels, carried=carried,
        carry=(tuple(c.t() for c in carry) if carried else None),
        want_state=want_state, want_xcells=want_xcells)
    res = dict(best_score=out[0][0].to(torch.int32),
               best_slot=out[1][0].to(torch.int32),
               best_col=out[2][0].to(torch.int32),
               best_in=out[3].permute(2, 1, 0).to(torch.int8).contiguous())
    k = 4
    if want_state:
        res.update(out_ssb=out[k].t().to(torch.int32).contiguous(),
                   out_hp=to_i32_bits(out[k + 1].t()).contiguous(),
                   out_hn=to_i32_bits(out[k + 2].t()).contiguous())
        k += 3
    if want_xcells:
        res.update(xbest=out[k][0].to(torch.int32),
                   xslot=out[k + 1][0].to(torch.int32),
                   xrow=out[k + 2][0].to(torch.int32))
    return _fa.FragResult(**res)


def frag_core_cuda(node_eq, node_len, band_nodes, band_in, band_level,
                   seed_shift, req, rows, *, S: int, max_in: int,
                   n_levels: int) -> _fa.FragResult:
    """Launch the kernel on CUDA tensors in their host types: node_eq
    int32 bits (N2, 4), node_len int32 (N2,), band_nodes int32 (F, B),
    band_in int8 (F, B, max_in), band_level int8 (F, B), seed_shift int32
    (F,), req uint32 bits in int32 (F, S, 4), rows int32 (F,)."""
    F, B = band_nodes.shape
    _check_inputs(node_eq, node_len, band_nodes, band_in, band_level,
                  seed_shift, req, rows, S, max_in, (F,))
    out = _result_views(_result_buffer(F, B, S, band_nodes.device), F, B, S)
    if F:
        L = _cuda.lib()
        with _cuda.device_of(band_nodes):
            rc = L.frag_core_launch(
                node_eq.data_ptr(), node_len.data_ptr(),
                band_nodes.data_ptr(), band_in.data_ptr(),
                band_level.data_ptr(), seed_shift.data_ptr(),
                req.data_ptr(), rows.data_ptr(), node_eq.shape[0], F, B, S,
                max_in, n_levels, *(x.data_ptr() for x in out[:4]),
                _cuda.stream_ptr(band_nodes))
        _cuda.check(rc, "frag_core")
        _cuda.count_launch("frag_core")
    return out


def frag_core_carried_cuda(node_eq, node_len, band_nodes, band_in,
                           band_level, seed_shift, req, rows, *, S: int,
                           max_in: int, n_levels: int, carry=None,
                           want_state: bool = False,
                           want_xcells: bool = False) -> _fa.FragResult:
    """Launch the kernel's carried entry: frag_core_cuda's inputs, with
    seed_shift int32 (F,) (slot 0 only) or (F, B) (every slot), and carry
    None or (ssb, hp, hn) int32 (F, B) (hp / hn as uint32 bits).  The
    outputs of want_state (out_ssb, out_hp, out_hn (F, B)) and of
    want_xcells (xbest, xslot, xrow (F,)) share one buffer with the
    others."""
    F, B = band_nodes.shape
    per_slot = seed_shift.dim() == 2
    _check_inputs(node_eq, node_len, band_nodes, band_in, band_level,
                  seed_shift, req, rows, S, max_in,
                  (F, B) if per_slot else (F,))
    if carry is not None:
        _cuda.require_cuda_all([(name, c, (F, B), None) for name, c in
                                zip(("carry ssb", "carry hp", "carry hn"),
                                    carry)])
    out = _result_views(_result_buffer(F, B, S, band_nodes.device,
                                       want_state, want_xcells),
                        F, B, S, want_state, want_xcells)
    if F:
        L = _cuda.lib()
        null = 0
        cs, ch, cn = ((c.data_ptr() for c in carry) if carry is not None
                      else (null, null, null))
        with _cuda.device_of(band_nodes):
            rc = L.frag_core_carried_launch(
                node_eq.data_ptr(), node_len.data_ptr(),
                band_nodes.data_ptr(), band_in.data_ptr(),
                band_level.data_ptr(), seed_shift.data_ptr(),
                req.data_ptr(), rows.data_ptr(), cs, ch, cn,
                node_eq.shape[0], F, B, S, max_in, n_levels, int(per_slot),
                *(x.data_ptr() if x is not None else null for x in out),
                _cuda.stream_ptr(band_nodes))
        _cuda.check(rc, "frag_core (carried entry)")
        _cuda.count_launch("frag_core_carried")
    return out


def _check_inputs(node_eq, node_len, band_nodes, band_in, band_level,
                  seed_shift, req, rows, S, max_in, shift_shape):
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
        ("seed_shift", seed_shift, shift_shape, None),
        ("req", req, (F, S, 4), None),
        ("rows", rows, (F,), None)])
    for name, t in (("node_eq", node_eq), ("req", req)):
        if t.data_ptr() % 16:
            raise ValueError(f"frag_core: {name} is not 16-byte aligned")


def _result_buffer(F: int, B: int, S: int, device, want_state: bool = False,
                   want_xcells: bool = False):
    """The int32 buffer of every output of one launch."""
    n = 3 * F + (3 * F * B if want_state else 0) + (3 * F if want_xcells
                                                      else 0)
    return torch.empty(n + -(-F * B * S // 4), dtype=torch.int32,
                       device=device)


def _result_views(buf, F: int, B: int, S: int, want_state: bool = False,
                  want_xcells: bool = False) -> _fa.FragResult:
    """A FragResult of views of one int32 buffer: best_score, best_slot,
    best_col, [out_ssb, out_hp, out_hn], [xbest, xslot, xrow], then
    best_in's bytes."""
    res, o = {}, 0
    for name in ("best_score", "best_slot", "best_col"):
        res[name] = buf[o:o + F]
        o += F
    if want_state:
        for name in ("out_ssb", "out_hp", "out_hn"):
            res[name] = buf[o:o + F * B].view(F, B)
            o += F * B
    if want_xcells:
        for name in ("xbest", "xslot", "xrow"):
            res[name] = buf[o:o + F]
            o += F
    res["best_in"] = buf[o:].view(torch.int8)[:F * B * S].view(F, B, S)
    return _fa.FragResult(**res)


def to_numpy(res: _fa.FragResult) -> _fa.FragResult:
    """A FragResult as numpy arrays, in one copy from the device when its
    outputs share one buffer (as the kernel's entries return them);
    out_hp / out_hn come back as uint32."""
    st = res.best_score.untyped_storage()
    present = [x for x in res if x is not None]
    if any(x.untyped_storage().data_ptr() != st.data_ptr()
           for x in present[1:]):
        def get(x):
            return x.cpu().numpy()
    else:
        whole = torch.empty(0, dtype=torch.uint8,
                            device=res.best_score.device)
        raw = whole.set_(st, 0, (st.nbytes(),)).cpu().numpy()

        def get(x):
            o = x.storage_offset() * x.element_size()
            n = x.numel() * x.element_size()
            return raw[o:o + n].view(_NP_DTYPE[x.dtype]).reshape(x.shape)
    out = {k: (None if x is None else get(x))
           for k, x in zip(res._fields, res)}
    for k in ("out_hp", "out_hn"):
        if out[k] is not None:
            out[k] = out[k].view(np.uint32)
    return _fa.FragResult(**out)


_NP_DTYPE = {torch.int32: "int32", torch.int8: "int8"}


def frag_wide_cuda(node_eq, node_len, band_nodes, band_in, band_level,
                   seed_shift, req, rows, seed_base=None, *, S: int,
                   max_in: int, n_levels: int,
                   full_start: bool) -> _fa.WideResult:
    """Launch csrc/frag_wide.cu on CUDA tensors: node_eq uint32 bits in
    int32 (N2, 4), node_len int32 (N2,), band_nodes int32 (F, B), band_in
    int16 (F, B, max_in), band_level int32 (F, B), seed_shift int32 (F,),
    req uint32 bits in int32 (F, S, 4), rows int32 (F,), seed_base int32
    (F,) or None (0); B and n_levels at most MAX_WIDE_B.  Returns int32
    best_score / best_slot / best_col (F,), best_in (F, B, S) int8 for
    B <= 127 and int16 above, int32 end_score / end_col (F, B)."""
    F, B = band_nodes.shape
    N2 = node_eq.shape[0]
    if not 1 <= B <= MAX_WIDE_B:
        raise ValueError(f"frag_wide: B={B} outside 1..{MAX_WIDE_B}")
    if not 1 <= n_levels <= MAX_WIDE_B:
        raise ValueError(f"frag_wide: n_levels={n_levels} outside "
                         f"1..{MAX_WIDE_B}")
    if S < 1 or max_in < 0 or N2 < 1:
        raise ValueError(f"frag_wide: bad S={S} / max_in={max_in} / N2={N2}")
    specs = [("node_eq", node_eq, (N2, 4), None),
             ("node_len", node_len, (N2,), None),
             ("band_nodes", band_nodes, (F, B), None),
             ("band_in", band_in, (F, B, max_in), torch.int16),
             ("band_level", band_level, (F, B), None),
             ("seed_shift", seed_shift, (F,), None),
             ("req", req, (F, S, 4), None),
             ("rows", rows, (F,), None)]
    if seed_base is not None:
        specs.append(("seed_base", seed_base, (F,), None))
    _cuda.require_cuda_all(specs)
    for name, t in (("node_eq", node_eq), ("req", req)):
        if t.data_ptr() % 16:
            raise ValueError(f"frag_wide: {name} is not 16-byte aligned")
    dev = band_nodes.device
    ptr = torch.int8 if B <= 127 else torch.int16
    i32 = torch.int32
    out = _fa.WideResult(
        best_score=torch.empty(F, dtype=i32, device=dev),
        best_slot=torch.empty(F, dtype=i32, device=dev),
        best_col=torch.empty(F, dtype=i32, device=dev),
        best_in=torch.empty((F, B, S), dtype=ptr, device=dev),
        end_score=torch.empty((F, B), dtype=i32, device=dev),
        end_col=torch.empty((F, B), dtype=i32, device=dev))
    if F:
        # end-word buffers of a fragment: one per slice of a wavefront
        # round, two (slice parity) for a level-by-level run
        T = max(2, min(S, WIDE_THREADS))
        scratch = torch.empty((F, T, B, 4), dtype=i32, device=dev)
        L = _cuda.lib()
        with _cuda.device_of(band_nodes):
            rc = L.frag_wide_launch(
                node_eq.data_ptr(), node_len.data_ptr(),
                band_nodes.data_ptr(), band_in.data_ptr(),
                band_level.data_ptr(), seed_shift.data_ptr(),
                req.data_ptr(), rows.data_ptr(),
                0 if seed_base is None else seed_base.data_ptr(),
                N2, F, B, S, max_in, n_levels, int(full_start), T,
                scratch.data_ptr(), out.best_score.data_ptr(),
                out.best_slot.data_ptr(), out.best_col.data_ptr(),
                out.best_in.data_ptr(), out.end_score.data_ptr(),
                out.end_col.data_ptr(), _cuda.stream_ptr(band_nodes))
        _cuda.check(rc, "frag_wide")
        _cuda.count_launch("frag_wide")
    return out

"""Wrapper of the fragment DP kernel (csrc/frag_core.cu).

frag_core() takes the lane-major inputs of frag_align._frag_core_t and
returns (best_score, best_slot, best_col, best_in) with best_in as int8
(F, B, S), the layout native.join_anchors reads.  A CPU tensor runs the
plain torch core; a CUDA tensor launches the kernel, which replaces the
Pallas kernel graphchainer_tpu/ops/pallas_frag.py::frag_core_pallas.
"""
from __future__ import annotations

import torch

from graphchainer_torch.ops import _cuda
from graphchainer_torch.ops import frag_align as _fa
from graphchainer_torch.ops.myers import to_i32_bits

MAX_B = 128       # the kernel keeps per-slot state for up to 128 slots


def frag_core(slot_eq_t, slot_len_t, band_in_t, band_level_t, req_t,
              frag_len, seed_base, *, S: int, max_in: int,
              n_levels: int) -> _fa.FragResult:
    """The fragment DP for F fragments of B band slots (see
    frag_align._frag_core_t for the arguments)."""
    if not slot_eq_t.is_cuda:
        bs, bslot, bcol, bin_ = _fa._frag_core_t(
            slot_eq_t, slot_len_t, band_in_t, band_level_t, req_t,
            frag_len, seed_base, S=S, max_in=max_in, n_levels=n_levels)
        return _fa.FragResult(
            best_score=bs[0].to(torch.int32),
            best_slot=bslot[0].to(torch.int32),
            best_col=bcol[0].to(torch.int32),
            best_in=bin_.permute(2, 1, 0).to(torch.int8).contiguous())
    args = (to_i32_bits(slot_eq_t), slot_len_t.to(torch.int32),
            band_in_t.to(torch.int32), band_level_t.to(torch.int32),
            to_i32_bits(req_t), frag_len.reshape(-1).to(torch.int32),
            seed_base.reshape(-1).to(torch.int32))
    return frag_core_cuda(*(a.contiguous() for a in args),
                          S=S, max_in=max_in, n_levels=n_levels)


def frag_core_cuda(slot_eq_t, slot_len_t, band_in_t, band_level_t, req_t,
                   frag_len, seed_base, *, S: int, max_in: int,
                   n_levels: int) -> _fa.FragResult:
    """Launch the kernel on int32 CUDA tensors (words as bit patterns):
    slot_eq_t (4, B, F), slot_len_t (B, F), band_in_t (max_in, B, F),
    band_level_t (B, F), req_t (S, 4, F), frag_len (F,), seed_base (F,)."""
    _, B, F = slot_eq_t.shape
    if not 1 <= B <= MAX_B:
        raise ValueError(f"frag_core: B={B} outside 1..{MAX_B}")
    if S < 1 or max_in < 0:
        raise ValueError(f"frag_core: bad S={S} / max_in={max_in}")
    chk = _cuda.require_cuda_int32
    chk("slot_eq_t", slot_eq_t, (4, B, F))
    chk("slot_len_t", slot_len_t, (B, F))
    chk("band_in_t", band_in_t, (max_in, B, F))
    chk("band_level_t", band_level_t, (B, F))
    chk("req_t", req_t, (S, 4, F))
    chk("frag_len", frag_len, (F,))
    chk("seed_base", seed_base, (F,))
    dev = slot_eq_t.device
    best_score = torch.empty(F, dtype=torch.int32, device=dev)
    best_slot = torch.empty(F, dtype=torch.int32, device=dev)
    best_col = torch.empty(F, dtype=torch.int32, device=dev)
    best_in = torch.empty((F, B, S), dtype=torch.int8, device=dev)
    if F:
        L = _cuda.lib()
        rc = L.frag_core_launch(
            slot_eq_t.data_ptr(), slot_len_t.data_ptr(),
            band_in_t.data_ptr(), band_level_t.data_ptr(),
            req_t.data_ptr(), frag_len.data_ptr(), seed_base.data_ptr(),
            F, B, S, max_in, n_levels,
            best_score.data_ptr(), best_slot.data_ptr(),
            best_col.data_ptr(), best_in.data_ptr(),
            _cuda.stream_ptr(slot_eq_t))
        _cuda.check(rc, "frag_core")
        _cuda.count_launch("frag_core")
    return _fa.FragResult(best_score=best_score, best_slot=best_slot,
                          best_col=best_col, best_in=best_in)

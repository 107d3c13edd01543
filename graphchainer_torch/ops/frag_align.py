"""Banded fragment-to-graph DP (the CLC fragment stage and GA mode's
extension windows) in torch.

Port of graphchainer_tpu/ops/frag_align.py: the F-major
`align_fragments` (optimal mode and seedless DP: whole-component bands
up to 4096 slots, free start at every slot and column with
`full_start`), which runs ops/frag_kernel.frag_wide_cuda on a CUDA tensor
and its plain version `align_fragments_plain` on a CPU tensor; the
lane-major core `_frag_core_t` as plain torch, with its fresh windows (the CLC path) and
its carried ones (GA mode: a boundary state carried in from the window
before, the state of the last slice out, the best X-score cell),
`lane_major`, which gathers each band slot's Eq planes and length from
the resident node tables and applies the seed trims, and the
`align_fragments_tl` front end, which hands the fragment-major batch to
ops/frag_kernel.frag_core: on a CUDA tensor the kernel does the gather
itself, on a CPU tensor lane_major + `_frag_core_t` run.

The band is a fixed set of B node slots around the seed, in topological
levels; each 32-row read slice advances every slot of a level together,
merging its candidate words (seed injection, vertical carry, in-edges) by
exact elementwise min over 33 expanded row-score planes, then running the
slot's remaining columns through the Myers recurrence.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from graphchainer_torch.ops.myers import (MASK32, ONES, W, _ABOVE,
                                          advance_word, popcount32,
                                          source_word, to_i32_bits, u32)

BIG = 1 << 28

# best_in codes (values >= 0 are band slot indices)
IN_NONE = -1      # no incoming candidate won (inactive slot)
IN_SEED = -2      # seed boundary injection (path starts here)
IN_VERT = -3      # vertical continuation from previous slice, same slot

_ABOVE_T = torch.tensor(_ABOVE, dtype=torch.int64)
_BITVAL_T = torch.tensor([1 << r for r in range(W)], dtype=torch.int64)


class FragResult(NamedTuple):
    best_score: torch.Tensor  # (F,) int32 best end score
    best_slot: torch.Tensor   # (F,) int32 argmin slot (lowest wins ties)
    best_col: torch.Tensor    # (F,) int32 argmin column within that slot
    best_in: torch.Tensor     # (F, B, S) int8 winning incoming candidate
    # want_state: the last slice's boundary state per slot, which a
    # following window on the same band takes as its carry
    out_ssb: Optional[torch.Tensor] = None  # (F, B) column-0 bottom score
    out_hp: Optional[torch.Tensor] = None   # (F, B) bottom-row +1 bits
    out_hn: Optional[torch.Tensor] = None   # (F, B) bottom-row -1 bits
    # want_xcells: the best X-score cell, X = (row + 1) - 5 * score over
    # every (slot end word, row); ties go to the lowest (slice, slot, row)
    xbest: Optional[torch.Tensor] = None    # (F,) its X value
    xslot: Optional[torch.Tensor] = None    # (F,) its slot
    xrow: Optional[torch.Tensor] = None     # (F,) its window-local row


class WideResult(NamedTuple):
    """The outputs of the F-major align_fragments, in the JAX function's
    order: FragResult's, with every slot's best end score and column."""
    best_score: torch.Tensor  # (F,) int32 best end score
    best_slot: torch.Tensor   # (F,) int32 argmin slot (lowest wins ties)
    best_col: torch.Tensor    # (F,) int32 argmin column within that slot
    best_in: torch.Tensor     # (F, B, S) int8 (B <= 127) or int16
    end_score: torch.Tensor   # (F, B) int32 per-slot best end score
    end_col: torch.Tensor     # (F, B) int32 its column
    out_ssb: Optional[torch.Tensor] = None
    out_hp: Optional[torch.Tensor] = None
    out_hn: Optional[torch.Tensor] = None
    xbest: Optional[torch.Tensor] = None
    xslot: Optional[torch.Tensor] = None
    xrow: Optional[torch.Tensor] = None


class _MergeAcc:
    """Progressive elementwise min of candidate Myers words, kept as 33
    expanded row-score planes (boundary + 32 rows) of shape (B, F) and
    repacked once after the last candidate (frag_align._MergeAcc)."""

    def __init__(self, shape, device):
        self.before = torch.full(shape, BIG, dtype=torch.int64,
                                 device=device)
        self.rows = torch.full((W,) + tuple(shape), BIG, dtype=torch.int64,
                               device=device)
        self.above = _ABOVE_T.to(device).view(W, 1, 1)

    def add(self, vp, vn, sb):
        self.before = torch.minimum(
            self.before, sb - popcount32(vp) + popcount32(vn))
        s = (sb[None] - popcount32(vp[None] & self.above)
             + popcount32(vn[None] & self.above))
        self.rows = torch.minimum(self.rows, s)

    def add_vertical(self, prev_ssb, valid):
        """source_word(prev_ssb) in closed form: S(r) = prev_ssb + r + 1."""
        s0 = torch.where(valid, prev_ssb, BIG)
        self.before = torch.minimum(self.before, s0)
        r1 = torch.arange(1, W + 1, dtype=torch.int64,
                          device=s0.device).view(W, 1, 1)
        self.rows = torch.minimum(self.rows, s0[None] + r1)

    def pack(self):
        """Rebuild (vp, vn, sb): a row bit is set only where adjacent row
        scores differ by exactly +1 / -1."""
        prev = torch.cat([self.before[None], self.rows[:-1]], dim=0)
        d = self.rows - prev
        bit = _BITVAL_T.to(d.device).view(W, 1, 1)
        vp = ((d == 1).to(torch.int64) * bit).sum(dim=0)
        vn = ((d == -1).to(torch.int64) * bit).sum(dim=0)
        return vp, vn, self.rows[W - 1]


def _frag_core_t(slot_eq_t, slot_len_t, band_in_t, band_level_t, req_t,
                 frag_len, seed_base, *, S: int, max_in: int,
                 n_levels: int, carried: bool = False, carry=None,
                 want_state: bool = False, want_xcells: bool = False):
    """Lane-major fragment DP, plain torch.  All arrays are (..., F) with
    fragments last; words are int64 holding 32 bits:

    slot_eq_t:    (4, B, F) seed-shifted Eq bitplanes per slot
    slot_len_t:   (B, F) effective slot lengths (after the seed trim)
    band_in_t:    (max_in, B, F) in-edge slot ids (-1 none)
    band_level_t: (B, F) topo level per slot (-1 pad)
    req_t:        (S, 4, F) read row planes per 32-row slice
    frag_len:     (1, F);  seed_base: (1, F)
    carry:        (ssb, hp, hn) each (B, F) when carried: slice 0
                  continues that state (vertical carry and exact boundary
                  bits, no seed injection)

    Returns (best_score (1, F), best_slot (1, F), best_col (1, F),
    best_in (S, B, F), [ssb, hp, hn (B, F) when want_state], [xbest,
    xslot, xrow (1, F) when want_xcells]), all int64 — the values of
    graphchainer_tpu.ops.frag_align._frag_core_t."""
    _, B, F = slot_eq_t.shape
    dev = slot_eq_t.device
    i64 = torch.int64
    slot_eq_t = slot_eq_t.to(i64)
    slot_len_t = slot_len_t.to(i64)
    band_in_t = band_in_t.to(i64)
    band_level_t = band_level_t.to(i64)
    req_t = req_t.to(i64)
    frag_len = frag_len.to(i64)
    slot_active = slot_len_t > 0
    is_seed = (torch.arange(B, device=dev) == 0).view(B, 1)
    end_slice = torch.div(frag_len - 1, W, rounding_mode="floor")
    er = torch.remainder(frag_len - 1, W)
    end_row_mask = torch.where(
        er < W - 1,
        torch.bitwise_left_shift(torch.full_like(er, ONES), er + 1) & MASK32,
        torch.zeros_like(er))

    b0_vp, b0_vn, b0_sb = source_word(seed_base.to(i64))   # (1, F)

    def full(v):
        return torch.full((B, F), v, dtype=i64, device=dev)

    evp, evn, esb = full(0), full(0), full(BIG)
    if carried:     # hp / hn may come as int32 bit patterns
        ssb, hp, hn = carry[0].to(i64), u32(carry[1]), u32(carry[2])
    else:
        ssb, hp, hn = full(BIG), full(0), full(0)
    end_score, end_col = full(BIG), full(0)
    best_in_slices = []
    xbest = torch.full((1, F), -BIG, dtype=i64, device=dev)
    xslot = torch.zeros((1, F), dtype=i64, device=dev)
    xrow = torch.zeros((1, F), dtype=i64, device=dev)

    def eq_col(req_s, c):
        bits = (slot_eq_t >> c) & 1                      # (4, B, F)
        return (req_s[0] * bits[0] | req_s[1] * bits[1]
                | req_s[2] * bits[2] | req_s[3] * bits[3])

    def em_score(vp, vn, sb):
        return (sb - popcount32(vp & end_row_mask)
                + popcount32(vn & end_row_mask))

    for s in range(S):
        req_s = [req_t[s, b][None] for b in range(4)]   # 4 x (1, F)
        prev_ssb, prev_hp, prev_hn = ssb, hp, hn
        prev_exists = s > 0 or carried
        at_end = end_slice == s                          # (1, F)
        n_ssb, n_hp, n_hn = full(BIG), full(0), full(0)
        bin_s = full(IN_NONE)
        for lv in range(n_levels):
            lvl = band_level_t == lv
            eq0 = eq_col(req_s, 0)
            acc = _MergeAcc((B, F), dev)
            cbest = full(IN_NONE)
            csb_run = full(BIG)

            if not prev_exists:
                seed_valid = is_seed.expand(B, F)
                avp, avn, asb, _ = advance_word(
                    b0_vp.expand(B, F), b0_vn.expand(B, F),
                    b0_sb.expand(B, F), eq0, 1)
                avp = torch.where(seed_valid, avp, ONES)
                avn = torch.where(seed_valid, avn, 0)
                asb = torch.where(seed_valid, asb, BIG)
                acc.add(avp, avn, asb)
                better = asb < csb_run
                csb_run = torch.minimum(csb_run, asb)
                cbest = torch.where(seed_valid & better, IN_SEED, cbest)
            else:
                valid = slot_active & (prev_ssb < BIG)
                acc.add_vertical(prev_ssb, valid)
                vsb = torch.where(valid, prev_ssb + W, BIG)
                better = vsb < csb_run
                csb_run = torch.minimum(csb_run, vsb)
                cbest = torch.where(valid & better, IN_VERT, cbest)

            for e in range(max_in):
                u = band_in_t[e]                         # (B, F)
                inb = (u >= 0) & (u < B)
                uc = u.clamp(0, B - 1)
                uvp = torch.where(inb, evp.gather(0, uc), 0)
                uvn = torch.where(inb, evn.gather(0, uc), 0)
                usb = torch.where(inb, esb.gather(0, uc), BIG)
                valid = (u >= 0) & slot_active & (usb < BIG)
                if prev_exists:
                    ubs = usb - popcount32(uvp) + popcount32(uvn)
                    hin = (prev_ssb - ubs).clamp(-1, 1)
                    hin = torch.where(prev_ssb >= BIG, 1, hin)
                else:
                    hin = 1
                avp, avn, asb, _ = advance_word(uvp, uvn, usb, eq0, hin)
                avp = torch.where(valid, avp, ONES)
                avn = torch.where(valid, avn, 0)
                asb = torch.where(valid, asb, BIG)
                acc.add(avp, avn, asb)
                better = asb < csb_run
                csb_run = torch.minimum(csb_run, asb)
                cbest = torch.where(valid & better, u, cbest)

            cvp, cvn, csb = acc.pack()
            if not prev_exists:
                len0 = is_seed & (slot_len_t == 0)
                cvp = torch.where(len0, b0_vp, cvp)
                cvn = torch.where(len0, b0_vn, cvn)
                csb = torch.where(len0, b0_sb, csb)
                cbest = torch.where(len0, IN_SEED, cbest)
            col0_sb = csb

            sr = em_score(cvp, cvn, csb)
            best_sc = torch.where(at_end & slot_active, sr, BIG)
            best_cl = full(0)

            wvp, wvn, wsb = cvp, cvn, csb
            hp_acc, hn_acc = full(0), full(0)
            short = slot_len_t <= 1
            evp_c = torch.where(short, wvp, 0)
            evn_c = torch.where(short, wvn, 0)
            esb_c = torch.where(short, wsb, BIG)
            for c in range(1, W):
                eqc = eq_col(req_s, c)
                if prev_exists:
                    hin = ((prev_hp >> c) & 1) - ((prev_hn >> c) & 1)
                else:
                    hin = 1
                wvp, wvn, wsb, hout = advance_word(wvp, wvn, wsb, eqc, hin)
                hp_acc = hp_acc | ((hout > 0).to(i64) << c)
                hn_acc = hn_acc | ((hout < 0).to(i64) << c)
                sr = em_score(wvp, wvn, wsb)
                upd = at_end & (c < slot_len_t) & (sr < best_sc)
                best_sc = torch.where(upd, sr, best_sc)
                best_cl = torch.where(upd, c, best_cl)
                cap = c == slot_len_t - 1
                evp_c = torch.where(cap, wvp, evp_c)
                evn_c = torch.where(cap, wvn, evn_c)
                esb_c = torch.where(cap, wsb, esb_c)
            esb_c = torch.where(slot_active | (is_seed & (slot_len_t == 0)),
                                esb_c, BIG)

            evp = torch.where(lvl, evp_c, evp)
            evn = torch.where(lvl, evn_c, evn)
            esb = torch.where(lvl, esb_c, esb)
            n_ssb = torch.where(lvl, col0_sb, n_ssb)
            n_hp = torch.where(lvl, hp_acc, n_hp)
            n_hn = torch.where(lvl, hn_acc, n_hn)
            improved = lvl & (best_sc < end_score)
            end_score = torch.where(improved, best_sc, end_score)
            end_col = torch.where(improved, best_cl, end_col)
            bin_s = torch.where(lvl, cbest, bin_s)
        ssb, hp, hn = n_ssb, n_hp, n_hn
        best_in_slices.append(bin_s)

        if want_xcells:
            # the best X cell of this slice's end words: per slot the
            # first best row, then the lowest slot, then (below) the
            # earliest slice, each by strict >
            ok0 = slot_active & (esb < BIG)
            xv, xr = full(-BIG), full(0)
            for r in range(W):
                m = int(_ABOVE[r])
                srow = esb - popcount32(evp & m) + popcount32(evn & m)
                grow = s * W + r
                x = torch.where(ok0 & (grow < frag_len), grow + 1 - 5 * srow,
                                -BIG)
                hit = x > xv
                xv = torch.where(hit, x, xv)
                xr = torch.where(hit, grow, xr)
            sv, sr_ = xv[0][None], xr[0][None]
            sb_slot = torch.zeros((1, F), dtype=i64, device=dev)
            for b in range(1, B):
                hit = xv[b][None] > sv
                sv = torch.where(hit, xv[b][None], sv)
                sb_slot = torch.where(hit, b, sb_slot)
                sr_ = torch.where(hit, xr[b][None], sr_)
            hit = sv > xbest
            xbest = torch.where(hit, sv, xbest)
            xslot = torch.where(hit, sb_slot, xslot)
            xrow = torch.where(hit, sr_, xrow)

    # reduction over slots: strict <, so the lowest slot wins ties
    best_score = end_score[0][None]
    best_slot = torch.zeros((1, F), dtype=i64, device=dev)
    best_col = end_col[0][None]
    for b in range(1, B):
        better = end_score[b][None] < best_score
        best_score = torch.where(better, end_score[b][None], best_score)
        best_slot = torch.where(better, b, best_slot)
        best_col = torch.where(better, end_col[b][None], best_col)
    out = [best_score, best_slot, best_col, torch.stack(best_in_slices, 0)]
    if want_state:
        out += [ssb, hp, hn]
    if want_xcells:
        out += [xbest, xslot, xrow]
    return tuple(out)


def lane_major(node_eq, node_len, band_nodes, band_in, seed_shift, req,
               frag_len, band_level):
    """The core's lane-major inputs from fragment-major batch tensors:
    each slot's Eq planes and length gathered from the node tables and
    trimmed by its seed shift: seed_shift (F,) trims slot 0 only (a fresh
    window), (F, B) every slot (a carried window keeps the seed node
    trimmed wherever it lands).  Words may come as int64 or as int32 bit
    patterns.  Returns the first seven arguments of `_frag_core_t` (int64
    words)."""
    F, B = band_nodes.shape
    N2 = node_eq.shape[0]
    i64 = torch.int64
    ids = band_nodes.to(i64)
    idc = ids.clamp(0, N2 - 1)
    slot_eq = node_eq[idc].to(i64) & MASK32                  # (F, B, 4)
    slot_len = torch.where(ids >= 0, node_len[idc].to(i64), 0)
    if seed_shift.dim() == 2:
        shift = seed_shift.to(i64)
    else:
        shift = torch.zeros((F, B), dtype=i64, device=ids.device)
        shift[:, 0] = seed_shift.to(i64)
    slot_eq = slot_eq >> (shift & 31)[..., None]
    slot_len = slot_len - shift
    return (slot_eq.permute(2, 1, 0).contiguous(),
            slot_len.t().contiguous(),
            band_in.to(i64).permute(2, 1, 0).contiguous(),
            band_level.to(i64).t().contiguous(),
            u32(req).permute(1, 2, 0).contiguous(),
            frag_len.to(i64)[None, :],
            torch.zeros((1, F), dtype=i64, device=ids.device))


def align_fragments_tl(node_eq, node_len, band_nodes, band_in, seed_shift,
                       req, frag_len, n_slices: int, max_in: int,
                       band_level, n_levels: int) -> FragResult:
    """Fragment DP on fragment-major inputs (frag_align.align_fragments_tl,
    fresh windows).

    node_eq:    (N2, 4) words of the resident node table (fwd ++ reversed)
    node_len:   (N2,) node lengths
    band_nodes: (F, B) slot node ids into the tables, -1 = pad
    band_in:    (F, B, max_in) in-edge slot ids, -1 = none
    seed_shift: (F,) columns trimmed from slot 0's start
    req:        (F, S, 4) read row planes per slice (32-bit words)
    frag_len:   (F,) fragment rows;  band_level: (F, B), -1 = pad
    n_levels:   level-loop trip count (> max level)

    All tensors on one device; on a CUDA device they come in the host
    types of frag_kernel.frag_core_cuda and the CUDA kernel runs, on the
    CPU lane_major + `_frag_core_t`."""
    from graphchainer_torch.ops.frag_kernel import frag_core
    return frag_core(node_eq, node_len, band_nodes, band_in, band_level,
                     seed_shift, req, frag_len, S=n_slices, max_in=max_in,
                     n_levels=n_levels)


def align_fragments(node_eq, node_len, band_nodes, band_in, seed_shift, req,
                    frag_len, n_slices: int, max_in: int, seed_base=None,
                    full_start: bool = False, band_level=None,
                    n_levels: Optional[int] = None, carry_in=None,
                    want_xcells: bool = False) -> WideResult:
    """The F-major banded DP (graphchainer_tpu.ops.frag_align.
    align_fragments), with every argument of the JAX function:

    node_eq:    (N2, 4) words of the resident node table (fwd ++ reversed)
    node_len:   (N2,) node lengths
    band_nodes: (F, B) slot node ids into the tables, -1 = pad
    band_in:    (F, B, max_in) in-edge slot ids, -1 = none
    seed_shift: (F,) columns trimmed from slot 0, or (F, B) from every slot
    req:        (F, S, 4) read row planes per 32-row slice
    frag_len:   (F,) fragment rows
    seed_base:  (F,) score injected at the seed boundary (None: 0)
    full_start: inject the boundary word at every active slot on slice 0
                and merge a free-start word into every column of every
                slice (free alignment start anywhere: optimal mode and
                seedless DP)
    band_level: (F, B) topo level per slot, -1 = pad (None: the slot index)
    n_levels:   level-loop trip count (> the largest level)
    carry_in:   (ssb, hp, hn) each (F, B): continue a previous call's state
    want_xcells: also return the best X-score cell

    On a CUDA tensor the kernel runs (ops/frag_kernel.frag_wide_cuda: no
    carry_in, no want_xcells, no state out; it raises on anything it does
    not take); on a CPU tensor the plain version."""
    if band_nodes.is_cuda:
        if carry_in is not None or want_xcells:
            raise ValueError("align_fragments on CUDA: the kernel takes no "
                             "carry_in and no want_xcells")
        from graphchainer_torch.ops.frag_kernel import frag_wide_cuda
        if band_level is None:
            F, B = band_nodes.shape
            band_level = torch.arange(B, dtype=torch.int32,
                                      device=band_nodes.device
                                      ).expand(F, B).contiguous()
            n_levels = B
        return frag_wide_cuda(node_eq, node_len, band_nodes, band_in,
                              band_level, seed_shift, req, frag_len,
                              seed_base, S=n_slices, max_in=max_in,
                              n_levels=n_levels, full_start=full_start)
    return align_fragments_plain(
        node_eq, node_len, band_nodes, band_in, seed_shift, req, frag_len,
        n_slices, max_in, seed_base=seed_base, full_start=full_start,
        band_level=band_level, n_levels=n_levels, carry_in=carry_in,
        want_xcells=want_xcells)


def _expand(vp, vn, sb):
    """(k,) words -> their boundary score (k,) and 32 row scores (k, 32)."""
    above = _ABOVE_T.to(vp.device)
    rows = (sb[:, None] - popcount32(vp[:, None] & above)
            + popcount32(vn[:, None] & above))
    return sb - popcount32(vp) + popcount32(vn), rows


def _pack(before, rows):
    """Rebuild (vp, vn, sb) from a boundary score and 32 row scores."""
    prev = torch.cat([before[:, None], rows[:, :-1]], dim=1)
    d = rows - prev
    bit = _BITVAL_T.to(d.device)
    return (((d == 1).to(torch.int64) * bit).sum(dim=1),
            ((d == -1).to(torch.int64) * bit).sum(dim=1), rows[:, W - 1])


def align_fragments_plain(node_eq, node_len, band_nodes, band_in, seed_shift,
                          req, frag_len, n_slices: int, max_in: int,
                          seed_base=None, full_start: bool = False,
                          band_level=None, n_levels: Optional[int] = None,
                          carry_in=None, want_xcells: bool = False,
                          want_state: bool = True) -> WideResult:
    """align_fragments in plain torch, on tensors of any device.  The
    slots of one level are gathered and advanced together (the JAX
    function advances every slot and commits a level's: the same values);
    a free-start merge that cannot change a word is skipped (its word lies
    on or above the column's on every row).  Returns int32 best_score /
    best_slot / best_col (F,), best_in (F, B, S) int8 for B <= 127 and
    int16 above, int32 end_score / end_col (F, B), the last slice's state
    out_ssb (int32) and out_hp / out_hn (uint32 bits in int32) (F, B)
    (want_state=False: none, and the columns past each slot's length,
    which reach only them, are skipped), and with want_xcells int32 xbest
    / xslot / xrow (F,)."""
    F, B = band_nodes.shape
    S = n_slices
    dev = band_nodes.device
    i64 = torch.int64
    N = F * B
    N2 = node_eq.shape[0]
    ptr_dtype = torch.int8 if B <= 127 else torch.int16
    if band_level is None:
        band_level = torch.arange(B, device=dev).expand(F, B)
        n_levels = B
    assert n_levels is not None

    ids = band_nodes.to(i64)
    idc = ids.clamp(0, N2 - 1)
    slot_eq = u32(node_eq[idc])                              # (F, B, 4)
    slot_len = torch.where(ids >= 0, node_len[idc].to(i64), 0)
    if seed_shift.dim() == 2:
        shift = seed_shift.to(i64)
    else:
        shift = torch.zeros((F, B), dtype=i64, device=dev)
        shift[:, 0] = seed_shift.to(i64)
    slot_eq = (slot_eq >> (shift & 31)[..., None]).reshape(N, 4)
    slot_len = (slot_len - shift).reshape(N)
    active = slot_len > 0
    fo = torch.arange(N, device=dev) // B                   # fragment of slot
    is_seed = torch.arange(N, device=dev) % B == 0
    lvl = band_level.to(i64).reshape(N)
    bi = band_in.to(i64).reshape(N, max_in)
    bi_flat = fo[:, None] * B + bi.clamp(0, B - 1)
    req64 = u32(req)                                         # (F, S, 4)
    flen = frag_len.to(i64)
    end_slice = torch.div(flen - 1, W, rounding_mode="floor")[fo]
    er = torch.remainder(flen - 1, W)
    erm = torch.where(er < W - 1, (ONES << (er + 1)) & MASK32,
                      torch.zeros_like(er))[fo]
    base = (torch.zeros(F, dtype=i64, device=dev) if seed_base is None
            else seed_base.to(i64))[fo]
    colv = torch.arange(W, device=dev)

    def full(v):
        return torch.full((N,), v, dtype=i64, device=dev)

    evp, evn, esb = full(0), full(0), full(BIG)
    carried = carry_in is not None
    if carried:
        ssb = carry_in[0].to(i64).reshape(N)
        hp = u32(carry_in[1]).reshape(N)
        hn = u32(carry_in[2]).reshape(N)
    else:
        ssb, hp, hn = full(BIG), full(0), full(0)
    end_score, end_col = full(BIG), full(0)
    best_in = torch.full((N, S), IN_NONE, dtype=i64, device=dev)
    xbest = torch.full((F,), -BIG, dtype=i64, device=dev)
    xslot = torch.zeros(F, dtype=i64, device=dev)
    xrow = torch.zeros(F, dtype=i64, device=dev)
    levels = [torch.nonzero(lvl == lv).flatten() for lv in range(n_levels)]
    levels = [sel for sel in levels if sel.numel()]

    for s in range(S):
        prev_exists = s > 0 or carried
        n_ssb, n_hp, n_hn = full(BIG), full(0), full(0)
        bin_s = full(IN_NONE)
        for sel in levels:
            k = sel.numel()
            ln, act, seed = slot_len[sel], active[sel], is_seed[sel]
            rq = req64[fo[sel], s]                           # (k, 4)
            bits = (slot_eq[sel][:, :, None] >> colv) & 1    # (k, 4, 32)
            eqs = (rq[:, :, None] * bits).sum(dim=1)         # (k, 32)
            eq0 = eqs[:, 0]
            b0 = base[sel]
            before = torch.full((k,), BIG, dtype=i64, device=dev)
            rows = torch.full((k, W), BIG, dtype=i64, device=dev)
            csb = torch.full((k,), BIG, dtype=i64, device=dev)
            cbest = torch.full((k,), IN_NONE, dtype=i64, device=dev)

            def add(wvp, wvn, wsb, valid, code, before=before, rows=rows):
                nonlocal csb, cbest
                wvp = torch.where(valid, wvp, ONES)
                wvn = torch.where(valid, wvn, 0)
                wsb = torch.where(valid, wsb, BIG)
                b_, r_ = _expand(wvp, wvn, wsb)
                torch.minimum(before, b_, out=before)
                torch.minimum(rows, r_, out=rows)
                better = wsb < csb
                cbest = torch.where(valid & better, code, cbest)
                csb = torch.minimum(csb, wsb)

            pssb = ssb[sel]
            if not prev_exists:
                valid = (act | seed) if full_start else seed
                svp, svn, ssb_ = source_word(b0)
                avp, avn, asb, _ = advance_word(svp, svn, ssb_, eq0, 1)
                add(avp, avn, asb, valid, IN_SEED)
            else:
                vvp, vvn, vsb = source_word(pssb)
                add(vvp, vvn, vsb, act & (pssb < BIG), IN_VERT)
            for e in range(max_in):
                u = bi[sel, e]
                uf = bi_flat[sel, e]
                uvp, uvn, usb = evp[uf], evn[uf], esb[uf]
                valid = (u >= 0) & act & (usb < BIG)
                if prev_exists:
                    ubs = usb - popcount32(uvp) + popcount32(uvn)
                    hin = torch.where(pssb >= BIG, 1,
                                      (pssb - ubs).clamp(-1, 1))
                else:
                    hin = 1
                avp, avn, asb, _ = advance_word(uvp, uvn, usb, eq0, hin)
                add(avp, avn, asb, valid, u)
            cvp, cvn, cs = _pack(before, rows)
            cbefore = before
            if not prev_exists:
                len0 = seed & (ln == 0)
                svp, svn, ssb_ = source_word(b0)
                cvp = torch.where(len0, svp, cvp)
                cvn = torch.where(len0, svn, cvn)
                cs = torch.where(len0, ssb_, cs)
                cbefore = torch.where(len0, b0, cbefore)
                cbest = torch.where(len0, IN_SEED, cbest)
            col0_sb = cs

            at_end = end_slice[sel] == s
            # columns past a slot's length reach no output but the state
            # bits of the last slice: without want_state they are skipped
            ncol = W - 1 if want_state else int(
                ln.clamp(1, W).max()) - 1
            if prev_exists:
                hbits = torch.stack([hp[sel], hn[sel]])[:, :, None] >> colv
                hpos, hneg = hbits[0] & 1, hbits[1] & 1      # (k, 32)
            else:
                hpos, hneg = 1, 0
            if full_start:
                fbase = b0 + W * s
                fvp, fvn, fsb = source_word(fbase)
                fvp, fvn, fsb, _ = advance_word(
                    fvp[:, None], fvn[:, None], fsb[:, None], eqs,
                    0 if s == 0 else 1)                      # (k, 32)
            wvp, wvn, wsb, wb = cvp, cvn, cs, cbefore
            words = [(wvp, wvn, wsb)]
            houts = []
            for c in range(1, ncol + 1):
                hp_c = hpos if isinstance(hpos, int) else hpos[:, c]
                hn_c = hneg if isinstance(hneg, int) else hneg[:, c]
                eq = eqs[:, c] | hn_c
                xv = eq | wvn
                xh = ((((eq & wvp) + wvp) & MASK32) ^ wvp) | eq
                ph = wvn | (~(xh | wvp) & MASK32)
                mh = wvp & xh
                op, on = ph >> 31, mh >> 31
                houts.append((op, on))
                ph = ((ph << 1) & MASK32) | hp_c
                mh = ((mh << 1) & MASK32) | hn_c
                wvp, wvn = mh | (~(xv | ph) & MASK32), ph & xv
                wsb = wsb + op - on
                wb = wb + hp_c - hn_c
                if full_start:
                    fvalid = act & (c < ln)
                    # the free-start word lies on or above the column's
                    # word on every row unless the column's boundary score
                    # reaches its (or the invalid word's) bound
                    need = wb >= torch.where(fvalid, fbase, BIG - W + 1)
                    if bool(need.any()):
                        m_vp = torch.where(fvalid, fvp[:, c], ONES)
                        m_vn = torch.where(fvalid, fvn[:, c], 0)
                        m_sb = torch.where(fvalid, fsb[:, c], BIG)
                        b1, r1 = _expand(wvp, wvn, wsb)
                        b2, r2 = _expand(m_vp, m_vn, m_sb)
                        nb = torch.minimum(b1, b2)
                        pvp, pvn, psb = _pack(nb, torch.minimum(r1, r2))
                        wvp = torch.where(need, pvp, wvp)
                        wvn = torch.where(need, pvn, wvn)
                        wsb = torch.where(need, psb, wsb)
                        wb = torch.where(need, nb, wb)
                words.append((wvp, wvn, wsb))
            if houts:
                ho = torch.stack([torch.stack(h, 1) for h in zip(*houts)])
                ho = ho << colv[1:ncol + 1]                  # (2, k, ncol)
                hp_acc, hn_acc = ho[0].sum(1), ho[1].sum(1)
            else:
                hp_acc = hn_acc = torch.zeros(k, dtype=i64, device=dev)
            wv = [torch.stack(x, 1) for x in zip(*words)]    # (k, ncol+1)
            # the slot's end word: column len - 1 (column 0 for len <= 1;
            # none for a slot longer than 32 columns)
            pick = (ln - 1).clamp(0, ncol)[:, None]
            long_ = ln > W
            evp_c = torch.where(long_, 0, wv[0].gather(1, pick)[:, 0])
            evn_c = torch.where(long_, 0, wv[1].gather(1, pick)[:, 0])
            esb_c = torch.where(long_, BIG, wv[2].gather(1, pick)[:, 0])
            esb_c = torch.where(act | (seed & (ln == 0)), esb_c, BIG)
            # the best end-row cell: column 0 (an active slot), then the
            # first strictly lower column inside the slot
            if bool(at_end.any()):
                m = erm[sel][:, None]
                sr = wv[2] - popcount32(wv[0] & m) + popcount32(wv[1] & m)
                inside = colv[:ncol + 1][None, :] < ln[:, None]
                inside[:, 0] = True
                sr = torch.where(inside, sr, 4 * BIG)
                best_sc = sr.min(dim=1).values
                best_cl = (sr == best_sc[:, None]).to(torch.int8).argmax(1)
                ok = at_end & act
                best_sc = torch.where(ok, best_sc, BIG)
                best_cl = torch.where(ok, best_cl, 0)
            else:
                best_sc = torch.full((k,), BIG, dtype=i64, device=dev)
                best_cl = torch.zeros(k, dtype=i64, device=dev)

            evp[sel], evn[sel], esb[sel] = evp_c, evn_c, esb_c
            n_ssb[sel], n_hp[sel], n_hn[sel] = col0_sb, hp_acc, hn_acc
            improved = best_sc < end_score[sel]
            end_score[sel] = torch.where(improved, best_sc, end_score[sel])
            end_col[sel] = torch.where(improved, best_cl, end_col[sel])
            bin_s[sel] = cbest
        ssb, hp, hn = n_ssb, n_hp, n_hn
        best_in[:, s] = bin_s
        if want_xcells:
            _, srow = _expand(evp, evn, esb)                 # (N, 32)
            grow = s * W + colv
            ok = ((active & (esb < BIG))[:, None]
                  & (grow[None, :] < flen[fo][:, None]))
            xs = torch.where(ok, (grow + 1)[None, :] - 5 * srow, -BIG)
            xf = xs.reshape(F, B * W)
            val = xf.max(dim=1).values
            arg = (xf == val[:, None]).to(torch.int8).argmax(dim=1)
            better = val > xbest
            xbest = torch.where(better, val, xbest)
            xslot = torch.where(better, arg // W, xslot)
            xrow = torch.where(better, s * W + arg % W, xrow)

    es = end_score.reshape(F, B)
    ec = end_col.reshape(F, B)
    best_score = es.min(dim=1).values
    best_slot = (es == best_score[:, None]).to(torch.int8).argmax(dim=1)
    best_col = ec.gather(1, best_slot[:, None])[:, 0]
    i32 = torch.int32
    out = dict(best_score=best_score.to(i32), best_slot=best_slot.to(i32),
               best_col=best_col.to(i32),
               best_in=best_in.reshape(F, B, S).to(ptr_dtype),
               end_score=es.to(i32), end_col=ec.to(i32))
    if want_state:
        out.update(out_ssb=ssb.reshape(F, B).to(i32),
                   out_hp=to_i32_bits(hp.reshape(F, B)),
                   out_hn=to_i32_bits(hn.reshape(F, B)))
    if want_xcells:
        out.update(xbest=xbest.to(i32), xslot=xslot.to(i32),
                   xrow=xrow.to(i32))
    return WideResult(**out)

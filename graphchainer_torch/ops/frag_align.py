"""Banded fragment-to-graph DP (the CLC fragment stage and GA mode's
extension windows) in torch.

Port of graphchainer_tpu/ops/frag_align.py: the lane-major core
`_frag_core_t` as plain torch, with its fresh windows (the CLC path) and
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
                                          source_word, u32)

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

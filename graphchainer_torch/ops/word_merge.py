"""The word tricks of csrc/frag_wide.cu's merges and of frag_core.cu's
carried entry, in torch, for the tests.

The CUDA kernel merges Myers words (vp, vn and the score at the boundary
row above the word; row r scores the boundary plus the +1 bits minus the
-1 bits of rows 0..r) with word operations in place of a loop over the
32 rows.  These functions run the same steps on int64 tensors holding
32-bit words (ops/myers.py's convention), so the CPU tests can hold each
trick to the row-by-row min (`merge_words_rows`), which is what the
kernel's earlier loop and the plain versions compute:

- `merge_words_swar`: the general merge.  Popcount bounds settle most
  pairs; otherwise the difference of the two words' row scores runs as
  four byte lanes (rows 8k + j in byte k, biased by 127), and the parity
  of the difference (a prefix XOR) gives the rows where the lower word
  changes.
- `merge_free_start`: the merge with a column's free-start word, whose
  row r scores fbase + r + 1 - [a match in rows 0..r]: a binary search of
  popcounts for the first row where the word comes within one of
  fbase + r.

And the carried entry's (csrc/frag_core.cu, frag_carried_kernel), a lane
a row:

- `merge_words_lanes`: column 0's merge of any number of candidates, each
  row score from two masked popcounts, the min over candidates, repacked
  as the ballots of the rows where the min moves by +1 / -1; held to the
  plain version's 33-row merge (frag_align._MergeAcc).
- `x_scan_lanes`: the best X cell of an end word, the max over the rows'
  X and the first row at it; held to the row loop (`x_scan_rows`).
- `split_columns`: the columns below a slot's length (the chain the next
  level waits on) and its tail (the columns past it, which feed only the
  state out), each entered by its own part of the slice before's bits;
  held to all 31 columns run at once (`whole_columns`).

No route of the port calls them; the kernels are held to the plain
versions on the card.
"""
from __future__ import annotations

import torch

from graphchainer_torch.ops.myers import (MASK32, ONES, W, advance_word,
                                          popcount32, source_word)

BYTE_LSB = 0x01010101


def _low_rows(r: torch.Tensor) -> torch.Tensor:
    """Mask of rows 0..r (0 <= r < 32) per element."""
    return torch.where(r >= W - 1, ONES, (2 << r.clamp(max=W - 2)) - 1)


def merge_words_rows(avp, avn, ba, bvp, bvn, bb):
    """Elementwise min of two words' row scores, row by row: the scores
    from each boundary down, the min of the boundaries and of each row,
    and a +1 / -1 bit where the min moves by exactly one.  Returns (vp,
    vn, sb, boundary)."""
    s1, s2 = ba.clone(), bb.clone()
    prev = torch.minimum(s1, s2)
    before = prev.clone()
    vp = torch.zeros_like(avp)
    vn = torch.zeros_like(avp)
    for r in range(W):
        s1 = s1 + ((avp >> r) & 1) - ((avn >> r) & 1)
        s2 = s2 + ((bvp >> r) & 1) - ((bvn >> r) & 1)
        m = torch.minimum(s1, s2)
        d = m - prev
        vp = vp | ((d == 1).to(torch.int64) << r)
        vn = vn | ((d == -1).to(torch.int64) << r)
        prev = m
    return vp, vn, prev, before


def byte_popcount(x: torch.Tensor) -> torch.Tensor:
    """The set bits of each byte of 32-bit words, one count a byte."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    return (x + (x >> 4)) & 0x0F0F0F0F


def merge_words_swar(avp, avn, ba, bvp, bvn, bb):
    """merge_words_rows by word operations (csrc/frag_wide.cu merge2)."""
    pa, na = avp & ~avn & MASK32, avn & ~avp & MASK32
    pb, nb = bvp & ~bvn & MASK32, bvn & ~bvp & MASK32
    d0 = ba - bb
    all_a = d0 + popcount32(pa) + popcount32(nb) <= 0
    all_b = d0 - popcount32(na) - popcount32(pb) >= 1
    # byte k of v: 127 + d at row 8k - 1, then each row of the byte; kept
    # to the pairs where |d| <= 64, the others take all_a / all_b
    up = byte_popcount(pa) + byte_popcount(nb)
    dn = byte_popcount(na) + byte_popcount(pb)
    d0c = d0.clamp(-63, 64)
    v = ((127 + d0c) * BYTE_LSB + ((up << 8) * BYTE_LSB)
         - ((dn << 8) * BYTE_LSB)) & MASK32
    cb = torch.zeros_like(v)
    for j in range(8):
        v = (v + ((pa >> j) & BYTE_LSB) + ((nb >> j) & BYTE_LSB)) & MASK32
        v = (v - ((na >> j) & BYTE_LSB) - ((pb >> j) & BYTE_LSB)) & MASK32
        cb = cb | ((v & 0x80808080) >> (7 - j))
    cb = torch.where(all_a, 0, torch.where(all_b, ONES, cb))
    px = pa ^ na ^ pb ^ nb
    for sh in (1, 2, 4, 8, 16):
        px = (px ^ (px << sh)) & MASK32
    even = (~px & MASK32) ^ torch.where((d0 & 1) == 1, ONES, 0)
    cbp = ((cb << 1) & MASK32) | (d0 >= 1).to(torch.int64)
    ncb, ncbp, neven = ~cb & MASK32, ~cbp & MASK32, ~even & MASK32
    keep_a, keep_b = ncb & ncbp, cb & cbp
    to_a, to_b = ncb & cbp, cb & ncbp
    vp = (keep_a & pa) | (keep_b & pb) | (to_a & even & pb)
    vn = ((keep_a & na) | (keep_b & nb) | (to_a & even & nb)
          | (to_a & neven & ~(pb | nb) & MASK32)
          | (to_b & neven & ~(pa | na) & MASK32) | (to_b & even & pa))
    sb = torch.where((cb >> 31) == 1,
                     bb + popcount32(pb) - popcount32(nb),
                     ba + popcount32(pa) - popcount32(na))
    return vp, vn, sb, torch.minimum(ba, bb)


def free_start_word(eq, fbase, hin: int):
    """The free-start word of a column (the all-insertion column of bottom
    score fbase + 32 advanced into it with hin 0 at slice 0 and 1 after):
    (vp, vn, sb, boundary)."""
    vp, vn, sb = source_word(fbase)
    vp, vn, sb, _ = advance_word(vp, vn, sb, eq, hin)
    return vp, vn, sb, fbase + hin


def merge_free_start(vp, vn, wb, eq, fbase, hin: int):
    """merge_words_rows of a word (boundary wb) with free_start_word(eq,
    fbase, hin), in closed form (csrc/frag_wide.cu merge_free)."""
    pa, na = vp & ~vn & MASK32, vn & ~vp & MASK32
    ua = ~pa & MASK32
    c0 = wb - fbase + 1

    def units(r):
        m = _low_rows(r)
        return popcount32(ua & m) + popcount32(na & m)

    p1 = torch.zeros_like(c0)
    for st in (16, 8, 4, 2, 1):
        p1 = torch.where(units(p1 + st - 1) < c0, p1 + st, p1)
    p1 = torch.where(units(torch.full_like(c0, W - 1)) < c0, W, p1)
    p1 = torch.where(c0 > 0, p1, 0)
    # the first match row (32: none)
    k = torch.full_like(eq, W)
    for r in range(W - 1, -1, -1):
        k = torch.where(((eq >> r) & 1) == 1, r, k)
    lo = torch.where(p1 >= W, ONES, (1 << p1.clamp(max=W - 1)) - 1)
    hi = torch.where(p1 >= W - 1, 0, (ONES << (p1 + 1).clamp(max=W - 1))
                     & MASK32)
    kbit = torch.where(k < W, 1 << k.clamp(max=W - 1), 0)
    mvp = ((~kbit & MASK32) & lo) | (pa & hi)
    mvn = na & hi
    inner = (p1 >= 1) & (p1 <= W - 1)
    pc = p1.clamp(1, W - 1)
    delta = (c0 - units(pc)) - (k >= pc).to(torch.int64) + 1
    mvp = mvp | torch.where(inner & (delta == 1), 1 << pc, 0)
    mvn = mvn | torch.where(inner & (delta == -1), 1 << pc, 0)
    fb = fbase + hin
    mb = torch.minimum(wb, fb)
    m0 = torch.where(p1 == 0, wb + (pa & 1) - (na & 1), fbase + 1 - (eq & 1))
    mvp = (mvp & ~1 & MASK32) | (m0 - mb == 1).to(torch.int64)
    mvn = (mvn & ~1 & MASK32) | (m0 - mb == -1).to(torch.int64)
    sb = torch.where(p1 == W, fbase + W - (eq != 0).to(torch.int64),
                     wb + popcount32(pa) - popcount32(na))
    return mvp, mvn, sb, mb


BIG = 1 << 28
INT_MIN = -(1 << 31)
_LANES = torch.arange(W, dtype=torch.int64)


def merge_words_lanes(words):
    """The merge of candidate words [(vp, vn, sb), ...] (int64 tensors of
    one shape), as the carried kernel's main warp runs it with lane r
    holding row r: the first word as it is when it is alone, else the min
    of every word's row scores (from BIG), repacked.  Returns (vp, vn,
    sb)."""
    if len(words) == 1:
        return words[0]
    low = _low_rows(_LANES)                            # (32,) rows 0..r
    bmin = rmin = None
    for vp, vn, sb in words:
        bef = sb - popcount32(vp) + popcount32(vn)
        row = (bef[..., None] + popcount32(vp[..., None] & low)
               - popcount32(vn[..., None] & low))
        bmin = (torch.minimum(bef, torch.full_like(bef, BIG)) if bmin is None
                else torch.minimum(bmin, bef))
        rmin = (torch.minimum(row, torch.full_like(row, BIG)) if rmin is None
                else torch.minimum(rmin, row))
    up = torch.cat([bmin[..., None], rmin[..., :-1]], dim=-1)  # shfl_up
    d = rmin - up
    vp = ((d == 1).to(torch.int64) << _LANES).sum(-1)          # ballots
    vn = ((d == -1).to(torch.int64) << _LANES).sum(-1)
    return vp, vn, rmin[..., W - 1]


def x_scan_rows(evp, evn, esb, s: int, nr):
    """The X cell of an end word, row by row (the reference's loop): X =
    s 32 + r + 1 - 5 score(r) over rows r < nr, the first strictly best
    from -BIG.  Returns (X, row): (-BIG, 0) when no row passes -BIG."""
    sv = torch.full_like(esb, -BIG)
    srow = torch.zeros_like(esb)
    sr = esb - popcount32(evp) + popcount32(evn)
    for r in range(W):
        sr = sr + ((evp >> r) & 1) - ((evn >> r) & 1)
        x = s * W + r + 1 - 5 * sr
        hit = (r < nr) & (x > sv)
        sv = torch.where(hit, x, sv)
        srow = torch.where(hit, r, srow)
    return sv, srow


def x_scan_lanes(evp, evn, esb, s: int, nr):
    """x_scan_rows a lane a row: every row's X from two masked popcounts
    (rows past nr INT_MIN), its max (__reduce_max_sync) and the first row
    at it (the ballot's lowest bit).  Returns (max, row); the kernel
    counts a max only above -BIG."""
    low = _low_rows(_LANES)
    bef = esb - popcount32(evp) + popcount32(evn)
    sr = (bef[..., None] + popcount32(evp[..., None] & low)
          - popcount32(evn[..., None] & low))
    nr = torch.as_tensor(nr)
    nr = nr[..., None] if nr.dim() else nr
    x = torch.where(_LANES < nr, s * W + _LANES + 1 - 5 * sr, INT_MIN)
    m = x.max(dim=-1).values
    row = (x == m[..., None]).to(torch.int64).argmax(dim=-1)
    return m, row


def _columns(vp, vn, eq_cols, hp, hn, lo, hi):
    """Columns lo .. hi - 1 (lo, hi tensors) of the recurrence from the
    word (vp, vn), each entered by bit c of hp / hn; the bottom-row
    moves of those columns as bits, and the word after them."""
    tp = torch.zeros_like(vp)
    tn = torch.zeros_like(vp)
    sb = torch.zeros_like(vp)
    for c in range(1, W):
        hin = ((hp >> c) & 1) - ((hn >> c) & 1)
        nvp, nvn, _, hout = advance_word(vp, vn, sb, eq_cols[c], hin)
        run = (c >= lo) & (c < hi)
        vp = torch.where(run, nvp, vp)
        vn = torch.where(run, nvn, vn)
        tp = tp | ((run & (hout > 0)).to(torch.int64) << c)
        tn = tn | ((run & (hout < 0)).to(torch.int64) << c)
    return vp, vn, tp, tn


def whole_columns(vp, vn, eq_cols, hp, hn):
    """All 31 columns of a slice from its column-0 word, entered by the
    slice before's bits: the bottom-row moves (hp, hn) of the state out."""
    one = torch.ones_like(vp)
    return _columns(vp, vn, eq_cols, hp, hn, one, W * one)[2:]


def split_columns(vp, vn, eq_cols, slen, hp, hn, thp, thn):
    """The same slice split as the carried kernel runs it: the main warp's
    columns 1 .. min(slen, 32) - 1 entered by the main bits (hp, hn), the
    aux warp's tail max(slen, 1) .. 31 from the word after them, entered
    by the tail bits (thp, thn).  Returns the new main and tail bits."""
    one = torch.ones_like(vp)
    top = torch.clamp(slen, max=W)
    mvp, mvn, mp, mn = _columns(vp, vn, eq_cols, hp, hn, one, top)
    _, _, tp, tn = _columns(mvp, mvn, eq_cols, thp, thn,
                            torch.clamp(slen, min=1), W * one)
    return mp, mn, tp, tn

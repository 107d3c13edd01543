"""Banded linear Myers alignment of a read against its path (polish).

Port of graphchainer_tpu/ops/linear_align.py, lane-major: reads are the
last axis.  `_polish_core_t` is the plain torch band fill (the CUDA
kernel of ops/polish_kernel.py computes the same dump);
`_score_from_dump_t` reads the global NW score off the dump and
`_backtrace_t` walks it back into edit ops; `_polish_walk_t` packs both
(the CUDA kernel of ops/polish_kernel.polish_walk computes the same
rows).  `polish_full_packed2` / `polish_full_packed` run the fill and the
walk on 2-bit base codes / 4-bit match nibbles and return one packed row
per read:
  word 0: score, word 1: n_ops (-1 when the walk left the band or
  overflowed ops_cap), word 2: touched, words 3..: 2-bit ops (16 per
  word), walk order (end -> start).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from graphchainer_torch.ops.myers import (_ABOVE, MASK32, ONES, W,
                                          popcount32, u32)

BIGS = 1 << 28
OP_MATCH, OP_DEL, OP_INS, OP_MISMATCH, OP_NONE = 0, 1, 2, 3, 255
WIN_EXTRA = 8     # plane-window words below the band

_I64 = torch.int64


def _above(rm: torch.Tensor) -> torch.Tensor:
    """Bits strictly above row rm (0..31) per element."""
    return torch.where(
        rm < W - 1,
        torch.bitwise_left_shift(torch.full_like(rm, ONES), rm + 1) & MASK32,
        torch.zeros_like(rm))


def _polish_core_t(planes_t, path_t, read_len, path_len, bw: int):
    """Banded NW fill, plain torch.

    planes_t: (4, RW, R) read plane words;  path_t: (P, R) path char masks
    Returns (dump_vp, dump_vn (P, bw, R) int64 words, dump_sb (P, bw, R)
    per-word bottom scores, dump_base (P, R) band top word per column).

    The band slides down by `shift` words per column (at most bw: a
    longer jump refills the whole band from the old bottom score).  The
    plane words of the band come from a rolling window of bw + WIN_EXTRA
    words: a read whose band moves by at most one word and whose window
    still holds bw valid words rolls it; any other read refills it from
    its planes.  At bw >= 2 the window's first bw words are always the
    band's own plane words; at bw = 1 a band that jumps two or more words
    a column leaves the rolled window behind it, as in the reference.
    The band bases, shifts and window bases depend on the lengths alone,
    so they are computed for every column first, and the match words a
    chunk of columns at a time.

    Each column advances its bw words with the horizontal delta entering
    each word from the one above (+1 at the top).  A word's result
    depends on that delta only through bit 0 of its match word (set for
    -1), so every word is advanced for both match words at once and the
    chain of deltas is resolved afterwards, one cheap step a word."""
    _, RW, R = planes_t.shape
    P = path_t.shape[0]
    dev = planes_t.device
    dump_vp = torch.empty((P, bw, R), dtype=_I64, device=dev)
    dump_vn = torch.empty_like(dump_vp)
    dump_sb = torch.empty_like(dump_vp)
    dump_base = torch.empty((P, R), dtype=_I64, device=dev)
    if P == 0:
        return dump_vp, dump_vn, dump_sb, dump_base
    with torch.inference_mode():
        _fill(u32(planes_t), u32(path_t), read_len, path_len, bw,
              (dump_vp, dump_vn, dump_sb, dump_base))
    return dump_vp, dump_vn, dump_sb, dump_base


FILL_CHUNK = 256     # columns whose match words are gathered at once


def _window_base(nb, shift, bw: int):
    """(P, R) plane word of each column's window word 0 (see
    _polish_core_t): the band base at bw >= 2; at bw = 1 the serial
    roll-or-refill of the window."""
    if bw > 1:
        return nb
    bwe = bw + WIN_EXTRA
    wb = torch.empty_like(nb)
    cur = nb[0].clone()
    valid = torch.full_like(cur, bwe)
    for col in range(nb.shape[0]):
        sh = shift[col]
        valid = valid - sh
        slow = (sh > 1) | (valid < bw)
        cur = torch.where(slow, nb[col], cur + (sh == 1).to(_I64))
        valid = torch.where(slow, bwe, valid)
        wb[col] = cur
    return wb


def _fill(planes_t, path_t, read_len, path_len, bw: int, dump):
    dump_vp, dump_vn, dump_sb, dump_base = dump
    _, RW, R = planes_t.shape
    P = path_t.shape[0]
    dev = planes_t.device
    rl = read_len.to(_I64)
    pl1 = path_len.to(_I64).clamp(min=1)
    rw_cap = torch.div(rl + W - 1, W, rounding_mode="floor")
    ub = (rw_cap - bw).clamp(min=0)
    scale = rl.to(torch.float32) / pl1.to(torch.float32)

    # band base of every column: the target row's word less half the band,
    # never moving up; the shift from the column before, clamped to bw
    cols = torch.arange(P, dtype=_I64, device=dev)[:, None]
    cc = torch.minimum(pl1[None, :] - 1, cols)
    target = (cc + 1).to(torch.float32) * scale[None, :]
    bb = (target * (1.0 / W)).to(torch.int32).to(_I64) - bw // 2
    bb = torch.minimum(bb.clamp(min=0), ub[None, :])
    nb = torch.cummax(bb, dim=0).values
    shift = (nb - torch.cat([bb[:1], nb[:-1]])).clamp(0, bw)
    wb = _window_base(nb, shift, bw)
    dump_base.copy_(nb)
    shifted = (shift != 0).any(dim=1).tolist()

    iota_w = torch.arange(bw, dtype=_I64, device=dev)[:, None]
    vps = torch.full((bw, R), ONES, dtype=_I64, device=dev)
    vns = torch.zeros((bw, R), dtype=_I64, device=dev)
    sbs = nb[0][None, :] * W + (iota_w + 1) * W
    for c0 in range(0, P, FILL_CHUNK):
        c1 = min(P, c0 + FILL_CHUNK)
        # match words of the chunk's columns: window word w of column c is
        # plane word wb[c] + w (none past the read's words)
        widx = wb[c0:c1, None, :] + iota_w[None]
        g = planes_t.gather(1, widx.clamp(max=RW - 1).reshape(1, -1, R)
                            .expand(4, -1, R)).reshape(4, c1 - c0, bw, R)
        g = torch.where((widx < RW)[None], g, 0)
        pm = path_t[c0:c1, None, :]
        eqs = g[0] * (pm & 1)
        for b in range(1, 4):
            eqs = eqs | (g[b] * ((pm >> b) & 1))
        # each column's match words for a top delta of 0 or +1, and of -1
        eqs = torch.stack((eqs, eqs | 1), dim=1)
        for col in range(c0, c1):
            if shifted[col]:
                # drop `shift` words off the top, fill the bottom with
                # all-insertion words continuing from the old bottom score
                sh = shift[col]
                bot_sb = sbs[-1]
                idx = iota_w + sh[None, :]
                keep = idx < bw
                idxc = idx.clamp(max=bw - 1)
                vps = torch.where(keep, vps.gather(0, idxc), ONES)
                vns = torch.where(keep, vns.gather(0, idxc), 0)
                sbs = torch.where(keep, sbs.gather(0, idxc),
                                  bot_sb[None, :] + (idx - bw + 1) * W)
            # myers.advance_word for both match words: [0] eq (delta in
            # 0 or +1), [1] eq | 1 (delta in -1)
            e2 = eqs[col - c0]
            xv = e2 | vns
            xh = ((((e2 & vps) + vps) & MASK32) ^ vps) | e2
            ph = vns | (~(xh | vps) & MASK32)
            mh = vps & xh
            hout = ((ph >> (W - 1)) & 1) - ((mh >> (W - 1)) & 1)
            h0, h1 = hout[0].unbind(0), hout[1].unbind(0)
            hin = [torch.ones(R, dtype=_I64, device=dev)]
            neg = hin[0] < 0
            for w in range(1, bw):
                hin.append(torch.where(neg, h1[w - 1], h0[w - 1]))
                neg = hin[-1] < 0
            hin = torch.stack(hin)
            neg = hin < 0
            xv = torch.where(neg, xv[1], xv[0])
            ph = torch.where(neg, ph[1], ph[0])
            mh = torch.where(neg, mh[1], mh[0])
            ph = ((ph << 1) & MASK32) | (hin > 0).to(_I64)
            mh = ((mh << 1) & MASK32) | neg.to(_I64)
            vps = mh | (~(xv | ph) & MASK32)
            vns = ph & xv
            sbs = sbs + torch.where(neg, hout[1], hout[0])
            dump_vp[col] = vps
            dump_vn[col] = vns
            dump_sb[col] = sbs


def _score_from_dump_t(dump_vp, dump_vn, dump_sb, dump_base, read_len,
                       path_len, bw: int):
    """Global NW score per read: row read_len-1 at column path_len-1."""
    P, _, R = dump_vp.shape
    lanes = torch.arange(R, device=dump_vp.device)
    last = (path_len.to(_I64) - 1).clamp(0, P - 1)
    r = read_len.to(_I64) - 1
    lbase = dump_base[last, lanes].to(_I64)
    wofs = (torch.div(r, W, rounding_mode="floor") - lbase).clamp(0, bw - 1)
    above = _above(torch.remainder(r, W))
    svp = u32(dump_vp[last, wofs, lanes])
    svn = u32(dump_vn[last, wofs, lanes])
    ssb = dump_sb[last, wofs, lanes].to(_I64)
    return ssb - popcount32(svp & above) + popcount32(svn & above)


class BacktraceResult(NamedTuple):
    ops_rev: torch.Tensor   # (R, ops_cap) uint8, walk order (end -> start)
    n_ops: torch.Tensor     # (R,) int64, -1 when the walk failed
    touched: torch.Tensor   # (R,) bool: the walk touched a band edge with
                            # DP rows beyond it (the score may overestimate)


def _backtrace_t(dump_vp, dump_vn, dump_sb, dump_base, planes_t, path_t,
                 read_len, path_len, bw: int, max_steps: int,
                 ops_cap: int = 0, sync_every: int = 16):
    """Walk the banded DP back from (read_len-1, path_len-1), one step per
    iteration for every read at once, emitting edit ops (ties: insertion,
    then diagonal, then deletion).  A walk longer than ops_cap fails
    (n_ops == -1); callers retry with a wider band.

    The loop stops once every walk is done, checked every `sync_every`
    steps (a check costs a device sync; extra steps change nothing)."""
    P, _, R = dump_vp.shape
    RW = planes_t.shape[1]
    dev = dump_vp.device
    BIGB = 1 << 26
    rl = read_len.to(_I64)
    pl = path_len.to(_I64)
    rw_cap = torch.div(rl + W - 1, W, rounding_mode="floor")
    if not ops_cap or ops_cap > max_steps:
        ops_cap = max_steps
    vp_flat = dump_vp.reshape(P * bw, R)
    vn_flat = dump_vn.reshape(P * bw, R)
    sb_flat = dump_sb.reshape(P * bw, R)
    lanes = torch.arange(R, device=dev)
    above_of = torch.tensor(_ABOVE, dtype=_I64, device=dev)
    bits16 = popcount32(torch.arange(1 << 16, dtype=_I64, device=dev))
    # the read's 4-bit match mask of every row, (RW * W, R)
    rows = (u32(planes_t)[:, :, None, :]
            >> torch.arange(W, dtype=_I64, device=dev)[None, None, :, None]
            ) & 1
    row_mask = (rows[0] | (rows[1] << 1) | (rows[2] << 2)
                | (rows[3] << 3)).reshape(RW * W, R)

    def score(rr, cc):
        """Score of row rr at column cc, (..., R) each."""
        cq = cc.clamp(0, P - 1)
        base_c = dump_base[cq, lanes].to(_I64)
        w = torch.div(rr, W, rounding_mode="floor") - base_c
        idx = cq * bw + w.clamp(0, bw - 1)
        above = above_of[torch.remainder(rr, W)]
        x = u32(torch.stack((vp_flat[idx, lanes], vn_flat[idx, lanes]))
                ) & above
        vpn = bits16[x & 0xFFFF] + bits16[x >> 16]
        s = sb_flat[idx, lanes].to(_I64) - vpn[0] + vpn[1]
        s = torch.where((w < 0) | (w >= bw), BIGB, s)
        s = torch.where(rr < 0, cc + 1, s)
        s = torch.where(cc < 0, rr + 1, s)
        return torch.where((rr < 0) & (cc < 0), 0, s)

    def matches(rr, cc):
        pm = path_t[cc.clamp(0, P - 1), lanes]
        return (row_mask[rr.clamp(0, RW * W - 1), lanes] & pm & 15) != 0

    r = rl - 1
    c = pl - 1
    s = score(r, c)
    fail = (rl <= 0) | (pl <= 0)
    done = fail.clone()
    touch = torch.zeros(R, dtype=torch.bool, device=dev)
    buf = torch.full((ops_cap, R), OP_NONE, dtype=torch.uint8, device=dev)
    for i in range(max_steps):
        if i % sync_every == 0 and bool(done.all()):
            break
        # the three neighbours' scores in one lookup
        r1, c1 = r - 1, c - 1
        d, left, up = score(torch.stack((r1, r, r1)),
                            torch.stack((c1, c1, c))).unbind(0)
        sub = torch.where(matches(r, c), 0, 1)
        can_diag = (r >= 0) & (c >= 0) & (s == d + sub)
        can_left = (c >= 0) & (s == left + 1)
        can_up = (r >= 0) & (s == up + 1)
        op = torch.where(
            can_up, OP_INS,
            torch.where(can_diag,
                        torch.where(sub == 1, OP_MISMATCH, OP_MATCH),
                        torch.where(can_left, OP_DEL, OP_NONE)))
        fail = fail | (~done & (op == OP_NONE))
        if i >= ops_cap:
            fail = fail | ~done
        emit = ~done & ~fail
        base_c = dump_base[c.clamp(0, P - 1), lanes].to(_I64)
        w = torch.div(r.clamp(0, RW * W - 1), W, rounding_mode="floor") \
            - base_c
        edge = (((w <= 0) & (base_c > 0))
                | ((w >= bw - 1) & (base_c + bw < rw_cap)))
        touch = touch | (emit & (r >= 0) & (c >= 0) & edge)
        go_up = can_up
        go_diag = ~can_up & can_diag
        go_left = ~can_up & ~can_diag & can_left
        r_new = torch.where(emit & (go_up | go_diag), r - 1, r)
        c_new = torch.where(emit & (go_diag | go_left), c - 1, c)
        s = torch.where(emit, torch.where(go_up, up,
                                          torch.where(go_diag, d, left)), s)
        done = done | ((r_new < 0) & (c_new < 0)) | fail
        iw = min(i, ops_cap - 1)
        buf[iw] = torch.where(emit, op.to(torch.uint8), buf[iw])
        r, c = r_new, c_new
    ops = buf.t().contiguous()
    complete = done & ~fail & (r < 0) & (c < 0)
    n = (ops != OP_NONE).sum(dim=1)
    n = torch.where(complete, n, -1)
    return BacktraceResult(ops_rev=ops, n_ops=n, touched=touch)


# ---------------------------------------------------------------------------
# Packed formats: 2-bit base codes (16 per word, pure ACGT) and 4-bit match
# nibbles (8 per word, IUPAC masks intact); edit ops leave as 2-bit codes.

def expand_nibbles(p4: torch.Tensor) -> torch.Tensor:
    """(R, PW) words of packed 4-bit codes -> (R, PW*8) uint8."""
    shifts = torch.arange(8, dtype=_I64, device=p4.device) * 4
    out = (u32(p4)[:, :, None] >> shifts) & 0xF
    return out.to(torch.uint8).reshape(p4.shape[0], -1)


def _compact4(x: torch.Tensor) -> torch.Tensor:
    """Gather bits at positions {4j} of each word into bits 0..7."""
    x = (x | (x >> 3)) & 0x03030303
    x = (x | (x >> 6)) & 0x000F000F
    return (x | (x >> 12)) & 0xFF


def expand_planes(p4: torch.Tensor) -> torch.Tensor:
    """(R, rw*4) words of packed 4-bit codes -> (R, rw, 4) row planes
    (bit i of plane b at word w = mask bit b of char 32w+i)."""
    R, RW4 = p4.shape
    rw = RW4 // 4
    p4 = u32(p4)
    planes = []
    for b in range(4):
        c = _compact4((p4 >> b) & 0x11111111).reshape(R, rw, 4)
        planes.append(c[:, :, 0] | (c[:, :, 1] << 8)
                      | (c[:, :, 2] << 16) | (c[:, :, 3] << 24))
    return torch.stack(planes, dim=-1)


def _compact2(x: torch.Tensor) -> torch.Tensor:
    """Gather bits at even positions {2j} of each word into bits 0..15."""
    x = x & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    return (x | (x >> 8)) & 0x0000FFFF


def expand_planes2(c2: torch.Tensor) -> torch.Tensor:
    """(R, rw*2) words of 16 packed 2-bit base codes -> (R, rw, 4) row
    planes (bit i of plane b = code of row 32w+i equals b)."""
    R, RW2 = c2.shape
    rw = RW2 // 2
    c2 = u32(c2)
    lo = c2 & 0x55555555
    hi = (c2 >> 1) & 0x55555555
    planes = []
    for b in range(4):
        m = ((lo if b & 1 else ~lo & MASK32)
             & (hi if b & 2 else ~hi & MASK32) & 0x55555555)
        c = _compact2(m).reshape(R, rw, 2)
        planes.append(c[:, :, 0] | (c[:, :, 1] << 16))
    return torch.stack(planes, dim=-1)


def expand_codes2(c2: torch.Tensor) -> torch.Tensor:
    """(R, PW) words of 16 packed 2-bit codes -> (R, PW*16) uint8 match
    nibbles (1 << code)."""
    shifts = torch.arange(16, dtype=_I64, device=c2.device) * 2
    codes = (u32(c2)[:, :, None] >> shifts) & 3
    nib = torch.bitwise_left_shift(torch.ones_like(codes), codes)
    return nib.to(torch.uint8).reshape(c2.shape[0], -1)


def pack_ops2(ops: torch.Tensor) -> torch.Tensor:
    """(R, M) uint8 edit ops -> (R, M//16) words, 2 bits per op (only the
    low 2 bits survive; padding past n_ops is discarded by the host)."""
    R, M = ops.shape
    o = (ops.to(_I64) & 3).reshape(R, M // 16, 16)
    shifts = torch.arange(16, dtype=_I64, device=ops.device) * 2
    return (o << shifts).sum(dim=2)


def _polish_walk_t(dump_vp, dump_vn, dump_sb, dump_base, planes_t, path_t,
                   read_len, path_len, bw: int, max_steps: int,
                   ops_cap: int = 0) -> torch.Tensor:
    """Score, backtrace and op packing of a dump, plain torch: the
    (R, 3 + ops_cap/16) int64 rows of polish_full_packed2 (computed in
    inference mode, which halves the cost of the walk's small ops)."""
    with torch.inference_mode():
        score = _score_from_dump_t(dump_vp, dump_vn, dump_sb, dump_base,
                                   read_len, path_len, bw)
        bt = _backtrace_t(dump_vp, dump_vn, dump_sb, dump_base, planes_t,
                          path_t, read_len, path_len, bw, max_steps,
                          ops_cap)
        rows = torch.cat([score[:, None], bt.n_ops[:, None],
                          bt.touched.to(_I64)[:, None],
                          pack_ops2(bt.ops_rev)], dim=1)
    return rows.clone()


def _polish_full(planes_t, path_t, read_len, path_len, bw: int,
                 max_steps: int, ops_cap: int) -> torch.Tensor:
    from graphchainer_torch.ops.polish_kernel import polish_core, polish_walk
    dump = polish_core(planes_t, path_t, read_len, path_len, bw)
    return polish_walk(*dump, planes_t, path_t, read_len, path_len, bw,
                       max_steps, ops_cap)


def polish_full_packed2(read_c2, path_c2, read_len, path_len, bw: int,
                        max_steps: int, ops_cap: int = 0) -> torch.Tensor:
    """Score + backtrace over 2-bit base codes (pure-ACGT batches):
    read_c2 (R, rmax/16), path_c2 (R, pmax/16) words on one device.
    Returns the (R, 3 + ops_cap/16) int64 packed rows."""
    planes_t = expand_planes2(read_c2).permute(2, 1, 0).contiguous()
    path_t = expand_codes2(path_c2).t().to(_I64).contiguous()
    return _polish_full(planes_t, path_t, read_len, path_len, bw,
                        max_steps, ops_cap)


def polish_full_packed(read_p4, path_p4, read_len, path_len, bw: int,
                       max_steps: int, ops_cap: int = 0) -> torch.Tensor:
    """polish_full_packed2 over 4-bit match nibbles (IUPAC bases)."""
    planes_t = expand_planes(read_p4).permute(2, 1, 0).contiguous()
    path_t = expand_nibbles(path_p4).t().to(_I64).contiguous()
    return _polish_full(planes_t, path_t, read_len, path_len, bw,
                        max_steps, ops_cap)

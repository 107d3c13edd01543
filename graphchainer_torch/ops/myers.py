"""32-bit Myers bit-parallel word primitives in torch.

Port of graphchainer_tpu/ops/myers.py.  A DP word covers 32 read rows and
is the triple (vp, vn, sb): vertical +1 / -1 delta bits and the score at
the bottom row.  CPU torch has no uint32 shift, add or compare and no
popcount, so the plain versions carry every word in an int64 tensor
masked to its low 32 bits and count bits with a SWAR popcount.  The CUDA
kernels use uint32_t and __popc on the same bit patterns.
"""
from __future__ import annotations

import torch

W = 32
MASK32 = 0xFFFFFFFF
ONES = 0xFFFFFFFF
HIGH = 0x80000000

# _ABOVE[r]: bits strictly above row r (r+1..31)
_ABOVE = [((ONES << (r + 1)) & MASK32) if r < W - 1 else 0 for r in range(W)]


def u32(x: torch.Tensor) -> torch.Tensor:
    """32-bit word bit patterns (int32 or int64) as int64 in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 tensor with the same bits (the
    kernels' uint32_t arguments); int32 input is already that."""
    if x.dtype == torch.int32:
        return x
    x = x.to(torch.int64)
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int64 words holding 32-bit values."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def above_mask(r: torch.Tensor) -> torch.Tensor:
    """Mask of bits strictly above row r (0 <= r < 32), per element."""
    return torch.where(r < W - 1, (ONES << (r + 1)) & MASK32,
                       torch.zeros_like(r))


def advance_word(vp, vn, sb, eq, hin):
    """One DP column step: from column word (vp, vn, sb) to the next column
    given its match bits `eq` and the horizontal delta `hin` in {-1, 0, +1}
    at the boundary row.  Returns (vp', vn', sb', hout)."""
    if isinstance(hin, int):
        hin_neg, hin_pos = int(hin < 0), int(hin > 0)
    else:
        hin_neg = (hin < 0).to(torch.int64)
        hin_pos = (hin > 0).to(torch.int64)
    eq = eq | hin_neg
    xv = eq | vn
    xh = ((((eq & vp) + vp) & MASK32) ^ vp) | eq
    ph = vn | (~(xh | vp) & MASK32)
    mh = vp & xh
    hout = (((ph & HIGH) != 0).to(torch.int64)
            - ((mh & HIGH) != 0).to(torch.int64))
    ph = ((ph << 1) & MASK32) | hin_pos
    mh = ((mh << 1) & MASK32) | hin_neg
    vp_new = mh | (~(xv | ph) & MASK32)
    vn_new = ph & xv
    return vp_new, vn_new, sb + hout, hout


def score_before_start(vp, vn, sb):
    """S[-1]: the implied score at the boundary row above the word."""
    return sb - popcount32(vp) + popcount32(vn)


def source_word(before_score: torch.Tensor):
    """A fresh boundary column: S[-1] = before_score, S[i] = before + i + 1
    (all insertions)."""
    vp = torch.full_like(before_score, ONES, dtype=torch.int64)
    vn = torch.zeros_like(before_score, dtype=torch.int64)
    return vp, vn, before_score.to(torch.int64) + W

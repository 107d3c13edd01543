"""Host glue for the polish alignment (read vs chained path sequence).

Port of graphchainer_tpu/align/polish.py: builds the batched inputs of
ops/linear_align.polish_full_packed2 (2-bit base codes) or
polish_full_packed (4-bit nibbles, for IUPAC bases), runs it on the
model's devices (a row block of reads a device, parallel/device.py, the
per-batch read table replicated, as JAX shards them at
align/polish.py:296-330), and decodes the packed rows.  Reads whose
walk leaves the band, overflows the ops buffer or touches a band edge are
retried with a doubled band up to MAX_BAND_WORDS.

The padded sizes rmax / pmax stay the reference's power-of-two buckets:
they set max_steps and ops_cap, and ops_cap decides whether a walk
overflows (n_ops == -1) and is retried wider, so they shape results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from graphchainer_torch.parallel.device import local_devices, shard_call
from graphchainer_torch.utils import timers
from graphchainer_torch.utils.seq import match_masks
from graphchainer_torch.ops import linear_align

W = 32
MAX_BAND_WORDS = 32      # widest retry band: 32 words = 1024 rows


def _round_up(x: int, m: int) -> int:
    """Smallest m * 2^k >= x (power-of-two buckets from m)."""
    out = m
    while out < x:
        out *= 2
    return out


@dataclass
class PolishOutcome:
    score: int
    ops: Optional[np.ndarray]   # uint8 edit ops (None if the walk failed)
    touched: bool = False       # the walk touched a band edge


def pack_nibbles(mm: np.ndarray) -> np.ndarray:
    """(..., L) uint8 4-bit match masks -> (..., L//8) uint32, 8 chars per
    word."""
    lead = mm.shape[:-1]
    m = mm.reshape(*lead, -1, 8).astype(np.uint32)
    shifts = (np.arange(8, dtype=np.uint32) * 4)
    return (m << shifts).sum(axis=-1, dtype=np.uint32)


# match nibble {1,2,4,8} -> base code 0..3 (other values unmapped)
_NIB_CODE = np.zeros(16, dtype=np.uint32)
for _c in range(4):
    _NIB_CODE[1 << _c] = _c


def pack_codes2(mm: np.ndarray) -> np.ndarray:
    """(..., L) uint8 single-base match masks -> (..., L//16) uint32, 16
    2-bit base codes per word (padding maps to code 0; DP cells inside
    (read_len, path_len) never read it)."""
    lead = mm.shape[:-1]
    m = _NIB_CODE[mm].reshape(*lead, -1, 16)
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    return (m << shifts).sum(axis=-1, dtype=np.uint32)


def build_read_table(seqs: Sequence[str], device):
    """Per-batch read-code table on `device` (the first, of a list):
    (Rp, rmax/16) words, 16 2-bit codes per word.  Built once per batch
    and shared by the polish passes, which gather rows by index (on the
    other devices of a list, from a copy made once).  None when any read
    has an IUPAC base (the polish then packs its reads itself)."""
    R = len(seqs)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    rmax = _round_up(int(lens.max()) if R else 1, 1024)
    Rp = _round_up(R, 16)
    mm = np.zeros((Rp, rmax), dtype=np.uint8)
    for i, s in enumerate(seqs):
        mm[i, :len(s)] = match_masks(s)
    in_range = np.arange(rmax)[None, :] < lens[:, None]
    if (in_range & ((mm[:R] == 0) | ((mm[:R] & (mm[:R] - 1)) != 0))).any():
        return None
    return torch.as_tensor(pack_codes2(mm).astype(np.int64)).to(
        local_devices(device)[0])


def _ops_cap(rmax: int, pmax: int, bw: int) -> int:
    """Size of the emitted ops buffer: a walk takes ~max(read, path) +
    O(band) steps; longer walks fail and are retried wider, and the cap
    grows with bw up to the lossless read + path bound."""
    return min(rmax + pmax, -(-(max(rmax, pmax) + 4 * bw * W) // 16) * 16)


def polish_batch(reads: Sequence[str], paths: Sequence[str], bw: int = 8,
                 table=None, device="cuda") -> List[PolishOutcome]:
    """Global NW of each read vs its path sequence, batched on `device`
    (the card unless the caller asks for the CPU; a device or a list of
    them, a row block of reads each), with the band-doubling retry.

    table: optional (dev_tbl, row_idx) — build_read_table's table and the
    row of each read in it (rows must hold exactly reads[i]'s codes)."""
    out = _polish_once(reads, paths, bw, table, device)
    while bw < MAX_BAND_WORDS:
        bad = [i for i, oc in enumerate(out)
               if (oc.ops is None or oc.touched)
               and len(reads[i]) and len(paths[i])]
        if not bad:
            break
        bw *= 2
        redo = _polish_once([reads[i] for i in bad],
                            [paths[i] for i in bad], bw,
                            (table[0], np.asarray(table[1])[bad])
                            if table is not None else None, device)
        for i, oc in zip(bad, redo):
            out[i] = oc
    return out


def _pure(mm: np.ndarray, lens: np.ndarray) -> bool:
    """Every in-range char matches exactly one base."""
    R = len(lens)
    in_range = np.arange(mm.shape[1])[None, :] < lens[:, None]
    bad = in_range & ((mm[:R] == 0) | ((mm[:R] & (mm[:R] - 1)) != 0))
    return not bad.any()


def _pack_rows(seqs: Sequence[str], lens: np.ndarray, width: int):
    """(R, width) uint8 match masks of the sequences, zero padded."""
    R = len(seqs)
    mm = np.zeros((R, width), dtype=np.uint8)
    if R:
        cat = match_masks("".join(seqs))
        rows_idx = np.repeat(np.arange(R), lens)
        cols_idx = (np.arange(len(cat))
                    - np.repeat(np.cumsum(lens) - lens, lens))
        mm[rows_idx, cols_idx] = cat
    return mm


def _polish_once(reads: Sequence[str], paths: Sequence[str], bw: int,
                 table, device) -> List[PolishOutcome]:
    R = len(reads)
    assert R == len(paths)
    read_len = np.array([len(r) for r in reads], dtype=np.int64)
    path_len = np.array([len(p) for p in paths], dtype=np.int64)
    rmax = _round_up(int(read_len.max()) if R else 1, 1024)
    pmax = _round_up(int(path_len.max()) if R else 1, 1024)
    if table is not None and table[0].shape[1] * 16 < rmax:
        table = None

    def i64(a):
        return np.ascontiguousarray(a, dtype=np.int64)

    path_mm = _pack_rows(paths, path_len, pmax)
    path_pure = _pure(path_mm, path_len)
    tbl = ()
    if table is not None and path_pure:
        # read rows gathered on the device from the batch table
        dev_tbl, row_idx = table
        read_w = i64(row_idx)
        tbl = (dev_tbl,)
        path_w = i64(pack_codes2(path_mm))
        kernel = linear_align.polish_full_packed2
        rmax = dev_tbl.shape[1] * 16
    else:
        read_mm = _pack_rows(reads, read_len, rmax)
        if path_pure and _pure(read_mm, read_len):
            read_w = i64(pack_codes2(read_mm))
            path_w = i64(pack_codes2(path_mm))
            kernel = linear_align.polish_full_packed2
        else:
            read_w = i64(pack_nibbles(read_mm))
            path_w = i64(pack_nibbles(path_mm))
            kernel = linear_align.polish_full_packed
    timers.count("cells(polish)", int(path_len.sum()) * bw * W)
    cap = _ops_cap(rmax, pmax, bw)

    def run(rw, pw, rl, pl, *t):
        return kernel(t[0][rw] if t else rw, pw, rl, pl, bw,
                      max_steps=rmax + pmax, ops_cap=cap)
    w = shard_call(run, (read_w, path_w, read_len, path_len) + tbl,
                   (True,) * 4 + (False,) * len(tbl), device)
    scores, n_ops, touched = w[:, 0], w[:, 1], w[:, 2] != 0
    ops2 = w[:, 3:].astype(np.uint32)
    # unpack 2-bit ops (values beyond n_ops are padding)
    shifts = (np.arange(16, dtype=np.uint32) * 2)
    ops_rev = ((ops2[:, :, None] >> shifts) & 3).astype(np.uint8)
    ops_rev = ops_rev.reshape(ops2.shape[0], -1)
    out = []
    for i in range(R):
        ops = (ops_rev[i, :n_ops[i]][::-1].copy()
               if n_ops[i] >= 0 else None)
        out.append(PolishOutcome(score=int(scores[i]), ops=ops,
                                 touched=bool(touched[i])))
    return out

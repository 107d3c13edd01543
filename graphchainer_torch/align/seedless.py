"""Seedless whole-read alignment start discovery (--seedless-DP).

Re-design of the reference's fullstart mode (src/GraphAligner.h:53-83
AlignOneWay + :342-405 fullstartOneWay, src/GraphAlignerBitvectorFullstart.h):
align a read with ZERO seeder hits by running the DP with a free start at
every graph position, then extending from the best cell.

The reference runs getBacktraceFullStart over the whole graph slice by
slice, and with --DP-restart-stride > 0 re-runs it at ``lastEnd + stride``
after each alignment to recover post-clip coverage.  A sequential
whole-graph sweep is the wrong shape for the TPU; instead:

* the graph is cut into overlapping TILES of at most ``tile`` band slots
  (node ids are topo ranks, so a sorted slot order keeps every in-tile
  edge forward — the same invariant the banded kernel already relies on);
* ONE batched ``align_fragments(..., full_start=True)`` call scans a read
  prefix window against every tile of every component at every restart
  offset simultaneously (F = tiles x offsets fragments in flight);
* the best (score, slot, col) per offset becomes a SYNTHETIC SeedHit that
  anchors the prefix's last row at the winning graph base, and the normal
  windowed bidirectional extension machinery (models/aligner.py) takes
  over — identical to how a minimizer seed is extended.

Restart offsets are static multiples of the stride rather than the
reference's data-dependent ``lastEnd + stride`` (a host-sequential loop);
seeds from later offsets are only extended when earlier alignments leave
the read under-covered, which reproduces the reference's "restart after a
clip" behaviour without serializing on the device.

Tiles overlap by ``overlap`` slots so a prefix whose alignment crosses a
tile boundary is fully contained in the next tile; in-edges that point
outside a tile are dropped (full start makes every slot reachable, so the
only loss is continuation across the overlap, bounded by the overlap
width).

Port of graphchainer_tpu/align/seedless.py on one torch device: the scan
runs ops/frag_align.align_fragments, the hand kernel csrc/frag_wide.cu on
a CUDA device and its plain version on the CPU.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.index.minimizer import SeedHit
from graphchainer_torch.utils.seq import match_masks

W = 32


def _pow2(x: int, lo: int) -> int:
    out = lo
    while out < x:
        out *= 2
    return out


class FullstartScanner:
    """Process-lifetime tile tables for one graph (built once, reused
    across reads like the anchor band cache)."""

    def __init__(self, g: AlignmentGraph, gx, tile: int = 1024,
                 overlap: int = 128, max_in_cap: int = 8, device="cuda"):
        self.g = g
        self.gx = gx
        self.device = torch.device(device)
        self.tile = tile
        self.overlap = overlap
        self.max_in_cap = max_in_cap
        self._tiles = None           # built lazily

    # -- tile tables ------------------------------------------------------
    def _build_tiles(self):
        if self._tiles is not None:
            return self._tiles
        g = self.g
        tile, overlap = self.tile, self.overlap
        chunks: List[np.ndarray] = []
        for c in range(g.ncomp):
            nodes = np.nonzero(g.comp == c)[0].astype(np.int64)
            if len(nodes) == 0:
                continue
            step = max(tile - overlap, 1)
            for lo in range(0, len(nodes), step):
                chunk = nodes[lo:lo + tile]
                chunks.append(chunk)
                if lo + tile >= len(nodes):
                    break
        T = len(chunks)
        B = _pow2(max(len(c) for c in chunks), 64)
        band_nodes = np.full((T, B), -1, dtype=np.int32)
        levels = np.full((T, B), -1, dtype=np.int32)
        max_in = 1
        in_lists: List[List[List[int]]] = []
        for t, chunk in enumerate(chunks):
            band_nodes[t, :len(chunk)] = chunk
            slot_of = {int(v): i for i, v in enumerate(chunk)}
            rows = []
            lvl = np.zeros(len(chunk), dtype=np.int32)
            for i, v in enumerate(chunk):
                ins = [slot_of[int(u)] for u in g.in_neighbors(int(v))
                       if int(u) in slot_of]
                if len(ins) > self.max_in_cap:
                    # keep the nearest predecessors (largest slot ids):
                    # distant in-edges mostly re-enter from other bubbles
                    ins = sorted(ins)[-self.max_in_cap:]
                rows.append(ins)
                lvl[i] = 1 + max((lvl[u] for u in ins), default=-1)
                max_in = max(max_in, len(ins))
            levels[t, :len(chunk)] = lvl
            in_lists.append(rows)
        band_in = np.full((T, B, max_in), -1, dtype=np.int16)
        for t, rows in enumerate(in_lists):
            for i, ins in enumerate(rows):
                band_in[t, i, :len(ins)] = ins
        self._tiles = (band_nodes, band_in, levels)
        return self._tiles

    # -- the scan ---------------------------------------------------------
    def scan_inputs(self, read: str, offsets: Sequence[int] = (0,),
                    prefix_rows: int = 192):
        """align_fragments' arguments of one scan on the scanner's device
        (args, keyword args), and the offsets and rows it scans."""
        from graphchainer_torch.align.anchors import (level_bucket,
                                                      pack_row_planes, upload)
        band_nodes, band_in, levels = self._build_tiles()
        T, B = band_nodes.shape
        max_in = band_in.shape[2]
        offsets = [o for o in offsets if o < len(read) - 1] or [0]
        K = len(offsets)

        rows_per = [min(prefix_rows, len(read) - o) for o in offsets]
        S = _pow2(-(-max(rows_per) // W), 1)
        req_rows = np.zeros((K, S * W), dtype=np.uint8)
        for j, (o, r) in enumerate(zip(offsets, rows_per)):
            req_rows[j, :r] = match_masks(read[o:o + r])
        req_k = pack_row_planes(req_rows).reshape(K, S, 4)

        # fragment layout: offset-major (tile t of offset j at j*T + t)
        F = K * T
        bn = np.broadcast_to(band_nodes, (K, T, B)).reshape(F, B)
        bi = np.broadcast_to(band_in, (K, T, B, max_in)).reshape(
            F, B, max_in)
        lv = np.broadcast_to(levels, (K, T, B)).reshape(F, B)
        req = np.broadcast_to(req_k[:, None], (K, T, S, 4)).reshape(F, S, 4)
        frag_len = np.repeat(np.asarray(rows_per, np.int32), T)

        dev_eq, dev_len = self.gx.device_tables(self.device)
        band = upload([np.ascontiguousarray(bn, dtype=np.int32),
                       np.ascontiguousarray(bi, dtype=np.int16),
                       np.zeros(F, dtype=np.int32),
                       np.ascontiguousarray(req).view(np.int32),
                       np.ascontiguousarray(frag_len, dtype=np.int32),
                       np.ascontiguousarray(lv, dtype=np.int32)],
                      dev_eq.device)
        kw = dict(n_slices=S, max_in=max_in, full_start=True,
                  band_level=band[5], n_levels=level_bucket(lv, B))
        return (dev_eq, dev_len) + tuple(band[:5]), kw, offsets, rows_per

    def scan(self, read: str, offsets: Sequence[int] = (0,),
             prefix_rows: int = 192, topk: int = 3) -> List[SeedHit]:
        """Synthetic SeedHits ordered by restart offset, then score."""
        from graphchainer_torch.ops import frag_align

        g = self.g
        band_nodes = self._build_tiles()[0]
        T = band_nodes.shape[0]
        args, kw, offsets, rows_per = self.scan_inputs(read, offsets,
                                                       prefix_rows)
        K = len(offsets)
        res = frag_align.align_fragments(*args, **kw)
        score = res.best_score.cpu().numpy().reshape(K, T)
        slot = res.best_slot.cpu().numpy().reshape(K, T)
        col = res.best_col.cpu().numpy().reshape(K, T)

        seeds: List[SeedHit] = []
        for j, o in enumerate(offsets):
            order = np.argsort(score[j], kind="stable")[:topk]
            seen = set()
            for t in order:
                v = int(band_nodes[int(t), int(slot[j, t])])
                if v < 0 or v in seen:
                    continue
                seen.add(v)
                c = int(col[j, t])
                seeds.append(SeedHit(
                    di_node=int(g.orig_node[v]),
                    node_offset=int(g.orig_offset[v]) + c,
                    seq_pos=o + rows_per[j] - 1,
                    match_len=1,
                    goodness=float(-score[j, t])))
        return seeds

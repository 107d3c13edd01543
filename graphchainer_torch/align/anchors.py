"""Fragment jobs, bands and the fragment DP run (the CLC fragment stage
and GA mode's extension windows).

JAX-free copies of the host half of graphchainer_tpu/align/anchors.py
(GraphTensors, assemble_batch_cols, FragJob, assemble_batch, CarryJob,
assemble_carry_batch, pack_row_planes, level_bucket, _warn_truncated,
backwalk; JobCols lives in native.py) plus `run_fragments`, which runs
ops/frag_kernel.frag_core over a whole batch on the model's devices: the
node tables stay resident on each, the band arrays go up in their host
types (`fragment_inputs`), a row block a device (parallel/device.py), or
each fragment to the device of its component's table block
(parallel/sharded_graph.py).

Each fragment with a seed at read row r0 and graph position (v, o) is two
jobs: forward rows read[r0:end) from node v trimmed to start at offset o,
and backward rows reversed(read[start:r0)) on the edge-reversed graph
(reversed node sequences, ids offset by N).
"""
from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from graphchainer_torch import native
from graphchainer_torch.native import JobCols
from graphchainer_torch.constants import MAX_IN_DEGREE
from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.utils import timers
from graphchainer_torch.utils.bits import reverse_eq_planes
from graphchainer_torch.ops import frag_align, frag_kernel
from graphchainer_torch.ops.myers import to_i32_bits
from graphchainer_torch.parallel.device import (concat_rows, local_devices,
                                                run_shards, shard_call,
                                                unpermute, upload)
from graphchainer_torch.parallel.sharded_graph import (localize_bands,
                                                       route_fragments)

W = 32


@dataclass
class GraphTensors:
    """Host tables derived from the AlignmentGraph once, plus the node
    Eq/length tables resident on a torch device (copy of
    graphchainer_tpu.align.anchors.GraphTensors; the native glue reads
    the attributes g, di_base, in_ptr, in_idx, out_ptr, out_idx,
    node_len64, orig_offset64, seq_bytes and split_lookup).

    The device tables are the forward table concatenated with the
    reversed-sequence table: backward jobs address reversed nodes as
    id + N."""
    g: AlignmentGraph
    node_eq_rev: np.ndarray      # uint32 [N,4] reversed-sequence planes
    node_eq_cat: np.ndarray      # uint32 [2N,4] fwd ++ reversed
    node_len_cat: np.ndarray     # int32 [2N]
    out_ptr: np.ndarray
    out_idx: np.ndarray
    in_ptr: np.ndarray
    in_idx: np.ndarray
    node_len64: np.ndarray
    seq_bytes: np.ndarray = None   # uint8 concat of all digraph sequences
    di_base: np.ndarray = None     # int64 [n_di+1] offsets into seq_bytes
    # component-sharded tables (parallel/sharded_graph.py), published as
    # one tuple: (devices, ShardPlan, [(eq, len)] per shard)
    shards: Optional[tuple] = field(default=None, repr=False)
    _dev: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    @staticmethod
    def build(g: AlignmentGraph) -> "GraphTensors":
        rev = reverse_eq_planes(g.node_eq, g.node_len)
        seq_bytes = np.frombuffer(
            "".join(g.di_seqs).encode("ascii"), dtype=np.uint8)
        di_base = np.zeros(len(g.di_seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in g.di_seqs], out=di_base[1:])
        return GraphTensors.from_numpy(
            g, node_eq_cat=np.concatenate([g.node_eq, rev], axis=0),
            node_len_cat=np.concatenate([g.node_len, g.node_len]),
            out_ptr=g.out_ptr, out_idx=g.out_idx, in_ptr=g.in_ptr,
            in_idx=g.in_idx, seq_bytes=seq_bytes, di_base=di_base)

    @staticmethod
    def from_numpy(g: AlignmentGraph, node_eq_cat, node_len_cat, out_ptr,
                   out_idx, in_ptr, in_idx, seq_bytes,
                   di_base) -> "GraphTensors":
        """Build from the numpy fields of an existing table set (e.g. the
        JAX package's GraphTensors), so both packages compute on
        identical tables."""
        n = g.n_nodes
        node_eq_cat = np.ascontiguousarray(node_eq_cat, dtype=np.uint32)
        return GraphTensors(
            g=g, node_eq_rev=node_eq_cat[n:], node_eq_cat=node_eq_cat,
            node_len_cat=np.ascontiguousarray(node_len_cat, dtype=np.int32),
            out_ptr=np.ascontiguousarray(out_ptr, dtype=np.int64),
            out_idx=np.ascontiguousarray(out_idx, dtype=np.int64),
            in_ptr=np.ascontiguousarray(in_ptr, dtype=np.int64),
            in_idx=np.ascontiguousarray(in_idx, dtype=np.int64),
            node_len64=np.ascontiguousarray(g.node_len, dtype=np.int64),
            seq_bytes=np.ascontiguousarray(seq_bytes, dtype=np.uint8),
            di_base=np.ascontiguousarray(di_base, dtype=np.int64))

    def split_lookup(self):
        """(sorted keys, split ids) for the global (digraph node, offset)
        -> split-node binary search.  Keys and values are built together
        and published as one tuple, so a concurrent reader never sees a
        half-built lookup."""
        got = self.__dict__.get("_split")
        if got is None:
            g = self.g
            # di_splits is grouped by digraph node (ascending) with
            # ascending offsets inside: keys are globally sorted
            splits = g.di_splits.astype(np.int64)
            owner_di = np.repeat(np.arange(g.n_digraph, dtype=np.int64),
                                 np.diff(g.di_ptr))
            keys = np.ascontiguousarray(
                (owner_di << 33) | g.orig_offset[splits].astype(np.int64))
            got = (keys, np.ascontiguousarray(splits))
            self.__dict__["_split"] = got
        return got

    def find_splits(self, di: np.ndarray, off: np.ndarray):
        """(split node ids, offsets within the split) of (digraph node,
        offset) arrays (graphchainer_tpu's GraphTensors.find_splits), over
        the one published split_lookup tuple."""
        keys_sorted, vals = self.split_lookup()
        off = np.asarray(off, dtype=np.int64)
        keys = (np.asarray(di, dtype=np.int64) << 33) | off
        v = vals[np.searchsorted(keys_sorted, keys, side="right") - 1]
        return v, off - self.g.orig_offset[v].astype(np.int64)

    @property
    def orig_offset64(self) -> np.ndarray:
        got = self.__dict__.get("_orig_offset64")
        if got is None:
            got = np.ascontiguousarray(self.g.orig_offset, dtype=np.int64)
            self.__dict__["_orig_offset64"] = got
        return got

    def positions_seq(self, positions) -> str:
        """Path sequence of (node, offset) rows."""
        if len(positions) == 0:
            return ""
        arr = np.asarray(positions, dtype=np.int64)
        g = self.g
        nodes, offs = arr[:, 0], arr[:, 1]
        idx = (self.di_base[g.orig_node[nodes].astype(np.int64)]
               + g.orig_offset[nodes] + offs)
        return self.seq_bytes[idx].tobytes().decode("ascii")

    def device_tables(self, device):
        """(node_eq, node_len) resident on `device`, uploaded once per
        device: Eq words as int64 on the CPU, as uint32 bits in int32 on
        a CUDA device (half the bytes)."""
        dev = torch.device(device)
        with self._lock:
            got = self._dev.get(dev)
            if got is None:
                got = self._dev[dev] = node_table(
                    self.node_eq_cat, self.node_len_cat, dev)
            return got


def node_table(node_eq: np.ndarray, node_len: np.ndarray, device):
    """(node_eq, node_len) tensors on `device`: Eq words as int64 on the
    CPU, as uint32 bits in int32 on a CUDA device (half the bytes)."""
    dev = torch.device(device)
    eq = torch.as_tensor(node_eq.astype(np.int64))
    if dev.type == "cuda":
        eq = to_i32_bits(eq)
    return eq.to(dev), torch.as_tensor(node_len).to(dev)


def assemble_batch_cols(gx: GraphTensors, jc: JobCols, read_mm_cat:
                        np.ndarray, read_base: np.ndarray, B: int,
                        max_in: int = MAX_IN_DEGREE, slack: int = 8):
    """Band + read-plane tensors for a columnar job batch.

    Returns (band_nodes [F,B] int64 original split ids, band_nodes_cat
    [F,B] int32 ids into the fwd ++ rev tables, band_in [F,B,max_in] int8,
    seed_shift [F] int32, req [F,S,4] uint32, rows [F] int32, S,
    band_level [F,B] int8).  B shrinks to the batch's widest band rounded
    up to a multiple of 8."""
    g = gx.g
    if B > 127:
        raise ValueError(
            f"band slots B={B} exceeds 127: the CLC band is int8-indexed "
            "(native backwalks); use -b/-B <= 127")
    F = len(jc)
    rows = np.maximum(jc.hi - jc.lo, 1).astype(np.int32)
    S = int(max(1, -(-int(rows.max(initial=1)) // W)))

    band_nodes = np.full((F, B), -1, dtype=np.int64)
    band_in = np.full((F, B, max_in), -1, dtype=np.int64)
    band_level = np.full((F, B), -1, dtype=np.int64)
    for rev in (False, True):
        sel = np.nonzero(jc.rev == rev)[0]
        if not len(sel):
            continue
        max_bp = int(rows[sel].max()) + slack
        ptr, idx = (gx.in_ptr, gx.in_idx) if rev else (gx.out_ptr,
                                                      gx.out_idx)
        bn, bi, bl, trunc = native.band_build(
            g.n_nodes, ptr, idx, gx.node_len64,
            np.ascontiguousarray(jc.seed[sel]),
            np.ascontiguousarray(jc.trim[sel]), B, max_bp, max_in, rev,
            by_dist=g.cyclic)
        if trunc:
            _warn_truncated(trunc, max_in)
        band_nodes[sel] = bn
        band_in[sel] = bi
        band_level[sel] = bl

    # adaptive band width: bands rarely fill all B slots; in-band in-edges
    # always reference earlier slots, so trimming the tail is safe
    used = int((band_nodes >= 0).sum(axis=1).max()) if F else 1
    B_eff = min(B, max(8, -(-used // 8) * 8))
    if B_eff < B:
        band_nodes = band_nodes[:, :B_eff]
        band_in = band_in[:, :B_eff]
        band_level = band_level[:, :B_eff]

    band_nodes_cat = np.where(
        band_nodes >= 0,
        band_nodes + np.where(jc.rev, g.n_nodes, 0)[:, None],
        -1).astype(np.int32)

    seed_len = g.node_len[np.clip(band_nodes[:, 0], 0,
                                  g.n_nodes - 1)].astype(np.int64)
    seed_shift = (seed_len - jc.trim).astype(np.int32)

    # read-row match planes: one gather over the concatenated batch masks
    ar = np.arange(S * W, dtype=np.int64)[None, :]
    base = read_base[jc.read_idx][:, None]
    idx_f = base + jc.lo[:, None] + ar
    idx_b = base + jc.hi[:, None] - 1 - ar
    idx = np.where(jc.rev[:, None], idx_b, idx_f)
    in_range = ar < rows[:, None]
    mm_pad = np.where(in_range,
                      read_mm_cat[np.clip(idx, 0, len(read_mm_cat) - 1)],
                      0).astype(np.uint8)
    req = pack_row_planes(mm_pad).reshape(F, S, 4)

    return (band_nodes, band_nodes_cat, band_in.astype(np.int8),
            seed_shift, req, rows, S, band_level.astype(np.int8))


@dataclass
class FragJob:
    rmm: np.ndarray      # (rows,) uint8 read-row match masks (bwd: reversed)
    seed_node: int
    seed_trim_len: int   # seed slot length after trimming
    reverse: bool


_trunc_warned = False


def _warn_truncated(n: int, max_in: int):
    """One-shot warning when band in-edge lists hit the max_in cap (the
    DP then overestimates scores on those slots); every call also feeds
    the `band_truncated_in_edges` counter."""
    global _trunc_warned
    timers.count("band_truncated_in_edges", int(n))
    if not _trunc_warned:
        print(f"WARNING: {n} in-band in-edges dropped by the "
              f"max_in={max_in} cap; DP scores may overestimate on "
              "dense-graph slots (further warnings suppressed)",
              file=sys.stderr)
        _trunc_warned = True


def assemble_batch(gx: GraphTensors, jobs: Sequence[FragJob], B: int,
                   max_in: int = MAX_IN_DEGREE, slack: int = 8):
    """Build kernel index tensors for a batch of jobs.

    Returns (band_nodes [F,B] int64 ORIGINAL node ids (host use),
    band_nodes_cat [F,B] int32 ids into the concatenated fwd++rev device
    tables, band_in [F,B,max_in] int8, seed_shift [F] int32, req,
    frag_len, n_slices, band_level [F,B] int32)."""
    g = gx.g
    if B > 127:
        raise ValueError(
            f"band slots B={B} exceeds 127: the CLC band is int8-indexed "
            "(native backwalks); use -b/-B <= 127 or optimal mode")
    F = len(jobs)
    rows = np.array([max(1, len(j.rmm)) for j in jobs], dtype=np.int32)
    S = int(max(1, -(-int(rows.max()) // W)))

    # band selection, forward and backward seeds in separate native calls
    band_nodes = np.full((F, B), -1, dtype=np.int64)
    band_in = np.full((F, B, max_in), -1, dtype=np.int64)
    band_level = np.full((F, B), -1, dtype=np.int64)
    for rev in (False, True):
        sel = [i for i, j in enumerate(jobs) if j.reverse == rev]
        if not sel:
            continue
        seeds = np.array([jobs[i].seed_node for i in sel], dtype=np.int64)
        slens = np.array([jobs[i].seed_trim_len for i in sel],
                         dtype=np.int64)
        max_bp = int(rows[sel].max()) + slack
        ptr, idx = (gx.in_ptr, gx.in_idx) if rev else (gx.out_ptr, gx.out_idx)
        bn, bi, bl, trunc = native.band_build(g.n_nodes, ptr, idx,
                                              gx.node_len64, seeds, slens,
                                              B, max_bp, max_in, rev,
                                              by_dist=g.cyclic)
        if trunc:
            _warn_truncated(trunc, max_in)
        band_nodes[sel] = bn
        band_in[sel] = bi
        band_level[sel] = bl

    # adaptive band width: bands rarely fill all B slots (a 35bp fragment
    # spans ~10 split nodes); trimming to the batch max (bucketed to
    # multiples of 8) cuts host->device transfer and kernel work.  Safe:
    # in-band in-edges always reference earlier slots.
    used = int((band_nodes >= 0).sum(axis=1).max()) if F else 1
    B_eff = min(B, max(8, -(-used // 8) * 8))
    if B_eff < B:
        band_nodes = band_nodes[:, :B_eff]
        band_in = band_in[:, :B_eff]
        band_level = band_level[:, :B_eff]

    # ids into the concatenated device tables: reversed nodes offset by +N
    is_rev = np.array([j.reverse for j in jobs], dtype=bool)
    band_nodes_cat = np.where(
        band_nodes >= 0,
        band_nodes + np.where(is_rev, g.n_nodes, 0)[:, None],
        -1).astype(np.int32)

    # seed trimming: drop (len - trim_len) columns from the slot-0 start
    trim_len = np.array([j.seed_trim_len for j in jobs], dtype=np.int64)
    seed_len = g.node_len[np.clip(band_nodes[:, 0], 0,
                                  g.n_nodes - 1)].astype(np.int64)
    seed_shift = (seed_len - trim_len).astype(np.int32)

    # read-row match planes, vectorized across the whole batch
    mm_pad = np.zeros((F, S * W), dtype=np.uint8)
    for i, j in enumerate(jobs):
        mm_pad[i, :len(j.rmm)] = j.rmm[:S * W]
    req = pack_row_planes(mm_pad).reshape(F, S, 4)

    return (band_nodes, band_nodes_cat, band_in.astype(np.int8),
            seed_shift, req, rows, S, band_level.astype(np.int8))


@dataclass
class CarryJob:
    """A continued extension window: the band is re-grown from every
    still-plausible slot of the previous window's band, and the previous
    boundary state carries over (full-band carry — re-design of the
    reference's slice-to-slice band seeding,
    src/GraphAlignerBitvectorBanded.h:253-406)."""
    rmm: np.ndarray          # window read rows (bwd: reversed)
    reverse: bool
    old_nodes: np.ndarray    # (B,) previous band node ids (-1 pad)
    old_ssb: np.ndarray      # (B,) carried boundary scores
    old_hp: np.ndarray       # (B,) carried horizontal +1 bits
    old_hn: np.ndarray       # (B,) carried horizontal -1 bits
    src_mask: np.ndarray     # (B,) bool: slots that re-seed the band
    old_shift: np.ndarray = None   # (B,) per-slot seed trims (column
                                   # alignment of carried hp/hn bits)


def assemble_carry_batch(gx: GraphTensors, jobs: Sequence["CarryJob"],
                         B: int, max_in: int = MAX_IN_DEGREE,
                         slack: int = 8):
    """Band + carried-state tensors for a batch of continued windows.

    Returns (band_nodes [F,B] int64, band_nodes_cat [F,B] int32,
    band_in [F,B,max_in] int8, band_level [F,B] int32,
    carry (ssb, hp, hn) each [F,B], slot_map [F,B] int32 new slot -> old
    slot (-1 = fresh), shifts [F,B] int32, req, rows, S)."""
    g = gx.g
    if B > 127:
        raise ValueError("carry bands are int8-indexed; B <= 127")
    F = len(jobs)
    rows = np.array([max(1, len(j.rmm)) for j in jobs], dtype=np.int32)
    S = int(max(1, -(-int(rows.max()) // W)))

    band_nodes = np.full((F, B), -1, dtype=np.int64)
    band_in = np.full((F, B, max_in), -1, dtype=np.int64)
    band_level = np.full((F, B), -1, dtype=np.int64)
    for rev in (False, True):
        sel = [i for i, j in enumerate(jobs) if j.reverse == rev]
        if not sel:
            continue
        src_off = [0]
        src_nodes = []
        for i in sel:
            j = jobs[i]
            srcs = j.old_nodes[j.src_mask & (j.old_nodes >= 0)]
            src_nodes.append(srcs[:B])
            src_off.append(src_off[-1] + len(src_nodes[-1]))
        # distances count from source-node STARTS, but the carried
        # boundary cell can sit at a source node's last column — extend
        # the reach by one full split node so the window's true path
        # cannot run off the band end
        max_bp = int(rows[sel].max()) + slack + W
        ptr, idx = (gx.in_ptr, gx.in_idx) if rev else (gx.out_ptr,
                                                      gx.out_idx)
        bn, bi, bl, trunc = native.band_build_multi(
            g.n_nodes, ptr, idx, gx.node_len64,
            np.array(src_off, dtype=np.int64),
            np.concatenate(src_nodes) if src_nodes else
            np.zeros(0, np.int64), B, max_bp, max_in, rev,
            by_dist=g.cyclic)
        if trunc:
            _warn_truncated(trunc, max_in)
        band_nodes[sel] = bn
        band_in[sel] = bi
        band_level[sel] = bl

    # adaptive band width (see assemble_batch)
    used = int((band_nodes >= 0).sum(axis=1).max()) if F else 1
    B_eff = min(B, max(8, -(-used // 8) * 8))
    if B_eff < B:
        band_nodes = band_nodes[:, :B_eff]
        band_in = band_in[:, :B_eff]
        band_level = band_level[:, :B_eff]
        B = B_eff

    is_rev = np.array([j.reverse for j in jobs], dtype=bool)
    band_nodes_cat = np.where(
        band_nodes >= 0,
        band_nodes + np.where(is_rev, g.n_nodes, 0)[:, None],
        -1).astype(np.int32)

    # map new slots onto old slots by node id (both bands are sorted in
    # traversal-topo order: ascending for fwd, descending for rev)
    BIG = frag_align.BIG
    slot_map = np.full((F, B), -1, dtype=np.int32)
    ssb = np.full((F, B), BIG, dtype=np.int32)
    hp = np.zeros((F, B), dtype=np.uint32)
    hn = np.zeros((F, B), dtype=np.uint32)
    shifts = np.zeros((F, B), dtype=np.int32)
    for i, j in enumerate(jobs):
        old_valid = j.old_nodes >= 0
        old_nodes = j.old_nodes[old_valid]
        old_idx = np.nonzero(old_valid)[0]
        # sort old nodes by id for the searchsorted match (fwd bands are
        # already ascending on DAGs, but cyclic by_dist bands are not)
        order = np.argsort(old_nodes)
        srt = old_nodes[order]
        new_valid = band_nodes[i] >= 0
        nn = band_nodes[i][new_valid]
        pos = np.searchsorted(srt, nn)
        ok = (pos < len(srt)) & (srt[np.clip(pos, 0, max(len(srt) - 1, 0))]
                                 == nn)
        mapped = np.full(len(nn), -1, dtype=np.int64)
        mapped[ok] = old_idx[order[pos[ok]]]
        slots = np.nonzero(new_valid)[0]
        m_ok = slots[ok]
        slot_map[i, m_ok] = mapped[ok]
        ssb[i, m_ok] = j.old_ssb[mapped[ok]]
        hp[i, m_ok] = j.old_hp[mapped[ok]]
        hn[i, m_ok] = j.old_hn[mapped[ok]]
        if j.old_shift is not None:
            shifts[i, m_ok] = j.old_shift[mapped[ok]]

    mm_pad = np.zeros((F, S * W), dtype=np.uint8)
    for i, j in enumerate(jobs):
        mm_pad[i, :len(j.rmm)] = j.rmm[:S * W]
    req = pack_row_planes(mm_pad).reshape(F, S, 4)

    return (band_nodes, band_nodes_cat, band_in.astype(np.int8),
            band_level.astype(np.int8), (ssb, hp, hn), slot_map, shifts,
            req, rows, S)


def pack_row_planes(mm: np.ndarray) -> np.ndarray:
    """(..., S*32) uint8 match masks -> (..., S, 4) uint32 planes (bit i
    of plane b = row 32s+i matches b)."""
    lead = mm.shape[:-1]
    S = mm.shape[-1] // W
    m = mm.reshape(*lead, S, W).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(W, dtype=np.uint32))
    planes = np.zeros((*lead, S, 4), dtype=np.uint32)
    for b in range(4):
        planes[..., b] = (((m >> np.uint32(b)) & 1) * weights).sum(
            axis=-1, dtype=np.uint32)
    return planes


def level_bucket(band_level: np.ndarray, B: int) -> int:
    """Level-loop trip count: next power of two >= max level + 1, at
    least 4, at most B (the reference's value)."""
    max_l = int(band_level.max(initial=0)) + 1
    n = 4
    while n < max_l:
        n *= 2
    return min(n, B)


def code0_padding(band_nodes_cat: np.ndarray, band_in: np.ndarray,
                  req: np.ndarray, rows: np.ndarray, max_in: int) -> bool:
    """Whether the reference would run this batch in its 2-bit read-code
    format (graphchainer_tpu.align.anchors._try_pack_frag accepts it).

    That format stores rows past a fragment's end as base code 0, so those
    rows match A, while the plane format leaves them matching nothing.
    They lie below the fragment's end row, yet the winning candidate of a
    slot (best_in) is chosen on the bottom row of the slice, so they can
    change the backwalk; the port reproduces them to give the same
    anchors."""
    F, B = band_nodes_cat.shape
    if B > 16 or band_in.shape[2] > 4 or max_in > 4 or F == 0:
        return False
    if (B * req.shape[1]) % 4:
        return False
    pad = band_nodes_cat < 0
    base = np.where(pad[:, 0], 0, band_nodes_cat[:, 0]).astype(np.int64)
    d = band_nodes_cat.astype(np.int64) - base[:, None]
    if ((~pad) & ((d > 32767) | (d < -32767))).any():
        return False
    p = req.astype(np.uint32)
    p0, p1, p2, p3 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    multi = ((p0 & p1) | (p0 & p2) | (p0 & p3) | (p1 & p2) | (p1 & p3)
             | (p2 & p3))
    cover = p0 | p1 | p2 | p3
    S = p.shape[1]
    ns = np.clip(rows[:, None].astype(np.int64)
                 - W * np.arange(S, dtype=np.int64)[None, :], 0, W)
    need = ((np.uint64(1) << ns.astype(np.uint64)) - 1).astype(np.uint32)
    return not ((multi != 0).any() or ((cover & need) != need).any())


def pad_rows_code0(req: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """req with every row at or past the fragment end matching A."""
    S = req.shape[1]
    ns = np.clip(rows[:, None].astype(np.int64)
                 - W * np.arange(S, dtype=np.int64)[None, :], 0, W)
    need = ((np.uint64(1) << ns.astype(np.uint64)) - 1).astype(np.uint32)
    out = req.copy()
    out[..., 0] |= ~need
    return out


def drop_self_edges(band_in: np.ndarray) -> np.ndarray:
    """band_in without in-edges of a slot to itself: the 2-bit format
    stores "none" as the slot's own index, so the reference reads such an
    edge as none."""
    own = band_in == np.arange(band_in.shape[1])[None, :, None]
    return np.where(own, -1, band_in).astype(band_in.dtype) \
        if own.any() else band_in


def band_arrays(band_nodes_cat: np.ndarray, band_in: np.ndarray,
                seed_shift: np.ndarray, req: np.ndarray, rows: np.ndarray,
                S: int, max_in: int, band_level: np.ndarray, carry_in=None):
    """frag_core's band arguments as host arrays, in the band build's
    types (int32 ids, int8 in-edges and levels, int32 shifts (F,) or
    (F, B), uint32 planes as int32 bits, int32 rows), with the 2-bit
    format's row padding and in-edge decoding where the reference would
    use that format (decided on the whole batch), then the carried state
    (ssb int32, hp / hn uint32 as int32 bits); and the keyword
    arguments.  Every array has the fragments on axis 0."""
    B = band_nodes_cat.shape[1]
    n_levels = level_bucket(band_level, B)
    if code0_padding(band_nodes_cat, band_in, req, rows, max_in):
        req = pad_rows_code0(req, rows)
        band_in = drop_self_edges(band_in)
    i32 = np.int32

    def bits(a):
        return np.ascontiguousarray(a, dtype=np.uint32).view(i32)
    arrays = [(band_nodes_cat, i32), (band_in, np.int8),
              (band_level, np.int8), (seed_shift, i32), (bits(req), i32),
              (rows, i32)]
    if carry_in is not None:
        arrays += [(carry_in[0], i32), (bits(carry_in[1]), i32),
                   (bits(carry_in[2]), i32)]
    return ([np.ascontiguousarray(a, dtype=t) for a, t in arrays],
            dict(S=S, max_in=max_in, n_levels=n_levels))


def _frag_args(eq, ln, band, kw):
    """frag_core's (args, keyword args) from the node table and the
    uploaded band arrays (the carry, if any, last)."""
    kw = dict(kw)
    if len(band) > 6:
        kw["carry"] = tuple(band[6:])
    return (eq, ln) + tuple(band[:6]), kw


def fragment_inputs(gx: GraphTensors, band_nodes_cat: np.ndarray,
                    band_in: np.ndarray, seed_shift: np.ndarray,
                    req: np.ndarray, rows: np.ndarray, S: int, max_in: int,
                    band_level: np.ndarray, device, carry_in=None):
    """The arguments of ops/frag_kernel.frag_core for a batch on one
    `device`: the resident node tables, then band_arrays' arrays in one
    copy, the carried state in the keyword `carry`.  Returns (args,
    keyword args)."""
    dev_eq, dev_len = gx.device_tables(device)
    arrays, kw = band_arrays(band_nodes_cat, band_in, seed_shift, req, rows,
                             S, max_in, band_level, carry_in)
    return _frag_args(dev_eq, dev_len, upload(arrays, dev_eq.device), kw)


def run_fragments(gx: GraphTensors, band_nodes_cat: np.ndarray,
                  band_in: np.ndarray, seed_shift: np.ndarray,
                  req: np.ndarray, rows: np.ndarray, S: int, max_in: int,
                  band_level: np.ndarray, device,
                  carry_in: Optional[tuple] = None,
                  want_state: bool = False,
                  want_xcells: bool = False) -> frag_align.FragResult:
    """The fragment DP over a whole batch on `device`, a device or a list
    of them (parallel/device.local_devices): one launch a shard, each
    device a row block against its resident copy of the node tables, or,
    where the model sharded the tables by component, each fragment on
    its component's shard.  No chunking, wire packing or band cache.
    Returns a numpy FragResult in batch order whose best_in is int8
    (F, B, S).

    seed_shift: (F,) trims slot 0 (fresh windows), (F, B) every slot
                (carried windows)
    carry_in:   (ssb, hp, hn) each (F, B) — continue a previous window's
                DP (its out_ssb / out_hp / out_hn, mapped onto this
                window's slots)
    want_state: also return out_ssb / out_hp (uint32) / out_hn (uint32),
                the carry of the next window
    want_xcells: also return xbest / xslot / xrow, the best X-score cell"""
    devices = local_devices(device)
    arrays, kw = band_arrays(band_nodes_cat, band_in, seed_shift, req, rows,
                             S, max_in, band_level, carry_in)

    def launch(eq, ln, band):
        args, kw2 = _frag_args(eq, ln, band, kw)
        return frag_kernel.frag_core(*args, **kw2, want_state=want_state,
                                     want_xcells=want_xcells)
    # component-sharded tables under the JAX package's condition
    # (graphchainer_tpu/align/anchors.py:841-851): a fresh batch with no
    # carry, state or X cells, B <= 32; otherwise the replicated tables
    sh = gx.shards
    F, B = band_nodes_cat.shape
    if (sh is not None and sh[0] == devices and len(devices) > 1 and F
            and carry_in is None and not want_state and not want_xcells
            and B <= 32):
        return _run_fragments_sharded(sh, band_nodes_cat, arrays, launch)
    return shard_call(
        lambda *band: launch(*gx.device_tables(band[0].device), band),
        arrays, (True,) * len(arrays), devices,
        download=frag_kernel.to_numpy)


def _run_fragments_sharded(shards, band_nodes_cat, arrays, launch):
    """run_fragments over component-sharded tables: each fragment goes to
    its seed's shard with its band ids made shard-local (the 2-bit
    format's decision stays the whole batch's, on global ids, so the
    result equals the replicated tables' run), each shard's rows go up in
    one copy and run against its table block, and the results come back
    in batch order."""
    devices, plan, tables = shards
    _, order, keep, Fd = route_fragments(plan, band_nodes_cat)
    arrays = [localize_bands(plan, band_nodes_cat)] + arrays[1:]
    calls, sels = [], []
    for d, (dev, (eq, ln)) in enumerate(zip(devices, tables)):
        sel = order[d * Fd:(d + 1) * Fd][keep[d * Fd:(d + 1) * Fd]]
        if len(sel):
            sels.append(sel)
            calls.append((d, dev, lambda eq=eq, ln=ln, dev=dev, sel=sel:
                          launch(eq, ln, upload(
                              [np.ascontiguousarray(a[sel]) for a in arrays],
                              dev))))
    return unpermute(concat_rows(run_shards(calls, frag_kernel.to_numpy)),
                     np.concatenate(sels))


def backwalk(best_in: np.ndarray, band_nodes: np.ndarray, end_slot: int,
             end_slice: int) -> Optional[list]:
    """Walk best_in pointers (B, S), int8 or int16, from (end_slot,
    end_slice) to the seed slot.  Returns the slot sequence [end ... seed]
    or None on a broken walk."""
    B, S = best_in.shape
    slot, s = int(end_slot), int(end_slice)
    out = [slot]
    for _ in range(B * S + 4):
        e = int(best_in[slot, s])
        if e == frag_align.IN_SEED:
            return out
        if e == frag_align.IN_VERT:
            s -= 1
            if s < 0:
                return None
            continue
        if e < 0:
            return None
        slot = e
        out.append(slot)
    return None

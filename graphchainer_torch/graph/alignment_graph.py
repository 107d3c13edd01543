"""The tensorized alignment graph.

Pipeline (re-design of reference src/BigraphToDigraph.cpp +
src/AlignmentGraph.cpp:38-307):

  GFA bigraph
    -> doubled digraph: segment X becomes digraph node 2X (forward strand)
       and 2X+1 (reverse complement), links mapped per orientation with their
       mirror edges (reference BigraphToDigraph.cpp:67-132)
    -> split nodes: each digraph node is cut at edge-overlap breakpoints and
       into <=SPLIT_LEN bp pieces (reference uses 64bp, we use 32bp to match
       the 32-bit Myers words; see constants.py)
    -> topological renumbering: split nodes are renumbered by topo rank so
       that device gathers of in-neighbors touch nearby addresses
    -> flat numpy arrays (lengths, Eq bitplanes, CSR edges, components).

The result is a host-side object whose arrays are uploaded to the device
once per run.

Copy of graphchainer_tpu/graph/alignment_graph.py; convert.py builds this
class from the fields of the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphchainer_torch import native
from graphchainer_torch.constants import SPLIT_LEN
from graphchainer_torch.io.gfa import Bigraph
from graphchainer_torch.utils.seq import match_masks, revcomp


@dataclass
class AlignmentGraph:
    # --- digraph level (2 nodes per GFA segment) ---
    names: List[str]          # GFA segment name for digraph node pair i//2
    di_seqs: List[str]        # sequence per digraph node (fwd / revcomp)

    # --- split-node level, topo-renumbered ---
    node_len: np.ndarray      # int32 [N] bases in split node (1..SPLIT_LEN)
    node_eq: np.ndarray       # uint32 [N, 4] Eq bitplanes
    orig_node: np.ndarray     # int32 [N] digraph node id
    orig_offset: np.ndarray   # int32 [N] offset of split within digraph node
    out_ptr: np.ndarray       # int64 [N+1]
    out_idx: np.ndarray       # int32 [M]
    in_ptr: np.ndarray        # int64 [N+1]
    in_idx: np.ndarray        # int32 [M]
    comp: np.ndarray          # int32 [N] weakly-connected component id
    ncomp: int

    # digraph node -> its split nodes ordered by offset
    di_ptr: np.ndarray        # int64 [n_di+1]
    di_splits: np.ndarray     # int32 (ragged data)

    # Cyclic-graph support (GA mode only, like the reference: its GA
    # machinery runs on cyclic graphs via SCC component order,
    # src/AlignmentGraph.cpp:1008-1115, while chaining requires a DAG,
    # src/AlignmentGraph.cpp:1298-1302).  When cyclic, node ids are SCC
    # condensation-topo ranks instead of topo ranks: edges BETWEEN SCCs
    # still go forward in id; edges within an SCC may go backward.
    cyclic: bool = False

    @property
    def n_nodes(self) -> int:
        return len(self.node_len)

    @property
    def n_digraph(self) -> int:
        return len(self.di_seqs)

    def node_seq(self, v: int) -> str:
        d = self.orig_node[v]
        o = self.orig_offset[v]
        return self.di_seqs[d][o:o + self.node_len[v]]

    def path_seq(self, path) -> str:
        """Concatenated sequence of a split-node path (nodes assumed
        consecutive along edges; overlap trimming is already encoded in the
        split-node structure, so plain concatenation is correct)."""
        return "".join(self.node_seq(int(v)) for v in path)

    def out_neighbors(self, v: int) -> np.ndarray:
        return self.out_idx[self.out_ptr[v]:self.out_ptr[v + 1]]

    def in_neighbors(self, v: int) -> np.ndarray:
        return self.in_idx[self.in_ptr[v]:self.in_ptr[v + 1]]

    def find_split(self, di_node: int, offset: int) -> Tuple[int, int]:
        """Split node covering (digraph node, base offset); returns
        (split id, offset within split)."""
        lo, hi = self.di_ptr[di_node], self.di_ptr[di_node + 1]
        splits = self.di_splits[lo:hi]
        offs = self.orig_offset[splits]
        j = int(np.searchsorted(offs, offset, side="right")) - 1
        s = int(splits[j])
        return s, offset - int(self.orig_offset[s])

    def reverse_position(self, v: int, offset: int) -> Tuple[int, int]:
        """Map (split node, offset) to the same base on the opposite strand
        (reference GetReversePosition, src/AlignmentGraph.cpp:741-760)."""
        d = int(self.orig_node[v])
        pos = int(self.orig_offset[v]) + offset
        rd = d ^ 1
        rpos = len(self.di_seqs[d]) - 1 - pos
        return self.find_split(rd, rpos)

    def gfa_name(self, v: int) -> str:
        return self.names[int(self.orig_node[v]) // 2]

    def is_reverse(self, v: int) -> bool:
        return bool(int(self.orig_node[v]) & 1)

    def approx_linear_pos(self) -> np.ndarray:
        """Approximate linear coordinate per split node: longest-path-
        from-source bp (native approx_pos) — the stand-in for the
        reference's chain decomposition + approximate positions
        (chainApproxPos / fixChainApproxPos, src/AlignmentGraph.cpp:
        309-642), used for diagonal seed clustering.  Both arms of a
        bubble share a coordinate, so seed diagonals stay aligned across
        variant arms.  Cached."""
        if not hasattr(self, "_approx_pos"):
            src = np.repeat(np.arange(self.n_nodes, dtype=np.int64),
                            np.diff(self.out_ptr))
            self._approx_pos = native.approx_pos(
                self.n_nodes, src, self.out_idx.astype(np.int64),
                self.node_len.astype(np.int64))
        return self._approx_pos

    def chains(self):
        """Chain decomposition (chain id + per-chain approximate position
        per split node) — the reference's findChains/chainApproxPos
        (src/AlignmentGraph.cpp:309-642): original-node splits, tip
        components, simple cycles and superbubble endpoints share a
        chain; the position is a DFS coordinate within the chain.
        Returns (chain_number [N] int64, chain_pos [N] int64).  Cached."""
        if not hasattr(self, "_chains"):
            self._chains = native.find_chains(
                self.n_nodes, self.out_ptr, self.out_idx, self.in_ptr,
                self.in_idx, self.node_len, self.di_ptr, self.di_splits,
                split_size=32)
        return self._chains

    def stats(self) -> Dict[str, int]:
        return dict(n_split_nodes=self.n_nodes,
                    n_edges=len(self.out_idx),
                    n_digraph_nodes=self.n_digraph,
                    n_components=self.ncomp,
                    total_bp=int(self.node_len.sum()))


def _digraph_edges(bg: Bigraph):
    """Doubled-digraph edges with overlap trims.

    Each edge is (src, dst, src_trim, dst_trim): a path through the edge
    spells src_seq[:len-src_trim] + dst_seq[dst_trim:].  The forward edge
    trims the overlap from the target's start; the reverse-complement mirror
    edge trims it from (the rc of) the source's end.
    """
    edges = set()
    for u, frev, v, trev, o in bg.links:
        su = 2 * u + (1 if frev else 0)
        sv = 2 * v + (1 if trev else 0)
        edges.add((su, sv, 0, o))
        # mirror edge on the opposite strands
        mu = 2 * v + (0 if trev else 1)
        mv = 2 * u + (0 if frev else 1)
        edges.add((mu, mv, o, 0))
    return sorted(edges)


def _pack_eq_planes(di_seqs: List[str], orig_node: np.ndarray,
                    orig_offset: np.ndarray,
                    node_len: np.ndarray) -> np.ndarray:
    """Vectorized Eq bitplane packing for all split nodes at once."""
    n = len(orig_node)
    mm_all = np.concatenate([match_masks(s) for s in di_seqs]) \
        if di_seqs else np.zeros(0, dtype=np.uint8)
    di_base = np.zeros(len(di_seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in di_seqs], out=di_base[1:])
    starts = di_base[orig_node.astype(np.int64)] + orig_offset
    cols = np.arange(SPLIT_LEN, dtype=np.int64)
    weights = (np.uint32(1) << np.arange(SPLIT_LEN, dtype=np.uint32))
    node_eq = np.zeros((n, 4), dtype=np.uint32)
    chunk = 1 << 18
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        idx = starts[lo:hi, None] + cols[None, :]
        valid = cols[None, :] < node_len[lo:hi, None]
        mm = np.where(valid, mm_all[np.clip(idx, 0, max(len(mm_all) - 1, 0))],
                      0).astype(np.uint32)
        for b in range(4):
            node_eq[lo:hi, b] = np.bitwise_or.reduce(
                ((mm >> np.uint32(b)) & np.uint32(1)) * weights, axis=1)
    return node_eq


def build_alignment_graph(bg: Bigraph,
                          allow_cycles: bool = False) -> AlignmentGraph:
    n_di = 2 * len(bg.seqs)
    di_seqs: List[str] = []
    for s in bg.seqs:
        di_seqs.append(s)
        di_seqs.append(revcomp(s))

    edges = _digraph_edges(bg)

    # Breakpoints per digraph node: edge entry/exit offsets (nonzero only
    # for GFA links with overlaps — rare; those nodes take a slow path).
    breakpoints: Dict[int, set] = {}
    for su, sv, st, dt in edges:
        if dt:
            breakpoints.setdefault(sv, set()).add(dt)
        if st:
            breakpoints.setdefault(su, set()).add(len(di_seqs[su]) - st)

    di_len = np.array([len(s) for s in di_seqs], dtype=np.int64)
    if np.any(di_len == 0):
        raise ValueError("empty GFA segment sequence")

    # --- vectorized split-node construction (regular nodes) -------------
    # Regular nodes (no breakpoints) split into ceil(L/32) pieces; nodes
    # with breakpoints are rebuilt below and patched in.
    counts = -(-di_len // SPLIT_LEN)
    irregular = sorted(breakpoints.keys())
    for d in irregular:
        bps = sorted({0, int(di_len[d])}
                     | {b for b in breakpoints[d] if 0 < b < di_len[d]})
        c = 0
        for a, b in zip(bps[:-1], bps[1:]):
            c += -(-(b - a) // SPLIT_LEN)
        counts[d] = c
    di_ptr_arr0 = np.zeros(n_di + 1, dtype=np.int64)
    np.cumsum(counts, out=di_ptr_arr0[1:])
    n = int(di_ptr_arr0[-1])

    split_di_arr = np.repeat(np.arange(n_di, dtype=np.int64), counts)
    # regular offsets: k*SPLIT_LEN within each node
    within = (np.arange(n, dtype=np.int64)
              - di_ptr_arr0[split_di_arr])
    split_off_arr = within * SPLIT_LEN
    split_len_arr = np.minimum(SPLIT_LEN,
                               di_len[split_di_arr] - split_off_arr)
    for d in irregular:
        bps = sorted({0, int(di_len[d])}
                     | {b for b in breakpoints[d] if 0 < b < di_len[d]})
        offs, lens = [], []
        for a, b in zip(bps[:-1], bps[1:]):
            pos = a
            while pos < b:
                ln = min(SPLIT_LEN, b - pos)
                offs.append(pos)
                lens.append(ln)
                pos += ln
        lo = di_ptr_arr0[d]
        split_off_arr[lo:lo + len(offs)] = offs
        split_len_arr[lo:lo + len(offs)] = lens

    # intra-node chain edges: consecutive splits of the same node
    intra_src = np.nonzero(split_di_arr[:-1] == split_di_arr[1:])[0]
    intra = np.stack([intra_src, intra_src + 1], axis=1)

    # inter-node edges: exact-offset lookup (binary search per node)
    def split_at(d, offset, end):
        lo, hi = di_ptr_arr0[d], di_ptr_arr0[d + 1]
        offs = split_off_arr[lo:hi]
        if end:
            j = int(np.searchsorted(offs + split_len_arr[lo:hi], offset,
                                    side="left"))
        else:
            j = int(np.searchsorted(offs, offset, side="left"))
        return int(lo + j)

    inter = np.empty((len(edges), 2), dtype=np.int64)
    for i, (su, sv, st, dt) in enumerate(edges):
        inter[i, 0] = split_at(su, int(di_len[su]) - st, end=True)
        inter[i, 1] = split_at(sv, dt, end=False)

    all_e = np.unique(np.concatenate([intra, inter], axis=0), axis=0) \
        if len(intra) + len(inter) else np.zeros((0, 2), np.int64)
    src = all_e[:, 0]
    dst = all_e[:, 1]
    split_di = split_di_arr
    split_off = split_off_arr
    split_len = split_len_arr
    di_ptr = di_ptr_arr0

    cyclic = False
    try:
        order, rank = native.topo_order(n, src, dst)
    except ValueError:
        if not allow_cycles:
            raise
        # GA mode tolerates cycles: renumber by SCC condensation order
        # (the kernel's one-pass band drops intra-window back edges;
        # cycles are traversed across extension windows, whose band
        # rebuild walks the raw CSR).
        _, order, rank, _ = native.scc_order(n, src, dst)
        cyclic = True

    # Renumber: new id = topo rank.
    rank32 = rank.astype(np.int64)
    new_src = rank32[src]
    new_dst = rank32[dst]
    perm = order  # new id i corresponds to old id order[i]

    node_len = np.asarray(split_len, dtype=np.int32)[perm]
    orig_node = np.asarray(split_di, dtype=np.int32)[perm]
    orig_offset = np.asarray(split_off, dtype=np.int32)[perm]

    node_eq = _pack_eq_planes(di_seqs, orig_node, orig_offset, node_len)

    # CSR (sorted by src then dst for determinism)
    eorder = np.lexsort((new_dst, new_src))
    es, ed = new_src[eorder], new_dst[eorder]
    out_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(out_ptr, es + 1, 1)
    out_ptr = np.cumsum(out_ptr)
    out_idx = ed.astype(np.int32)
    eorder2 = np.lexsort((new_src, new_dst))
    es2, ed2 = new_src[eorder2], new_dst[eorder2]
    in_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(in_ptr, ed2 + 1, 1)
    in_ptr = np.cumsum(in_ptr)
    in_idx = es2.astype(np.int32)

    ncomp, comp = native.connected_components(n, new_src, new_dst)

    # digraph -> splits (renumbered, still ordered by offset)
    di_ptr_arr = np.asarray(di_ptr, dtype=np.int64)
    old_splits = np.arange(n, dtype=np.int64)
    new_of_old = rank32
    di_splits = new_of_old[old_splits].astype(np.int32)  # index = old id

    return AlignmentGraph(
        names=list(bg.names), di_seqs=di_seqs,
        node_len=node_len, node_eq=node_eq,
        orig_node=orig_node, orig_offset=orig_offset,
        out_ptr=out_ptr, out_idx=out_idx, in_ptr=in_ptr, in_idx=in_idx,
        comp=comp.astype(np.int32), ncomp=ncomp,
        di_ptr=di_ptr_arr, di_splits=di_splits, cyclic=cyclic)

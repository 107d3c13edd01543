"""MUM/MEM seeding over a suffix array of the graph node sequences.

Copy of graphchainer_tpu/index/mem.py, on this package's native bindings
and SeedHit.  Re-design of the reference MummerSeeder
(src/MummerSeeder.{h,cpp}), which wraps mummer4's sparseSA over the
concatenated node sequences with a boost-serialized on-disk cache.  Here: a prefix-doubling suffix array in
the C++ host runtime, matching statistics per read, and maximal-match
extraction:

  MEM  = maximal exact match (locally maximal: cannot be extended left or
         right), all graph occurrences up to `max_count`;
  MUM  = MEMs whose graph occurrence is unique.

The index serializes to .npz (the reference's --seeds-mxm-cache-prefix).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from graphchainer_torch import native
from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.index.minimizer import SeedHit

SEP = 0  # separator byte between node sequences (never matches ACGT)


@dataclass
class MemIndex:
    text: np.ndarray        # uint8 concat of digraph node seqs + separators
    sa: np.ndarray          # int64 suffix array
    starts: np.ndarray      # int64 [n_di] text offset of each digraph node

    def save(self, path: str):
        np.savez_compressed(path, text=self.text, sa=self.sa,
                            starts=self.starts)

    @staticmethod
    def load(path: str) -> "MemIndex":
        z = np.load(path)
        return MemIndex(text=z["text"], sa=z["sa"], starts=z["starts"])


def build_mem_index(g: AlignmentGraph) -> MemIndex:
    parts = []
    starts = np.zeros(g.n_digraph, dtype=np.int64)
    pos = 0
    for d, seq in enumerate(g.di_seqs):
        starts[d] = pos
        b = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        parts.append(b)
        parts.append(np.array([SEP], dtype=np.uint8))
        pos += len(b) + 1
    text = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    sa = native.suffix_array(text)
    return MemIndex(text=text, sa=sa, starts=starts)


def get_mem_seeds(index: MemIndex, g: AlignmentGraph, read: str,
                  min_len: int = 20, max_count: int = 10,
                  unique_only: bool = False) -> List[SeedHit]:
    """Maximal exact matches of the read vs all node sequences as seeds.
    unique_only=True gives MUM-style seeds (single graph occurrence)."""
    rb = np.frombuffer(read.upper().encode("ascii"), dtype=np.uint8)
    if len(rb) == 0 or len(index.text) == 0:
        return []
    ms_len, ms_lo, ms_hi = native.matching_stats(index.text, index.sa, rb)
    seeds: List[SeedHit] = []
    prev_len = 0
    for i in range(len(rb)):
        L = int(ms_len[i])
        if L >= min_len and L + 1 != prev_len:
            # locally maximal: not a suffix of the previous position's match
            count = int(ms_hi[i] - ms_lo[i])
            if count >= 1 and (not unique_only or count == 1) \
                    and count <= max_count:
                for s in range(int(ms_lo[i]), int(ms_hi[i])):
                    tpos = int(index.sa[s])
                    d = int(np.searchsorted(index.starts, tpos,
                                            side="right")) - 1
                    off = tpos - int(index.starts[d])
                    if off + L > len(g.di_seqs[d]):
                        continue  # match crosses a separator (shouldn't)
                    seeds.append(SeedHit(di_node=d, node_offset=off,
                                         seq_pos=i, match_len=L,
                                         goodness=float(L)))
        prev_len = L
    return seeds


class MemSeeder:
    """Drop-in seeder: get_seeds(read) like the minimizer path."""

    def __init__(self, g: AlignmentGraph, index: Optional[MemIndex] = None,
                 min_len: int = 20, max_count: int = 10,
                 unique_only: bool = False):
        self.g = g
        self.index = index or build_mem_index(g)
        self.min_len = min_len
        self.max_count = max_count
        self.unique_only = unique_only

    def get_seeds(self, read: str) -> List[SeedHit]:
        return get_mem_seeds(self.index, self.g, read, self.min_len,
                             self.max_count, self.unique_only)

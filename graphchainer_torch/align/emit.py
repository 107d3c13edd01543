"""Alignment -> mappings/edits conversion for the GAF emitter.

JAX-free copy of graphchainer_tpu/align/emit.py (to_mappings, identity,
cigar_string): walks the polish edit ops over the per-char path
positions, grouping by original (GFA) node into vg-style mappings with
match/mismatch/ins/del edits."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.models.chainer import ReadAlignment

OP_MATCH, OP_DEL, OP_INS, OP_MISMATCH = 0, 1, 2, 3


@dataclass
class EditItem:
    from_length: int
    to_length: int
    sequence: str = ""


@dataclass
class MappingItem:
    node_name: str
    node_id: int          # the reference binary's INTERNAL digraph node
                          # id (0-based appearance order) — byte-parity
                          # with its GAM output (src/Aligner.cpp:152-165
                          # writes internal ids in node_id and the GFA
                          # name in Position.name)
    offset: int           # offset in the oriented node where mapping starts
    is_reverse: bool
    edits: List[EditItem] = field(default_factory=list)
    node_len: int = 0


def to_mappings(g: AlignmentGraph, aln: ReadAlignment
                ) -> List[MappingItem]:
    """Convert (positions, ops) into per-original-node mappings.  A new
    mapping starts whenever the consumed path char is not the next offset
    of the current oriented node."""
    if aln.failed or aln.ops is None:
        return []
    # oriented digraph-node coordinates per path char (vectorized)
    arr = np.asarray(aln.positions, dtype=np.int64)
    di = g.orig_node[arr[:, 0]].astype(np.int64).tolist()
    off = (g.orig_offset[arr[:, 0]].astype(np.int64) + arr[:, 1]).tolist()

    mappings: List[MappingItem] = []
    read = aln.seq
    pi = 0   # path char index
    si = aln.seq_start   # read index (ops cover the aligned span)
    cur: Optional[MappingItem] = None
    cur_d = None
    next_off = -1   # expected offset of the next path char in cur mapping

    def new_mapping(p):
        nonlocal cur, cur_d, next_off
        d = di[p]
        name = g.names[d // 2]
        cur = MappingItem(node_name=name,
                          node_id=d // 2,
                          offset=off[p], is_reverse=bool(d & 1),
                          node_len=len(g.di_seqs[d]))
        cur_d = d
        next_off = off[p]
        mappings.append(cur)

    for op in aln.ops:
        p = min(pi, len(di) - 1)
        if op != OP_INS:
            if cur is None or di[p] != cur_d or off[p] != next_off:
                new_mapping(p)
            next_off = off[p] + 1
        elif cur is None:
            new_mapping(p)
            # an insertion doesn't consume the path char: keep next_off
            next_off = off[p]

        if op == OP_MATCH:
            if cur.edits and cur.edits[-1].from_length == cur.edits[-1].to_length \
                    and not cur.edits[-1].sequence:
                cur.edits[-1].from_length += 1
                cur.edits[-1].to_length += 1
            else:
                cur.edits.append(EditItem(1, 1))
            pi += 1
            si += 1
        elif op == OP_MISMATCH:
            ch = read[si] if si < len(read) else "N"
            if cur.edits and cur.edits[-1].from_length == cur.edits[-1].to_length \
                    and cur.edits[-1].sequence:
                cur.edits[-1].from_length += 1
                cur.edits[-1].to_length += 1
                cur.edits[-1].sequence += ch
            else:
                cur.edits.append(EditItem(1, 1, ch))
            pi += 1
            si += 1
        elif op == OP_DEL:
            if cur.edits and cur.edits[-1].to_length == 0:
                cur.edits[-1].from_length += 1
            else:
                cur.edits.append(EditItem(1, 0))
            pi += 1
        else:  # OP_INS
            ch = read[si] if si < len(read) else "N"
            if cur is not None and cur.edits \
                    and cur.edits[-1].from_length == 0:
                cur.edits[-1].to_length += 1
                cur.edits[-1].sequence += ch
            elif cur is not None:
                cur.edits.append(EditItem(0, 1, ch))
            si += 1
    return mappings


def identity(aln: ReadAlignment) -> float:
    if aln.ops is None or len(aln.ops) == 0:
        return 0.0
    matches = int(np.sum(np.asarray(aln.ops) == OP_MATCH))
    return matches / len(aln.ops)


def cigar_string(aln: ReadAlignment, merge_mm: bool = True) -> str:
    """GAF cg:Z cigar: = / X (or merged M), I, D."""
    if aln.ops is None:
        return ""
    syms = {OP_MATCH: "=", OP_MISMATCH: "X", OP_DEL: "D", OP_INS: "I"}
    if merge_mm:
        syms[OP_MATCH] = "M"
        syms[OP_MISMATCH] = "M"
    out = []
    last, n = None, 0
    for op in aln.ops:
        s = syms[int(op)]
        if s == last:
            n += 1
        else:
            if last is not None:
                out.append(f"{n}{last}")
            last, n = s, 1
    if last is not None:
        out.append(f"{n}{last}")
    return "".join(out)

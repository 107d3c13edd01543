"""GAF (graph alignment format) emission.

JAX-free copy of graphchainer_tpu/io/gaf.py: one tab-separated line per
alignment with an oriented node path (>name / <name), path coordinates
and a cg:Z cigar."""
from __future__ import annotations

from typing import List

from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.align import emit as emit_mod
from graphchainer_torch.align.emit import OP_MATCH, cigar_string
from graphchainer_torch.models.chainer import ReadAlignment


def gaf_line(g: AlignmentGraph, aln: ReadAlignment,
             cigar_merge_mm: bool = True) -> str:
    mappings = emit_mod.to_mappings(g, aln)
    if not mappings:
        return ""
    path_parts: List[str] = []
    path_len = 0
    prev = None
    for m in mappings:
        key = (m.node_name, m.is_reverse)
        if key != prev:
            path_parts.append(("<" if m.is_reverse else ">") + m.node_name)
            path_len += m.node_len
            prev = key
    path_start = mappings[0].offset
    consumed = sum(e.from_length for m in mappings for e in m.edits)
    path_end = path_start + consumed
    matches = sum(1 for op in (aln.ops if aln.ops is not None else [])
                  if op == OP_MATCH)
    block_len = len(aln.ops) if aln.ops is not None else 0
    mapq = 60
    fields = [
        aln.name, str(len(aln.seq)), str(aln.seq_start), str(aln.seq_end),
        "+", "".join(path_parts), str(path_len), str(path_start),
        str(path_end), str(matches), str(block_len), str(mapq),
        "NM:i:" + str(aln.score), "AS:f:" + str(max(block_len - aln.score, 0)),
        "dv:f:" + (f"{aln.score / block_len:.6f}" if block_len else "0"),
        "id:f:" + (f"{matches / block_len:.6f}" if block_len else "0"),
        "cg:Z:" + cigar_string(aln, cigar_merge_mm),
    ]
    return "\t".join(fields)

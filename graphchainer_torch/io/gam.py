"""GAM / vg-JSON alignment emission.

GAM wire format (reference src/stream.hpp): a gzip stream of groups, each
group = varint64 message count + per-message (varint32 length + protobuf
bytes).  vg.Alignment messages are encoded by the hand-rolled wire encoder
(io/vg_wire.py).  An empty GAM still carries one varint-0 group
(reference src/Aligner.cpp:228-240).

JAX-free copy of graphchainer_tpu/io/gam.py."""
from __future__ import annotations

import gzip
import json
from typing import IO, List, Optional

from graphchainer_torch.align import emit as emit_mod
from graphchainer_torch.align.emit import MappingItem, identity
from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.io import vg_wire
from graphchainer_torch.models.chainer import ReadAlignment


def alignment_message(g: AlignmentGraph, aln: ReadAlignment) -> bytes:
    mappings = emit_mod.to_mappings(g, aln)
    wire_mappings = []
    # the reference binary numbers mapping ranks 0-based (the first
    # mapping's rank field is absent on the wire) — byte parity
    for rank, m in enumerate(mappings, start=0):
        pos = vg_wire.position(m.node_id, m.offset, m.is_reverse,
                               name=m.node_name)
        edits = [vg_wire.edit(e.from_length, e.to_length, e.sequence)
                 for e in m.edits]
        wire_mappings.append(vg_wire.mapping(pos, edits, rank))
    path_msg = vg_wire.path(wire_mappings) if wire_mappings else None
    return vg_wire.alignment(sequence=aln.seq, path_msg=path_msg,
                             name=aln.name, score=int(aln.score),
                             identity=identity(aln),
                             is_secondary=aln.is_secondary)


class GamWriter:
    def __init__(self, path: str, group_size: int = 100):
        self._f = gzip.open(path, "wb")
        self._buf: List[bytes] = []
        self._group = group_size
        self._wrote_any = False

    def write(self, msg: bytes):
        self._buf.append(msg)
        if len(self._buf) >= self._group:
            self.flush()

    def flush(self):
        if not self._buf:
            return
        out = vg_wire.varint(len(self._buf))
        for m in self._buf:
            out += vg_wire.varint(len(m)) + m
        self._f.write(out)
        self._wrote_any = True
        self._buf = []

    def close(self):
        self.flush()
        if not self._wrote_any:
            # empty GAM: a single varint 0 group
            self._f.write(vg_wire.varint(0))
        self._f.close()


def read_gam(path: str) -> List[bytes]:
    """Read back raw Alignment message bytes (for tests/tools)."""
    data = gzip.open(path, "rb").read()
    pos = 0

    def take_varint():
        nonlocal pos
        shift, val = 0, 0
        while True:
            b = data[pos]
            pos += 1
            val |= (b & 0x7F) << shift
            if not (b & 0x80):
                return val
            shift += 7

    out = []
    while pos < len(data):
        count = take_varint()
        for _ in range(count):
            ln = take_varint()
            out.append(data[pos:pos + ln])
            pos += ln
    return out


def alignment_json(g: AlignmentGraph, aln: ReadAlignment) -> str:
    """vg-style JSON (one line), like the reference's --all-alignments-file
    .json output."""
    mappings = emit_mod.to_mappings(g, aln)
    obj = {
        "name": aln.name,
        "sequence": aln.seq,
        "score": int(aln.score),
        "identity": identity(aln),
    }
    if mappings:
        jm = []
        for rank, m in enumerate(mappings, start=1):
            position = {"node_id": str(m.node_id)}
            if m.node_name:
                # original GFA segment name, like the GAM wire's
                # Position.name (the reference binary sets both)
                position["name"] = m.node_name
            if m.offset:
                position["offset"] = str(m.offset)
            if m.is_reverse:
                position["is_reverse"] = True
            edits = []
            for e in m.edits:
                je = {}
                if e.from_length:
                    je["from_length"] = e.from_length
                if e.to_length:
                    je["to_length"] = e.to_length
                if e.sequence:
                    je["sequence"] = e.sequence
                edits.append(je)
            jm.append({"position": position, "edit": edits,
                       "rank": str(rank)})
        obj["path"] = {"mapping": jm}
    return json.dumps(obj, separators=(",", ":"))

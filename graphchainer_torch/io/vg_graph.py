"""vg protobuf graph input (.vg) -> Bigraph.

The .vg format is a gzip stream of varint-framed vg.Graph messages
(reference src/BigraphToDigraph.cpp StreamVGGraphFromFile + stream.hpp).
Edge orientation semantics (vg schema, mirrored in the reference's vendored
src/vg.proto:28-38): an edge connects the end of `from` to the start of
`to` by default; from_start / to_end flip the respective side, which maps
onto the Bigraph's (from_reverse, to_reverse) link flags.  Embedded
vg.Path messages (Graph field 3; src/vg.proto:104-109) are parsed into
Bigraph.paths as (node, is_reverse) step lists ordered by mapping rank.

JAX-free copy of graphchainer_tpu/io/vg_graph.py."""
from __future__ import annotations

import gzip
from typing import Iterator

from graphchainer_torch.io.gfa import Bigraph
from graphchainer_torch.io.vg_wire import decode_fields, to_dict

_NODE_SCHEMA = {1: ("sequence", "str"), 2: ("name", "str"), 3: ("id", "int")}
_EDGE_SCHEMA = {1: ("from", "int"), 2: ("to", "int"),
                3: ("from_start", "int"), 4: ("to_end", "int"),
                5: ("overlap", "int")}
# vg.Path / Mapping / Position subset (reference src/vg.proto:62-109)
_POS_SCHEMA = {1: ("node_id", "int"), 4: ("is_reverse", "int")}
_MAPPING_SCHEMA = {1: ("position", "bytes"), 5: ("rank", "int")}
_PATH_SCHEMA = {1: ("name", "str"),
                2: ("mapping", "bytes", "repeated")}


def _stream_messages(path: str) -> Iterator[bytes]:
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

    while pos < len(data):
        count = take_varint()
        for _ in range(count):
            ln = take_varint()
            yield data[pos:pos + ln]
            pos += ln


def _parse_path(msg: bytes):
    """vg.Path -> (name, [(vg_node_id, is_reverse), ...]) ordered by rank."""
    p = to_dict(msg, _PATH_SCHEMA)
    steps = []
    for order, m in enumerate(p.get("mapping", [])):
        md = to_dict(m, _MAPPING_SCHEMA)
        if "position" not in md:
            continue
        pos = to_dict(md["position"], _POS_SCHEMA)
        if "node_id" not in pos:
            continue
        rank = md.get("rank", 0)
        steps.append((rank if rank else order + 1, order,
                      pos["node_id"], bool(pos.get("is_reverse", 0))))
    steps.sort()
    return p.get("name", ""), [(nid, rev) for _, _, nid, rev in steps]


def load_vg(path: str) -> Bigraph:
    bg = Bigraph()
    id_to_idx = {}
    pending_edges = []
    pending_paths = []
    for msg in _stream_messages(path):
        for field, wire, val in decode_fields(msg):
            if field == 1 and wire == 2:      # Node
                node = to_dict(val, _NODE_SCHEMA)
                nid = node.get("id")
                seq = node.get("sequence", "")
                if nid is None or not seq:
                    continue
                id_to_idx[nid] = bg.add_segment(str(nid), seq.upper())
            elif field == 2 and wire == 2:    # Edge
                pending_edges.append(to_dict(val, _EDGE_SCHEMA))
            elif field == 3 and wire == 2:    # Path (embedded haplotype/ref)
                pending_paths.append(_parse_path(val))
    for e in pending_edges:
        f, t = e.get("from"), e.get("to")
        if f not in id_to_idx or t not in id_to_idx:
            raise ValueError(f"vg edge references unknown node: {f}->{t}")
        bg.links.append((id_to_idx[f], bool(e.get("from_start", 0)),
                         id_to_idx[t], bool(e.get("to_end", 0)),
                         int(e.get("overlap", 0))))
    for name, steps in pending_paths:
        if not name or not steps:
            continue
        try:
            bg.paths[name] = [(id_to_idx[nid], rev) for nid, rev in steps]
        except KeyError as e:
            raise ValueError(
                f"vg path {name!r} references unknown node: {e}") from None
    return bg

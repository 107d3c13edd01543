"""GAM alignment reading: decode vg.Alignment messages (for seed files,
Postprocess-style tools and tests).

Reference: file seeds are .gam alignments loaded into a name -> SeedHit
map (src/Aligner.cpp:1169-1190).

JAX-free copy of graphchainer_tpu/io/gam_reader.py."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from graphchainer_torch.io.gam import read_gam
from graphchainer_torch.io.vg_wire import decode_fields, to_dict

_POSITION_SCHEMA = {1: ("node_id", "int"), 2: ("offset", "int"),
                    4: ("is_reverse", "int"), 5: ("name", "str")}
_EDIT_SCHEMA = {1: ("from_length", "int"), 2: ("to_length", "int"),
                3: ("sequence", "str")}


@dataclass
class GamMapping:
    node_id: int = 0
    offset: int = 0
    is_reverse: bool = False
    edits: List[dict] = field(default_factory=list)
    rank: int = 0
    node_name: str = ""     # Position.name: the original GFA segment name
                            # (the reference binary always sets it,
                            # src/Aligner.cpp:152-165)

    @property
    def node_key(self) -> str:
        """GFA segment name for graph lookups: Position.name when the
        writer set it (ours and the reference binary do; node_id is the
        internal digraph id there), else the numeric node_id (plain vg
        GAMs, where node_id IS the segment name)."""
        return self.node_name or str(self.node_id)


@dataclass
class GamAlignment:
    name: str = ""
    sequence: str = ""
    score: int = 0
    identity: float = 0.0
    mapping_quality: int = 0
    mappings: List[GamMapping] = field(default_factory=list)


def parse_alignment(data: bytes) -> GamAlignment:
    import struct
    aln = GamAlignment()
    for f, wire, val in decode_fields(data):
        if f == 1:
            aln.sequence = val.decode("utf-8")
        elif f == 3:
            aln.name = val.decode("utf-8")
        elif f == 5:
            aln.mapping_quality = val
        elif f == 6:
            aln.score = val
        elif f == 16:
            aln.identity = struct.unpack("<d", val.to_bytes(8, "little"))[0]
        elif f == 2:  # Path
            for pf, pw, pv in decode_fields(val):
                if pf != 2:
                    continue
                m = GamMapping()
                for mf, mw, mv in decode_fields(pv):
                    if mf == 1:
                        pos = to_dict(mv, _POSITION_SCHEMA)
                        m.node_id = pos.get("node_id", 0)
                        m.offset = pos.get("offset", 0)
                        m.is_reverse = bool(pos.get("is_reverse", 0))
                        m.node_name = pos.get("name", "")
                    elif mf == 2:
                        m.edits.append(to_dict(mv, _EDIT_SCHEMA))
                    elif mf == 5:
                        m.rank = mv
                aln.mappings.append(m)
    return aln


def load_gam_alignments(path: str) -> List[GamAlignment]:
    return [parse_alignment(msg) for msg in read_gam(path)]


def load_gam_seeds(path: str, name_to_id=None):
    """name -> list of SeedHit (reference file-seed semantics,
    src/Aligner.cpp:1169-1190): the first mapping of each stored alignment
    seeds the read at its query_position/first mapping position."""
    from graphchainer_torch.index.minimizer import SeedHit
    seeds = {}
    for aln in load_gam_alignments(path):
        if not aln.mappings:
            continue
        m = aln.mappings[0]
        if name_to_id is not None:
            # our writer (like the reference binary) carries the GFA
            # segment name in Position.name and the internal digraph id
            # in node_id; third-party GAMs may only set node_id
            base = name_to_id.get(m.node_name or str(m.node_id))
            if base is None:
                continue
            di = 2 * base + (1 if m.is_reverse else 0)
        else:
            di = 2 * m.node_id + (1 if m.is_reverse else 0)
        match_len = sum(e.get("from_length", 0) for e in m.edits) or 15
        seeds.setdefault(aln.name, []).append(SeedHit(
            di_node=di, node_offset=m.offset, seq_pos=0,
            match_len=min(match_len, 32), goodness=1.0))
    return seeds

"""GFA v1/1.1 parsing into a bidirected sequence graph.

Parses S (segment) and L (link) lines like the reference
(src/GfaGraph.cpp:220-293), plus P (GFA 1.0 paths) and W (GFA 1.1 walks)
lines, which the reference ignores but which are useful as truth paths for
simulation and evaluation.  String node names are mapped to dense integer
ids; per-link overlaps are kept (a link `u o1 v o2 kM` means the last k
bases of the source orientation equal the first k bases of the target
orientation, so a path uses seq(u) + seq(v)[k:]).

Copy of graphchainer_tpu/io/gfa.py.
"""
from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Bigraph:
    """Bidirected graph: one entry per GFA segment, links with orientations."""
    names: List[str] = field(default_factory=list)
    seqs: List[str] = field(default_factory=list)
    # (from_id, from_is_reverse, to_id, to_is_reverse, overlap_bp)
    links: List[Tuple[int, bool, int, bool, int]] = field(default_factory=list)
    name_to_id: Dict[str, int] = field(default_factory=dict)
    # named paths from P (GFA 1.0) / W (GFA 1.1 walk) lines:
    # name -> [(segment_id, is_reverse), ...]
    paths: Dict[str, List[Tuple[int, bool]]] = field(default_factory=dict)

    def add_segment(self, name: str, seq: str) -> int:
        if name in self.name_to_id:
            raise ValueError(f"duplicate GFA segment name: {name}")
        nid = len(self.names)
        self.name_to_id[name] = nid
        self.names.append(name)
        self.seqs.append(seq)
        return nid


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def parse_overlap(cigar: str) -> int:
    """Overlap in bases from a GFA link CIGAR.  Accepts '*', '0M', 'kM'."""
    cigar = cigar.strip()
    if cigar in ("*", ""):
        return 0
    if cigar.endswith("M"):
        try:
            return int(cigar[:-1])
        except ValueError:
            pass
    raise ValueError(f"unsupported GFA link overlap: {cigar!r}")


def parse_path_steps(spec: str) -> List[Tuple[str, bool]]:
    """P-line step list: 'seg1+,seg2-,...' -> [(name, is_reverse), ...]."""
    steps = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok[-1] not in "+-":
            raise ValueError(f"malformed GFA path step: {tok!r}")
        steps.append((tok[:-1], tok[-1] == "-"))
    return steps


def parse_walk_steps(spec: str) -> List[Tuple[str, bool]]:
    """W-line walk string: '>s1<s2>s3' -> [(name, is_reverse), ...]."""
    steps: List[Tuple[str, bool]] = []
    i, n = 0, len(spec)
    while i < n:
        orient = spec[i]
        if orient not in "><":
            raise ValueError(f"malformed GFA walk at offset {i}: {spec!r}")
        j = i + 1
        while j < n and spec[j] not in "><":
            j += 1
        name = spec[i + 1:j]
        if not name:
            raise ValueError(f"empty segment name in GFA walk: {spec!r}")
        steps.append((name, orient == "<"))
        i = j
    return steps


def load_gfa(path: str) -> Bigraph:
    g = Bigraph()
    pending_links: List[Tuple[str, bool, str, bool, int]] = []
    pending_paths: List[Tuple[str, List[Tuple[str, bool]]]] = []
    with _open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.rstrip("\r\n")
            if not line:
                continue
            parts = line.split("\t")
            if parts[0] == "S":
                if len(parts) < 3:
                    raise ValueError(f"{path}:{lineno}: malformed S line")
                g.add_segment(parts[1], parts[2].upper())
            elif parts[0] == "L":
                if len(parts) < 5:
                    raise ValueError(f"{path}:{lineno}: malformed L line")
                overlap = parse_overlap(parts[5]) if len(parts) > 5 else 0
                pending_links.append((parts[1], parts[2] == "-",
                                      parts[3], parts[4] == "-", overlap))
            elif parts[0] == "P":
                if len(parts) < 3:
                    raise ValueError(f"{path}:{lineno}: malformed P line")
                pending_paths.append((parts[1], parse_path_steps(parts[2])))
            elif parts[0] == "W":
                # W sample hap-index seq-id seq-start seq-end walk
                if len(parts) < 7:
                    raise ValueError(f"{path}:{lineno}: malformed W line")
                name = f"{parts[1]}#{parts[2]}#{parts[3]}"
                if parts[4] != "*" and parts[5] != "*":
                    name += f":{parts[4]}-{parts[5]}"
                pending_paths.append((name, parse_walk_steps(parts[6])))
    for fn, frev, tn, trev, overlap in pending_links:
        if fn not in g.name_to_id or tn not in g.name_to_id:
            raise ValueError(f"GFA link references unknown segment: {fn}->{tn}")
        g.links.append((g.name_to_id[fn], frev, g.name_to_id[tn], trev,
                        overlap))
    for pname, steps in pending_paths:
        resolved = []
        for sn, srev in steps:
            if sn not in g.name_to_id:
                raise ValueError(
                    f"GFA path {pname!r} references unknown segment: {sn}")
            resolved.append((g.name_to_id[sn], srev))
        g.paths[pname] = resolved
    return g


_RC = str.maketrans("ACGTN", "TGCAN")


def path_sequence(g: Bigraph, name: str) -> str:
    """Sequence spelled by a named P/W path, honoring orientations and
    per-link overlap trimming (seq(u) + seq(v)[overlap:])."""
    if name not in g.paths:
        raise KeyError(f"no such path in GFA: {name!r}")
    overlap_of = {(f, fr, t, tr): o for f, fr, t, tr, o in g.links}
    out = []
    prev = None
    for nid, rev in g.paths[name]:
        s = g.seqs[nid]
        if rev:
            s = s.translate(_RC)[::-1]
        if prev is not None:
            o = overlap_of.get((*prev, nid, rev))
            if o is None:
                # a walk may traverse the link in the opposite direction
                o = overlap_of.get((nid, not rev, prev[0], not prev[1]), 0)
            s = s[o:]
        out.append(s)
        prev = (nid, rev)
    return "".join(out)


def save_gfa(g: Bigraph, path: str, keep=None, keep_links=None) -> None:
    """Write a Bigraph (or a node/link subset) as GFA1.  keep: set of
    segment ids to emit (None = all); keep_links: iterable of link
    tuples to emit (None = all links among kept segments)."""
    with open(path, "w") as f:
        for i, (name, seq) in enumerate(zip(g.names, g.seqs)):
            if keep is None or i in keep:
                f.write(f"S\t{name}\t{seq}\n")
        links = g.links if keep_links is None else keep_links
        for u, ur, v, vr, o in links:
            if keep is not None and (u not in keep or v not in keep):
                continue
            f.write(f"L\t{g.names[u]}\t{'-' if ur else '+'}"
                    f"\t{g.names[v]}\t{'-' if vr else '+'}\t{o}M\n")

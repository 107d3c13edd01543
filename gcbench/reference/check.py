"""Plain reference of the benchmark's check: the graph, the alignments it
allows, and a read's edit distance, worked out without the program.

Imports only the standard library and numpy: nothing of the program
(graphchainer_torch) and nothing of the JAX package.  It parses the GFA
itself and judges each GAF line by what the line says:

- the path is a walk of the graph: every node a segment, every step a
  link (in either direction of the bidirected link), the path length the
  sum of the nodes' lengths;
- the CIGAR spells the read's aligned span against the path's span:
  '=' a match, 'X' a mismatch, 'I' a read base, 'D' a path base, 'M'
  either of the first two; both spans used up exactly; NM, the matches
  and the block length as the CIGAR counts them;
- the read's whole-read edit distance against the path's sequence (the
  read end to end, the path's ends free), by Myers' bit-vector algorithm
  on Python integers, is set beside the same distance against the
  stretch of the truth walk the read was drawn from.
"""
from __future__ import annotations

import re

_COMP = bytes.maketrans(b"ACGT", b"TGCA")
_NODE = re.compile(rb"([<>])([^<>]+)")
_CIGAR = re.compile(rb"(\d+)([=XIDM])")


def revcomp(s: bytes) -> bytes:
    return s.translate(_COMP)[::-1]


class RefGraph:
    """Segments by name and the set of links, read from GFA text."""

    def __init__(self, path: str):
        self.seqs: dict = {}
        self.links: set = set()
        with open(path, "rb") as f:
            for line in f:
                if line.startswith(b"S\t"):
                    _, name, seq = line.rstrip(b"\r\n").split(b"\t")[:3]
                    self.seqs[name] = seq.upper()
                elif line.startswith(b"L\t"):
                    p = line.rstrip(b"\r\n").split(b"\t")
                    if p[5] not in (b"0M", b"*"):
                        raise ValueError("links with overlaps are not "
                                         "supported by the reference")
                    self.links.add((p[1], p[2], p[3], p[4]))

    def linked(self, a, b) -> bool:
        """a, b: (orientation b'>' / b'<', name)."""
        fa = b"+" if a[0] == b">" else b"-"
        fb = b"+" if b[0] == b">" else b"-"
        flip = {b"+": b"-", b"-": b"+"}
        return ((a[1], fa, b[1], fb) in self.links
                or (b[1], flip[fb], a[1], flip[fa]) in self.links)

    def spell(self, steps) -> bytes:
        return b"".join(self.seqs[n] if o == b">" else revcomp(self.seqs[n])
                        for o, n in steps)


def parse_gaf(line: bytes) -> dict:
    f = line.rstrip(b"\r\n").split(b"\t")
    tags = {}
    for t in f[12:]:
        k, _, v = t.split(b":", 2)
        tags[k] = v
    return {"name": f[0].decode(), "qlen": int(f[1]), "qstart": int(f[2]),
            "qend": int(f[3]), "strand": f[4], "path": f[5],
            "plen": int(f[6]), "pstart": int(f[7]), "pend": int(f[8]),
            "matches": int(f[9]), "block": int(f[10]),
            "nm": int(tags.get(b"NM", b"-1")), "cigar": tags.get(b"cg", b"")}


def myers_infix(pattern: bytes, text: bytes) -> int:
    """The least edit distance of the whole pattern against any substring
    of text (Myers 1999, one bit a pattern base)."""
    m = len(pattern)
    if m == 0:
        return 0
    full = (1 << m) - 1
    peq = {}
    for i, ch in enumerate(pattern):
        peq[ch] = peq.get(ch, 0) | (1 << i)
    pv, mv, score = full, 0, m
    best = m
    top = 1 << (m - 1)
    for ch in text:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & full)
        mh = pv & xh
        if ph & top:
            score += 1
        elif mh & top:
            score -= 1
        ph = (ph << 1) & full
        mh = (mh << 1) & full
        pv = mh | (~(xv | ph) & full)
        mv = ph & xv
        if score < best:
            best = score
    return best


def check_line(g: RefGraph, rec: dict, read: bytes):
    """What is wrong with the line, or None."""
    if rec["strand"] != b"+":
        return "strand is not +"
    if rec["qlen"] != len(read):
        return "read length differs"
    steps = _NODE.findall(rec["path"])
    if not steps or b"".join(o + n for o, n in steps) != rec["path"]:
        return "path is not a list of oriented nodes"
    for o, n in steps:
        if n not in g.seqs:
            return f"unknown node {n.decode()}"
    for a, b in zip(steps, steps[1:]):
        if not g.linked(a, b):
            return (f"no link {a[0].decode()}{a[1].decode()} -> "
                    f"{b[0].decode()}{b[1].decode()}")
    pseq = g.spell(steps)
    if len(pseq) != rec["plen"]:
        return "path length differs"
    if not (0 <= rec["pstart"] <= rec["pend"] <= rec["plen"]
            and 0 <= rec["qstart"] <= rec["qend"] <= rec["qlen"]):
        return "coordinates out of range"
    ops = _CIGAR.findall(rec["cigar"])
    if b"".join(n + o for n, o in ops) != rec["cigar"] or not ops:
        return "CIGAR is malformed"
    q, p = rec["qstart"], rec["pstart"]
    nm = matches = block = 0
    for n, op in ops:
        n = int(n)
        block += n
        if op in b"=XM":
            a, b = read[q:q + n], pseq[p:p + n]
            if len(a) != n or len(b) != n:
                return "CIGAR runs past a span"
            same = sum(x == y for x, y in zip(a, b))
            if op == b"=" and same != n:
                return "'=' over a mismatch"
            if op == b"X" and same != 0:
                return "'X' over a match"
            matches += same
            nm += n - same
            q += n
            p += n
        elif op == b"I":
            nm += n
            q += n
        else:
            nm += n
            p += n
    if q != rec["qend"] or p != rec["pend"]:
        return "CIGAR does not use up the spans"
    if nm != rec["nm"]:
        return f"NM {rec['nm']} but the CIGAR has {nm} edits"
    if matches != rec["matches"] or block != rec["block"]:
        return "match or block count differs from the CIGAR"
    return None

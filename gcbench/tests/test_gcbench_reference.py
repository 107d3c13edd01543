"""The plain reference judges GAF lines by what they say: a line over a
walk of the graph whose CIGAR spells the read passes; a line tampered in
its path or its CIGAR does not."""
from __future__ import annotations

import random

import pytest

from gcbench import graphs
from gcbench.reference import check as ref

A, B, C, D = "ACGTACGGTA", "TTGCA", "G", "CCATGACTTGA"


@pytest.fixture
def graph(tmp_path):
    g = graphs.Graph()
    ia, ib, ic, id_ = (g.add(n, s) for n, s in
                       (("a", A), ("b", B), ("c", C), ("d", D)))
    for x, y in ((ia, ib), (ia, ic), (ib, id_), (ic, id_)):
        g.link(x, y)
    path = tmp_path / "g.gfa"
    graphs.write_gfa(g, str(path))
    return ref.RefGraph(str(path))


def line(read, path, plen, ps, pe, qs, qe, cigar, nm, matches, block):
    return ("\t".join(["r1", str(len(read)), str(qs), str(qe), "+", path,
                       str(plen), str(ps), str(pe), str(matches), str(block),
                       "60", f"NM:i:{nm}", "AS:f:0", "dv:f:0", "id:f:0",
                       f"cg:Z:{cigar}"]) + "\n").encode()


def good(read=None):
    # path a b d from offset 2: "GTACGGTA" "TTGCA" "CCATG"; the read has
    # one mismatch (T->A at the 9th base) and one inserted base
    pseq = (A + B + D)[2:20]
    read = read or (pseq[:8] + "A" + pseq[9:12] + "G" + pseq[12:]).encode()
    return read, line(read, ">a>b>d", 26, 2, 20, 0, len(read),
                      "8=1X3=1I6=", 2, 17, 19)


def test_good_line_passes(graph):
    read, ln = good()
    assert ref.check_line(graph, ref.parse_gaf(ln), read) is None


def test_reverse_strand_line_passes(graph):
    pseq = ref.revcomp((A + C + D).encode())
    read = pseq[3:20]
    ln = line(read, "<d<c<a", 22, 3, 20, 0, len(read), "17=", 0, 17, 17)
    assert ref.check_line(graph, ref.parse_gaf(ln), read) is None


@pytest.mark.parametrize("old,new,why", [
    (b">a>b>d", b">a>d>b", "no link"),
    (b">a>b>d", b">a>c>d", "path length"),
    (b">a>b>d", b">a>b>x", "unknown node"),
    (b"8=1X3=1I6=", b"9=3=1I6=", "'=' over a mismatch"),
    (b"8=1X3=1I6=", b"8=1X3=1I5=", "spans"),
    (b"8=1X3=1I6=", b"8=1X2=1X1I6=", "'X' over a match"),
    (b"NM:i:2", b"NM:i:1", "NM"),
    (b"\t26\t2\t20\t", b"\t26\t3\t21\t", "mismatch"),
])
def test_tampered_line_fails(graph, old, new, why):
    read, ln = good()
    bad = ln.replace(old, new, 1)
    assert bad != ln
    fault = ref.check_line(graph, ref.parse_gaf(bad), read)
    assert fault is not None and why in fault, fault


def dp(p, t):
    prev = [0] * (len(t) + 1)
    for i in range(1, len(p) + 1):
        cur = [i] + [0] * len(t)
        for j in range(1, len(t) + 1):
            cur[j] = min(prev[j - 1] + (p[i - 1] != t[j - 1]), prev[j] + 1,
                         cur[j - 1] + 1)
        prev = cur
    return min(prev)


def test_myers_equals_plain_dp():
    rnd = random.Random(1)
    for _ in range(200):
        p = bytes(rnd.choice(b"ACGT") for _ in range(rnd.randint(1, 70)))
        t = bytes(rnd.choice(b"ACGT") for _ in range(rnd.randint(0, 90)))
        assert ref.myers_infix(p, t) == dp(p, t)

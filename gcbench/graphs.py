"""Frozen graph generators of the benchmark's configurations.

Each configuration builds its variation graph from a fixed seed, writes it
as GFA and draws one forward source-to-sink walk as the truth path that
the reads are simulated from.  The generators are copies, frozen here so
that a change to the program cannot change the benchmark's inputs:

- bench_chain: graphchainer_torch/workload.py build_bench_graph (SNP and
  short-indel bubbles on a random backbone of 40-90 bp spacers);
- knots: graphchainer_torch/graph/simulate.py tangle_bigraph (a backbone
  of superbubble knots of `arms` parallel arms, the first arm holding a
  nested bubble), with the arm count optionally drawn per knot.

With the source's arguments each yields the source's segments and links
in the source's order (gcbench/tests/test_gcbench_frozen.py holds them
equal at a small size).  Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np

_ACGT = list("ACGT")


class Graph:
    """Segments (names, sequences) and forward links (from, to) by index."""

    def __init__(self):
        self.names: list = []
        self.seqs: list = []
        self.links: list = []          # (from index, to index), both "+"

    def add(self, name: str, seq: str) -> int:
        self.names.append(name)
        self.seqs.append(seq)
        return len(self.names) - 1

    def link(self, a: int, b: int) -> None:
        self.links.append((a, b))


def bench_chain(rng, total_bp: int) -> Graph:
    """build_bench_graph: spacers of 40-89 bp, after each a SNP bubble
    (70%), a short indel bubble (15%) or a plain join; a 50 bp end."""
    g = Graph()
    prev = None
    bp = 0
    i = 0
    while bp < total_bp:
        spacer_len = int(rng.integers(40, 90))
        sp = g.add(f"s{i}", "".join(rng.choice(_ACGT, spacer_len)))
        bp += spacer_len
        if prev is not None:
            for pn in prev:
                g.link(pn, sp)
        r = rng.random()
        if r < 0.7:
            a = g.add(f"a{i}", str(rng.choice(_ACGT)))
            b = g.add(f"b{i}", str(rng.choice(_ACGT)))
            g.link(sp, a)
            g.link(sp, b)
            prev = [a, b]
            bp += 1
        elif r < 0.85:
            ln = int(rng.integers(2, 8))
            a = g.add(f"a{i}", "".join(rng.choice(_ACGT, ln)))
            prev = [sp, a]
            g.link(sp, a)
            bp += ln
        else:
            prev = [sp]
        i += 1
    end = g.add("end", "".join(rng.choice(_ACGT, 50)))
    for pn in prev:
        g.link(pn, end)
    return g


def knots(rng, n_knots: int = 10, arms=8, spacer: int = 40,
          arm_len: int = 8, nested: bool = True) -> Graph:
    """tangle_bigraph without back edges: start, then per knot a fork and
    a join of `spacer` bp joined by the arms (arm_len +- arm_len // 2 bp;
    with `nested` the first arm is head, two one-base alleles, tail), then
    an end.  `arms` is a count, or [lo, hi] to draw each knot's count
    uniformly (drawn first in the knot)."""
    g = Graph()
    prev = g.add("start", "".join(rng.choice(_ACGT, spacer)))
    for i in range(n_knots):
        n_arms = (arms if isinstance(arms, int)
                  else int(rng.integers(arms[0], arms[1] + 1)))
        fork = g.add(f"f{i}", "".join(rng.choice(_ACGT, spacer)))
        g.link(prev, fork)
        join = g.add(f"j{i}", "".join(rng.choice(_ACGT, spacer)))
        for a in range(n_arms):
            ln = max(1, arm_len + int(rng.integers(-arm_len // 2,
                                                   arm_len // 2 + 1)))
            if nested and a == 0:
                head = g.add(f"k{i}a{a}h", "".join(rng.choice(_ACGT, ln)))
                x = g.add(f"k{i}a{a}x", str(rng.choice(_ACGT)))
                y = g.add(f"k{i}a{a}y", str(rng.choice(_ACGT)))
                tail = g.add(f"k{i}a{a}t", "".join(rng.choice(_ACGT, ln)))
                g.link(fork, head)
                g.link(head, x)
                g.link(head, y)
                g.link(x, tail)
                g.link(y, tail)
                g.link(tail, join)
            else:
                arm = g.add(f"k{i}a{a}", "".join(rng.choice(_ACGT, ln)))
                g.link(fork, arm)
                g.link(arm, join)
        prev = join
    end = g.add("end", "".join(rng.choice(_ACGT, spacer)))
    g.link(prev, end)
    return g


GENERATORS = {"bench_chain": bench_chain, "knots": knots}


def build(cfg: dict) -> Graph:
    """The graph of a configuration: its "generator" run from
    default_rng("graph_seed") with its "generator_params"."""
    return GENERATORS[cfg["generator"]](
        np.random.default_rng(cfg["graph_seed"]), **cfg["generator_params"])


def write_gfa(g: Graph, path: str) -> None:
    """GFA 1.0 text: a header, every segment, every link with 0M."""
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for name, seq in zip(g.names, g.seqs):
            f.write(f"S\t{name}\t{seq}\n")
        for a, b in g.links:
            f.write(f"L\t{g.names[a]}\t+\t{g.names[b]}\t+\t0M\n")


def truth_walk(g: Graph, seed: int) -> np.ndarray:
    """A random forward walk from the first segment along the links until a
    segment without successors, as base codes (A C G T = 0 1 2 3)."""
    rng = np.random.default_rng(seed)
    outs = [[] for _ in g.names]
    for a, b in g.links:
        outs[a].append(b)
    v = 0
    parts = [g.seqs[0]]
    while outs[v]:
        nxt = outs[v]
        v = nxt[int(rng.integers(0, len(nxt)))] if len(nxt) > 1 else nxt[0]
        parts.append(g.seqs[v])
    seq = np.frombuffer("".join(parts).encode(), dtype=np.uint8)
    codes = np.full(256, 255, dtype=np.uint8)
    codes[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)
    out = codes[seq]
    if (out == 255).any():
        raise ValueError("truth walk holds a base outside ACGT")
    return out

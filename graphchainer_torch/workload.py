"""The bench.py workload: a synthetic variation graph and simulated reads.

A chromosome-like backbone of 40-90 bp spacers with SNP bubbles (70%),
short indel bubbles (15%) or plain joins, built from a seeded numpy
generator, and pbsim-like reads of ~N(read_len, read_len/10) at 10%
error drawn from one source-to-sink path.  build_bench_graph is a copy of
bench.py:165-200, so this package does not import bench.py (which pulls
in jax).

polish_hard_pairs makes the (read, path) pairs that the polish kernels
must survive, for the CPU tests (small) and the smoke run (full size);
frag_hard_batch the fragment batch that the fragment DP must survive.
"""
from __future__ import annotations

import time

import numpy as np

from graphchainer_torch.graph.alignment_graph import build_alignment_graph
from graphchainer_torch.graph.mpc import build_mpc
from graphchainer_torch.graph.simulate import (generate_path, mutate_read,
                                               simulate_reads)
from graphchainer_torch.index.minimizer import build_index
from graphchainer_torch.io.gfa import Bigraph


def build_bench_graph(rng, total_bp: int) -> Bigraph:
    bg = Bigraph()
    prev = None
    bp = 0
    i = 0
    while bp < total_bp:
        spacer_len = int(rng.integers(40, 90))
        sp = bg.add_segment(f"s{i}", "".join(rng.choice(list("ACGT"),
                                                        spacer_len)))
        bp += spacer_len
        if prev is not None:
            for pn in prev:
                bg.links.append((pn, False, sp, False, 0))
        r = rng.random()
        if r < 0.7:      # SNP bubble
            a = bg.add_segment(f"a{i}", str(rng.choice(list("ACGT"))))
            b = bg.add_segment(f"b{i}", str(rng.choice(list("ACGT"))))
            bg.links.append((sp, False, a, False, 0))
            bg.links.append((sp, False, b, False, 0))
            prev = [a, b]
            bp += 1
        elif r < 0.85:   # short indel bubble
            ln = int(rng.integers(2, 8))
            a = bg.add_segment(f"a{i}", "".join(rng.choice(list("ACGT"),
                                                           ln)))
            prev = [sp, a]
            bg.links.append((sp, False, a, False, 0))
            bp += ln
        else:
            prev = [sp]
        i += 1
    end = bg.add_segment("end", "".join(rng.choice(list("ACGT"), 50)))
    for pn in prev:
        bg.links.append((pn, False, end, False, 0))
    return bg


def bench_workload(graph_bp: int = 60_000, n_reads: int = 960,
                   read_len: int = 3000):
    """bench.py's graph (default_rng(7)), indices (k=15, w=10), path
    (seed 3) and reads (seed 11, 10% error, len_std read_len // 10).
    Returns (g, mpc, index, path_seq, reads, host_build_seconds)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    g = build_alignment_graph(build_bench_graph(rng, graph_bp))
    mpc = build_mpc(g)
    index = build_index(g, k=15, w=10)
    build_s = time.perf_counter() - t0
    path_seq, _ = generate_path(g, seed=3)
    reads = simulate_reads(path_seq, n_reads, read_len, seed=11,
                           error_rate=0.10, len_std=read_len // 10)
    return g, mpc, index, path_seq, reads, build_s


def frag_hard_batch(seed: int, F: int = 256, B: int = 8, max_in: int = 4,
                    S: int = 3):
    """A fragment batch, fragment-major in the band build's host types,
    with the cases the fragment DP must get right:
      - a length-0 seed slot (the seed shift equals the seed's length,
        32 included, where the word shift wraps to 0);
      - fragments that end at row 1, 31, 32, 33, 63, 64, 65 and 96 (the
        edges of slices 0, 1 and 2, as far as S reaches) and at random
        rows;
      - slots of 32 columns and longer, and of 1;
      - slots with max_in in-edges, in-edges from pad slots and from
        beyond B;
      - pad slots between live ones;
      - every 16th fragment an in-edge from the same or a higher level,
        which band_build never makes.
    Levels follow band_build (0 without kept in-edges, else one more than
    the highest).  Returns (node_eq (N2, 4) uint32, node_len (N2,) int32,
    band_nodes (F, B) int32, band_in (F, B, max_in) int8, band_level
    (F, B) int8, seed_shift (F,) int32, req (F, S, 4) uint32, rows (F,)
    int32)."""
    rng = np.random.default_rng(seed)
    N2 = 64
    node_len = rng.integers(1, 33, N2).astype(np.int32)
    node_len[:8] = 32
    node_len[8:10] = (33, 40)
    node_len[10:12] = 1
    node_eq = np.zeros((N2, 4), np.uint32)
    for v in range(N2):
        for c in range(min(int(node_len[v]), 32)):
            node_eq[v, rng.integers(0, 4)] |= np.uint32(1) << np.uint32(c)

    band_nodes = np.full((F, B), -1, np.int32)
    band_in = np.full((F, B, max_in), -1, np.int8)
    band_level = np.full((F, B), -1, np.int8)
    seed_shift = np.zeros(F, np.int32)
    edges = [r for r in (1, 31, 32, 33, 63, 64, 65, 96) if r <= 32 * S]
    rows = np.where(np.arange(F) < 2 * len(edges),
                    np.resize(np.array(edges), F),
                    rng.integers(1, 32 * S + 1, F)).astype(np.int32)
    for f in range(F):
        live = [0] + [b for b in range(1, B) if rng.random() < 0.7]
        for b in live:
            band_nodes[f, b] = rng.integers(0, N2)
        trim = rng.integers(0, node_len[band_nodes[f, 0]] + 1)
        if f % 5 == 0:
            trim = 0                      # length-0 seed slot
        seed_shift[f] = node_len[band_nodes[f, 0]] - trim
        for b in live[1:]:
            n_in = max_in if f % 3 == 0 else int(rng.integers(0, max_in + 1))
            earlier = [u for u in live if u < b]
            pads = [u for u in range(B) if u not in live]
            for e in range(n_in):
                r = rng.random()
                if r < 0.8 or (r < 0.9 and not pads):
                    band_in[f, b, e] = rng.choice(earlier)
                elif r < 0.9:
                    band_in[f, b, e] = rng.choice(pads)
                else:
                    band_in[f, b, e] = rng.integers(min(B, 127), 128)
        for b in live:
            lv = 0
            for u in band_in[f, b]:
                if 0 <= u < b and band_level[f, u] >= 0:
                    lv = max(lv, int(band_level[f, u]) + 1)
            band_level[f, b] = lv
        if f % 16 == 1 and len(live) > 2:  # an in-edge from the same or a
            b = live[1]                    # higher level
            band_in[f, b, 0] = live[-1] if f % 32 == 1 else b
    req = np.zeros((F, S, 4), np.uint32)
    for f in range(F):
        for r in range(int(rows[f])):
            req[f, r // 32, rng.integers(0, 4)] |= np.uint32(1) << np.uint32(r % 32)
    return (node_eq, node_len, band_nodes, band_in, band_level, seed_shift,
            req, rows)


def polish_hard_pairs(seed: int, n_plain: int, length: int, indel: int = 200):
    """(label, read, path) triples for the polish fill and walk: `n_plain`
    reads of ~`length` bp at 10% error against their true path, mixed
    with the cases a kernel must get right:
      multi_shift   path of length // 40: the band moves several words in
                    a column (read / path ratio above 32)
      steep         path of length // 20: ratio between 16 and 32, one
                    word a column on most columns
      short_path    path of 48 bp, far below the padded column count
      deletion      `indel` read bases missing: the walk runs along a
                    band edge of a narrow band, or leaves it
      insertion     `indel` extra read bases, the other edge
      empty_read / empty_path   length 0
    The plain reads sit between them, so a batch mixes both."""
    rng = np.random.default_rng(seed)

    def rand_seq(n):
        return "".join(rng.choice(list("ACGT"), n))

    def noisy(seq):
        return mutate_read(rng, seq, sub=0.1 / 3, ins=0.1 / 3, dele=0.1 / 3)

    out = []
    for i in range(n_plain):
        path = rand_seq(max(50, int(rng.normal(length, length // 10))))
        out.append((f"plain{i}", noisy(path), path))
    path = rand_seq(length)
    read = noisy(path)
    half = length // 2
    hard = [
        ("multi_shift", read, path[:max(length // 40, 1)]),
        ("steep", read, path[:max(length // 20, 1)]),
        ("short_path", read, path[:48]),
        ("deletion", path[:half] + path[half + indel:], path),
        ("insertion", path[:half] + rand_seq(indel) + path[half:], path),
        ("empty_read", "", path[:length // 3]),
        ("empty_path", read[:length // 3], ""),
    ]
    # interleave: plain, hard, plain, hard, ...
    mixed = []
    for i in range(max(len(out), len(hard))):
        mixed += out[i:i + 1] + hard[i:i + 1]
    return mixed

"""The bench.py workload: a synthetic variation graph and simulated reads.

A chromosome-like backbone of 40-90 bp spacers with SNP bubbles (70%),
short indel bubbles (15%) or plain joins, built from a seeded numpy
generator, and pbsim-like reads of ~N(read_len, read_len/10) at 10%
error drawn from one source-to-sink path.  build_bench_graph is a copy of
bench.py:165-200, so this package does not import bench.py (which pulls
in jax).
"""
from __future__ import annotations

import time

import numpy as np

from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.graph.mpc import build_mpc
from graphchainer_tpu.graph.simulate import generate_path, simulate_reads
from graphchainer_tpu.index.minimizer import build_index
from graphchainer_tpu.io.gfa import Bigraph


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

"""The bench.py workload: a synthetic variation graph and simulated reads.

A chromosome-like backbone of 40-90 bp spacers with SNP bubbles (70%),
short indel bubbles (15%) or plain joins, built from a seeded numpy
generator, and pbsim-like reads of ~N(read_len, read_len/10) at 10%
error drawn from one source-to-sink path.  build_bench_graph is a copy of
bench.py:165-200, so this package does not import bench.py (which pulls
in jax).

component_chains_workload is the multi-component graph of the
component-sharded tables' test, and fusion_workload the fusion finder's
two-gene input.

scale_graph, mix_reads and sustained_workload are the chromosome-scale
inputs of scripts/scale_test.py and scripts/sustained_test.py (copies of
their generators): the bench graph at millions of bases and the sustained
mix of ~1.5, ~3 and ~9 kbp reads, written as that script writes them.

polish_hard_pairs makes the (read, path) pairs that the polish kernels
must survive, for the CPU tests (small) and the smoke run (full size);
frag_hard_batch the fragment batch that the fragment DP must survive,
frag_hard_carry a carried state for it, and frag_wide_hard_batch the same
batch for the wide fragment DP (optimal mode and seedless DP).

golden_cyclic_workload, golden_badread_workload and golden100_workload
are copies of build_workload of scripts/make_golden_cyclic.py,
scripts/make_golden_badread.py and scripts/make_golden100.py (which
import the JAX package): the workloads whose per-read edit distances of
the reference binary are pinned in tests/data/golden_cyclic.json,
golden_badread.json and golden100.json, which nw_edit_distance
(tests/test_polish.py's scorer) reads against.
"""
from __future__ import annotations

import os
import time

import numpy as np

from graphchainer_torch.graph.alignment_graph import build_alignment_graph
from graphchainer_torch.graph.mpc import build_mpc
from graphchainer_torch.graph.simulate import (generate_path, mutate_read,
                                               simulate_reads, tangle_bigraph)
from graphchainer_torch.index.minimizer import build_index
from graphchainer_torch.io.gfa import Bigraph, load_gfa


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


# The sustained mix of scripts/sustained_test.py:55-85, one entry a class:
# (mean length, length sd, read seed), 10% error, from path seed 3.
MIX_CLASSES = ((1500, 300, 11), (3000, 600, 12), (9000, 1500, 13))


def mix_counts(n_reads: int):
    """sustained_test.py's split of n_reads over MIX_CLASSES: half, 35%,
    the rest."""
    n1 = n_reads // 2
    n2 = int(n_reads * 0.35)
    return (n1, n2, n_reads - n1 - n2)


def scale_graph(graph_bp: int):
    """The bench generator's graph (default_rng(7)) at graph_bp and its
    alignment graph: (bg, g, synthesis seconds, graph build seconds)."""
    t0 = time.perf_counter()
    bg = build_bench_graph(np.random.default_rng(7), graph_bp)
    t1 = time.perf_counter()
    g = build_alignment_graph(bg)
    return bg, g, t1 - t0, time.perf_counter() - t1


def mix_reads(g, counts):
    """sustained_test.py's reads on g: counts[k] reads of MIX_CLASSES[k],
    classes in order, named r{i}_{simulated name}."""
    path_seq, _ = generate_path(g, seed=3)
    reads = []
    for n, (mean, sd, seed) in zip(counts, MIX_CLASSES):
        reads += simulate_reads(path_seq, n, mean, seed=seed,
                                error_rate=0.10, len_std=sd)
    return [(f"r{i}_{name}", seq) for i, (name, seq) in enumerate(reads)]


def write_fasta(reads, path: str) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")


def sustained_workload(workdir: str, graph_bp: int, counts):
    """sustained_test.py's inputs in workdir: g.gfa (the scale graph, its
    GFA text) and reads.fa (mix_reads).  Returns (gfa path, FASTA path,
    seconds)."""
    t0 = time.perf_counter()
    bg, g, _, _ = scale_graph(graph_bp)
    gfa = os.path.join(workdir, "g.gfa")
    fa = os.path.join(workdir, "reads.fa")
    _write_gfa(bg, gfa)
    write_fasta(mix_reads(g, counts), fa)
    return gfa, fa, time.perf_counter() - t0


def component_chains_workload(reads_per_component: int = 1):
    """The multi-component graph of tests/test_multichip.py:191-278 (its
    generator, copied): five disjoint chains of twelve 60-120 bp segments,
    each followed by a two-way SNP (ten strand components), from
    default_rng(17); its indices (k=15, w=10) and reads_per_component
    reads of ~500 bp at 8% error from each chain's path, those of the odd
    chains reverse-complemented (so that the reads reach components of
    both strands).  Returns (g, mpc, index, reads)."""
    from graphchainer_torch.utils.seq import revcomp
    rng = np.random.default_rng(17)
    bg = Bigraph()
    comp_paths = []
    for c in range(5):
        prev = None
        path = []
        for i in range(12):
            sp = bg.add_segment(f"c{c}s{i}", "".join(rng.choice(
                list("ACGT"), int(rng.integers(60, 120)))))
            if prev is not None:
                bg.links.append((prev, False, sp, False, 0))
            a = bg.add_segment(f"c{c}a{i}", str(rng.choice(list("ACGT"))))
            b = bg.add_segment(f"c{c}b{i}", str(rng.choice(list("ACGT"))))
            bg.links.append((sp, False, a, False, 0))
            bg.links.append((sp, False, b, False, 0))
            path.append(bg.seqs[sp])
            path.append(bg.seqs[a])
            prev = a
        comp_paths.append("".join(path))
    g = build_alignment_graph(bg)
    reads = []
    for c, ps in enumerate(comp_paths):
        reads += [(f"{n}_c{c}", revcomp(s) if c % 2 else s) for n, s in
                  simulate_reads(ps, reads_per_component, 500, seed=100 + c,
                                 error_rate=0.08, len_std=80)]
    return g, build_mpc(g), build_index(g, k=15, w=10), reads


def fusion_workload(tmpdir: str):
    """The two-gene input of tests/test_cli_tools.py::test_fusion_finder:
    genes A and B of 800 random bases (default_rng(12345), the tests' rng
    fixture) as two GFA segments, a read fusing A[100:400] with
    B[200:500] and one from A alone, the putative pair and one transcript
    alignment a gene (gene:<id> in its name).  Returns fusion-finder's
    input arguments."""
    from graphchainer_torch.io import vg_wire as w
    from graphchainer_torch.io.gam import GamWriter
    rng = np.random.default_rng(12345)
    gene_a = "".join(rng.choice(list("ACGT"), 800))
    gene_b = "".join(rng.choice(list("ACGT"), 800))
    files = {k: os.path.join(tmpdir, k) for k in
             ("g.gfa", "r.fa", "put.txt", "t.gam")}
    with open(files["g.gfa"], "w") as fh:
        fh.write(f"S\tga\t{gene_a}\nS\tgb\t{gene_b}\n")
    with open(files["r.fa"], "w") as fh:
        fh.write(f">fused\n{gene_a[100:400] + gene_b[200:500]}\n"
                 f">normal\n{gene_a[150:650]}\n")
    with open(files["put.txt"], "w") as fh:
        fh.write("GENEA GENEB 5\n")
    gw = GamWriter(files["t.gam"])
    for i, (gene, seq, node) in enumerate((("GENEA", gene_a, "ga"),
                                           ("GENEB", gene_b, "gb"))):
        gw.write(w.alignment(seq, w.path([w.mapping(
            w.position(i + 1, 0, False, name=node), [w.edit(800, 800)],
            1)]), f"tx{i + 1}_gene:{gene}_x"))
    gw.close()
    return ["fusion-finder", "-g", files["g.gfa"], "--putative",
            files["put.txt"], "--transcripts", files["t.gam"], "-f",
            files["r.fa"], "--min-fusion-len", "100"]


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


def frag_hard_carry(seed: int, band_nodes: np.ndarray,
                    node_len: np.ndarray):
    """A random carried state and per-slot seed trims for a batch of
    frag_hard_batch, the inputs of the fragment DP's carried windows:
    carry (ssb int32, hp uint32, hn uint32) each (F, B), with invalid
    slots (ssb = BIG) among boundary scores of 0..200 and disjoint
    random hp / hn bits, and shifts (F, B) int32, most 0, some a random
    part of the slot's node and some all of it (a length-0 slot).
    Returns (carry, shifts)."""
    rng = np.random.default_rng(seed)
    F, B = band_nodes.shape
    big = 1 << 28
    ssb = np.where(rng.random((F, B)) < 0.2, big,
                   rng.integers(0, 201, (F, B))).astype(np.int32)
    bits = rng.integers(0, 1 << 32, (F, B), dtype=np.uint64).astype(np.uint32)
    sign = rng.integers(0, 1 << 32, (F, B), dtype=np.uint64).astype(np.uint32)
    hp, hn = bits & sign, bits & ~sign
    lens = np.where(band_nodes >= 0,
                    node_len[np.clip(band_nodes, 0, len(node_len) - 1)], 0)
    r = rng.random((F, B))
    part = (rng.random((F, B)) * (lens + 1)).astype(np.int32)
    shifts = np.where(r < 0.6, 0, np.where(r < 0.9, part, lens))
    return (ssb, hp, hn), np.where(band_nodes >= 0, shifts, 0).astype(
        np.int32)


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


def _write_gfa(bg: Bigraph, path: str) -> None:
    with open(path, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for name, seq in zip(bg.names, bg.seqs):
            f.write(f"S\t{name}\t{seq}\n")
        for a, ar, b, br, ov in bg.links:
            f.write(f"L\t{bg.names[a]}\t{'-' if ar else '+'}"
                    f"\t{bg.names[b]}\t{'-' if br else '+'}\t{ov}M\n")


def frag_wide_hard_batch(seed: int, F: int = 64, B: int = 64,
                         max_in: int = 4, S: int = 3):
    """frag_hard_batch in the types of the wide fragment DP (int16
    in-edges, int32 levels) with a seed base per fragment and, in every
    8th fragment, a live slot at a level past n_levels (never processed).
    Every 16th fragment keeps frag_hard_batch's in-edge from the same or a
    higher level, which sends it down the kernel's level-by-level path.
    Returns (node_eq, node_len, band_nodes, band_in, band_level,
    seed_shift, req, rows, seed_base, n_levels)."""
    eq, ln, bn, bi, bl, ss, req, rows = frag_hard_batch(seed, F=F, B=B,
                                                        max_in=max_in, S=S)
    rng = np.random.default_rng(seed + 1000)
    bi = bi.astype(np.int16)
    bl = bl.astype(np.int32)
    n_levels = int(bl.max()) + 1
    for f in range(0, F, 8):
        live = np.nonzero(bl[f] >= 0)[0]
        if len(live) > 1:
            bl[f, live[-1]] = n_levels
    base = rng.integers(0, 8, F).astype(np.int32)
    return eq, ln, bn, bi, bl, ss, req, rows, base, n_levels


def golden_cyclic_workload(tmpdir: str):
    """The cyclic golden set (scripts/make_golden_cyclic.py
    build_workload): three circular plasmids (cycles of ~240 / 500 / 900
    bp) and a tangle backbone with back edges, and 36 reads lapping the
    cycles 1.5-3 times at 0 / 8 / 15% error.  Returns (gfa path, the
    cyclic AlignmentGraph, reads)."""
    rng = np.random.default_rng(71)
    bg = Bigraph()
    units = []
    for p, (segs, bp) in enumerate([(2, 120), (2, 250), (3, 300)]):
        ids = [bg.add_segment(f"p{p}s{i}",
                              "".join(rng.choice(list("ACGT"), bp)))
               for i in range(segs)]
        for i in range(segs):
            bg.links.append((ids[i], False, ids[(i + 1) % segs], False, 0))
        units.append("".join(bg.seqs[i] for i in ids))
    tg = tangle_bigraph(rng, n_knots=6, arms=4, spacer=60, arm_len=10,
                        nested=True, cycle_every=2)
    off = len(bg.names)
    for name, seq in zip(tg.names, tg.seqs):
        bg.add_segment(f"t{name}", seq)
    for a, ar, b, br, ov in tg.links:
        bg.links.append((a + off, ar, b + off, br, ov))
    gfa = os.path.join(tmpdir, "cyclic.gfa")
    _write_gfa(bg, gfa)
    g = build_alignment_graph(load_gfa(gfa), allow_cycles=True)

    reads = []
    err_rng = np.random.default_rng(72)
    ri = 0
    for err in (0.0, 0.08, 0.15):
        for u, unit in enumerate(units):
            for lap_i in range(4):
                laps = 1.5 + 0.5 * lap_i
                start = int(err_rng.integers(0, len(unit)))
                L = int(len(unit) * laps)
                frag = ((unit * 5)[start:start + L])
                per = err / 3
                read = (mutate_read(err_rng, frag, sub=per, ins=per,
                                    dele=per) if err else frag)
                reads.append((f"cyc{ri}_u{u}_e{int(err*100)}", read))
                ri += 1
    return gfa, g, reads


def golden_badread_workload(tmpdir: str):
    """The badread golden set (scripts/make_golden_badread.py
    build_workload): the bench generator at 30 kbp (default_rng(53)) and
    80 reads of ~2000 bp in the badread error profile at a mean identity
    of 0.88.  Returns (gfa path, AlignmentGraph, reads)."""
    rng = np.random.default_rng(53)
    bg = build_bench_graph(rng, 30_000)
    gfa = os.path.join(tmpdir, "badread.gfa")
    _write_gfa(bg, gfa)
    g = build_alignment_graph(load_gfa(gfa))
    path_seq, _ = generate_path(g, seed=3)
    reads = simulate_reads(path_seq, 80, 2000, seed=29, error_rate=0.12,
                           len_std=300, profile="badread")
    return gfa, g, reads


def golden100_workload(tmpdir: str):
    """The 100-read golden set (scripts/make_golden100.py build_workload):
    the bench generator at 30 kbp (default_rng(31)), 88 reads of ~1500 bp
    at 8% error, 6 error-free reads of 1200 bp and 6 hard reads at 15%
    error.  Returns (gfa path, AlignmentGraph, reads)."""
    rng = np.random.default_rng(31)
    bg = build_bench_graph(rng, 30_000)
    gfa = os.path.join(tmpdir, "golden.gfa")
    _write_gfa(bg, gfa)
    g = build_alignment_graph(load_gfa(gfa))
    path_seq, _ = generate_path(g, seed=3)
    reads = simulate_reads(path_seq, 88, 1500, seed=11, error_rate=0.08,
                           len_std=150)
    clean_rng = np.random.default_rng(77)
    for i in range(6):
        a = int(clean_rng.integers(0, len(path_seq) - 1200))
        reads.append((f"clean{i}", path_seq[a:a + 1200]))
    reads += simulate_reads(path_seq, 6, 1500, seed=13, error_rate=0.15,
                            len_std=150)
    # simulate_reads names overlap between the two batches: disambiguate
    seen = {}
    uniq = []
    for name, seq in reads:
        if name in seen:
            name = f"{name}_hard"
        seen[name] = True
        uniq.append((name, seq))
    return gfa, g, uniq


def poisoned(read: str, period: int = 8) -> str:
    """Every `period`-th base substituted (A->C->G->T->A): no minimizer of
    k >= 11 survives (tests/test_seedless.py's poisoned)."""
    out = list(read)
    for i in range(0, len(out), period):
        out[i] = {"A": "C", "C": "G", "G": "T", "T": "A"}[out[i]]
    return "".join(out)


def nw_edit_distance(a: str, b: str) -> int:
    """Global edit distance of two strings (unit costs), row by row
    (tests/test_polish.py's nw_edit_distance)."""
    la, lb = len(a), len(b)
    D = np.zeros((la + 1, lb + 1), dtype=np.int64)
    D[:, 0] = np.arange(la + 1)
    D[0, :] = np.arange(lb + 1)
    for i in range(1, la + 1):
        sub = (np.frombuffer(b.encode(), np.uint8)
               != ord(a[i - 1])).astype(np.int64)
        row = D[i - 1]
        t = np.minimum(row[:-1] + sub, row[1:] + 1)
        # sequential min over the row (vectorized prefix trick)
        idx = np.arange(lb + 1)
        tt = np.empty(lb + 1, dtype=np.int64)
        tt[0] = row[0] + 1
        tt[1:] = t
        D[i] = np.minimum.accumulate(tt - idx) + idx
    return int(D[la, lb])

"""Auxiliary standalone tools (re-design of the reference's extra binaries,
SURVEY.md §2.9 / reference makefile:34-70).

Port of graphchainer_tpu/tools.py: the same 21 subcommands with the same
arguments, defaults and output bytes, on the port's own copies of the host
modules.  fusion-finder runs the port's GraphAlignerModel, with --device
as in the port's CLI (default cuda: the current card; cpu runs the
kernels' plain versions); every other subcommand is host code.

Usage: python -m graphchainer_torch.tools <command> [args]

Commands:
  gfa-path-sequence       GFA P/W paths -> FASTA (truth sequences; the
                          reference obtains these via external vg paths)
  extract-path-sequence   GAM -> FASTA of alignment path sequences
                          (reference ExtractPathSequence.cpp)
  select-longest          keep the longest alignment per read
                          (reference SelectLongestAlignment.cpp)
  postprocess             re-run alignment selection on a GAM
                          (reference Postprocess.cpp)
  extract-corrected       GAM -> corrected reads FASTA
                          (reference ExtractCorrectedReads.cpp)
  simulate-reads          error-model read simulator
                          (reference SimulateReads.cpp)
  reverse-reads           reverse-complement a read file
                          (reference ReverseReads.cpp)
  node-pos-csv            graph node -> approximate linear position CSV
                          (reference NodePosCsv.cpp)
  subsequence-identity    alignment path vs truth path agreement
                          (reference AlignmentSubsequenceIdentity.cpp)
  visualize               render an alignment as read/path text
                          (reference VisualizeAlignment.cpp)
  pick-adjacent-pairs     report read-adjacent alignment pairs
                          (reference PickAdjacentAlnPairs.cpp)
  extract-exact-path-subgraph  subgraph of aligned nodes+edges
                          (reference ExtractExactPathSubgraph.cpp)
  extract-neighbourhood   subgraph within N bp of aligned nodes
                          (reference ExtractPathSubgraphNeighbourhood.cpp)
  supported-subgraph      keep alignment-supported edges
                          (reference SupportedSubgraph.cpp)
  unitigify               merge bidirected non-branching runs
                          (reference UnitigifyDBG.cpp)
  untip                   drop short relative tips
                          (reference UntipRelative.cpp)
  estimate-repeat-count   per-node repeat estimate from coverage
                          (reference EstimateRepeatCount.cpp)
  pick-mummer-seeds       MUMmer matches -> seed GAM
                          (reference PickMummerSeeds.cpp)
  brute-force-prefix-seeds exact k-prefix seeds by graph DFS
                          (reference BruteForceExactPrefixSeeds.cpp)
  maf-to-alignment        MAF truth entries -> GAM + reads FASTA
                          (reference MafToAlignment.cpp)
  fusion-finder           transcript fusion detection
                          (reference FusionFinder.cpp)
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np


import contextlib


@contextlib.contextmanager
def _out(path: str):
    if path == "-":
        yield sys.stdout
    else:
        f = open(path, "w")
        try:
            yield f
        finally:
            f.close()


def _load_node_seqs(graph_file: str) -> Dict[str, str]:
    from graphchainer_torch.io.gfa import load_gfa
    from graphchainer_torch.io.vg_graph import load_vg
    bg = load_vg(graph_file) if graph_file.endswith(".vg") \
        else load_gfa(graph_file)
    return {bg.names[i]: bg.seqs[i] for i in range(len(bg.names))}


def _mapping_seq(node_seqs: Dict[str, str], aln) -> str:
    """Path sequence consumed by a GAM alignment's mappings."""
    from graphchainer_torch.utils.seq import revcomp
    out = []
    for m in aln.mappings:
        seq = node_seqs.get(m.node_key, "")
        if m.is_reverse:
            seq = revcomp(seq)
        consumed = sum(e.get("from_length", 0) for e in m.edits) \
            or (len(seq) - m.offset)
        out.append(seq[m.offset:m.offset + consumed])
    return "".join(out)


def cmd_extract_path_sequence(args):
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    node_seqs = _load_node_seqs(args.graph)
    with _out(args.output) as f:
        for aln in load_gam_alignments(args.gam):
            f.write(f">{aln.name}\n{_mapping_seq(node_seqs, aln)}\n")


def cmd_select_longest(args):
    from graphchainer_torch.io import gam as gam_mod
    from graphchainer_torch.io.gam_reader import parse_alignment
    msgs = gam_mod.read_gam(args.gam)
    best: Dict[str, tuple] = {}
    for msg in msgs:
        aln = parse_alignment(msg)
        ln = sum(e.get("to_length", 0) for m in aln.mappings
                 for e in m.edits)
        if aln.name not in best or ln > best[aln.name][0]:
            best[aln.name] = (ln, msg)
    w = gam_mod.GamWriter(args.output)
    for ln, msg in best.values():
        w.write(msg)
    w.close()


def cmd_postprocess(args):
    """Re-run alignment selection (greedy-length by default) on a GAM."""
    from dataclasses import dataclass

    from graphchainer_torch.align.selection import (SelectionMethod,
                                                  SelectionOptions,
                                                  select_alignments)
    from graphchainer_torch.io import gam as gam_mod
    from graphchainer_torch.io.gam_reader import parse_alignment

    @dataclass
    class Item:
        seq_start: int
        seq_end: int
        score: int
        msg: bytes

    per_read: Dict[str, List[Item]] = {}
    for msg in gam_mod.read_gam(args.gam):
        aln = parse_alignment(msg)
        ln = sum(e.get("to_length", 0) for m in aln.mappings
                 for e in m.edits)
        per_read.setdefault(aln.name, []).append(
            Item(seq_start=0, seq_end=max(ln, 1), score=aln.score, msg=msg))
    opts = SelectionOptions(
        method=SelectionMethod(args.method))
    w = gam_mod.GamWriter(args.output)
    for name, items in per_read.items():
        for it in select_alignments(items, opts):
            w.write(it.msg)
    w.close()


def cmd_extract_corrected(args):
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    node_seqs = _load_node_seqs(args.graph)
    with _out(args.output) as f:
        for aln in load_gam_alignments(args.gam):
            seq = _mapping_seq(node_seqs, aln)
            if seq:
                f.write(f">{aln.name}\n{seq}\n")


def cmd_simulate_reads(args):
    from graphchainer_torch.graph.simulate import generate_path, simulate_reads
    from graphchainer_torch.pipeline import load_graph
    g = load_graph(args.graph)
    path_seq, names = generate_path(g, seed=args.seed)
    reads = simulate_reads(path_seq, args.count, args.length,
                           seed=args.seed, error_rate=args.error_rate,
                           profile=args.profile)
    with _out(args.output) as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")


def cmd_reverse_reads(args):
    from graphchainer_torch.io.fastq import stream_reads
    from graphchainer_torch.utils.seq import revcomp
    with _out(args.output) as f:
        for rd in stream_reads(args.reads):
            f.write(f">{rd.name}_reverse\n{revcomp(rd.seq)}\n")


def cmd_node_pos_csv(args):
    from graphchainer_torch.pipeline import load_graph
    g = load_graph(args.graph)
    # approximate linear position: cumulative topo-order bp offset per
    # original node (first split's topo prefix sum)
    prefix = np.zeros(g.n_nodes + 1, dtype=np.int64)
    np.cumsum(g.node_len, out=prefix[1:])
    with _out(args.output) as f:
        f.write("node,approx_pos\n")
        seen = set()
        for v in range(g.n_nodes):
            d = int(g.orig_node[v])
            if d % 2 or d in seen:
                continue
            seen.add(d)
            f.write(f"{g.gfa_name(v)},{int(prefix[v])}\n")


def _lcs_len(a, b):
    """Longest common subsequence length of two sequences."""
    import numpy as np
    if not a or not b:
        return 0
    prev = np.zeros(len(b) + 1, dtype=np.int64)
    for x in a:
        cur = prev.copy()
        match = np.array([1 if x == y else 0 for y in b], dtype=np.int64)
        for j in range(1, len(b) + 1):
            cur[j] = max(cur[j - 1], prev[j], prev[j - 1] + match[j - 1])
        prev = cur
    return int(prev[-1])


def cmd_subsequence_identity(args):
    """Fraction of the alignment's node path contained (in order) in the
    truth path."""
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    truth = open(args.truth).read().split()
    with _out(args.output) as f:
        f.write("read,path_len,in_truth,identity\n")
        for aln in load_gam_alignments(args.gam):
            path = [m.node_key for m in aln.mappings]
            common = _lcs_len(path, truth)
            ident = common / max(len(path), 1)
            f.write(f"{aln.name},{len(path)},{common},{ident:.4f}\n")


def cmd_visualize(args):
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    node_seqs = _load_node_seqs(args.graph)
    width = args.width
    with _out(args.output) as f:
        for aln in load_gam_alignments(args.gam):
            pathseq = _mapping_seq(node_seqs, aln)
            read = aln.sequence
            # walk edits to build aligned strings
            top, mid, bot = [], [], []
            pi = si = 0
            for m in aln.mappings:
                for e in m.edits:
                    fl, tl = e.get("from_length", 0), e.get("to_length", 0)
                    seq = e.get("sequence", "")
                    if fl == tl:
                        for k in range(fl):
                            a = pathseq[pi] if pi < len(pathseq) else "?"
                            b = read[si] if si < len(read) else "?"
                            top.append(a)
                            bot.append(b)
                            mid.append("|" if a == b else "X")
                            pi += 1
                            si += 1
                    elif tl == 0:
                        for k in range(fl):
                            top.append(pathseq[pi] if pi < len(pathseq)
                                       else "?")
                            bot.append("-")
                            mid.append(" ")
                            pi += 1
                    else:
                        for k in range(tl):
                            top.append("-")
                            bot.append(read[si] if si < len(read) else "?")
                            mid.append(" ")
                            si += 1
            f.write(f">{aln.name} score={aln.score}\n")
            for lo in range(0, len(top), width):
                f.write("P " + "".join(top[lo:lo + width]) + "\n")
                f.write("  " + "".join(mid[lo:lo + width]) + "\n")
                f.write("R " + "".join(bot[lo:lo + width]) + "\n\n")


def cmd_pick_adjacent_pairs(args):
    """Pairs of alignments of the same read whose read intervals are
    adjacent within --max-gap bp."""
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    per_read = {}
    for aln in load_gam_alignments(args.gam):
        ln = sum(e.get("to_length", 0) for m in aln.mappings
                 for e in m.edits)
        per_read.setdefault(aln.name, []).append((0, ln, aln))
    with _out(args.output) as f:
        f.write("read,left_end,right_start,gap\n")
        for name, items in per_read.items():
            items.sort(key=lambda t: t[0])
            for (s1, e1, a1), (s2, e2, a2) in zip(items[:-1], items[1:]):
                gap = s2 - e1
                if 0 <= gap <= args.max_gap:
                    f.write(f"{name},{e1},{s2},{gap}\n")


def cmd_gfa_path_sequence(args):
    """FASTA of named P/W paths embedded in a GFA (truth sequences for
    simulation/eval; the reference gets these externally via vg paths)."""
    from graphchainer_torch.io.gfa import load_gfa, path_sequence
    from graphchainer_torch.io.vg_graph import load_vg
    g = load_vg(args.graph) if args.graph.endswith(".vg") \
        else load_gfa(args.graph)
    names = [args.name] if args.name else sorted(g.paths)
    if args.name and args.name not in g.paths:
        raise SystemExit(f"no path {args.name!r}; available: "
                         f"{', '.join(sorted(g.paths)) or '(none)'}")
    with _out(args.output) as f:
        for name in names:
            f.write(f">{name}\n{path_sequence(g, name)}\n")


def _load_bigraph(path: str):
    from graphchainer_torch.io.gfa import load_gfa
    from graphchainer_torch.io.vg_graph import load_vg
    return load_vg(path) if path.endswith(".vg") else load_gfa(path)


def _aln_nodes_edges(gam_path: str):
    """Node-name / oriented-edge sets touched by a GAM's paths."""
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    nodes, edges = set(), set()
    for aln in load_gam_alignments(gam_path):
        ms = aln.mappings
        for m in ms:
            nodes.add(m.node_key)
        for a, b in zip(ms[:-1], ms[1:]):
            edges.add((a.node_key, a.is_reverse,
                       b.node_key, b.is_reverse))
    return nodes, edges


def cmd_extract_exact_path_subgraph(args):
    """Subgraph of exactly the nodes+edges traversed by alignments
    (reference ExtractExactPathSubgraph.cpp)."""
    from graphchainer_torch.io.gfa import save_gfa
    g = _load_bigraph(args.graph)
    nodes, edges = _aln_nodes_edges(args.gam)
    keep = {i for i, n in enumerate(g.names) if n in nodes}
    eset = {(g.names[u], ur, g.names[v], vr)
            for u, ur, v, vr, _ in g.links}
    keep_links = [lk for lk in g.links
                  if (g.names[lk[0]], lk[1], g.names[lk[2]], lk[3])
                  in {e for e in edges
                      if e in eset or (e[2], not e[3], e[0], not e[1])
                      in eset}]
    print(f"{len(keep)} nodes, ~{len(keep_links)} edges", file=sys.stderr)
    save_gfa(g, args.output, keep=keep, keep_links=keep_links)


def cmd_extract_neighbourhood(args):
    """Subgraph within --length bp (Dijkstra over node lengths, both
    directions) of any aligned node (reference
    ExtractPathSubgraphNeighbourhood.cpp)."""
    import heapq
    from graphchainer_torch.io.gfa import save_gfa
    g = _load_bigraph(args.graph)
    nodes, _ = _aln_nodes_edges(args.gam)
    name_to_id = {n: i for i, n in enumerate(g.names)}
    adj = {}
    for u, ur, v, vr, _ in g.links:
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    dist = {}
    heap = []
    for n in nodes:
        i = name_to_id.get(n)
        if i is not None:
            dist[i] = 0
            heapq.heappush(heap, (0, i))
    while heap:
        d, v = heapq.heappop(heap)
        if d > dist.get(v, 1 << 60):
            continue
        nd = d + len(g.seqs[v])
        if nd > args.length:
            continue
        for w in adj.get(v, ()):
            if nd < dist.get(w, 1 << 60):
                dist[w] = nd
                heapq.heappush(heap, (nd, w))
    keep = set(dist)
    print(f"{len(keep)} nodes", file=sys.stderr)
    save_gfa(g, args.output, keep=keep)


def cmd_supported_subgraph(args):
    """Keep only nodes appearing in alignments and edges traversed by at
    least --min-support alignment adjacencies (reference
    SupportedSubgraph.cpp)."""
    from collections import Counter
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    from graphchainer_torch.io.gfa import save_gfa
    g = _load_bigraph(args.graph)
    support = Counter()
    nodes = set()
    for aln in load_gam_alignments(args.gam):
        ms = aln.mappings
        for m in ms:
            nodes.add(m.node_key)
        for a, b in zip(ms[:-1], ms[1:]):
            support[(a.node_key, b.node_key)] += 1
    keep = {i for i, n in enumerate(g.names) if n in nodes}
    keep_links = [
        lk for lk in g.links
        if max(support.get((g.names[lk[0]], g.names[lk[2]]), 0),
               support.get((g.names[lk[2]], g.names[lk[0]]), 0))
        >= args.min_support]
    save_gfa(g, args.output, keep=keep, keep_links=keep_links)


def cmd_unitigify(args):
    """Merge bidirected non-branching runs into unitig segments
    (reference UnitigifyDBG.cpp; our segments join with
    overlap-trimmed concatenation)."""
    from graphchainer_torch.io.gfa import Bigraph, save_gfa
    from graphchainer_torch.utils.seq import revcomp
    g = _load_bigraph(args.graph)
    n = len(g.names)
    # directed side graph: (node, end) -> [(node2, side2, overlap)]
    out_of = {}
    for u, ur, v, vr, o in g.links:
        out_of.setdefault((u, ur), []).append((v, vr, o))
        out_of.setdefault((v, not vr), []).append((u, not ur, o))

    def unique_next(u, ur):
        outs = out_of.get((u, ur), [])
        if len(outs) != 1:
            return None
        v, vr, o = outs[0]
        back = out_of.get((v, not vr), [])
        if len(back) != 1:
            return None
        return v, vr, o

    used = [False] * n
    out = Bigraph()
    runs = []
    internal = set()      # directed side edges consumed inside a run
    for s in range(n):
        if used[s]:
            continue
        # extend left to a run start (or detect an isolated cycle)
        u, ur = s, False
        seen = {(s, False)}
        while True:
            prev = unique_next(u, not ur)
            if prev is None:
                break
            pu, pur, _ = prev
            if (pu, not pur) in seen:
                break                       # cycle; cut here
            u, ur = pu, not pur
            seen.add((u, ur))
        run = [(u, ur, 0)]
        used[u] = True
        while True:
            nxt = unique_next(run[-1][0], run[-1][1])
            if nxt is None or used[nxt[0]]:
                break
            internal.add((run[-1][0], run[-1][1], nxt[0], nxt[1]))
            internal.add((nxt[0], not nxt[1], run[-1][0], not run[-1][1]))
            run.append(nxt)
            used[nxt[0]] = True
        runs.append(run)
    for ui, run in enumerate(runs):
        seq = []
        for v, vr, o in run:
            s = revcomp(g.seqs[v]) if vr else g.seqs[v]
            seq.append(s[o:])
        out.add_segment(f"unitig{ui}", "".join(seq))
    # map remaining original side edges to unitig-end links
    out_side = {}         # (node, side): unitig orientation leaving here
    in_side = {}          # (node, side): unitig orientation entering here
    for ui, run in enumerate(runs):
        tail_n, tail_r, _ = run[-1]
        head_n, head_r, _ = run[0]
        out_side[(tail_n, tail_r)] = (ui, False)
        out_side[(head_n, not head_r)] = (ui, True)
        in_side[(head_n, head_r)] = (ui, False)
        in_side[(tail_n, not tail_r)] = (ui, True)
    links = set()
    for u, ur, v, vr, o in g.links:
        if (u, ur, v, vr) in internal:
            continue
        a = out_side.get((u, ur))
        b = in_side.get((v, vr))
        if a is not None and b is not None:
            links.add((a[0], a[1], b[0], b[1], o))
    out.links = sorted(links)
    print(f"{len(out.names)} unitigs", file=sys.stderr)
    save_gfa(out, args.output)


def cmd_untip(args):
    """Remove short relative tips — the reference UntipRelative.cpp
    algorithm in full (not just single-segment tips):

    Over the oriented digraph (two nodes per segment, each link plus its
    reverse complement), depth(v) = longest forward path in bp from v to
    a dead end (infinite through any cycle or self-loop;
    UntipRelative.cpp:56-90).  For every surviving oriented node, let
    bigLength = the longest depth among its out-neighbors; when
    bigLength >= --min-safe-len, every out-neighbor subtree with depth
    <= min(--fraction * bigLength, --max-len) is removed recursively
    (UntipRelative.cpp:102-126).  A segment is kept only if BOTH of its
    orientations survive (UntipRelative.cpp:238-255).  Node lengths are
    reduced by the graph's uniform link overlap when there is one, like
    the reference's edgeOverlap (UntipRelative.cpp:28)."""
    import numpy as np
    from graphchainer_torch.io.gfa import save_gfa
    from graphchainer_torch.native import scc_order
    g = _load_bigraph(args.graph)
    nseg = len(g.names)
    n = 2 * nseg                     # oriented node (v, r) -> 2*v + r
    src, dst = [], []
    for u, ur, v, vr, _o in g.links:
        src.append(2 * u + ur)
        dst.append(2 * v + vr)
        src.append(2 * v + (not vr))
        dst.append(2 * u + (not ur))
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # CSR out-adjacency over oriented nodes
    order_e = np.argsort(src, kind="stable") if len(src) else src
    es, ed = src[order_e], dst[order_e]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, es + 1, 1)
    np.cumsum(ptr, out=ptr)
    overlaps = {o for *_ignore, o in g.links}
    ov = overlaps.pop() if len(overlaps) == 1 else 0
    length = np.empty(n, dtype=np.int64)
    for v in range(nseg):
        length[2 * v] = length[2 * v + 1] = max(len(g.seqs[v]) - ov, 0)

    INF = np.iinfo(np.int64).max
    nscc, order, _rank, scc = scc_order(n, src, dst)
    scc_size = np.bincount(scc, minlength=nscc)
    depth = np.zeros(n, dtype=np.int64)
    # sinks first: scc_order is condensation-topological, so reversed
    # node order visits every out-neighbor before its sources
    for v in order[::-1]:
        if scc_size[scc[v]] > 1:
            depth[v] = INF
            continue
        d = length[v]
        for w in ed[ptr[v]:ptr[v + 1]]:
            if w == v or depth[w] == INF:
                d = INF
                break
            d = max(d, depth[w] + length[v])
        depth[v] = d

    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        nbrs = ed[ptr[i]:ptr[i + 1]]
        if len(nbrs) == 0:
            continue
        big = int(depth[nbrs].max())
        if big < args.min_safe_len:
            continue
        removable = min(int(big * args.fraction), args.max_len)
        for w in nbrs:
            if depth[w] <= removable and keep[w]:
                stack = [int(w)]
                while stack:
                    x = stack.pop()
                    if not keep[x]:
                        continue
                    keep[x] = False
                    stack.extend(int(y) for y in ed[ptr[x]:ptr[x + 1]]
                                 if keep[y])
    kept = {v for v in range(nseg) if keep[2 * v] and keep[2 * v + 1]}
    print(f"removed {nseg - len(kept)} tip segments", file=sys.stderr)
    save_gfa(g, args.output, keep=kept)


def cmd_estimate_repeat_count(args):
    """Per-node repeat-count estimate — the reference
    EstimateRepeatCount.cpp min-alignment-topology fixpoint:

    counts[v] starts at max(per-side branch degree, max times any single
    read's alignment visits v) (EstimateRepeatCount.cpp:34-83).  Where a
    node side has a UNIQUE out-edge, its count flows to the target's
    entry-side bucket; the fixpoint raises counts[v] to
    max(sum over left-entry in-neighbors, sum over right-entry
    in-neighbors) and re-queues downstream nodes until stable
    (EstimateRepeatCount.cpp:85-131).  Output CSV matches the
    reference: `node,_minalntoporepeatcount`, sorted by node id."""
    from collections import defaultdict
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    g = _load_bigraph(args.graph)
    nseg = len(g.names)
    # per-side adjacency in the reference's NodePos terms: side True is
    # the '+'-exit ("end") side; our link flag r=True means '-'
    edges = defaultdict(set)
    for u, ur, v, vr, _o in g.links:
        edges[(u, not ur)].add((v, not vr))
        edges[(v, vr)].add((u, ur))
    out_n = defaultdict(list)
    left_in = defaultdict(list)    # in-neighbors entering via '-' side
    right_in = defaultdict(list)   # in-neighbors entering via '+' side
    counts = defaultdict(int)
    for v in range(nseg):
        for side in (True, False):
            ts = edges.get((v, side))
            if not ts:
                continue
            counts[v] = max(counts[v], len(ts))
            if len(ts) == 1:
                (tid, tend), = ts
                out_n[v].append(tid)
                (right_in if tend else left_in)[tid].append(v)

    # max per-read visit multiplicity per node
    by_name = {nm: i for i, nm in enumerate(g.names)}
    per_read = defaultdict(lambda: defaultdict(int))
    for aln in load_gam_alignments(args.gam):
        for m in aln.mappings:
            nid = by_name.get(m.node_key)
            if nid is not None:
                per_read[nid][aln.name] += 1
    for nid, reads in per_read.items():
        counts[nid] = max(counts[nid], max(reads.values()))

    queue = list(range(nseg))
    budget = 64 * max(nseg, 1) + len(queue)   # divergence guard (cycles
    # of unique edges can grow counts unboundedly; the reference has no
    # guard and would spin — we stop and warn instead)
    while queue and budget:
        budget -= 1
        v = queue.pop()
        left = sum(counts[w] for w in left_in.get(v, ()))
        right = sum(counts[w] for w in right_in.get(v, ()))
        if counts[v] >= left and counts[v] >= right:
            continue
        counts[v] = max(left, right)
        queue.extend(out_n.get(v, ()))
    if queue:
        print("warning: repeat-count fixpoint did not converge "
              "(cyclic unique-edge growth); partial counts written",
              file=sys.stderr)

    def node_key(i):
        nm = g.names[i]
        return (0, int(nm)) if nm.lstrip("-").isdigit() else (1, nm)

    with _out(args.output) as f:
        f.write("node,_minalntoporepeatcount\n")
        for i in sorted(range(nseg), key=node_key):
            f.write(f"{g.names[i]},{counts[i]}\n")


def _write_seed_gam(path: str, seeds):
    """seeds: iterable of (read_name, node_name_or_id, offset,
    is_reverse, k, query_pos)."""
    from graphchainer_torch.io import vg_wire as w
    from graphchainer_torch.io.gam import GamWriter
    gw = GamWriter(path)
    for name, node, off, rev, k, qpos in seeds:
        if not str(node).lstrip("-").isdigit():
            print(f"skipping seed on non-numeric node {node!r} "
                  "(GAM node ids are integers)", file=sys.stderr)
            continue
        pos = w.position(int(node), int(off), bool(rev))
        mp = w.mapping(pos, [w.edit(int(k), int(k))], 1)
        gw.write(w.alignment("", w.path([mp]), name, score=int(qpos)))
    gw.close()


def cmd_pick_mummer_seeds(args):
    """Convert MUMmer `mummer -mum` output (matches of reads against
    per-node reference sequences named by node id) into a seed GAM,
    keeping the --max-seeds longest per read (reference
    PickMummerSeeds.cpp)."""
    per_read = {}
    cur = None
    rev = False
    with open(args.mums) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].strip()
                rev = name.endswith(" Reverse")
                cur = name[:-8].strip() if rev else name
                continue
            parts = line.split()
            if len(parts) < 4 or cur is None:
                continue
            node, refpos, readpos, ln = (parts[0], int(parts[1]),
                                         int(parts[2]), int(parts[3]))
            per_read.setdefault(cur, []).append(
                (ln, node, refpos - 1, rev, readpos - 1))
    seeds = []
    for name, items in per_read.items():
        items.sort(reverse=True)
        for ln, node, off, rv, qpos in items[:args.max_seeds]:
            seeds.append((name, node, off, rv, ln, qpos))
    _write_seed_gam(args.output, seeds)
    print(f"{len(seeds)} seeds", file=sys.stderr)


def cmd_brute_force_prefix_seeds(args):
    """Exact k-length read prefixes located by brute-force DFS over all
    graph start positions (reference BruteForceExactPrefixSeeds.cpp).
    Emits one seed per (read, matching start position)."""
    from graphchainer_torch.io.fastq import stream_reads
    from graphchainer_torch.utils.seq import revcomp
    g = _load_bigraph(args.graph)
    k = args.k
    index = {}
    name_of = {}
    adj = {}
    for u, ur, v, vr, o in g.links:
        adj.setdefault((u, ur), []).append((v, vr))
        adj.setdefault((v, not vr), []).append((u, not ur))

    def walk(nid, rev, off, prefix):
        seq = revcomp(g.seqs[nid]) if rev else g.seqs[nid]
        take = seq[off:off + (k - len(prefix))]
        prefix += take
        if len(prefix) >= k:
            yield prefix[:k]
            return
        for v, vr in adj.get((nid, rev), ()):
            yield from walk(v, vr, 0, prefix)

    for nid in range(len(g.names)):
        for rev in (False, True):
            L = len(g.seqs[nid])
            for off in range(L):
                for s in walk(nid, rev, off, ""):
                    real_off = L - 1 - off if rev else off
                    index.setdefault(s.upper(), []).append(
                        (g.names[nid], real_off, rev))
    seeds = []
    for rd in stream_reads(args.reads):
        name, seq = rd.name, rd.seq
        if len(seq) < k:
            continue
        for node, off, rv in index.get(seq[:k].upper(), ()):
            seeds.append((name, node, off, rv, k, k - 1))
    _write_seed_gam(args.output, seeds)
    print(f"{len(seeds)} seeds", file=sys.stderr)


def cmd_maf_to_alignment(args):
    """Convert MAF entries (reads simulated from a linear reference) to
    GAM alignments against the graph whose path spells that reference
    (reference MafToAlignment.cpp; the reference path is given as a GFA
    P/W name instead of a vg reference alignment)."""
    from graphchainer_torch.io import vg_wire as w
    from graphchainer_torch.io.gam import GamWriter
    g = _load_bigraph(args.graph)
    steps = g.paths.get(args.path_name)
    if steps is None:
        raise SystemExit(f"no path {args.path_name!r} in graph")
    pos_to_node = []
    node_rev = {}
    for nid, rev in steps:
        pos_to_node.extend([nid] * len(g.seqs[nid]))
        node_rev[nid] = rev
    entries = []
    with open(args.maf) as f:
        lines = [ln.rstrip("\n") for ln in f]
    i = 0
    while i < len(lines):
        if lines[i].startswith("a"):
            ref = lines[i + 1].split()
            read = lines[i + 2].split()
            entries.append((read[1], int(ref[2]), int(ref[3]),
                            read[4] == "-", read[6].replace("-", "")))
            i += 3
        else:
            i += 1
    gw = GamWriter(args.output)
    with _out(args.reads_out) as rf:
        for name, start, length, backward, seq in entries:
            nids = []
            for j in range(length):
                nid = pos_to_node[start + j]
                if not nids or nids[-1] != nid:
                    nids.append(nid)
            if backward:
                nids = nids[::-1]
            mps = []
            for rank, nid in enumerate(nids):
                rev = node_rev[nid] != backward
                pos = w.position(int(g.names[nid])
                                 if g.names[nid].isdigit() else nid,
                                 0, rev)
                ln = len(g.seqs[nid])
                mps.append(w.mapping(pos, [w.edit(ln, ln)], rank + 1))
            gw.write(w.alignment(seq, w.path(mps), name))
            rf.write(f">{name}\n{seq}\n")
    gw.close()
    print(f"{len(entries)} alignments", file=sys.stderr)


def cmd_fusion_finder(args):
    """Transcript fusion detection (reference FusionFinder.cpp,
    makefile:42-43).  Re-design: instead of aligning each read to a
    char-level "dummy-middle" fusion graph per gene pair, a fusion is
    two CLIPPED alignments that partition the read between the two
    genes' subgraphs — each gene's subgraph aligns once per read on the
    batched extension model (on the card), and the split point falls out
    of the clip spans.  A read is a fusion of (A, B) when both parts are at
    least --min-fusion-len, the combined cost stays under
    --max-score-fraction, and it beats the best single-gene alignment
    by more than --fusion-penalty."""
    import re

    import numpy as np

    from graphchainer_torch.graph.alignment_graph import build_alignment_graph
    from graphchainer_torch.index.minimizer import build_index
    from graphchainer_torch.io.fastq import stream_reads
    from graphchainer_torch.io.gam import GamWriter, alignment_message
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    from graphchainer_torch.io.gfa import Bigraph
    from graphchainer_torch.models.aligner import (AlignerConfig,
                                                 GraphAlignerModel)
    from graphchainer_torch.models.chainer import ReadAlignment

    bg = _load_bigraph(args.graph)
    name_to_id = {n: i for i, n in enumerate(bg.names)}

    # putative fusion pairs: "left right support" lines
    pairs = []
    with open(args.putative) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            left, right, support = parts[0], parts[1], int(parts[2])
            if left != right and support >= args.min_support:
                pairs.append((left, right))

    # gene -> graph segments touched by its transcripts' alignments
    # (gene id parsed from the transcript name, reference
    # geneFromTranscript's `gene:<id>` convention)
    # gene id ends at "_" or " " like the reference's
    # geneFromTranscript regex (FusionFinder.cpp:36-47)
    genere = re.compile(r"gene:([^_ ]+)")
    gene_nodes = {}
    for a in load_gam_alignments(args.transcripts):
        m = genere.search(a.name)
        gene = m.group(1) if m else a.name
        s = gene_nodes.setdefault(gene, set())
        for mp in a.mappings:
            if mp.node_name in name_to_id:
                s.add(mp.node_name)

    reads = [(r.name, r.seq) for r in stream_reads(args.reads)]

    def gene_model(gene):
        segs = sorted(gene_nodes[gene])
        sub = Bigraph()
        ids = {}
        for nm in segs:
            ids[nm] = sub.add_segment(nm, bg.seqs[name_to_id[nm]])
        inset = set(segs)
        for a, ar, b, br, ov in bg.links:
            na, nb = bg.names[a], bg.names[b]
            if na in inset and nb in inset:
                sub.links.append((ids[na], ar, ids[nb], br, ov))
        g = build_alignment_graph(sub, allow_cycles=True)
        idx = build_index(g, k=args.seed_k, w=args.seed_w)
        model = GraphAlignerModel(g, idx, AlignerConfig(
            polish_band_words=4), device=args.device)
        return g, idx, model

    models = {}
    # best alignment of every read against every involved gene
    per_gene_alns = {}
    genes = sorted({g for pr in pairs for g in pr if g in gene_nodes})
    for gene in genes:
        models[gene] = gene_model(gene)
        _, _, model = models[gene]
        per_gene_alns[gene] = model.align_batch(reads)

    def clip_cost(aln, read_len):
        # unaligned read bp charge like edits (reference aligns the whole
        # read; clipped tails surface in its score the same way)
        if aln.failed:
            return read_len, 0, read_len
        return (aln.score + (aln.seq_start)
                + (read_len - aln.seq_end)), aln.seq_start, aln.seq_end

    gam = GamWriter(args.output) if args.output else None
    corr = open(args.corrected_out, "w") if args.corrected_out else None
    tsv = (sys.stdout if args.fusions_out == "-"
           else open(args.fusions_out, "w"))
    n_found = 0
    for ri, (name, seq) in enumerate(reads):
        L = len(seq)
        best = None            # (fusion_cost, left, right, split, alnL, alnR)
        single = min((per_gene_alns[g][ri].score
                      + per_gene_alns[g][ri].seq_start
                      + (L - per_gene_alns[g][ri].seq_end))
                     if not per_gene_alns[g][ri].failed else L
                     for g in genes) if genes else L
        for left, right in pairs:
            if left not in per_gene_alns or right not in per_gene_alns:
                continue
            for ga, gb in ((left, right), (right, left)):
                a = per_gene_alns[ga][ri]
                b = per_gene_alns[gb][ri]
                if a.failed or b.failed:
                    continue
                # a must cover a prefix part, b a suffix part
                if a.seq_start > b.seq_start or a.seq_end > b.seq_end:
                    continue
                la = a.seq_end - a.seq_start
                lb = b.seq_end - b.seq_start
                if la < args.min_fusion_len or lb < args.min_fusion_len:
                    continue
                uncovered = (a.seq_start + max(b.seq_start - a.seq_end, 0)
                             + (L - b.seq_end))
                overlap = max(a.seq_end - b.seq_start, 0)
                cost = a.score + b.score + uncovered + overlap
                if cost > args.max_score_fraction * L:
                    continue
                if best is None or cost < best[0]:
                    best = (cost, ga, gb, (a.seq_end + b.seq_start) // 2,
                            a, b)
        if best is None or best[0] + args.fusion_penalty >= single:
            continue
        n_found += 1
        cost, ga, gb, split, a, b = best
        tsv.write(f"{name}\t{ga}\t{gb}\t{split}\t{cost}\t{single}\n")
        if corr:
            gxA = models[ga][2].gx
            gxB = models[gb][2].gx
            corr.write(f">{name} {ga}|{gb}\n"
                       f"{gxA.positions_seq(a.positions)}"
                       f"{gxB.positions_seq(b.positions)}\n")
        if gam:
            gam.write(alignment_message(models[ga][0], a))
            gam.write(alignment_message(models[gb][0], b))
    if gam:
        gam.close()
    if corr:
        corr.close()
    if tsv is not sys.stdout:
        tsv.close()
    print(f"{n_found} fusion reads / {len(reads)}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="graphchainer-torch-tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("gfa-path-sequence")
    s.add_argument("--graph", required=True)
    s.add_argument("--name", default=None,
                   help="path/walk name (default: all)")
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_gfa_path_sequence)

    s = sub.add_parser("extract-path-sequence")
    s.add_argument("--gam", required=True)
    s.add_argument("--graph", required=True)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_extract_path_sequence)

    s = sub.add_parser("select-longest")
    s.add_argument("--gam", required=True)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_select_longest)

    s = sub.add_parser("postprocess")
    s.add_argument("--gam", required=True)
    s.add_argument("--output", "-o", required=True)
    from graphchainer_torch.align.selection import SelectionMethod
    s.add_argument("--method", default="GreedyLength",
                   choices=[m.value for m in SelectionMethod])
    s.set_defaults(fn=cmd_postprocess)

    s = sub.add_parser("extract-corrected")
    s.add_argument("--gam", required=True)
    s.add_argument("--graph", required=True)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_extract_corrected)

    s = sub.add_parser("simulate-reads")
    s.add_argument("--graph", required=True)
    s.add_argument("--count", type=int, default=100)
    s.add_argument("--length", type=int, default=3000)
    s.add_argument("--error-rate", type=float, default=0.1)
    s.add_argument("--profile", choices=["uniform", "badread"],
                   default="uniform",
                   help="error model: iid sub/ins/del, or badread-style "
                        "bursty + homopolymer-biased errors")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_simulate_reads)

    s = sub.add_parser("reverse-reads")
    s.add_argument("--reads", required=True)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_reverse_reads)

    s = sub.add_parser("node-pos-csv")
    s.add_argument("--graph", required=True)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_node_pos_csv)

    s = sub.add_parser("subsequence-identity")
    s.add_argument("--gam", required=True)
    s.add_argument("--truth", required=True,
                   help="whitespace-separated truth node names "
                        "(--generate-path .nodes output)")
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_subsequence_identity)

    s = sub.add_parser("visualize")
    s.add_argument("--gam", required=True)
    s.add_argument("--graph", required=True)
    s.add_argument("--width", type=int, default=80)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_visualize)

    s = sub.add_parser("pick-adjacent-pairs")
    s.add_argument("--gam", required=True)
    s.add_argument("--max-gap", type=int, default=100)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_pick_adjacent_pairs)

    s = sub.add_parser("extract-exact-path-subgraph")
    s.add_argument("--graph", required=True)
    s.add_argument("--gam", required=True)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_extract_exact_path_subgraph)

    s = sub.add_parser("extract-neighbourhood")
    s.add_argument("--graph", required=True)
    s.add_argument("--gam", required=True)
    s.add_argument("--length", type=int, required=True)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_extract_neighbourhood)

    s = sub.add_parser("supported-subgraph")
    s.add_argument("--graph", required=True)
    s.add_argument("--gam", required=True)
    s.add_argument("--min-support", type=int, default=1)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_supported_subgraph)

    s = sub.add_parser("unitigify")
    s.add_argument("--graph", required=True)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_unitigify)

    s = sub.add_parser("untip")
    s.add_argument("--graph", required=True)
    s.add_argument("--max-len", type=int, required=True,
                   help="max removable tip length in bp (reference "
                        "maxRemovableLen)")
    s.add_argument("--min-safe-len", type=int, default=0,
                   help="only prune next to a branch at least this long "
                        "(reference minSafeLen)")
    s.add_argument("--fraction", type=float, default=0.5)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_untip)

    s = sub.add_parser("estimate-repeat-count")
    s.add_argument("--graph", required=True)
    s.add_argument("--gam", required=True)
    s.add_argument("--output", "-o", default="-")
    s.set_defaults(fn=cmd_estimate_repeat_count)

    s = sub.add_parser("pick-mummer-seeds")
    s.add_argument("--mums", required=True)
    s.add_argument("--max-seeds", type=int, default=10)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_pick_mummer_seeds)

    s = sub.add_parser("brute-force-prefix-seeds")
    s.add_argument("--graph", required=True)
    s.add_argument("--reads", required=True)
    s.add_argument("--k", type=int, required=True)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=cmd_brute_force_prefix_seeds)

    s = sub.add_parser("fusion-finder")
    s.add_argument("-g", "--graph", required=True)
    s.add_argument("--putative", required=True,
                   help="putative fusion pairs: 'left right support' lines")
    s.add_argument("--transcripts", required=True,
                   help="transcript alignments GAM (gene:<id> in names)")
    s.add_argument("-f", "--reads", required=True)
    s.add_argument("--min-support", type=int, default=2)
    s.add_argument("--max-score-fraction", type=float, default=0.3)
    s.add_argument("--min-fusion-len", type=int, default=50)
    s.add_argument("--fusion-penalty", type=int, default=20)
    s.add_argument("--fusions-out", default="-")
    s.add_argument("-a", "--output", default=None, help="fusion GAM")
    s.add_argument("--corrected-out", default=None)
    s.add_argument("--seed-k", type=int, default=15)
    s.add_argument("--seed-w", type=int, default=10)
    s.add_argument("--device", default="cuda",
                   help="torch device of the GA model: cuda runs the CUDA "
                        "kernels on the current card, cpu their plain "
                        "torch versions")
    s.set_defaults(fn=cmd_fusion_finder)

    s = sub.add_parser("maf-to-alignment")
    s.add_argument("--graph", required=True)
    s.add_argument("--path-name", required=True)
    s.add_argument("--maf", required=True)
    s.add_argument("--output", "-o", required=True)
    s.add_argument("--reads-out", required=True)
    s.set_defaults(fn=cmd_maf_to_alignment)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

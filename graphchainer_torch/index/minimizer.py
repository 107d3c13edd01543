"""(w,k)-minimizer seeding.

Re-design of the reference MinimizerSeeder (src/MinimizerSeeder.cpp):

* The reference builds a BBHash minimal-perfect-hash over minimizers with
  sdsl bit-packed position arrays, filled by a thread pool.  Here the index
  is two sorted numpy arrays (kmer codes, positions) built with vectorized
  sliding-window minima — binary search replaces the MPHF (cache-friendly,
  trivially serializable, and directly usable from the device as a
  resident table).
* Minimizers are enumerated per digraph node sequence (both strands are
  separate digraph nodes, so reverse-complement hits come for free), the
  same per-node scope as the reference's iterateMinimizersReal.
* Query: read minimizers -> binary search -> frequency filter keeping the
  least-frequent fraction (reference initMaxCount / addMinimizers
  semantics) -> up to density*len seeds preferring rare minimizers.

Copy of graphchainer_tpu/index/minimizer.py; the saved .npz is readable by
both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph

_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i


def _encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def _mix64(x: np.ndarray) -> np.ndarray:
    """Invertible 64-bit mix (splitmix64-style finalizer)."""
    x = np.asarray(x, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def kmer_codes(codes: np.ndarray, k: int):
    """Sliding k-mer codes; returns (codes uint64, valid bool)."""
    n = len(codes)
    if n < k:
        return (np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool))
    m = n - k + 1
    kv = np.zeros(m, dtype=np.uint64)
    bad = np.zeros(m, dtype=bool)
    for j in range(k):
        c = codes[j:m + j]
        kv = (kv << np.uint64(2)) | np.where(c < 0, 0, c).astype(np.uint64)
        bad |= c < 0
    return kv, ~bad


def minimizers(seq_codes: np.ndarray, k: int, w: int):
    """Positions and codes of the (w,k)-minimizers of a sequence.

    Returns (positions int64, codes uint64); positions are k-mer start
    offsets.  Ties keep the leftmost occurrence per window; duplicates
    across overlapping windows are deduplicated.
    """
    kv, valid = kmer_codes(seq_codes, k)
    m = len(kv)
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64)
    h = _mix64(kv)
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    if m <= w:
        p = int(np.argmin(h))
        if not valid[p]:
            return np.zeros(0, np.int64), np.zeros(0, np.uint64)
        return (np.array([p], np.int64), kv[p:p + 1])
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    arg = np.argmin(win, axis=1) + np.arange(m - w + 1)
    pos = np.unique(arg)
    pos = pos[valid[pos]]
    return pos.astype(np.int64), kv[pos]


def minimizers_batch(codes_list, k: int, w: int):
    """minimizers() for MANY sequences in one vectorized pass (one
    kmer-code scan + one sliding-window argmin over the concatenation).
    Returns a list of (positions, codes) identical to per-sequence
    minimizers() — windows never span sequence boundaries because only
    window starts fully inside one sequence's kmer range are kept;
    sequences with <= w kmers fall back to the scalar path."""
    out = [None] * len(codes_list)
    todo = []
    for i, c in enumerate(codes_list):
        m = len(c) - k + 1
        if m <= w:      # single-window semantics differ; scalar fallback
            out[i] = minimizers(c, k, w)
        else:
            todo.append(i)
    if not todo:
        return out
    cat = np.concatenate([codes_list[i] for i in todo])
    n_i = np.array([len(codes_list[i]) for i in todo], dtype=np.int64)
    c0 = np.zeros(len(todo) + 1, dtype=np.int64)
    np.cumsum(n_i, out=c0[1:])
    kv, valid = kmer_codes(cat, k)
    # kmers whose k-span crosses a sequence boundary are not real kmers
    # of any sequence: invalidate global positions [c0_i + m_i, c0_{i+1})
    m_i = n_i - k + 1
    for t in range(len(todo) - 1):      # vectorizable; t is small
        valid[c0[t] + m_i[t]:c0[t + 1]] = False
    h = _mix64(kv)
    h = np.where(valid, h, np.uint64(0xFFFFFFFFFFFFFFFF))
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    arg = np.argmin(win, axis=1) + np.arange(len(h) - w + 1)
    starts = np.arange(len(h) - w + 1, dtype=np.int64)
    # window start s belongs to sequence t iff c0_t <= s <= c0_t+m_t-w
    owner = np.searchsorted(c0, starts, side="right") - 1
    inside = starts <= c0[owner] + m_i[owner] - w
    sel = np.unique(arg[inside])
    sel = sel[valid[sel]]
    o2 = np.searchsorted(c0, sel, side="right") - 1
    bounds = np.searchsorted(o2, np.arange(len(todo) + 1))
    for t in range(len(todo)):
        g_pos = sel[bounds[t]:bounds[t + 1]]
        out[todo[t]] = ((g_pos - c0[t]).astype(np.int64), kv[g_pos])
    return out


@dataclass
class MinimizerIndex:
    k: int
    w: int
    codes: np.ndarray       # uint64, sorted
    di_node: np.ndarray     # int32: digraph node per position entry
    offset: np.ndarray      # int32: k-mer start offset within node
    count_cap: int          # frequency cap from discard fraction

    def save(self, path: str):
        np.savez_compressed(path, k=self.k, w=self.w, codes=self.codes,
                            di_node=self.di_node, offset=self.offset,
                            count_cap=self.count_cap)

    @staticmethod
    def load(path: str) -> "MinimizerIndex":
        z = np.load(path)
        return MinimizerIndex(k=int(z["k"]), w=int(z["w"]),
                              codes=z["codes"], di_node=z["di_node"],
                              offset=z["offset"],
                              count_cap=int(z["count_cap"]))


def build_index(g: AlignmentGraph, k: int = 15, w: int = 20,
                discard_fraction: float = 0.0002) -> MinimizerIndex:
    """Index all digraph node sequences (both strands).

    Extraction + stable code sort run in the native runtime with a
    thread pool (the reference parallelizes its MPHF bucket build the
    same way, src/MinimizerSeeder.cpp:299-492; the per-node NumPy loop
    below — kept as the oracle, GCTPU_PY_INDEX=1 — took ~200s on a
    40Mbp graph)."""
    import os
    if not os.environ.get("GCTPU_PY_INDEX"):
        from graphchainer_torch import native
        seq_bytes = np.frombuffer(
            "".join(g.di_seqs).encode("ascii") or b"\0", dtype=np.uint8)
        seq_off = np.zeros(g.n_digraph + 1, dtype=np.int64)
        np.cumsum([len(s) for s in g.di_seqs], out=seq_off[1:])
        codes, node64, off64 = native.minimizer_build(seq_bytes, seq_off,
                                                      k, w)
        node = node64.astype(np.int32)
        off = off64.astype(np.int32)
        return MinimizerIndex(k=k, w=w, codes=codes, di_node=node,
                              offset=off,
                              count_cap=_count_cap(codes,
                                                   discard_fraction))
    all_codes: List[np.ndarray] = []
    all_node: List[np.ndarray] = []
    all_off: List[np.ndarray] = []
    for d, seq in enumerate(g.di_seqs):
        pos, kv = minimizers(_encode(seq), k, w)
        if len(pos) == 0:
            continue
        all_codes.append(kv)
        all_node.append(np.full(len(pos), d, dtype=np.int32))
        all_off.append(pos.astype(np.int32))
    if not all_codes:
        codes = np.zeros(0, np.uint64)
        node = np.zeros(0, np.int32)
        off = np.zeros(0, np.int32)
    else:
        codes = np.concatenate(all_codes)
        node = np.concatenate(all_node)
        off = np.concatenate(all_off)
        order = np.argsort(codes, kind="stable")
        codes, node, off = codes[order], node[order], off[order]
    return MinimizerIndex(k=k, w=w, codes=codes, di_node=node, offset=off,
                          count_cap=_count_cap(codes, discard_fraction))


def _count_cap(codes: np.ndarray, discard_fraction: float) -> int:
    """Frequency cap: discard the most numerous k-mers covering
    `discard_fraction` of all positions (reference initMaxCount,
    src/MinimizerSeeder.cpp:557-575)."""
    cap = len(codes)
    if len(codes):
        _, counts = np.unique(codes, return_counts=True)
        csort = np.sort(counts)[::-1]
        budget = discard_fraction * len(codes)
        acc = np.cumsum(csort)
        ndrop = int(np.searchsorted(acc, budget, side="right"))
        if ndrop == 0:
            cap = int(csort[0]) + 1          # nothing is frequent enough to drop
        elif ndrop < len(csort):
            cap = int(csort[ndrop])
        else:
            cap = int(csort[-1])
        cap = max(cap, 2)
    return cap


@dataclass
class SeedHit:
    """Reference src/GraphAlignerWrapper.h:11-37."""
    di_node: int       # digraph node id
    node_offset: int   # k-mer start offset within the digraph node
    seq_pos: int       # k-mer start position in the read
    match_len: int
    goodness: float    # rarity score (higher = rarer = better)


def get_seeds(index: MinimizerIndex, read: str,
              density: float = 10.0) -> List[SeedHit]:
    """Seeds for one read: minimizer hits in rarity order, stopping once
    `density * len(read)` hits were emitted AND the next minimizer is
    strictly more frequent than the last one added (reference getSeeds +
    addMinimizers, src/MinimizerSeeder.cpp:494-545).  density == -1 keeps
    everything under the index frequency cap."""
    arrs = get_seed_arrays(index, read, density)
    if arrs is None:
        return []
    di, off, sp, good = arrs
    return [SeedHit(di_node=int(di[j]), node_offset=int(off[j]),
                    seq_pos=int(sp[j]), match_len=index.k,
                    goodness=float(good[j]))
            for j in range(len(di))]


def get_seed_arrays_batch(index: MinimizerIndex, reads, density: float):
    """get_seed_arrays for a whole batch: one minimizer pass over the
    concatenated reads + one index binary search; the per-read budget
    selection runs on the per-read slices.  Returns a list of
    (di_node, node_offset, seq_pos, goodness) or None per read."""
    mins = minimizers_batch([_encode(r) for r in reads], index.k, index.w)
    kv_cat = np.concatenate([kv for _, kv in mins]) \
        if mins else np.zeros(0, np.uint64)
    lo_cat = np.searchsorted(index.codes, kv_cat, side="left")
    hi_cat = np.searchsorted(index.codes, kv_cat, side="right")
    out = []
    o = 0
    for read, (pos, kv) in zip(reads, mins):
        n = len(pos)
        out.append(_select_seeds(index, len(read), pos, kv,
                                 lo_cat[o:o + n], hi_cat[o:o + n],
                                 density) if n else None)
        o += n
    return out


def get_seed_arrays(index: MinimizerIndex, read: str, density: float = 10.0):
    """Vectorized seed lookup: returns (di_node, node_offset, seq_pos,
    goodness) arrays sorted by ascending seq_pos, or None."""
    pos, kv = minimizers(_encode(read), index.k, index.w)
    if len(pos) == 0:
        return None
    lo = np.searchsorted(index.codes, kv, side="left")
    hi = np.searchsorted(index.codes, kv, side="right")
    return _select_seeds(index, len(read), pos, kv, lo, hi, density)


def _select_seeds(index: MinimizerIndex, read_len: int, pos: np.ndarray,
                  kv: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                  density: float):
    counts = (hi - lo).astype(np.int64)
    budget = float("inf") if density < 0 else density * read_len
    keep = (counts > 0) & (counts < index.count_cap)
    if not keep.any():
        return None
    order = np.argsort(np.where(keep, counts, 1 << 60), kind="stable")
    csum = np.cumsum(np.where(keep, counts, 0)[order])
    kept = int(keep.sum())
    # emit whole equal-frequency groups until the budget is crossed
    # (reference addMinimizers, src/MinimizerSeeder.cpp:494-520)
    ncut = int(np.searchsorted(csum[:kept], budget, side="left")) + 1
    if ncut < kept:
        cval = counts[order[ncut - 1]]
        while ncut < kept and counts[order[ncut]] == cval:
            ncut += 1
    sel = order[:min(ncut, kept)]
    # expand hit ranges vectorized
    reps = counts[sel]
    j = np.repeat(lo[sel], reps) + (
        np.arange(int(reps.sum())) -
        np.repeat(np.cumsum(reps) - reps, reps))
    sp = np.repeat(pos[sel], reps)
    good = np.repeat((index.count_cap - counts[sel]).astype(np.float64),
                     reps)
    di = index.di_node[j].astype(np.int64)
    off = index.offset[j].astype(np.int64)
    o2 = np.argsort(sp, kind="stable")
    return di[o2], off[o2], sp[o2], good[o2]


def cluster_seeds(g, seeds, tolerance: int = 100,
                  min_cluster_size: int = 0):
    """Chain-grouped diagonal seed clustering (reference
    orderSeedsByChaining, src/GraphAligner.h:233-295): seeds group by the
    graph's chain decomposition (AlignmentGraph.chains — bubbles popped,
    tips merged, cycles collapsed: src/AlignmentGraph.cpp:309-642), sort
    by in-chain diagonal (chain pos + offset - read pos), split clusters
    at diagonal gaps > `tolerance`, score each cluster by its
    non-overlapping matched read bp, and return seeds ordered by
    descending (cluster bp + seed rarity) goodness."""
    if not seeds:
        return []
    chain_no, chain_pos = g.chains()
    vs = np.empty(len(seeds), dtype=np.int64)
    offs = np.empty(len(seeds), dtype=np.int64)
    for i, s in enumerate(seeds):
        vs[i], offs[i] = g.find_split(s.di_node, s.node_offset)
    sp = np.array([s.seq_pos for s in seeds], dtype=np.int64)
    mlen = np.array([s.match_len for s in seeds], dtype=np.int64)
    raw = np.array([s.goodness for s in seeds], dtype=np.float64)
    cno = chain_no[vs]
    diag = chain_pos[vs] + offs - sp
    # cluster = run of seeds in the same chain whose sorted diagonals
    # step by <= tolerance
    o = np.lexsort((diag, cno))
    new_cl = np.ones(len(o), dtype=bool)
    new_cl[1:] = ((cno[o][1:] != cno[o][:-1])
                  | (diag[o][1:] > diag[o][:-1] + tolerance))
    cl_id = np.cumsum(new_cl) - 1
    goodness = np.empty(len(seeds), dtype=np.float64)
    cl_size = np.empty(len(seeds), dtype=np.int64)
    clusters = []
    for c in range(int(cl_id[-1]) + 1):
        cl = o[cl_id == c]
        # non-overlapping matched bp along the read (reference counts the
        # half-open interval (matchStart, matchEnd]; our seq_pos is the
        # match START, the reference's is the end — same intervals)
        cl = cl[np.argsort(sp[cl], kind="stable")]
        last_end = -(1 << 60)
        bps = 0
        for i in cl:
            a = int(sp[i])
            b = int(sp[i]) + int(mlen[i]) - 1
            bps += b - max(a, last_end)
            last_end = b
        goodness[cl] = bps + raw[cl]
        cl_size[cl] = len(cl)
        clusters.append((bps, cl))
    keep = np.ones(len(seeds), dtype=bool)
    if min_cluster_size > 1:
        # reference --seeds-clustersize (src/AlignerMain.cpp:79): discard
        # clusters with fewer seeds (unless none would survive)
        if (cl_size >= min_cluster_size).any():
            keep = cl_size >= min_cluster_size
    # descending goodness; ties keep the (chain, diagonal) sweep order —
    # spreads the first tries across the read instead of piling them at
    # one end when a cluster's seeds all score equally
    order = o[np.argsort(-goodness[o], kind="stable")]
    out = []
    for i in order:
        if not keep[i]:
            continue
        s = seeds[i]
        s.goodness = float(goodness[i])
        out.append(s)
    return out

"""Scalar reference oracle: textbook sequence-to-DAG edit distance DP.

Slow but exact (NumPy, per-character vertices).  This is the ground truth
that every device kernel is validated against (SURVEY.md §7.2 step 2); it
mirrors what the reference validates with EXTRACORRECTNESSASSERTIONS
cell-recomputation checks (reference src/GraphAlignerBitvectorBanded.h:147).

Recurrence (Navarro 2000 sequence-to-graph edit distance), for character
vertex v with predecessors pred(v), read R (rows j = 1..|R|):

  D[v, j] = min( D[u, j-1] + (R[j] matches base(v) ? 0 : 1)   for u in pred(v),
                 D[v, j-1] + 1,
                 D[u, j]   + 1                                for u in pred(v),
                 inject[v] + (j-1) + (R[j] matches base(v) ? 0 : 1),
                 inject[v] + j + 1 )

`inject[v]` is the cost of a virtual boundary column sitting just BEFORE
char v (its row-j score is inject[v] + j): the uniform way to express
"alignment may start at graph position v with cost inject[v]".  A seed
exact-start is inject[seed]=0, everything else BIG.

JAX-free copy of graphchainer_tpu/align/oracle.py."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.utils.seq import match_masks

BIG = np.int64(1 << 28)


@dataclass
class CharGraph:
    """Per-character expansion of (a sub-DAG of) the alignment graph."""
    n: int
    # CSR of predecessor char-vertices; vertex ids are topo-ordered
    pred_ptr: np.ndarray
    pred_idx: np.ndarray
    match_mask: np.ndarray       # uint8 [n]: 4-bit base match mask
    node_of: np.ndarray          # int64 [n]: split node id
    offset_of: np.ndarray        # int64 [n]: offset within split node

    def char_id(self, node: int, offset: int) -> int:
        hit = np.nonzero((self.node_of == node) & (self.offset_of == offset))[0]
        assert len(hit) == 1
        return int(hit[0])


def build_char_graph(g: AlignmentGraph,
                     nodes: Optional[np.ndarray] = None) -> CharGraph:
    """Expand split nodes (default: all) into one vertex per base.

    `nodes` must be sorted split node ids (global ids are topo ranks, so
    sorted == topo-sorted).  Edges from nodes outside the subset are
    dropped (out-of-band boundary, as in the banded kernel).
    """
    if nodes is None:
        nodes = np.arange(g.n_nodes, dtype=np.int64)
    nodes = np.asarray(nodes, dtype=np.int64)
    sel = {int(v): i for i, v in enumerate(nodes)}
    first_char = np.zeros(len(nodes) + 1, dtype=np.int64)
    np.cumsum(g.node_len[nodes], out=first_char[1:])
    n = int(first_char[-1])
    node_of = np.repeat(nodes, g.node_len[nodes])
    offset_of = np.concatenate(
        [np.arange(g.node_len[v], dtype=np.int64) for v in nodes]) \
        if len(nodes) else np.zeros(0, dtype=np.int64)
    mm = np.concatenate([match_masks(g.node_seq(int(v))) for v in nodes]) \
        if len(nodes) else np.zeros(0, dtype=np.uint8)

    preds: List[List[int]] = [[] for _ in range(n)]
    for i, v in enumerate(nodes):
        base = int(first_char[i])
        ln = int(g.node_len[v])
        for o in range(1, ln):
            preds[base + o].append(base + o - 1)
        # incoming node edges attach to the node's first char
        for u in g.in_neighbors(int(v)):
            if int(u) in sel:
                iu = sel[int(u)]
                preds[base].append(int(first_char[iu])
                                   + int(g.node_len[int(u)]) - 1)
    pred_ptr = np.zeros(n + 1, dtype=np.int64)
    pred_ptr[1:] = np.cumsum([len(p) for p in preds])
    pred_idx = np.concatenate([np.asarray(p, dtype=np.int64)
                               for p in preds]) if n else np.zeros(0, np.int64)
    return CharGraph(n=n, pred_ptr=pred_ptr, pred_idx=pred_idx,
                     match_mask=mm, node_of=node_of, offset_of=offset_of)


def dag_dp(cg: CharGraph, read: str, inject: np.ndarray) -> np.ndarray:
    """Full DP table D[v, j], j=0..len(read), from per-vertex boundary
    injection costs (see module docstring)."""
    R = len(read)
    rmm = match_masks(read)
    idx = np.arange(R + 1, dtype=np.int64)
    D = np.empty((cg.n, R + 1), dtype=np.int64)
    for v in range(cg.n):
        bound = np.minimum(inject[v] + idx, BIG)   # virtual column before v
        ps = cg.pred_idx[cg.pred_ptr[v]:cg.pred_ptr[v + 1]]
        if len(ps):
            inc = np.minimum(np.min(D[ps], axis=0), bound)
        else:
            inc = bound
        sub = ((rmm.astype(np.int64) & int(cg.match_mask[v])) == 0).astype(np.int64)
        t = np.empty(R + 1, dtype=np.int64)
        t[0] = inc[0] + 1
        t[1:] = np.minimum(inc[:-1] + sub, inc[1:] + 1)
        # vertical closure: D[v,j] = min_{p<=j} t[p] + (j - p)
        D[v] = np.minimum.accumulate(t - idx) + idx
        np.minimum(D[v], BIG, out=D[v])
    return D


OP_MATCH, OP_DEL, OP_INS, OP_MISMATCH = 0, 1, 2, 3


def backtrace(cg: CharGraph, D: np.ndarray, read: str,
              inject: np.ndarray, end_char: int):
    """Exact backtrace from (end_char, len(read)) to an alignment start.

    Returns (positions (N,2) int64, ops uint8) where ops use the polish
    codes (0=match, 3=mismatch, 1=del/path, 2=ins/read).  Leading read
    prefix before a free start is emitted as insertions (its cost is part
    of the boundary injection column, see dag_dp)."""
    rmm = match_masks(read)
    pos_rev = []
    ops_rev = []
    v, j = int(end_char), len(read)
    while True:
        cell = D[v, j]
        sub_ok = j > 0 and (int(rmm[j - 1]) & int(cg.match_mask[v])) != 0
        sub = 0 if sub_ok else 1
        ps = cg.pred_idx[cg.pred_ptr[v]:cg.pred_ptr[v + 1]]
        moved = False
        # start moves first when exact (deterministic preference: finish
        # the walk as early as possible at equal cost)
        if j > 0 and cell == min(inject[v] + (j - 1), BIG) + sub:
            pos_rev.append(v)
            ops_rev.append(OP_MISMATCH if sub else OP_MATCH)
            ops_rev.extend([OP_INS] * (j - 1))
            break
        if cell == min(inject[v] + j, BIG) + 1:
            pos_rev.append(v)
            ops_rev.append(OP_DEL)
            ops_rev.extend([OP_INS] * j)
            break
        if j > 0:
            for u in ps:
                if D[u, j - 1] + sub == cell:
                    pos_rev.append(v)
                    ops_rev.append(OP_MISMATCH if sub else OP_MATCH)
                    v, j = int(u), j - 1
                    moved = True
                    break
        if moved:
            continue
        for u in ps:
            if D[u, j] + 1 == cell:
                pos_rev.append(v)
                ops_rev.append(OP_DEL)
                v = int(u)
                moved = True
                break
        if moved:
            continue
        if j > 0 and D[v, j - 1] + 1 == cell:
            ops_rev.append(OP_INS)
            j -= 1
            continue
        raise AssertionError("inconsistent DP table in oracle backtrace")
    chars = list(reversed(pos_rev))
    positions = np.stack([cg.node_of[chars], cg.offset_of[chars]], axis=1) \
        if chars else np.zeros((0, 2), dtype=np.int64)
    ops = np.array(list(reversed(ops_rev)), dtype=np.uint8)
    return positions, ops


def extend_from_seed(g: AlignmentGraph, read: str, seed_node: int,
                     seed_offset: int, nodes: Optional[np.ndarray] = None
                     ) -> Tuple[CharGraph, np.ndarray]:
    """Oracle extension DP: align `read` forward with the alignment forced
    to start exactly at graph position (seed_node, seed_offset): read[0]
    consumes that char diagonally (or is inserted before it)."""
    cg = build_char_graph(g, nodes)
    inject = np.full(cg.n, BIG, dtype=np.int64)
    inject[cg.char_id(seed_node, seed_offset)] = 0
    return cg, dag_dp(cg, read, inject)


# ---------------------------------------------------------------------------
# Checkpointed DP: exact score + traceback with O(n * (C + R/C)) memory
# instead of the full O(n * R) table (lifts the r2 20M-cell traceback cap
# of --optimal-alignment; reference Dijkstra mode has no such cap,
# src/GraphAlignerBitvectorDijkstra.h).

def _dp_block(cg: CharGraph, rmm_block: np.ndarray, inject: np.ndarray,
              left: np.ndarray, j_base: int) -> np.ndarray:
    """One read-stripe of the DP: D_block[:, 0] = `left` (the exact DP
    column at global read position j_base); returns (n, C+1) covering
    global columns j_base..j_base+C."""
    C = len(rmm_block)
    idx = np.arange(C + 1, dtype=np.int64)
    gidx = j_base + idx
    D = np.empty((cg.n, C + 1), dtype=np.int64)
    rb = rmm_block.astype(np.int64)
    for v in range(cg.n):
        bound = np.minimum(inject[v] + gidx, BIG)
        ps = cg.pred_idx[cg.pred_ptr[v]:cg.pred_ptr[v + 1]]
        if len(ps):
            inc = np.minimum(np.min(D[ps], axis=0), bound)
        else:
            inc = bound
        sub = ((rb & int(cg.match_mask[v])) == 0).astype(np.int64)
        t = np.empty(C + 1, dtype=np.int64)
        t[0] = left[v]
        t[1:] = np.minimum(inc[:-1] + sub, inc[1:] + 1)
        D[v] = np.minimum.accumulate(t - idx) + idx
        np.minimum(D[v], BIG, out=D[v])
    return D


def dag_dp_ckpt(cg: CharGraph, read: str, inject: np.ndarray,
                stripe: int = 0) -> Tuple[np.ndarray, List[np.ndarray],
                                          int]:
    """Checkpointed forward DP.  Returns (final column D[:, R],
    checkpoint columns [D[:, 0], D[:, C], D[:, 2C], ...], stripe C).

    Memory is n x C for the working stripe plus n x ceil(R/C) for the
    checkpoints; stripe defaults to ~sqrt(R) to balance the two."""
    R = len(read)
    rmm = match_masks(read)
    if stripe <= 0:
        stripe = max(16, int(np.sqrt(max(R, 1)) * 1.4))
    # column 0 of the whole DP: vertical closure over inject along each
    # topological path; computed as a 1-column block from an all-BIG left
    # (t[0]=BIG makes the closure pick the inject/pred terms only)
    col0 = np.empty(cg.n, dtype=np.int64)
    for v in range(cg.n):
        ps = cg.pred_idx[cg.pred_ptr[v]:cg.pred_ptr[v + 1]]
        inc = min((int(col0[u]) for u in ps), default=BIG)
        col0[v] = min(inject[v] + 1, inc + 1, BIG)
    ckpts = [col0]
    left = col0
    for j0 in range(0, R, stripe):
        blk = rmm[j0:j0 + stripe]
        D = _dp_block(cg, blk, inject, left, j0)
        left = D[:, -1].copy()
        if j0 + stripe < R:
            ckpts.append(left)
    return left, ckpts, stripe


def _walk_block(cg: CharGraph, D: np.ndarray, rmm: np.ndarray,
                inject: np.ndarray, v: int, jl: int, j_base: int):
    """Backtrace inside one stripe block from local column jl.  Returns
    (pos_rev, ops_rev, v', done): walks until an alignment start breaks
    (done=True) or the stripe's left boundary is reached (done=False,
    continue at (v', local C_prev) in the previous block)."""
    pos_rev: List[int] = []
    ops_rev: List[int] = []
    while True:
        j = j_base + jl
        cell = D[v, jl]
        sub_ok = j > 0 and (int(rmm[j - 1]) & int(cg.match_mask[v])) != 0
        sub = 0 if sub_ok else 1
        ps = cg.pred_idx[cg.pred_ptr[v]:cg.pred_ptr[v + 1]]
        if jl == 0:
            # the previous block owns this column (it is its LAST column;
            # in-column deletions continue there)
            return pos_rev, ops_rev, v, False
        if cell == min(inject[v] + (j - 1), BIG) + sub:
            pos_rev.append(v)
            ops_rev.append(OP_MISMATCH if sub else OP_MATCH)
            ops_rev.extend([OP_INS] * (j - 1))
            return pos_rev, ops_rev, v, True
        if cell == min(inject[v] + j, BIG) + 1:
            pos_rev.append(v)
            ops_rev.append(OP_DEL)
            ops_rev.extend([OP_INS] * j)
            return pos_rev, ops_rev, v, True
        moved = False
        for u in ps:
            if D[u, jl - 1] + sub == cell:
                pos_rev.append(v)
                ops_rev.append(OP_MISMATCH if sub else OP_MATCH)
                v, jl = int(u), jl - 1
                moved = True
                break
        if moved:
            continue
        for u in ps:
            if D[u, jl] + 1 == cell:
                pos_rev.append(v)
                ops_rev.append(OP_DEL)
                v = int(u)
                moved = True
                break
        if moved:
            continue
        if D[v, jl - 1] + 1 == cell:
            ops_rev.append(OP_INS)
            jl -= 1
            continue
        raise AssertionError("inconsistent DP block in ckpt backtrace")


def backtrace_ckpt(cg: CharGraph, read: str, inject: np.ndarray,
                   ckpts: List[np.ndarray], stripe: int, end_char: int):
    """Exact traceback by stripe recompute from the forward checkpoints
    (2x forward work, O(n * stripe) peak memory).  Same output contract
    as `backtrace`."""
    R = len(read)
    rmm = match_masks(read)
    pos_rev: List[int] = []
    ops_rev: List[int] = []
    v = int(end_char)
    k = (R - 1) // stripe if R else 0   # stripe index holding column R
    jl = R - k * stripe
    done = False
    while not done:
        j0 = k * stripe
        D = _dp_block(cg, rmm[j0:j0 + stripe], inject, ckpts[k], j0)
        seg_pos, seg_ops, v, done = _walk_block(cg, D, rmm, inject, v,
                                                jl, j0)
        pos_rev.extend(seg_pos)
        ops_rev.extend(seg_ops)
        if not done:
            if k == 0:
                # column 0 of the whole DP: only starts/in-column dels
                # remain; resolve against the closed-form column 0
                cell = int(ckpts[0][v])
                while True:
                    if cell == min(int(inject[v]) + 1, BIG):
                        pos_rev.append(v)
                        ops_rev.append(OP_DEL)
                        done = True
                        break
                    ps = cg.pred_idx[cg.pred_ptr[v]:cg.pred_ptr[v + 1]]
                    stepped = False
                    for u in ps:
                        if int(ckpts[0][u]) + 1 == cell:
                            pos_rev.append(v)
                            ops_rev.append(OP_DEL)
                            v, cell = int(u), int(ckpts[0][u])
                            stepped = True
                            break
                    if not stepped:
                        raise AssertionError(
                            "inconsistent column-0 in ckpt backtrace")
                break
            k -= 1
            jl = stripe
    chars = list(reversed(pos_rev))
    positions = np.stack([cg.node_of[chars], cg.offset_of[chars]],
                         axis=1) if chars else np.zeros((0, 2),
                                                        dtype=np.int64)
    ops = np.array(list(reversed(ops_rev)), dtype=np.uint8)
    return positions, ops

"""Polish-guided bubble repair.

The fragment kernel's backwalk pointers are WORD-granular (32-row Myers
words), so at exact-score ties the reconstructed path can thread a
variation bubble through the wrong arm — the SCORE stays exact, but the
emitted path is one of the tie-compatible ones.  The reference's per-cell
backpointers (src/GraphAlignerBitvectorBanded.h backtrace) never do this.

Rather than paying for row-exact pointers on device, this host pass runs
AFTER the polish CIGAR exists: every mismatching locus that falls on a
small, fully-covered path node with sibling arms (nodes sharing the
path's predecessor and successor) is re-scored against each arm, and the
best arm is spliced in.  The caller re-polishes repaired reads (one extra
batched device call covering only them).

Vectorized decode: dirty-locus detection and read-span extraction are
numpy passes over the op string; Python only touches actual bubble
candidates (a handful per read).

Copy of graphchainer_tpu/align/repair.py.  The pipeline runs the native
whole-batch corridor re-polish (native.corridor_polish_batch) instead;
native.repair_batch is this module's pass in C++.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

OP_MATCH, OP_DEL, OP_INS, OP_MISMATCH = 0, 1, 2, 3


def _nw_small(a: np.ndarray, b: np.ndarray) -> int:
    """Edit distance of two short uint8 strings (full DP; lengths are a
    few dozen at most)."""
    la, lb = len(a), len(b)
    prev = np.arange(lb + 1, dtype=np.int32)
    for i in range(la):
        cur = np.empty(lb + 1, dtype=np.int32)
        cur[0] = i + 1
        cur[1:] = np.minimum(prev[:-1] + (b != a[i]), prev[1:] + 1)
        for j in range(1, lb + 1):        # left-insertion chain
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev = cur
    return int(prev[lb])


def repair_read(g, gx, read: str, positions: np.ndarray,
                ops: np.ndarray, max_arm_len: int = 32
                ) -> Optional[np.ndarray]:
    """Return repaired positions, or None when nothing changed.

    positions: (P, 2) path rows; ops: polish CIGAR over the WHOLE read
    (global NW, chainer polish path)."""
    if ops is None or len(positions) == 0:
        return None
    ops = np.asarray(ops)
    if not (ops != OP_MATCH).any():
        return None
    nodes = positions[:, 0]
    # path/read index consumed by each op
    path_step = (ops != OP_INS).astype(np.int64)
    read_step = (ops != OP_DEL).astype(np.int64)
    pi = np.cumsum(path_step) - path_step       # path char index per op
    ri = np.cumsum(read_step) - read_step       # read char index per op
    P = len(positions)
    pi = np.minimum(pi, P - 1)
    # per path index: min/max read index of any op touching it
    r_min = np.full(P, 1 << 60, dtype=np.int64)
    r_max = np.full(P, -1, dtype=np.int64)
    np.minimum.at(r_min, pi, ri)
    np.maximum.at(r_max, pi, ri + read_step)
    # dirty path indices
    dirty_p = np.unique(pi[ops != OP_MATCH])
    if not len(dirty_p):
        return None
    # node runs: start row of each node occurrence
    change = np.ones(P, dtype=bool)
    change[1:] = nodes[1:] != nodes[:-1]
    run_id = np.cumsum(change) - 1
    run_start = np.nonzero(change)[0]
    run_end = np.append(run_start[1:], P)
    dirty_runs = np.unique(run_id[dirty_p])

    rbytes = np.frombuffer(read.encode("ascii"), dtype=np.uint8)
    out_ptr, out_idx = g.out_ptr, g.out_idx
    in_ptr, in_idx = g.in_ptr, g.in_idx
    node_len = g.node_len

    def node_bytes(v):
        return np.frombuffer(g.node_seq(int(v)).encode("ascii"), np.uint8)

    def arm_set(u, x, exclude=-1):
        outs = out_idx[out_ptr[u]:out_ptr[u + 1]]
        ins = in_idx[in_ptr[x]:in_ptr[x + 1]]
        arms = np.intersect1d(outs, ins)
        return arms[arms != exclude]

    splices = []          # (p0, p1, new_node or -1 = delete)
    spliced_runs = set()
    for rid_ in dirty_runs:
        p0, p1 = int(run_start[rid_]), int(run_end[rid_])
        if p0 == 0 or p1 >= P:
            continue                       # path ends: tails, skip
        v = int(nodes[p0])
        lv = int(node_len[v])
        if lv > max_arm_len or p1 - p0 != lv:
            continue                       # not a fully-covered small node
        if int(positions[p0, 1]) != 0 or int(positions[p1 - 1, 1]) != lv - 1:
            continue
        u = int(nodes[p0 - 1])
        x = int(nodes[p1])
        if u == v or x == v:
            continue
        # candidate replacements for the span [v]:
        #   [w]    sibling arm            (u -> w -> x)
        #   []     pure-deletion arm      (edge u -> x)
        #   [v,w]  missing arm after v    (v -> w -> x); NW may have slid
        #   [w,v]  missing arm before v   (u -> w -> v); the indel inside v
        cands = [[int(w)] for w in arm_set(u, x, exclude=v)
                 if int(node_len[w]) <= max_arm_len]
        if bool((out_idx[out_ptr[u]:out_ptr[u + 1]] == x).any()):
            cands.append([])
        cands += [[v, int(w)] for w in arm_set(v, x)
                  if int(node_len[w]) <= max_arm_len]
        cands += [[int(w), v] for w in arm_set(u, v)
                  if int(node_len[w]) <= max_arm_len]
        if not cands:
            continue
        # read segment covering this node's locus (may be empty when the
        # whole node aligned as deletions)
        r_lo = int(r_min[p0:p1].min())
        r_hi = int(r_max[p0:p1].max())
        if r_lo >= (1 << 60):
            r_lo, r_hi = 0, 0
        seg = rbytes[min(r_lo, len(rbytes)):min(max(r_hi, r_lo),
                                                len(rbytes))]
        best_cost = _nw_small(seg, node_bytes(v))
        best = None
        for cand in cands:
            cseq = (np.concatenate([node_bytes(w) for w in cand])
                    if cand else np.zeros(0, np.uint8))
            c = _nw_small(seg, cseq)
            if c < best_cost:
                best_cost = c
                best = cand
        if best is not None:
            splices.append((p0, p1, best))
            spliced_runs.add(int(rid_))

    # missing-arm insertions: extra read chars between two path nodes u|x
    # where an arm node w (u -> w -> x) matches them
    rc = np.full(P, -1, dtype=np.int64)      # read idx consuming path char
    consumed = (ops == OP_MATCH) | (ops == OP_MISMATCH)
    rc[pi[consumed]] = ri[consumed]
    for rid_ in np.unique(run_id[dirty_p]):
        p = int(run_start[rid_])
        if p == 0 or int(rid_) in spliced_runs \
                or (int(rid_) - 1) in spliced_runs:
            continue
        if rc[p] < 0 or rc[p - 1] < 0:
            continue
        gap = int(rc[p]) - int(rc[p - 1]) - 1
        if gap < 1:
            continue
        u, x = int(nodes[p - 1]), int(nodes[p])
        arms = arm_set(u, x)
        if not len(arms):
            continue
        seg = rbytes[rc[p - 1] + 1:rc[p]]
        best_cost = len(seg)                 # current: all insertions
        best = None
        for w in arms:
            w = int(w)
            if int(node_len[w]) > max_arm_len:
                continue
            c = _nw_small(seg, node_bytes(w))
            if c < best_cost:
                best_cost = c
                best = [w]
        if best is not None:
            splices.append((p, p, best))

    if not splices:
        return None
    splices.sort(key=lambda t: (t[0], t[1]))
    parts = []
    last = 0
    for p0, p1, cand in splices:
        if p0 < last:
            continue                      # overlapping repair: keep first
        parts.append(positions[last:p0])
        for w in cand:
            lw = int(node_len[w])
            rows = np.empty((lw, 2), dtype=positions.dtype)
            rows[:, 0] = w
            rows[:, 1] = np.arange(lw)
            parts.append(rows)
        last = p1
    parts.append(positions[last:])
    return np.concatenate(parts, axis=0)


def rewrite_ops(gx, read: str, score: int, ops: np.ndarray,
                old_pos: np.ndarray, new_pos: np.ndarray):
    """Exact post-repair (score, ops) WITHOUT a re-polish, when the arm
    swap is a same-length substitution whose every changed path position
    the old CIGAR aligned as a mismatch (the SNP-bubble case — the
    repair scan selects arms at X ops by construction).

    Exactness: any alignment's cost changes by at most 1 per changed
    path character, so new_optimum >= old_optimum - n_changed; the X->=
    rewrite achieves exactly that bound.  (A changed position under a D
    op, or a new char that doesn't match the read, breaks the bound —
    return None and let the caller re-polish.)

    Returns (score, ops) or None."""
    old_pos = np.asarray(old_pos)
    new_pos = np.asarray(new_pos)
    if old_pos.shape != new_pos.shape:
        return None
    diff = np.nonzero((old_pos != new_pos).any(axis=1))[0]
    if len(diff) == 0:
        return score, ops
    op_rows = np.nonzero(ops != OP_INS)[0]     # ops consuming the path
    if len(op_rows) != len(new_pos):
        return None
    o = op_rows[diff]
    if not (ops[o] == OP_MISMATCH).all():
        return None
    ridx = np.cumsum(ops != OP_DEL) - 1        # read index per op
    newchars = np.frombuffer(
        gx.positions_seq(new_pos[diff]).encode(), np.uint8)
    rchars = np.frombuffer(read.encode(), np.uint8)[ridx[o]]
    if not (newchars == rchars).all():
        return None
    new_ops = ops.copy()
    new_ops[o] = OP_MATCH
    return score - len(o), new_ops

"""Chaining event packer over the MPC index (host).

JAX-free copies of global_path_ids, anchor_kmask_cols and
batch_arrays_cols from graphchainer_tpu/align/chaining.py: per-read
anchors (start node, end node, read interval) become the padded event
lists that ops/chain_scan.chain_scan sweeps.  Per anchor j the events are
SAME_START(start), SAME_END(end), INSERT(end) and one QUERY per
last2reach back-pointer of its start node, in the order
(node, section, y, x, j, subtype) per read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.graph.mpc import MPCIndex
from graphchainer_torch.ops.chain_scan import (EV_INSERT, EV_QUERY,
                                               EV_SAME_END, EV_SAME_START)


def _bucket(x: int, m: int) -> int:
    out = m
    while out < x:
        out *= 2
    return out


def global_path_ids(mpc: MPCIndex) -> Tuple[np.ndarray, int]:
    """Map (component, per-component k) -> global path id.  Returns
    (comp_path_base [ncomp + 1], n_paths)."""
    ncomp = len(mpc.comp_width)
    base = np.zeros(ncomp + 1, dtype=np.int64)
    np.cumsum(mpc.comp_width, out=base[1:])
    return base, int(base[-1])


def anchor_kmask_cols(g: AlignmentGraph, mpc: MPCIndex, counts: np.ndarray,
                      e: np.ndarray, R: int, A: int) -> np.ndarray:
    """(R, A, KW) uint32 per-anchor INSERT path bitmask: the global-path
    bits through each anchor's end node."""
    base, n_paths = global_path_ids(mpc)
    kw = _bucket(-(-n_paths // 32), 1)
    a_kmask = np.zeros((R, A, kw), dtype=np.uint32)
    Atot = len(e)
    if Atot == 0:
        return a_kmask
    rid = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    jloc = (np.arange(Atot, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))
    gbase = base[g.comp[e]]
    npk0 = mpc.nodepath_offsets[e]
    npn = (mpc.nodepath_offsets[e + 1] - npk0).astype(np.int64)
    NP = int(npn.sum())
    prep = np.repeat(np.arange(Atot, dtype=np.int64), npn)
    pflat = (np.arange(NP, dtype=np.int64)
             - np.repeat(np.cumsum(npn) - npn, npn) + npk0[prep])
    gk = gbase[prep] + mpc.nodepath_k[pflat]
    flat = (rid[prep] * A + jloc[prep]) * kw + gk // 32
    np.bitwise_or.at(a_kmask.reshape(-1), flat,
                     (np.uint32(1) << (gk % 32).astype(np.uint32)))
    return a_kmask


def batch_arrays_cols(g: AlignmentGraph, mpc: MPCIndex, counts: np.ndarray,
                      s: np.ndarray, e: np.ndarray, ax: np.ndarray,
                      ay: np.ndarray, A: Optional[int] = None,
                      E: Optional[int] = None):
    """Per-read anchor counts plus flat (start node, end node, x, y)
    arrays grouped by read -> dict of padded arrays x, y, valid, ev_type,
    ev_anchor, ev_k, ev_group (R, E) and a_kmask (R, A, KW)."""
    R = len(counts)
    base, _ = global_path_ids(mpc)
    Atot = int(counts.sum())
    A = A or _bucket(int(counts.max(initial=1)), 64)
    if Atot == 0:
        E = E or 512
        return dict(x=np.zeros((R, A), np.int32),
                    y=np.zeros((R, A), np.int32),
                    valid=np.zeros((R, A), bool),
                    ev_type=np.full((R, E), -1, np.int32),
                    ev_anchor=np.zeros((R, E), np.int32),
                    ev_k=np.full((R, E), -1, np.int32),
                    ev_group=np.full((R, E), -1, np.int32),
                    a_kmask=anchor_kmask_cols(g, mpc, counts, e, R, A))

    rid = np.repeat(np.arange(R, dtype=np.int64), counts)
    jloc = (np.arange(Atot, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))
    gbase = base[g.comp[s]]

    nb = (mpc.back_offsets[s + 1] - mpc.back_offsets[s]).astype(np.int64)
    NQ = int(nb.sum())
    qrep = np.repeat(np.arange(Atot, dtype=np.int64), nb)
    qflat = (np.arange(NQ, dtype=np.int64)
             - np.repeat(np.cumsum(nb) - nb, nb)
             + mpc.back_offsets[s][qrep])
    ev_node = np.concatenate([s, e, e, mpc.back_node[qflat]])
    ev_sec = np.concatenate([np.zeros(2 * Atot, np.int64),
                             np.full(Atot, 1, np.int64),
                             np.full(NQ, 2, np.int64)])
    ev_sub = np.concatenate([np.zeros(Atot, np.int64),
                             np.ones(Atot, np.int64),
                             np.zeros(Atot + NQ, np.int64)])
    ev_t = np.concatenate([np.full(Atot, EV_SAME_START, np.int64),
                           np.full(Atot, EV_SAME_END, np.int64),
                           np.full(Atot, EV_INSERT, np.int64),
                           np.full(NQ, EV_QUERY, np.int64)])
    ev_j = np.concatenate([jloc, jloc, jloc, jloc[qrep]])
    ev_x = np.concatenate([ax, ax, ax, ax[qrep]])
    ev_y = np.concatenate([ay, ay, ay, ay[qrep]])
    ev_r = np.concatenate([rid, rid, rid, rid[qrep]])
    ev_kq = np.concatenate([np.full(3 * Atot, -1, np.int64),
                            gbase[qrep] + mpc.back_k[qflat]])

    # execution order per read: (node, section, y, x, j, subtype)
    o = np.lexsort((ev_sub, ev_j, ev_x, ev_y, ev_sec, ev_node, ev_r))
    ev_node, ev_t, ev_j, ev_kq, ev_r = (
        a[o] for a in (ev_node, ev_t, ev_j, ev_kq, ev_r))

    NE = len(o)
    new_read = np.ones(NE, dtype=bool)
    new_read[1:] = ev_r[1:] != ev_r[:-1]
    new_grp = new_read.copy()
    new_grp[1:] |= ev_node[1:] != ev_node[:-1]
    grp = np.cumsum(new_grp) - 1
    read_start = np.nonzero(new_read)[0]
    per_read_ne = np.diff(np.append(read_start, NE))
    grp -= np.repeat(grp[read_start], per_read_ne)
    epos = np.arange(NE, dtype=np.int64) - np.repeat(read_start,
                                                     per_read_ne)

    E = E or int(per_read_ne.max(initial=1))
    x = np.zeros((R, A), dtype=np.int32)
    y = np.zeros((R, A), dtype=np.int32)
    valid = np.zeros((R, A), dtype=bool)
    x[rid, jloc] = ax
    y[rid, jloc] = ay
    valid[rid, jloc] = True
    ev_type = np.full((R, E), -1, dtype=np.int32)
    ev_anchor = np.zeros((R, E), dtype=np.int32)
    ev_k = np.full((R, E), -1, dtype=np.int32)
    ev_group = np.full((R, E), -1, dtype=np.int32)
    keep = epos < E
    rr, pp = ev_r[keep], epos[keep]
    ev_type[rr, pp] = ev_t[keep]
    ev_anchor[rr, pp] = ev_j[keep]
    ev_k[rr, pp] = ev_kq[keep]
    ev_group[rr, pp] = grp[keep]
    return dict(x=x, y=y, valid=valid, ev_type=ev_type, ev_anchor=ev_anchor,
                ev_k=ev_k, ev_group=ev_group,
                a_kmask=anchor_kmask_cols(g, mpc, counts, e, R, A))

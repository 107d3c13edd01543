"""Minimum path cover (MPC) index of the split-node DAG.

Reference: src/AlignmentGraph.cpp:1465-1489 (buildMPC) — greedy cover,
min-flow shrink, last2reach index, all per weakly-connected component.  The
heavy lifting runs in the C++ host runtime (native/graphchainer_native.cpp);
this module assembles the flat tensors consumed by the chaining scan and
makes the index a real serializable artifact (the reference's saveMPC /
loadMPC are stubs: src/AlignmentGraph.cpp:1490-1495).

Copy of graphchainer_tpu/graph/mpc.py; the saved .npz is readable by both
packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from graphchainer_torch import native
from graphchainer_torch.graph.alignment_graph import AlignmentGraph


@dataclass
class MPCIndex:
    # Paths of the cover (global split-node ids, topo order along path).
    path_offsets: np.ndarray   # int64 [npaths+1]
    path_nodes: np.ndarray     # int64 (flat)
    path_comp: np.ndarray      # int64 [npaths] component of each path
    path_k: np.ndarray         # int64 [npaths] per-component path index
    # last2reach backwards pointers: per node v, (u, k) pairs meaning "the
    # last node u of component-path k that reaches v strictly before v".
    back_offsets: np.ndarray   # int64 [N+1]
    back_node: np.ndarray      # int64 (flat)
    back_k: np.ndarray         # int64 (flat)
    # per node: component-path ids k passing through it
    nodepath_offsets: np.ndarray  # int64 [N+1]
    nodepath_k: np.ndarray        # int64 (flat)
    # per component: cover width K
    comp_width: np.ndarray     # int64 [ncomp]

    @property
    def max_width(self) -> int:
        return int(self.comp_width.max()) if len(self.comp_width) else 0

    def paths_of_component(self, c: int) -> List[np.ndarray]:
        out = []
        for p in np.nonzero(self.path_comp == c)[0]:
            out.append(self.path_nodes[self.path_offsets[p]:
                                       self.path_offsets[p + 1]])
        return out

    def backwards(self, v: int):
        lo, hi = self.back_offsets[v], self.back_offsets[v + 1]
        return self.back_node[lo:hi], self.back_k[lo:hi]

    def node_paths(self, v: int) -> np.ndarray:
        return self.nodepath_k[self.nodepath_offsets[v]:
                               self.nodepath_offsets[v + 1]]

    def save(self, path: str):
        np.savez_compressed(
            path, path_offsets=self.path_offsets, path_nodes=self.path_nodes,
            path_comp=self.path_comp, path_k=self.path_k,
            back_offsets=self.back_offsets, back_node=self.back_node,
            back_k=self.back_k, nodepath_offsets=self.nodepath_offsets,
            nodepath_k=self.nodepath_k, comp_width=self.comp_width)

    @staticmethod
    def load(path: str) -> "MPCIndex":
        z = np.load(path)
        return MPCIndex(**{k: z[k] for k in z.files})


def build_mpc(g: AlignmentGraph) -> MPCIndex:
    n = g.n_nodes
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(g.out_ptr).astype(np.int64))
    dst = g.out_idx.astype(np.int64)
    res = native.mpc_build(n, src, dst, g.comp.astype(np.int64), g.ncomp)
    comp_width = np.zeros(g.ncomp, dtype=np.int64)
    for c, k in zip(res["path_comp"], res["path_k"]):
        comp_width[c] = max(comp_width[c], k + 1)
    return MPCIndex(path_offsets=res["path_offsets"],
                    path_nodes=res["path_nodes"],
                    path_comp=res["path_comp"], path_k=res["path_k"],
                    back_offsets=res["back_offsets"],
                    back_node=res["back_node"], back_k=res["back_k"],
                    nodepath_offsets=res["nodepath_offsets"],
                    nodepath_k=res["nodepath_k"], comp_width=comp_width)


def check_min_path_cover(g: AlignmentGraph, mpc: MPCIndex) -> bool:
    """Validity/minimality check, a port of the reference's antichain
    verifier (checkMinPathCover, src/AlignmentGraph.cpp:1393-1428): per
    component, advance a frontier index on each path past nodes reachable
    from other frontier nodes; the cover is minimum iff the final frontier
    is a |K|-antichain.  Exponential-free but O(K^2 · N · reach); intended
    for tests and small/medium graphs."""
    # reachability via per-source BFS (memoized per query source)
    def reachable(s: int, t: int) -> bool:
        if s == t:
            return True
        seen = {s}
        stack = [s]
        while stack:
            u = stack.pop()
            for w in g.out_neighbors(u):
                w = int(w)
                if w == t:
                    return True
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return False

    for c in range(g.ncomp):
        pc = mpc.paths_of_component(c)
        if not pc:
            if np.any(g.comp == c):
                return False
            continue
        # every component node covered
        covered = set()
        for p in pc:
            covered.update(int(x) for x in p)
        if covered != set(np.nonzero(g.comp == c)[0].tolist()):
            return False
        # paths are valid graph paths
        for p in pc:
            for a, b in zip(p[:-1], p[1:]):
                if int(b) not in set(int(x) for x in g.out_neighbors(int(a))):
                    return False
        ids = [0] * len(pc)
        while True:
            pushed = False
            for i in range(len(pc)):
                for j in range(len(pc)):
                    while (i != j and ids[i] < len(pc[i])
                           and reachable(int(pc[i][ids[i]]),
                                         int(pc[j][ids[j]]))):
                        ids[i] += 1
                        pushed = True
                if ids[i] >= len(pc[i]):
                    return False
            if not pushed:
                break
        for i in range(len(pc)):
            for j in range(len(pc)):
                if i != j and reachable(int(pc[i][ids[i]]),
                                        int(pc[j][ids[j]])):
                    return False
    return True

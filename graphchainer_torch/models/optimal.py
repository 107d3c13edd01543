"""Exact optimal alignment (--optimal-alignment).

Port of graphchainer_tpu/models/optimal.py on one torch device: the
guaranteed-minimal edit distance alignment of the whole read with free
start and end positions in the graph.  The reference expands (node, slice)
states in score order; here the banded DP runs with the band set to an
ENTIRE component and free-start injection at every slot (full_start):
with the whole component in band there is no out-of-band approximation,
so one topo pass per slice is the exact DP.  On a CUDA device that pass is
the hand kernel csrc/frag_wide.cu (ops/frag_align.align_fragments), on
the CPU its plain version.

Components up to max_component (4096) split nodes run on the kernel;
wider components take the exact host checkpointed DP (align/oracle.py
dag_dp_ckpt), so the mode is unbounded like the reference's.  Traceback
is always exact and on the host: the full oracle table when component x
read fits in 20M cells, else stripe-checkpointed recompute.  Reads are
processed one at a time; the components tried are those of the read's
minimizer seeds (every component on a graph of at most 16).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphchainer_torch.align import oracle as orc
from graphchainer_torch.align.anchors import (GraphTensors, backwalk,
                                              level_bucket, pack_row_planes,
                                              upload)
from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.index.minimizer import MinimizerIndex, get_seeds
from graphchainer_torch.models.chainer import ReadAlignment
from graphchainer_torch.ops import frag_align
from graphchainer_torch.utils import timers
from graphchainer_torch.utils.seq import match_masks

W = 32
# Kernel fast-path bound: the level-parallel kernel steps once per topo
# level, so a chain-shaped component costs depth x 32 columns
# sequentially.  Components wider than this are NOT rejected: they take
# the exact host checkpointed-DP path instead.
MAX_COMPONENT = 4096


@dataclass
class OptimalConfig:
    max_component: int = MAX_COMPONENT
    polish_band_words: int = 8


def _pow2(x: int, lo: int) -> int:
    out = lo
    while out < x:
        out *= 2
    return out


class OptimalAlignerModel:
    def __init__(self, g: AlignmentGraph, index: MinimizerIndex,
                 cfg: Optional[OptimalConfig] = None,
                 gx: Optional[GraphTensors] = None, device="cuda"):
        self.g = g
        self.index = index
        self.cfg = cfg or OptimalConfig()
        self.gx = gx or GraphTensors.build(g)
        self.device = torch.device(device)
        self._comp_cache = {}

    def _component_band(self, c: int):
        """(band_nodes [1,B] int32, band_in [1,B,max_in] int16, band_level
        [1,B] int32, n_real)."""
        if c in self._comp_cache:
            return self._comp_cache[c]
        g = self.g
        nodes = np.nonzero(g.comp == c)[0].astype(np.int64)
        n = len(nodes)
        assert n <= self.cfg.max_component
        B = _pow2(n, 64)
        slot_of = {int(v): i for i, v in enumerate(nodes)}
        max_in = 1
        in_lists = []
        for v in nodes:
            ins = [slot_of[int(u)] for u in g.in_neighbors(int(v))]
            in_lists.append(ins)
            max_in = max(max_in, len(ins))
        band_nodes = np.full((1, B), -1, dtype=np.int32)
        band_nodes[0, :n] = nodes
        band_in = np.full((1, B, max_in), -1, dtype=np.int16)
        band_level = np.full((1, B), -1, dtype=np.int32)
        lvls = np.zeros(n, dtype=np.int32)
        for i, ins in enumerate(in_lists):
            band_in[0, i, :len(ins)] = ins
            # node ids are topo ranks, so slot order is topo order
            lvls[i] = 1 + max((lvls[u] for u in ins), default=-1)
        band_level[0, :n] = lvls
        self._comp_cache[c] = (band_nodes, band_in, band_level, n)
        return self._comp_cache[c]

    def component_inputs(self, read: str, c: int):
        """align_fragments' arguments for one read against component c on
        the model's device: (args, keyword args)."""
        band_nodes, band_in, band_level, _ = self._component_band(c)
        rows = len(read)
        S = _pow2(-(-rows // W), 2)
        mm = np.zeros(S * W, dtype=np.uint8)
        mm[:rows] = match_masks(read)
        req = pack_row_planes(mm[None, :]).reshape(1, S, 4)
        dev_eq, dev_len = self.gx.device_tables(self.device)
        band = upload([band_nodes, band_in, np.zeros(1, dtype=np.int32),
                       np.ascontiguousarray(req).view(np.int32),
                       np.array([rows], dtype=np.int32), band_level],
                      dev_eq.device)
        kw = dict(n_slices=S, max_in=band_in.shape[2], full_start=True,
                  band_level=band[5],
                  n_levels=level_bucket(band_level, band_nodes.shape[1]))
        return (dev_eq, dev_len) + tuple(band[:5]), kw

    def _align_component(self, read: str, c: int):
        g = self.g
        nodes = np.nonzero(g.comp == c)[0]
        if len(nodes) > self.cfg.max_component:
            # component too wide for one kernel band: exact host
            # checkpointed DP (O(n*sqrt(R)) memory) — slow but unbounded,
            # like the reference's score-ordered Dijkstra expansion
            cg = orc.build_char_graph(g, nodes)
            inject = np.zeros(cg.n, dtype=np.int64)
            fin, _, _ = orc.dag_dp_ckpt(cg, read, inject)
            return int(fin.min()), None, 0
        band_nodes = self._component_band(c)[0]
        rows = len(read)
        with timers.stage("optimal_dp"):
            args, kw = self.component_inputs(read, c)
            res = frag_align.align_fragments(*args, **kw)
            score = int(res.best_score[0])
            slot = int(res.best_slot[0])
            end_col = int(res.best_col[0])
            best_in = res.best_in[0].cpu().numpy()
        walk = backwalk(best_in, band_nodes[0], slot, (rows - 1) // W)
        if walk is None:
            return score, None, 0
        path = [int(band_nodes[0][s]) for s in reversed(walk)]
        return score, path, end_col

    def align_batch(self, reads: Sequence[Tuple[str, str]]
                    ) -> List[ReadAlignment]:
        out = [ReadAlignment(name=n, seq=s,
                             positions=np.zeros((0, 2), np.int64),
                             ops=None, score=len(s), seq_end=len(s))
               for n, s in reads]
        for ri, (name, read) in enumerate(reads):
            seeds = get_seeds(self.index, read, -1)
            comps = []
            for s in seeds:
                v, _ = self.g.find_split(s.di_node, s.node_offset)
                c = int(self.g.comp[v])
                if c not in comps:
                    comps.append(c)
            if self.g.ncomp <= 16:
                # small graphs: guarantee optimality by trying everything
                comps += [c for c in range(self.g.ncomp) if c not in comps]
            elif not comps:
                comps = list(range(min(self.g.ncomp, 4)))
            best = None
            for c in comps[:16]:
                score, path, end_col = self._align_component(read, c)
                if best is None or score < best[0]:
                    best = (score, c, path, end_col)
            if best is None:
                continue
            score, comp, path, end_col = best
            out[ri].score = score
            # exact traceback always: the full oracle table when it fits,
            # else the checkpointed stripe-recompute traceback
            # (align/oracle.py dag_dp_ckpt / backtrace_ckpt, O(n*sqrt(R))
            # memory, 2x forward work)
            with timers.stage("optimal_traceback"):
                nodes = np.nonzero(self.g.comp == comp)[0]
                n_chars = int(self.g.node_len[nodes].sum())
                cg = orc.build_char_graph(self.g, nodes)
                inject = np.zeros(cg.n, dtype=np.int64)
                if n_chars * (len(read) + 1) <= 20_000_000:
                    D = orc.dag_dp(cg, read, inject)
                    end = int(np.argmin(D[:, len(read)]))
                    positions, ops = orc.backtrace(cg, D, read, inject, end)
                else:
                    fin, ckpts, stripe = orc.dag_dp_ckpt(cg, read, inject)
                    end = int(np.argmin(fin))
                    positions, ops = orc.backtrace_ckpt(cg, read, inject,
                                                        ckpts, stripe, end)
            out[ri].positions = positions
            out[ri].ops = ops
        return out

"""The co-linear chaining alignment model: the CLC main path.

Port of graphchainer_tpu/models/chainer.py (CLC mode).  Per batch of
reads:

  1. seed+window    minimizer seeds and fragment windows (native C++);
                    file seeds or a seeder's (MEM / MUM, index/mem.py)
                    take the numpy window path
  2. band_build     fragment bands and read planes (native C++ + numpy)
  3. frag_kernel    the fragment DP on the device (CUDA kernel frag_core)
  4. join           backwalk + forward/backward join into anchors (native)
  5. chain_scan     the chaining event sweep on the device (torch)
  6. stitch         best chain -> contiguous node path (native)
  7. polish         banded NW of read vs path on the device (CUDA kernel
                    polish_core, torch score and backtrace)
  8. repair         corridor re-polish of the bubble-arm choices (native)
  9. escalate       reads still above escalate_threshold re-run once with
                    a wider band and in-degree cap
 10. rescue         reads that failed or are still above rescue_threshold
                    (every read with compare_with_baseline, or with
                    auto_compare_dense on a dense graph) are aligned again
                    by the whole-read GA baseline (models/aligner.py), and
                    the better alignment is kept

Stages 3 and 7 run on the model's devices: one device, or a list of
them, each taking a row block of the stage's rows (parallel/device.py);
stage 5 runs its whole batch on the first of them (its cost is per
event, not per read: ops/chain_scan.py); with shard_graph_tables the fragment DP runs each fragment on the device
that holds its component's table block (parallel/sharded_graph.py).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from graphchainer_torch import constants, native
from graphchainer_torch.align import polish
from graphchainer_torch.align.anchors import (GraphTensors,
                                              assemble_batch_cols,
                                              run_fragments)
from graphchainer_torch.align.chaining import batch_arrays_cols
from graphchainer_torch.ops import frag_align
from graphchainer_torch.ops.chain_scan import chain_scan
from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.graph.mpc import MPCIndex
from graphchainer_torch.index.minimizer import MinimizerIndex
from graphchainer_torch.parallel.device import local_devices
from graphchainer_torch.parallel.sharded_graph import (build_sharded_tables,
                                                       plan_component_shards)
from graphchainer_torch.utils import timers
from graphchainer_torch.utils.seq import match_masks


@dataclass
class ChainerConfig:
    """graphchainer_tpu's ChainerConfig, with its defaults."""
    colinear_split_len: int = constants.DEFAULT_COLINEAR_SPLIT_LEN
    colinear_split_gap: int = constants.DEFAULT_COLINEAR_SPLIT_GAP
    colinear_gap: int = constants.DEFAULT_COLINEAR_GAP
    band_slots: int = 32               # B: band node slots per fragment
    max_in: int = constants.MAX_IN_DEGREE
    band_slack: int = 8
    seed_density: float = constants.DEFAULT_SEED_MINIMIZER_DENSITY
    max_anchor_error: float = 0.5      # drop anchors with score > err*len
    seeds_per_fragment: int = 2        # try the k rarest seeds per window
    polish_band_words: int = 8         # 256-row polish band
    # run the whole-read GA baseline on every read too and keep the
    # better alignment (reference src/Aligner.cpp:901-920)
    compare_with_baseline: bool = False
    # selective rescue: reads that failed, or whose edit distance exceeds
    # this fraction of their length, are aligned by the GA baseline too
    rescue_threshold: float = 0.35
    fast_mode: bool = False            # skip the polish (mismatch count)
    escalate_band: int = 96            # wider band of the escalation retry
    escalate_max_in: int = 12
    # norm-ED trigger of the escalation retry; None = rescue_threshold
    escalate_threshold: Optional[float] = None
    # on a dense graph (more than 2% of nodes above max_in) every read
    # gets the baseline comparison instead of the threshold rescue
    auto_compare_dense: bool = True
    bubble_repair: bool = True         # native corridor re-polish
    corridor_band: int = 16
    corridor_passes: int = 1
    # split the node tables by connected component over the model's
    # devices, each fragment run where its component's block lives
    # (parallel/sharded_graph.py); ignored on a single device
    shard_graph_tables: bool = False


@dataclass
class ReadAlignment:
    name: str
    seq: str
    positions: np.ndarray              # (N,2) per path char (node, offset)
    ops: Optional[np.ndarray]          # edit ops (linear_align OP_* codes)
    score: int                         # edit distance read vs path
    seq_start: int = 0
    seq_end: int = 0
    n_anchors: int = 0
    n_chained: int = 0
    n_seeds: int = 0
    error: Optional[str] = None        # per-read fault isolation marker
    is_secondary: bool = False
    secondary: List["ReadAlignment"] = field(default_factory=list)

    @property
    def failed(self) -> bool:
        return len(self.positions) == 0


class ChainerModel:
    """CLC aligner over one graph on torch devices ("cuda" runs the
    hand-written kernels on the current card, "cuda:k" on that one, "cpu"
    their plain torch versions; a list of devices, which may repeat one,
    splits the fragment DP and the polish into a row block a device)."""

    def __init__(self, g: AlignmentGraph, mpc: MPCIndex,
                 index: MinimizerIndex, cfg: Optional[ChainerConfig] = None,
                 file_seeds: Optional[dict] = None, seed_fn=None,
                 gx: Optional[GraphTensors] = None, device="cuda"):
        self.g = g
        self.mpc = mpc
        self.index = index
        self.cfg = cfg or ChainerConfig()
        self.gx = gx or GraphTensors.build(g)
        self.devices = local_devices(device)
        self.device = self.devices[0]
        if (self.cfg.shard_graph_tables and len(self.devices) > 1
                and (self.gx.shards is None
                     or self.gx.shards[0] != self.devices)):
            plan = plan_component_shards(g, len(self.devices))
            self.gx.shards = (self.devices, plan, build_sharded_tables(
                self.gx, plan, self.devices))
        self._lock = threading.Lock()
        # one batch at a time runs a device stage: those stages are chains
        # of small torch ops, each of which drops and retakes the
        # interpreter lock, and threads interleaving them stall each other
        # (PERF.md); host stages of other batches run meanwhile
        self._device_lock = threading.Lock()
        self._escalated = None
        self._baseline = None
        indeg = np.diff(g.in_ptr)
        self._dense_graph = bool(np.mean(indeg > self.cfg.max_in) > 0.02)
        # external seeds: read name -> [SeedHit] (reference .gam seed
        # files, src/Aligner.cpp:1169-1190)
        self.file_seeds = file_seeds
        # a seeder in place of the minimizers: (name, seq) -> [SeedHit]
        # (the MEM / MUM seeder, index/mem.py)
        self.seed_fn = seed_fn

    def escalated(self) -> "ChainerModel":
        """Wide-band sibling model for the escalation retry (shares the
        graph tensors, index and MPC; cannot escalate again)."""
        with self._lock:
            if self._escalated is None:
                wide = replace(self.cfg,
                               band_slots=self.cfg.escalate_band,
                               max_in=self.cfg.escalate_max_in,
                               band_slack=self.cfg.band_slack * 2,
                               escalate_band=0, rescue_threshold=0.0,
                               compare_with_baseline=False,
                               auto_compare_dense=False)
                self._escalated = ChainerModel(
                    self.g, self.mpc, self.index, wide,
                    file_seeds=self.file_seeds, seed_fn=self.seed_fn,
                    gx=self.gx, device=self.devices)
                self._escalated._device_lock = self._device_lock
            return self._escalated

    def baseline(self):
        """The whole-read GA model of the rescue (shares the graph
        tensors, the index and the device lock)."""
        with self._lock:
            if self._baseline is None:
                from graphchainer_torch.models.aligner import (
                    AlignerConfig, GraphAlignerModel)
                self._baseline = GraphAlignerModel(
                    self.g, self.index,
                    AlignerConfig(
                        seed_density=self.cfg.seed_density,
                        polish_band_words=self.cfg.polish_band_words),
                    gx=self.gx, device=self.devices,
                    device_lock=self._device_lock)
            return self._baseline

    def _fragment_jobs_cols(self, reads: Sequence[Tuple[str, str]]):
        """Seeds + fragment windows -> the columnar job batch: (JobCols,
        frags [nfrag, 7] int64 rows of (read_idx, l, r, fi_fwd, fi_bwd,
        seed split, seed off), seed_counts).  Minimizer seeds run the
        native seed_window_batch; file seeds and a seed_fn run the numpy
        window path (graphchainer_tpu/models/chainer.py:222-354)."""
        cfg = self.cfg
        if self.file_seeds is None and self.seed_fn is None:
            return native.seed_window_batch(
                self.index, self.gx, reads, cfg.seed_density,
                cfg.colinear_split_len, cfg.colinear_split_gap,
                cfg.seeds_per_fragment)
        return self._seed_windows(reads)

    def _seed_windows(self, reads: Sequence[Tuple[str, str]]):
        """The window path over the given seeds, for all reads at once:
        each seed goes to every window of colinear_split_len rows (every
        colinear_split_gap) that it anchors, near-duplicates (same read,
        window, node and 8-base offset bucket) collapse to the best, and
        the seeds_per_fragment best of each window become a forward job
        and, where the seed lies past the window's start, a backward
        one."""
        cfg = self.cfg
        seed_counts = [0] * len(reads)
        flen, sep = cfg.colinear_split_len, cfg.colinear_split_gap
        kper = cfg.seeds_per_fragment
        parts = []
        for ri, (name, seq) in enumerate(reads):
            fs = (self.seed_fn(name, seq) if self.seed_fn is not None
                  else self.file_seeds.get(name, []))
            if not fs:
                continue
            seed_counts[ri] = len(fs)
            if len(seq) < 5:
                continue
            parts.append((np.full(len(fs), ri, dtype=np.int64),
                          np.array([s.di_node for s in fs], dtype=np.int64),
                          np.array([s.node_offset for s in fs],
                                   dtype=np.int64),
                          np.array([s.seq_pos for s in fs], dtype=np.int64),
                          np.array([s.goodness for s in fs]),
                          np.array([s.match_len for s in fs],
                                   dtype=np.int64)))
        z = np.zeros(0, np.int64)
        empty = (native.JobCols(seed=z, trim=z, rev=np.zeros(0, bool),
                                read_idx=z, lo=z, hi=z),
                 np.zeros((0, 7), dtype=np.int64), seed_counts)
        if not parts:
            return empty
        rid, di, off, sp, good, mlen = (np.concatenate(a)
                                        for a in zip(*parts))
        rlen = np.array([len(s) for _, s in reads], dtype=np.int64)
        rl = rlen[rid]
        # long seeds (MEMs can exceed the fragment length) anchor a window
        # by their start; their effective length is clamped so that they
        # are not dropped for spanning window boundaries
        mlen_eff = np.minimum(mlen, max(flen // 2, 1))
        short = rl < flen
        nwin = np.where(short, 1, (rl - flen) // sep + 1)
        wmin = np.where(short, 0,
                        np.maximum(-(-(sp + mlen_eff - flen) // sep), 0))
        wmax = np.where(short, np.where(sp + mlen_eff <= rl, 0, -1),
                        np.minimum(sp // sep, nwin - 1))
        reps = np.where(wmax >= wmin, wmax - wmin + 1, 0)
        total = int(reps.sum())
        if total == 0:
            return empty
        sidx = np.repeat(np.arange(len(rid)), reps)
        widx = (np.arange(total) - np.repeat(np.cumsum(reps) - reps, reps)
                + np.repeat(wmin, reps))
        # near-duplicate collapse: lexsort on the raw columns (a packed
        # key overflows on chromosome-scale node offsets)
        obkt = off[sidx] >> 3
        dnode = di[sidx]
        srid = rid[sidx]
        o = np.lexsort((-good[sidx], obkt, dnode, widx, srid))
        first = np.ones(total, dtype=bool)
        first[1:] = ((srid[o][1:] != srid[o][:-1])
                     | (widx[o][1:] != widx[o][:-1])
                     | (dnode[o][1:] != dnode[o][:-1])
                     | (obkt[o][1:] != obkt[o][:-1]))
        o = o[first]
        # the kper best of each (read, window) by goodness
        o2 = o[np.lexsort((-good[sidx[o]], widx[o], srid[o]))]
        w_sorted, r_sorted = widx[o2], srid[o2]
        grp_first = np.ones(len(o2), dtype=bool)
        grp_first[1:] = ((w_sorted[1:] != w_sorted[:-1])
                         | (r_sorted[1:] != r_sorted[:-1]))
        grp_id = np.cumsum(grp_first) - 1
        rank = np.arange(len(o2)) - np.nonzero(grp_first)[0][grp_id]
        o2 = o2[rank < kper]
        v_all, voff_all = self.gx.find_splits(di[sidx[o2]], off[sidx[o2]])
        v_all = v_all.astype(np.int64)
        voff_all = voff_all.astype(np.int64)
        frid = srid[o2]
        short_q = short[sidx[o2]]
        fl = np.where(short_q, 0, widx[o2] * sep)
        fr_ = np.where(short_q, rl[sidx[o2]], fl + flen)
        spq = sp[sidx[o2]]
        has_bwd = spq > fl
        job_start = np.zeros(len(o2), dtype=np.int64)
        np.cumsum(1 + has_bwd[:-1], out=job_start[1:])
        fi_fwd = job_start
        fi_bwd = np.where(has_bwd, job_start + 1, -1)
        F = int(job_start[-1]) + 1 + int(has_bwd[-1]) if len(o2) else 0
        seed = np.empty(F, dtype=np.int64)
        trim = np.empty(F, dtype=np.int64)
        rev = np.zeros(F, dtype=bool)
        read_idx = np.empty(F, dtype=np.int64)
        lo = np.empty(F, dtype=np.int64)
        hi = np.empty(F, dtype=np.int64)
        seed[fi_fwd] = v_all
        trim[fi_fwd] = self.g.node_len[v_all].astype(np.int64) - voff_all
        read_idx[fi_fwd] = frid
        lo[fi_fwd] = spq
        hi[fi_fwd] = fr_
        bsel = np.nonzero(has_bwd)[0]
        bpos = fi_bwd[bsel]
        seed[bpos] = v_all[bsel]
        trim[bpos] = voff_all[bsel]
        rev[bpos] = True
        read_idx[bpos] = frid[bsel]
        lo[bpos] = fl[bsel]
        hi[bpos] = spq[bsel]
        frags = np.stack([frid, fl, fr_, fi_fwd, fi_bwd, v_all, voff_all],
                         axis=1)
        return (native.JobCols(seed=seed, trim=trim, rev=rev,
                               read_idx=read_idx, lo=lo, hi=hi),
                frags, seed_counts)

    def align_batch(self, reads: Sequence[Tuple[str, str]]
                    ) -> List[ReadAlignment]:
        cfg = self.cfg
        out = [ReadAlignment(name=n, seq=s, positions=[], ops=None,
                             score=len(s), seq_end=len(s))
               for n, s in reads]
        with timers.stage("seed+window", len(reads)):
            jobs, frags, seed_counts = self._fragment_jobs_cols(reads)
        for ri, n in enumerate(seed_counts):
            out[ri].n_seeds = n
        if not len(jobs):
            return out

        with timers.stage("band_build", len(jobs)):
            read_mm_cat = match_masks("".join(s for _, s in reads))
            read_base = np.zeros(len(reads) + 1, dtype=np.int64)
            np.cumsum([len(s) for _, s in reads], out=read_base[1:])
            (band_nodes, band_nodes_cat, band_in, seed_shift, req, rows, S,
             band_level) = assemble_batch_cols(self.gx, jobs, read_mm_cat,
                                               read_base, B=cfg.band_slots,
                                               max_in=cfg.max_in,
                                               slack=cfg.band_slack)
        # one per-batch read-code table on the device, shared by the
        # polish passes (None when a read has IUPAC bases)
        dev_tbl = polish.build_read_table([s for _, s in reads], self.device)
        with self._device_lock, timers.stage("frag_kernel", len(jobs)):
            res = run_fragments(self.gx, band_nodes_cat, band_in,
                                seed_shift, req, rows, S, cfg.max_in,
                                band_level, self.devices)
        # DP cells = band slots x read rows per fragment
        timers.count("cells(frag)", int(rows.astype(np.int64).sum())
                     * band_nodes_cat.shape[1])

        # native backwalk + forward/backward join, one pass over all pairs
        fr = np.asarray(frags, dtype=np.int64).reshape(-1, 7)
        with timers.stage("join", len(fr)):
            end_slice = (rows.astype(np.int64) - 1) // 32
            (ok, score, fnode, foff, lnode, loff, poff, pdata) = \
                native.join_anchors(
                    res.best_in, res.best_slot, res.best_score,
                    res.best_col, end_slice, band_nodes, self.g.node_len,
                    fr[:, 3], fr[:, 4], fr[:, 5], fr[:, 6], frag_align.BIG)
        keep = np.nonzero(
            (ok == 1)
            & (score <= cfg.max_anchor_error * (fr[:, 2] - fr[:, 1])))[0]
        # anchors stay columnar; frags come in read order, so `keep` is
        # grouped by read
        counts = np.bincount(fr[keep, 0], minlength=len(reads))
        live = np.nonzero(counts)[0]
        if len(live) == 0:
            return out
        for ri in range(len(reads)):
            out[ri].n_anchors = int(counts[ri])
        a_x = fr[keep, 1]
        a_y = fr[keep, 2] - 1

        with self._device_lock, timers.stage("chain_scan", len(live)):
            arrs = batch_arrays_cols(
                self.g, self.mpc, counts[live], pdata[poff[keep]],
                pdata[poff[keep + 1] - 1], a_x, a_y)
            sres = chain_scan(**arrs, device=self.device)
            c_val, c_pred = sres.c_val, sres.c_pred

        polish_reads, polish_paths, polish_refs = [], [], []
        with timers.stage("stitch", len(live)):
            # rebase the kept anchors' ragged paths into one flat array
            plens = poff[keep + 1] - poff[keep]
            p_off = np.zeros(len(keep) + 1, dtype=np.int64)
            np.cumsum(plens, out=p_off[1:])
            pidx = (np.arange(int(p_off[-1]), dtype=np.int64)
                    - np.repeat(p_off[:-1], plens)
                    + np.repeat(poff[keep], plens))
            anch_off = np.zeros(len(live) + 1, dtype=np.int64)
            np.cumsum(counts[live], out=anch_off[1:])
            # one native pass: best_chain + stitch + extend_tails per read
            (positions_l, n_chained, first_x, last_y, okst) = \
                native.stitch_batch(
                    self.gx, anch_off, a_x, a_y, fnode[keep], foff[keep],
                    lnode[keep], loff[keep], p_off, pdata[pidx],
                    c_val, c_pred, [reads[ri][1] for ri in live],
                    cfg.colinear_gap)
            for bi, ri in enumerate(live):
                try:
                    out[ri].n_chained = int(n_chained[bi])
                    if not okst[bi]:
                        continue
                    read = reads[ri][1]
                    positions = positions_l[bi]
                    out[ri].positions = positions
                    pathseq = self.gx.positions_seq(positions)
                except Exception as e:          # noqa: BLE001
                    out[ri].positions = np.zeros((0, 2), dtype=np.int64)
                    out[ri].error = f"{type(e).__name__}: {e}"
                    continue
                if cfg.fast_mode:
                    # positional mismatch count (no CIGAR)
                    x = int(first_x[bi]) - max(int(first_x[bi]), 0)
                    n = min(len(pathseq), len(read) - x)
                    a = np.frombuffer(pathseq[:n].encode(), np.uint8)
                    b = np.frombuffer(read[x:x + n].encode(), np.uint8)
                    out[ri].score = int((a != b).sum()) + abs(len(read) - n)
                    continue
                polish_reads.append(read)
                polish_paths.append(pathseq)
                polish_refs.append(ri)

        if polish_reads:
            with self._device_lock, timers.stage("polish", len(polish_reads)):
                outcomes = polish.polish_batch(
                    polish_reads, polish_paths, bw=cfg.polish_band_words,
                    table=(None if dev_tbl is None else
                           (dev_tbl, np.asarray(polish_refs, np.int64))),
                    device=self.devices)
            for ri, oc in zip(polish_refs, outcomes):
                out[ri].score = oc.score
                out[ri].ops = oc.ops
            if cfg.bubble_repair:
                self._repair(out, reads, polish_refs)

        esc_thr = (cfg.escalate_threshold
                   if cfg.escalate_threshold is not None
                   else cfg.rescue_threshold)
        if cfg.escalate_band > cfg.band_slots and esc_thr > 0:
            # band escalation: re-run still-bad reads through the fragment
            # path with a wider band and in-degree cap
            esc = [ri for ri in range(len(reads))
                   if out[ri].failed
                   or out[ri].score > esc_thr * max(len(reads[ri][1]), 1)]
            if esc:
                with timers.stage("escalate", len(esc)):
                    ealn = self.escalated().align_batch(
                        [reads[ri] for ri in esc])
                timers.count("escalated_reads", len(esc))
                for bi, ri in enumerate(esc):
                    if not ealn[bi].failed and (
                            out[ri].failed
                            or ealn[bi].score < out[ri].score):
                        ealn[bi].n_seeds = max(ealn[bi].n_seeds,
                                               out[ri].n_seeds)
                        out[ri] = ealn[bi]

        if cfg.compare_with_baseline or (cfg.auto_compare_dense
                                         and self._dense_graph):
            retry = list(range(len(reads)))
        elif cfg.rescue_threshold > 0:
            retry = [ri for ri in range(len(reads))
                     if out[ri].failed
                     or out[ri].score > cfg.rescue_threshold
                     * max(len(reads[ri][1]), 1)]
        else:
            retry = []
        if retry:
            # keep the better of CLC / whole-read baseline per read
            # (reference src/Aligner.cpp:901-920: CLC wins only when the
            # baseline is absent or strictly worse by edit distance)
            with timers.stage("rescue", len(retry)):
                ga = self.baseline().align_batch(
                    [reads[ri] for ri in retry])
            timers.count("rescued_reads", len(retry))
            for bi, ri in enumerate(retry):
                clc_better = ga[bi].failed or (not out[ri].failed
                                               and ga[bi].score
                                               > out[ri].score)
                if not clc_better:
                    # keep the CLC stage counters: the stats report counts
                    # seeds/anchors found, not which candidate won
                    ga[bi].n_seeds = max(ga[bi].n_seeds, out[ri].n_seeds)
                    ga[bi].n_anchors = out[ri].n_anchors
                    ga[bi].n_chained = out[ri].n_chained
                    out[ri] = ga[bi]
        return out

    def _repair(self, out, reads, refs):
        """Corridor re-polish (native corridor_polish_batch): exact banded
        DP with per-cell backtrace over the path plus its 1-hop arms."""
        cfg = self.cfg
        cand = [ri for ri in refs
                if out[ri].score > 0 and out[ri].ops is not None]
        for _ in range(max(cfg.corridor_passes, 0)):
            if not cand:
                break
            with timers.stage("repair", len(cand)):
                fixed_l = native.corridor_polish_batch(
                    self.gx, [out[ri].positions for ri in cand],
                    [out[ri].ops for ri in cand],
                    [reads[ri][1] for ri in cand],
                    [out[ri].score for ri in cand],
                    band=cfg.corridor_band)
            improved = []
            for ri, fixed in zip(cand, fixed_l):
                if fixed is None:
                    continue
                sc, pos, ops = fixed
                out[ri].score = sc
                out[ri].positions = pos
                out[ri].ops = ops
                if sc > 0:
                    improved.append(ri)
            # another pass only helps where the path changed
            cand = improved

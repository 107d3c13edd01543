"""Whole-read seed-and-extend alignment (GraphAligner-style baseline).

Re-design of the reference's GraphAligner facade + banded extension
(src/GraphAligner.h AlignOneWay, getTwoDirectionalTrace,
src/GraphAlignerBitvectorBanded.h): a seed hit is extended bidirectionally
across the whole read.  The reference re-discovers the band every 64-row
slice with a priority flood fill; here the extension advances in WINDOWS
of up to 64 rows with FULL-BAND CARRY: each window runs the banded
fragment kernel, then the next window's band is re-grown by a
multi-source bounded BFS from every still-plausible slot of the current
band, and the per-slot boundary state (col0 bottom scores + horizontal
delta bits) carries over exactly (frag_align carry_in) — the TPU
analogue of the reference's slice-queue seeding from every previous-band
node (src/GraphAlignerBitvectorBanded.h:253-406).  On an unchanged band
the windowed DP is bit-identical to a single whole-read kernel call.
The alignment path is recovered at the end by walking the per-window
backtrace pointers across window boundaries.

Windows are batched across all active (read, direction) extension states,
so each loop iteration is ONE device call regardless of batch size.

Extension stops at the read ends or when a window's score delta exceeds
`window_error_cutoff * window_rows` (a simplified X-drop; the reference
uses an X-score cutoff / correctness HMM, src/GraphAlignerBitvectorBanded.h
:703-847).  If the final alignment covers too little of the read, the next
best seed is tried (reference seed-cluster retry, src/GraphAligner.h:121-173).

Port of graphchainer_tpu/models/aligner.py (GA mode, and the baseline of
the CLC rescue) on torch devices: the windows run the carried entry of
the CUDA fragment kernel (ops/frag_kernel, through anchors.run_fragments)
and the candidates the CUDA polish kernels, each device stage under a
lock the model shares with its ChainerModel.  --seedless-DP
(seedless_dp=True) takes its seeds from the full-start scan of
align/seedless.py (the wide kernel csrc/frag_wide.cu on a CUDA device).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from graphchainer_torch import constants, native
from graphchainer_torch.align import polish
from graphchainer_torch.align.correctness import CorrectnessState
from graphchainer_torch.align.anchors import (CarryJob, FragJob,
                                              GraphTensors,
                                              assemble_batch,
                                              assemble_carry_batch,
                                              run_fragments)
from graphchainer_torch.align.evalue import EValueCalculator
from graphchainer_torch.align.selection import (SelectionMethod,
                                                SelectionOptions,
                                                select_alignments)
from graphchainer_torch.align.stitch import path_to_positions
from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.index.minimizer import (MinimizerIndex,
                                                cluster_seeds, get_seeds)
from graphchainer_torch.models.chainer import ReadAlignment
from graphchainer_torch.ops import frag_align
from graphchainer_torch.ops.linear_align import (OP_DEL as OP_DEL_,
                                                 OP_INS as OP_INS_,
                                                 OP_MATCH as OP_MATCH_,
                                                 OP_MISMATCH as OP_MM_)
from graphchainer_torch.parallel.device import local_devices
from graphchainer_torch.utils import timers
from graphchainer_torch.utils.seq import match_masks

W = 32
WINDOW_ROWS = 64           # rows per extension window (2 slices)
DEFAULT_END_DROP = 50      # clip the extension end back to the X-score
                           # peak only when the tail loses more than this
                           # (an implicit X-drop; explicit --X-drop
                           # overrides)


@dataclass
class AlignerConfig:
    band_slots: int = 48
    max_alignments: int = 4            # emit up to N selected alignments
                                       # per read (multimapping)
    bubble_repair: bool = True         # polish-guided wrong-arm repair
                                       # (align/repair.py)
    max_in: int = constants.MAX_IN_DEGREE
    band_slack: int = 16
    seed_density: float = constants.DEFAULT_SEED_MINIMIZER_DENSITY
    window_error_cutoff: float = 0.55   # stop when a window is this bad
    min_coverage_frac: float = 0.3      # retry next seed below this
    max_seed_tries: int = 5
    polish_band_words: int = 8
    # reference --X-drop (src/AlignerMain.cpp:68,314-319): end the
    # extension when the running X-score (match +1 / edit -4, the vg
    # convention) drops more than this below its maximum.  None = off.
    x_drop: Optional[int] = None
    # reference --precise-clipping (src/AlignerMain.cpp:69,300-303):
    # identity cutoff between correct and wrong alignment; maps onto the
    # per-window error cutoff as (1 - identity).  None = keep default.
    precise_clipping: Optional[float] = None
    # reference --ramp-bandwidth/-B (src/AlignerMain.cpp:95): windows
    # that fail the error/HMM cutoff retry once with this band before
    # being clipped.  0 = off; must exceed band_slots otherwise.
    ramp_band_slots: int = 0
    # reference selection flags (src/AlignerMain.cpp:63,101-106): method
    # for picking the emitted non-overlapping alignment subset, and the
    # --E-cutoff filter (-1 = off)
    selection_method: str = "GreedyLength"
    e_cutoff: float = -1.0
    evalue_legacy_score: bool = False    # --evalue-legacy-score
    # reference seed-control flags (src/AlignerMain.cpp:64-65,79-80):
    # try every seed / extend up to density*len(read) seeds / discard
    # small diagonal clusters
    try_all_seeds: bool = False
    seed_extend_density: float = -1.0
    min_cluster_size: int = 0
    # reference --global-alignment (src/AlignerMain.cpp:66): never clip
    # on score cutoffs; extend to the read ends regardless
    global_alignment: bool = False
    # full-band carry: slots whose carried boundary score is within this
    # margin of the best re-seed the next window's band (the reference
    # keeps band nodes within minScore+bandwidth per slice,
    # src/GraphAlignerBitvectorBanded.h:286)
    carry_margin: int = 32
    # reference --seedless-DP (src/AlignerMain.cpp:77, GraphAligner.h:53):
    # ignore the seeder and discover alignment starts with a free-start
    # (fullstart) DP scan over the whole graph (align/seedless.py);
    # --DP-restart-stride re-scans at later read offsets to recover
    # coverage after clips (GraphAligner.h:60-80)
    seedless_dp: bool = False
    dp_restart_stride: int = 0

    def __post_init__(self):
        if self.precise_clipping is not None:
            if not 0.0 < self.precise_clipping < 1.0:
                raise ValueError("precise-clipping must be in (0, 1)")
            self.window_error_cutoff = 1.0 - self.precise_clipping
        if self.x_drop is not None and self.x_drop <= 1:
            raise ValueError("X-drop score cutoff must be > 1")
        if self.ramp_band_slots and self.ramp_band_slots <= self.band_slots:
            raise ValueError(
                "ramp bandwidth must be higher than default bandwidth")


@dataclass
class _WindowRec:
    """Per-window backtrace record for the deferred multi-window walk."""
    band_nodes: np.ndarray        # (B,) int64 node ids (-1 pad)
    best_in: np.ndarray           # (B, S) int8 kernel backtrace pointers
    slot_map: Optional[np.ndarray]  # (B,) int32 -> previous window's slot
                                    # (-1 = fresh; None for window 0)
    shifts: np.ndarray            # (B,) int32 per-slot seed trims
    rows: int                     # read rows consumed by this window
    end_slot: int = -1            # this window's best end point
    end_col: int = -1
    row_end: int = 0              # cumulative rows through this window
    xscore: float = 0.0           # running X-score after this window
    # cell-precise best X cell inside this window (reference per-cell
    # X endpoints, src/GraphAlignerBitvectorCommon.h:321-383):
    # (global X value, slot, window-local row); None when not tracked
    xcell: Optional[tuple] = None


@dataclass
class _ExtState:
    """One direction of one read's extension (full-band carry)."""
    read_idx: int
    reverse: bool           # True = extending toward the read start
    mm: np.ndarray          # direction-oriented remaining rows
    row: int                # rows consumed so far in this direction
    seed_node: int          # seed split node (window-0 band source)
    seed_trim: int          # trimmed length of the seed slot
    active: bool = True
    best: int = 0           # best end-row score of the last committed win
    band_nodes: Optional[np.ndarray] = None   # (B,) current band
    band_shifts: Optional[np.ndarray] = None  # (B,) per-slot trims
    carry_ssb: Optional[np.ndarray] = None    # (B,) boundary state
    carry_hp: Optional[np.ndarray] = None
    carry_hn: Optional[np.ndarray] = None
    windows: List[_WindowRec] = field(default_factory=list)
    end_slot: int = -1      # best end point over committed windows
    end_col: int = -1
    xscore: float = 0.0     # running X-score (match +1 / edit -4)
    xscore_max: float = 0.0
    # the window that failed the error/HMM/X-drop cutoff (never
    # committed to `windows`): its backtrace + X cells still feed the
    # endpoint choice, so clipping can land mid-window like the
    # reference's per-cell X endpoints
    tail: Optional[_WindowRec] = None
    # correctness HMM over per-window error fractions (reference
    # AlignmentCorrectnessEstimation drives band break decisions,
    # src/GraphAlignerBitvectorBanded.h:572-644)
    hmm: CorrectnessState = field(default_factory=CorrectnessState)


_XDELTA = np.array([+1, -5, -4, -4], dtype=np.int64)  # M, DEL, INS, MM


def _xdrop_trim(positions, ops: np.ndarray, span):
    """Cell-precise X-drop endpoint trim on the polished alignment: walk
    the CIGAR's running X-score (match +1, mismatch/ins -4, del -5) and
    clip each end back to its X peak (the final precision pass of the
    reference's per-cell X endpoints,
    src/GraphAlignerBitvectorCommon.h:321-383: our kernel clips at node
    granularity, this trims the <=32bp remainder).
    Returns (positions, ops, score, span)."""
    reads = np.isin(ops, (OP_MATCH_, OP_MM_, OP_INS_))
    paths = np.isin(ops, (OP_MATCH_, OP_MM_, OP_DEL_))
    lo, hi = 0, len(ops)
    # with X-drop enabled the reference always traces from the max-X
    # cell (getReverseTraceFromTableExactEndPos): clip each end to its
    # X peak unconditionally
    xs = np.cumsum(_XDELTA[ops])
    if len(xs):
        hi = int(len(xs) - 1 - np.argmax(xs[::-1])) + 1   # last argmax
    rx = np.cumsum(_XDELTA[ops[:hi]][::-1])
    if len(rx):
        lo = hi - (int(len(rx) - 1 - np.argmax(rx[::-1])) + 1)
    if lo == 0 and hi == len(ops):
        return positions, ops, int(np.sum(ops != OP_MATCH_)), span
    cut_r_front = int(reads[:lo].sum())
    cut_p_front = int(paths[:lo].sum())
    cut_r_back = int(reads[hi:].sum())
    cut_p_back = int(paths[hi:].sum())
    ops = ops[lo:hi]
    positions = positions[cut_p_front:len(positions) - cut_p_back]
    span = (span[0] + cut_r_front, span[1] - cut_r_back)
    return positions, ops, int(np.sum(ops != OP_MATCH_)), span


class GraphAlignerModel:
    """GA-mode aligner over one graph on torch devices ("cuda" runs the
    hand-written kernels on the current card, "cuda:k" on that one, "cpu"
    their plain torch versions; on a list of devices the windows and the
    polish take a row block each, the seedless scan the first)."""

    def __init__(self, g: AlignmentGraph, index: MinimizerIndex,
                 cfg: Optional[AlignerConfig] = None,
                 gx: Optional[GraphTensors] = None, device="cuda",
                 device_lock: Optional[threading.Lock] = None):
        self.g = g
        self.index = index
        self.cfg = cfg or AlignerConfig()
        self.gx = gx or GraphTensors.build(g)
        self.devices = local_devices(device)
        self.device = self.devices[0]
        # one batch at a time runs a device stage (see ChainerModel); a
        # ChainerModel hands its own lock to its rescue baseline
        self._device_lock = device_lock or threading.Lock()
        # single-strand graph bp, the E-value database size
        self._db_size = int(np.sum(g.node_len)) // 2
        self._fullstart = None   # lazy seedless-DP scanner

    def _seedless_seeds(self, seq: str):
        """Synthetic seeds from the fullstart scan (--seedless-DP)."""
        from graphchainer_torch.align.seedless import FullstartScanner
        if self._fullstart is None:
            self._fullstart = FullstartScanner(self.g, self.gx,
                                               device=self.device)
        stride = self.cfg.dp_restart_stride
        offsets = ((0,) if stride <= 0
                   else tuple(range(0, max(len(seq) - 32, 1), stride)))
        # one start per restart offset (the reference runs one fullstart
        # per restart); a lone offset-0 scan keeps 3 candidate starts
        with self._device_lock, timers.stage("seedless_scan"):
            return self._fullstart.scan(seq, offsets=offsets,
                                        topk=3 if len(offsets) == 1 else 1)

    # ------------------------------------------------------------------
    def _init_states(self, ri: int, read_mm: np.ndarray, seed_node: int,
                     seed_offset: int, seed_row: int) -> List[_ExtState]:
        g = self.g
        node_len = int(g.node_len[seed_node])
        fwd = _ExtState(read_idx=ri, reverse=False,
                        mm=read_mm[seed_row:], row=0, seed_node=seed_node,
                        seed_trim=node_len - seed_offset)
        bwd = _ExtState(read_idx=ri, reverse=True,
                        mm=read_mm[:seed_row][::-1], row=0,
                        seed_node=seed_node, seed_trim=seed_offset)
        if len(bwd.mm) == 0:
            bwd.active = False
        if len(fwd.mm) == 0:
            fwd.active = False
        return [fwd, bwd]

    # ------------------------------------------------------------------
    def _extend_round(self, states: List[_ExtState]):
        """One batched window step over all active states.  Windows that
        fail the error/HMM cutoff are retried once with the ramp band
        before being clipped (reference backtrack-and-retry with
        rampBandwidth, src/GraphAlignerBitvectorBanded.h:572-644)."""
        cfg = self.cfg
        act = [st for st in states if st.active]
        if not act:
            return False
        ramp = (cfg.ramp_band_slots
                if cfg.ramp_band_slots > cfg.band_slots else 0)
        retry = self._run_window(act, cfg.band_slots, can_retry=bool(ramp))
        if retry:
            self._run_window(retry, ramp, can_retry=False)
        return any(st.active for st in states)

    def _run_window(self, act: List[_ExtState], band_slots: int,
                    can_retry: bool) -> List[_ExtState]:
        """Run one window for `act`; commit results.  Returns the states
        whose commit was deferred for a wider-band retry."""
        cfg = self.cfg
        fresh = [st for st in act if not st.windows]
        carried = [st for st in act if st.windows]
        per_state = {}   # id(st) -> (res, i, band_nodes, shifts, slot_map)

        if fresh:
            jobs = [FragJob(rmm=st.mm[:WINDOW_ROWS],
                            seed_node=st.seed_node,
                            seed_trim_len=st.seed_trim,
                            reverse=st.reverse) for st in fresh]
            (bn, bnc, bi, seed_shift, req, rows_arr, S, bl) = \
                assemble_batch(self.gx, jobs, B=band_slots,
                               max_in=cfg.max_in, slack=cfg.band_slack)
            with self._device_lock, timers.stage("ga_window", len(jobs)):
                res = run_fragments(self.gx, bnc, bi, seed_shift, req,
                                    rows_arr, S, cfg.max_in, bl,
                                    self.devices, want_state=True,
                                    want_xcells=True)
            B = bn.shape[1]
            for i, st in enumerate(fresh):
                shifts = np.zeros(B, dtype=np.int32)
                shifts[0] = int(seed_shift[i])
                per_state[id(st)] = (res, i, bn[i], shifts, None,
                                     int(rows_arr[i]))

        if carried:
            cjobs = []
            for st in carried:
                valid = (st.carry_ssb < frag_align.BIG) \
                    & (st.band_nodes >= 0)
                lo = int(st.carry_ssb[valid].min()) if valid.any() else 0
                src = valid & (st.carry_ssb <= lo + cfg.carry_margin)
                cjobs.append(CarryJob(
                    rmm=st.mm[st.row:st.row + WINDOW_ROWS],
                    reverse=st.reverse, old_nodes=st.band_nodes,
                    old_ssb=st.carry_ssb, old_hp=st.carry_hp,
                    old_hn=st.carry_hn, src_mask=src,
                    old_shift=st.band_shifts))
            (bn, bnc, bi, bl, carry, slot_map, shifts_arr, req, rows_arr,
             S) = assemble_carry_batch(self.gx, cjobs, B=band_slots,
                                       max_in=cfg.max_in,
                                       slack=cfg.band_slack)
            with self._device_lock, timers.stage("ga_window", len(cjobs)):
                res = run_fragments(self.gx, bnc, bi, shifts_arr, req,
                                    rows_arr, S, cfg.max_in, bl,
                                    self.devices, carry_in=carry,
                                    want_state=True, want_xcells=True)
            for i, st in enumerate(carried):
                per_state[id(st)] = (res, i, bn[i], shifts_arr[i],
                                     slot_map[i], int(rows_arr[i]))

        retry = []
        for st in act:
            res, i, bn_i, shifts_i, smap_i, nrows = per_state[id(st)]
            best = int(res.best_score[i])
            delta = best - st.best
            bad = (delta > cfg.window_error_cutoff * nrows
                   or not st.hmm.next_state(delta, nrows)
                          .current_is_correct())
            if cfg.global_alignment:
                bad = False             # --global-alignment: never clip
            if bad and can_retry:
                retry.append(st)        # state untouched; rerun wider
                continue
            st.hmm = st.hmm.next_state(delta, nrows)
            st.xscore += (nrows - delta) - 4.0 * delta
            st.xscore_max = max(st.xscore_max, st.xscore)
            if (bad or (not cfg.global_alignment
                        and cfg.x_drop is not None
                        and st.xscore_max - st.xscore > cfg.x_drop)):
                st.active = False       # X-drop / correctness-HMM clip
                if res.xbest is not None:
                    # keep the failed window as a TAIL record: its X
                    # cells (e.g. a good stretch before the garbage that
                    # tripped the cutoff) still compete for the final
                    # endpoint, giving mid-window cell-precise clips
                    st.tail = _WindowRec(
                        band_nodes=bn_i.copy(), best_in=res.best_in[i],
                        slot_map=smap_i, shifts=shifts_i, rows=nrows,
                        end_slot=int(res.best_slot[i]),
                        end_col=int(res.best_col[i]),
                        row_end=st.row + nrows, xscore=st.xscore,
                        xcell=(st.row + int(res.xbest[i]),
                               int(res.xslot[i]), int(res.xrow[i])))
                continue
            rows_before = st.row
            st.row += nrows
            xcell = None
            if res.xbest is not None:
                # kernel X is (local_row+1) - 5*cumulative_edits; add the
                # rows aligned before this window for the global X value
                xcell = (rows_before + int(res.xbest[i]),
                         int(res.xslot[i]), int(res.xrow[i]))
            st.windows.append(_WindowRec(
                band_nodes=bn_i.copy(), best_in=res.best_in[i],
                slot_map=smap_i, shifts=shifts_i, rows=nrows,
                end_slot=int(res.best_slot[i]),
                end_col=int(res.best_col[i]), row_end=st.row,
                xscore=st.xscore, xcell=xcell))
            st.band_nodes = bn_i
            st.band_shifts = shifts_i
            st.carry_ssb = res.out_ssb[i]
            st.carry_hp = res.out_hp[i]
            st.carry_hn = res.out_hn[i]
            st.best = best
            st.end_slot = int(res.best_slot[i])
            st.end_col = int(res.best_col[i])
            if st.row >= len(st.mm):
                st.active = False
        return retry

    # ------------------------------------------------------------------
    @staticmethod
    def _multi_backwalk(windows: List[_WindowRec], end_slot: int,
                        end_slice: Optional[int] = None
                        ) -> Optional[List[int]]:
        """Walk the per-window backtrace pointers from the final end slot
        back to the seed, crossing window boundaries via slot_map.
        end_slice: slice within the last window to start from (default:
        the window's final slice; cell-precise X clipping starts at the
        argmax cell's slice).  Returns node ids in walk order
        (end -> seed), or None."""
        if not windows:
            return None
        w = len(windows) - 1
        rec = windows[w]
        slot = end_slot
        s = (rec.rows - 1) // W if end_slice is None else end_slice
        nodes = [int(rec.band_nodes[slot])]
        guard = sum(r.best_in.size for r in windows) + 8 * len(windows)
        for _ in range(guard):
            e = int(rec.best_in[slot, s])
            if e == frag_align.IN_SEED:
                return nodes
            if e == frag_align.IN_VERT:
                s -= 1
                if s >= 0:
                    continue
                if w == 0 or rec.slot_map is None:
                    return None
                prev = int(rec.slot_map[slot])
                if prev < 0:
                    return None
                w -= 1
                slot = prev
                rec = windows[w]
                s = (rec.rows - 1) // W
                continue
            if e < 0:
                return None
            slot = e
            nodes.append(int(rec.band_nodes[slot]))
        return None

    # ------------------------------------------------------------------
    def _finalize(self, read: str, fwd: _ExtState, bwd: _ExtState,
                  seed_node: int, seed_offset: int, seed_row: int):
        """Join both directions into (positions, span)."""
        g = self.g

        def walk_dir(st: _ExtState):
            """Backwalk from the end window.  When the X-score drops more
            than the X-drop cutoff below its running peak by the end of
            the extension, the end is clipped back to the exact best
            X-score CELL (the reference's per-cell X endpoint clipping,
            src/GraphAlignerBitvectorCommon.h:321-383: kernel-tracked
            argmax over slot end-words x rows); smaller dips keep the
            full extension (reference default has no X-drop).  Returns
            (end->seed node walk, direction-local end offset, rows
            covered) or None."""
            if not st.windows:
                return None
            w_end = len(st.windows) - 1
            if not self.cfg.global_alignment:
                drop = (self.cfg.x_drop if self.cfg.x_drop is not None
                        else DEFAULT_END_DROP)
                allw = list(st.windows)
                if st.tail is not None:
                    allw.append(st.tail)
                cells = [(rec.xcell[0], wi) for wi, rec in
                         enumerate(allw) if rec.xcell is not None]
                final_x = st.xscore
                if cells:
                    peak_val, peak_w = max(cells)
                    if final_x < peak_val - drop:
                        # clip at the exact argmax cell
                        rec = allw[peak_w]
                        _, xslot, xrow = rec.xcell
                        wins = allw[:peak_w + 1]
                        nodes = self._multi_backwalk(wins, xslot,
                                                     end_slice=xrow // W)
                        if nodes is None:
                            return None
                        # the cell sits at the END column of its slot's
                        # node word (X is scanned over end-of-node words)
                        node = int(rec.band_nodes[xslot])
                        off = int(self.g.node_len[node]) - 1
                        rows = rec.row_end - rec.rows + xrow + 1
                        return nodes, off, rows
                else:
                    xs = [rec.xscore for rec in st.windows]
                    peak = int(np.argmax(xs))
                    if xs[w_end] < xs[peak] - drop:
                        w_end = peak
            wins = st.windows[:w_end + 1]
            rec = wins[-1]
            nodes = self._multi_backwalk(wins, rec.end_slot)
            if nodes is None:
                return None
            off = rec.end_col + int(rec.shifts[rec.end_slot])
            return nodes, off, rec.row_end

        wf = walk_dir(fwd)
        wb = walk_dir(bwd)
        # direction-local offsets -> original coordinates
        if bwd.row > 0 and wb is not None:
            nodes_b, off_b, bwd_rows = wb
            first_node = nodes_b[0]
            # bwd offsets count from the reversed node start
            first_off = int(g.node_len[first_node]) - 1 - off_b
            # end->seed walk is already original path order; drop the seed
            bwd_nodes = nodes_b[:-1]
        else:
            first_node, first_off = seed_node, seed_offset
            bwd_nodes = []
            bwd_rows = 0
        if fwd.row > 0 and wf is not None:
            nodes_f, off_f, fwd_rows = wf
            last_node = nodes_f[0]
            last_off = off_f
            fwd_nodes = list(reversed(nodes_f))[1:]
        else:
            last_node, last_off = seed_node, seed_offset
            fwd_nodes = []
            fwd_rows = 0
        path = bwd_nodes + [seed_node] + fwd_nodes
        dedup = [path[0]]
        for p in path[1:]:
            if p != dedup[-1]:
                dedup.append(p)
        positions = path_to_positions(g, dedup, first_off, last_off)
        span = (seed_row - bwd_rows, seed_row + fwd_rows)
        return positions, span

    # ------------------------------------------------------------------
    def align_batch(self, reads: Sequence[Tuple[str, str]]
                    ) -> List[ReadAlignment]:
        cfg = self.cfg
        out = [ReadAlignment(name=n, seq=s, positions=[], ops=None,
                             score=len(s), seq_end=len(s))
               for n, s in reads]
        seed_lists = []
        for name, seq in reads:
            if cfg.seedless_dp:
                # --seedless-DP: fullstart scan instead of the seeder
                # (reference AlignOneWay, src/GraphAligner.h:53-83)
                seed_lists.append(self._seedless_seeds(seq))
                continue
            seeds = get_seeds(self.index, seq, cfg.seed_density)
            # diagonal clustering picks seeds from the best-supported
            # cluster first (reference OrderSeeds, src/GraphAligner.h:233)
            seeds = cluster_seeds(self.g, seeds,
                                  min_cluster_size=cfg.min_cluster_size)
            if cfg.try_all_seeds:
                ntry = len(seeds)
            elif cfg.seed_extend_density > 0:
                ntry = max(1, int(cfg.seed_extend_density * len(seq)))
            else:
                ntry = cfg.max_seed_tries
            seed_lists.append(seeds[:ntry])
        for ri, seeds in enumerate(seed_lists):
            out[ri].n_seeds = len(seeds)

        candidates = [[] for _ in reads]   # (positions, span) per try
        best_span = [(0, 0)] * len(reads)
        pending = [(ri, 0) for ri in range(len(reads))
                   if seed_lists[ri]]
        while pending:
            batch_states = []
            meta = []
            for ri, si in pending:
                seed = seed_lists[ri][si]
                v, off = self.g.find_split(seed.di_node, seed.node_offset)
                mm = match_masks(reads[ri][1])
                sts = self._init_states(ri, mm, v, off, seed.seq_pos)
                batch_states.extend(sts)
                meta.append((ri, si, sts, v, off, seed.seq_pos))
            while self._extend_round(batch_states):
                pass
            next_pending = []
            for ri, si, sts, v, off, srow in meta:
                fwd, bwd = sts
                positions, span = self._finalize(reads[ri][1], fwd, bwd,
                                                 v, off, srow)
                cov = (span[1] - span[0]) / max(len(reads[ri][1]), 1)
                prev_cov = ((best_span[ri][1] - best_span[ri][0])
                            / max(len(reads[ri][1]), 1))
                if len(positions):
                    candidates[ri].append((positions, span))
                if cov > prev_cov:
                    best_span[ri] = span
                # with --DP-restart-stride every restart offset extends
                # unconditionally (the reference re-runs fullstart after
                # each alignment, src/GraphAligner.h:60-80); otherwise
                # retry the next seed only while the read is under-covered
                advance = cov < cfg.min_coverage_frac or (
                    cfg.seedless_dp and cfg.dp_restart_stride > 0)
                if advance and si + 1 < len(seed_lists[ri]):
                    next_pending.append((ri, si + 1))
            pending = next_pending

        # polish every candidate alignment (batched), then select a
        # non-overlapping subset per read (multimapping; reference
        # AlignmentSelection over per-seed alignments)
        polish_reads, polish_paths, refs = [], [], []
        for ri in range(len(reads)):
            for ci, (positions, span) in enumerate(candidates[ri]):
                # clipped alignments polish span-locally (the unaligned
                # read head/tail is clipped, not charged as indels)
                polish_reads.append(reads[ri][1][span[0]:span[1]])
                polish_paths.append(self.gx.positions_seq(positions))
                refs.append((ri, ci))
        scored = {}
        if polish_reads:
            with self._device_lock, timers.stage("ga_polish",
                                                 len(polish_reads)):
                outcomes = polish.polish_batch(polish_reads, polish_paths,
                                               bw=cfg.polish_band_words,
                                               device=self.devices)
            for (ri, ci), oc in zip(refs, outcomes):
                scored[(ri, ci)] = oc
            if cfg.bubble_repair:
                # corridor re-polish (native corridor_polish_batch, see
                # models/chainer.py): exact banded DP with per-cell
                # backtrace over each candidate's path + 1-hop arm
                # corridor — the extension walk is word-granular, so its
                # path can miss the banded-optimal score; this jointly
                # fixes every wrong arm on host, no device round trip
                keys = [k for k, oc in zip(refs, outcomes)
                        if oc.score > 0 and oc.ops is not None]
                for _ in range(2):
                    if not keys:
                        break
                    fixed_l = native.corridor_polish_batch(
                        self.gx,
                        [candidates[ri][ci][0] for ri, ci in keys],
                        [scored[k].ops for k in keys],
                        [reads[ri][1][slice(*candidates[ri][ci][1])]
                         for ri, ci in keys],
                        [scored[k].score for k in keys])
                    improved = []
                    for (ri, ci), fixed in zip(keys, fixed_l):
                        if fixed is None:
                            continue
                        sc, pos, ops = fixed
                        candidates[ri][ci] = (pos,
                                              candidates[ri][ci][1])
                        scored[(ri, ci)] = polish.PolishOutcome(
                            score=sc, ops=ops)
                        if sc > 0:
                            improved.append((ri, ci))
                    keys = improved
        for ri in range(len(reads)):
            alts = []
            for ci, (positions, span) in enumerate(candidates[ri]):
                oc = scored.get((ri, ci))
                if oc is None:
                    continue
                score = oc.score
                ops = oc.ops
                if (cfg.x_drop is not None and not cfg.global_alignment
                        and ops is not None and len(ops)):
                    positions, ops, score, span = _xdrop_trim(
                        positions, ops, span)
                a = ReadAlignment(name=out[ri].name, seq=out[ri].seq,
                                  positions=positions, ops=ops,
                                  score=score, seq_start=span[0],
                                  seq_end=span[1])
                alts.append(a)
            if not alts:
                continue
            sel = select_alignments(
                alts, SelectionOptions(
                    method=SelectionMethod(cfg.selection_method),
                    graph_size=self._db_size,
                    read_size=len(out[ri].seq),
                    e_cutoff=cfg.e_cutoff,
                    evalue_calc=EValueCalculator(
                        cfg.precise_clipping
                        if cfg.precise_clipping is not None else 0.5,
                        legacy_score=cfg.evalue_legacy_score)))
            if not sel:
                continue
            if cfg.selection_method != "All":
                sel = sel[:cfg.max_alignments]
            primary = sel[0]
            primary.secondary = sel[1:]
            for a in primary.secondary:
                a.is_secondary = True
            primary.n_seeds = out[ri].n_seeds
            out[ri] = primary
        return out

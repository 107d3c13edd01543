"""align_reads: graph + indices + batched alignment + writers.

Port of graphchainer_tpu/pipeline.py for CLC mode (ChainerModel, with
minimizer, MEM, MUM or file seeds), GA mode (--mode ga,
GraphAlignerModel, with --seedless-DP) and optimal mode (--mode optimal,
OptimalAlignerModel), with GFA or .vg input: a reader thread streams
reads into batches, a thread pool runs the model's align_batch on up to
`inflight` batches at once (host stages of one batch overlap device work
of another), and the main thread writes GAM / GAF / JSON alignments and
corrected reads and sums each batch's statistics
(parallel/collectives.merge_stats).  "cuda" takes the current card;
a comma-separated list of devices, a row block of the fragment DP and
of the polish a device (parallel/device.py).
With num_processes P > 1 (parallel/multihost.py) each process takes
every P-th read and, with "cuda", the card I % count alone, writes
".partI" files, and the statistics are summed over all processes.
"""
from __future__ import annotations

import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from graphchainer_torch.align.evalue import EValueCalculator
from graphchainer_torch.graph.alignment_graph import (AlignmentGraph,
                                                    build_alignment_graph)
from graphchainer_torch.graph.mpc import MPCIndex, build_mpc
from graphchainer_torch.index.minimizer import MinimizerIndex, build_index
from graphchainer_torch.io import fastq, gaf, gam
from graphchainer_torch.io.gfa import load_gfa
from graphchainer_torch.parallel import multihost
from graphchainer_torch.parallel.collectives import merge_stats
from graphchainer_torch.parallel.device import local_devices, process_device
from graphchainer_torch.utils import timers
from graphchainer_torch.models.aligner import (AlignerConfig,
                                               GraphAlignerModel)
from graphchainer_torch.models.chainer import (ChainerConfig, ChainerModel,
                                               ReadAlignment)
from graphchainer_torch.models.optimal import (OptimalAlignerModel,
                                               OptimalConfig)


@dataclass
class PipelineParams:
    graph_file: str = ""
    read_files: List[str] = field(default_factory=list)
    out_gam: Optional[str] = None
    out_gaf: Optional[str] = None
    out_json: Optional[str] = None
    out_corrected: Optional[str] = None
    out_corrected_clipped: Optional[str] = None
    batch_size: int = 64
    inflight: int = 3          # batches aligned concurrently
    mpc_index_file: Optional[str] = None
    minimizer_index_file: Optional[str] = None
    seed_k: int = 15
    seed_w: int = 20
    discard_fraction: float = 0.0002
    chainer: ChainerConfig = field(default_factory=ChainerConfig)
    mode: str = "clc"          # clc (chaining) / ga (extension) / optimal
    seed_file: Optional[str] = None   # external .gam seeds (CLC)
    mem_count: int = 0                # >0: MEM seeding with this max count
    mum_count: int = 0                # >0: MUM seeding (unique matches)
    mxm_length: int = 20              # minimum MEM / MUM length
    mxm_cache_prefix: Optional[str] = None   # PREFIX.sa.npz suffix array
    cigar_match_mismatch: bool = False
    device: str = "cuda"
    verbose: bool = False
    x_drop: Optional[int] = None              # --X-drop (GA mode)
    precise_clipping: Optional[float] = None  # --precise-clipping
    ramp_band_slots: int = 0                  # --ramp-bandwidth/-B (GA)
    bandwidth: Optional[int] = None           # -b (GA band slots; CLC via
                                              # chainer.band_slots)
    selection_method: str = "GreedyLength"    # --all-alignments/--greedy-*
    e_cutoff: float = -1.0                    # --E-cutoff (-1 = off)
    evalue_legacy_score: bool = False
    try_all_seeds: bool = False               # --try-all-seeds (GA mode)
    seed_extend_density: float = -1.0         # --seeds-extend-density
    min_cluster_size: int = 0                 # --seeds-clustersize
    global_alignment: bool = False            # --global-alignment (GA)
    seedless_dp: bool = False                 # --seedless-DP (GA mode)
    dp_restart_stride: int = 0                # --DP-restart-stride
    # multi-process execution (parallel/multihost.py): all processes run
    # the same command; reads stripe by index, outputs get .partI
    # suffixes, the statistics are summed over the processes
    num_processes: int = 1
    process_id: int = 0
    coordinator: str = "127.0.0.1:43231"


@dataclass
class AlignmentStats:
    reads: int = 0
    bp_in_reads: int = 0
    seeds_found: int = 0
    reads_with_a_seed: int = 0
    reads_with_an_alignment: int = 0
    alignments: int = 0
    bp_in_alignments: int = 0
    assertion_broke: bool = False
    seconds: float = 0.0


def g_name_ids(g: AlignmentGraph):
    return {name: i for i, name in enumerate(g.names)}


def load_graph(path: str, allow_cycles: bool = False) -> AlignmentGraph:
    """GFA (.gfa / .gfa.gz) or vg protobuf (.vg) input.  allow_cycles: GA
    mode aligns cyclic graphs; CLC and optimal mode need a DAG."""
    if path.endswith(".vg"):
        from graphchainer_torch.io.vg_graph import load_vg
        return build_alignment_graph(load_vg(path), allow_cycles=allow_cycles)
    return build_alignment_graph(load_gfa(path), allow_cycles=allow_cycles)


def get_or_build_mpc(g: AlignmentGraph, cache: Optional[str]) -> MPCIndex:
    if cache and os.path.exists(cache):
        return MPCIndex.load(cache)
    mpc = build_mpc(g)
    if cache:
        mpc.save(cache)
    return mpc


def get_or_build_minimizer(g: AlignmentGraph,
                           params: PipelineParams) -> MinimizerIndex:
    cache = params.minimizer_index_file
    if cache and os.path.exists(cache):
        return MinimizerIndex.load(cache)
    idx = build_index(g, k=params.seed_k, w=params.seed_w,
                      discard_fraction=params.discard_fraction)
    if cache:
        idx.save(cache)
    return idx


def corrected_read(aln: ReadAlignment, gx,
                   clipped: bool) -> Optional[str]:
    """Reference src/ReadCorrection.cpp: replace the aligned span with the
    path sequence (lowercase = uncorrected context)."""
    if aln.failed:
        return None
    pathseq = gx.positions_seq(aln.positions)
    if clipped:
        return pathseq
    return (aln.seq[:aln.seq_start].lower() + pathseq.upper()
            + aln.seq[aln.seq_end:].lower())


def get_or_build_mem(g: AlignmentGraph, cache_prefix: Optional[str]):
    """The MEM / MUM suffix-array index, from PREFIX.sa.npz where it
    exists, else built (and saved there when a prefix is given)."""
    from graphchainer_torch.index.mem import MemIndex, build_mem_index
    cache = cache_prefix + ".sa.npz" if cache_prefix else None
    if cache and os.path.exists(cache):
        return MemIndex.load(cache)
    mem_index = build_mem_index(g)
    if cache:
        mem_index.save(cache)
    return mem_index


def align_reads(params: PipelineParams) -> AlignmentStats:
    """Align params.read_files to params.graph_file and write the outputs.
    With several processes, this one joins the others (before any device
    work) and leaves the process group at the end."""
    joined = multihost.initialize(params.coordinator, params.num_processes,
                                  params.process_id)
    try:
        return _align_reads(params)
    finally:
        if joined:
            multihost.finalize()


def _align_reads(params: PipelineParams) -> AlignmentStats:
    t0 = time.time()
    devices = local_devices(process_device(
        params.device, params.process_id, params.num_processes))
    try:
        with timers.stage("load_graph"):
            g = load_graph(params.graph_file,
                           allow_cycles=(params.mode == "ga"))
    except ValueError as e:
        if "directed cycle" in str(e) and params.mode != "ga":
            print("The input sequence graph has a directed cycle.\n"
                  "Colinear chaining only supports DAGs; re-run with "
                  "--no-colinear-chaining (GA mode) to align cyclic "
                  "graphs.", file=sys.stderr)
            sys.exit(1)
        raise
    if params.verbose:
        print(f"graph: {g.stats()}")
    with timers.stage("index"):
        index = get_or_build_minimizer(g, params)
    if params.mode != "ga" and (
            params.x_drop is not None
            or (params.precise_clipping is not None
                and params.e_cutoff == -1.0)):
        print("WARNING: outside --mode ga, --X-drop is ignored and "
              "--precise-clipping only feeds --E-cutoff E-values",
              file=sys.stderr)
    if params.mode == "ga":
        # X-drop without precise-clipping defaults the identity cutoff to
        # .66, like the reference (src/AlignerMain.cpp:443-447)
        pc = params.precise_clipping
        if params.x_drop is not None and pc is None:
            pc = 0.66
        model = GraphAlignerModel(
            g, index,
            AlignerConfig(seed_density=params.chainer.seed_density,
                          polish_band_words=params.chainer.polish_band_words,
                          x_drop=params.x_drop, precise_clipping=pc,
                          ramp_band_slots=params.ramp_band_slots,
                          selection_method=params.selection_method,
                          e_cutoff=params.e_cutoff,
                          evalue_legacy_score=params.evalue_legacy_score,
                          try_all_seeds=params.try_all_seeds,
                          seed_extend_density=params.seed_extend_density,
                          min_cluster_size=params.min_cluster_size,
                          global_alignment=params.global_alignment,
                          seedless_dp=params.seedless_dp,
                          dp_restart_stride=params.dp_restart_stride,
                          **({"band_slots": params.bandwidth}
                             if params.bandwidth else {})),
            device=devices)
    elif params.mode == "optimal":
        model = OptimalAlignerModel(
            g, index,
            OptimalConfig(polish_band_words=params.chainer.polish_band_words),
            device=devices[0])
    else:
        with timers.stage("index"):
            mpc = get_or_build_mpc(g, params.mpc_index_file)
        file_seeds = seed_fn = None
        if params.seed_file:
            from graphchainer_torch.io.gam_reader import load_gam_seeds
            file_seeds = load_gam_seeds(params.seed_file, g_name_ids(g))
        elif params.mem_count > 0 or params.mum_count > 0:
            from graphchainer_torch.index.mem import MemSeeder
            seeder = MemSeeder(
                g, get_or_build_mem(g, params.mxm_cache_prefix),
                min_len=params.mxm_length,
                max_count=params.mum_count or params.mem_count,
                unique_only=params.mum_count > 0)
            seed_fn = lambda name, seq: seeder.get_seeds(seq)  # noqa: E731
        model = ChainerModel(g, mpc, index, params.chainer,
                             file_seeds=file_seeds, seed_fn=seed_fn,
                             device=devices)
    stats = AlignmentStats()

    ecalc = None
    if params.e_cutoff != -1.0:
        # identity defaults to .5 like the reference (AlignerMain.cpp:172)
        ecalc = EValueCalculator(params.precise_clipping
                                 if params.precise_clipping is not None
                                 else 0.5,
                                 legacy_score=params.evalue_legacy_score)
        db_size = int(np.sum(g.node_len)) // 2
    batch_q: "queue.Queue" = queue.Queue(maxsize=4)
    npx, pid = params.num_processes, params.process_id

    def reader():
        batch = []
        gi = 0
        for path in params.read_files:
            for rd in fastq.stream_reads(path):
                # read i belongs to process i % P
                if gi % npx == pid:
                    batch.append((rd.name, rd.seq))
                    if len(batch) >= params.batch_size:
                        batch_q.put(batch)
                        batch = []
                gi += 1
        if batch:
            batch_q.put(batch)
        batch_q.put(None)

    def out(path):
        return multihost.part_suffix(path, pid, npx)

    gam_w = gam.GamWriter(out(params.out_gam)) if params.out_gam else None
    gaf_f = open(out(params.out_gaf), "w") if params.out_gaf else None
    json_f = open(out(params.out_json), "w") if params.out_json else None
    corr_f = (open(out(params.out_corrected), "w")
              if params.out_corrected else None)
    clip_f = (open(out(params.out_corrected_clipped), "w")
              if params.out_corrected_clipped else None)
    rt = threading.Thread(target=reader, daemon=True)
    rt.start()
    pool = ThreadPoolExecutor(max_workers=max(params.inflight, 1))
    futures = []
    totals = np.zeros(7, dtype=np.int64)

    def drain(block_all=False):
        done = []
        while futures and (block_all or futures[0].done()
                           or len(futures) >= max(params.inflight, 1)):
            done.append(futures.pop(0).result())
        return done

    def consume(alns):
        nonlocal totals
        rows = []
        for aln in alns:
            row = [1, len(aln.seq), aln.n_seeds,
                   1 if aln.n_seeds else 0, 0, 0, 0]
            rows.append(row)
            if aln.error is not None:
                stats.assertion_broke = True
            if aln.failed:
                continue
            emitted = [aln] + list(aln.secondary)
            if ecalc is not None:
                emitted = [a for a in emitted
                           if ecalc.evalue(db_size, len(aln.seq),
                                           a.seq_end - a.seq_start, a.score)
                           <= params.e_cutoff]
                if not emitted:
                    continue
                aln = emitted[0]
            row[4] = 1
            row[5] = len(emitted)
            row[6] = sum(a.seq_end - a.seq_start for a in emitted)
            if gam_w:
                for a in emitted:
                    gam_w.write(gam.alignment_message(g, a))
            if gaf_f:
                line = gaf.gaf_line(g, aln,
                                    cigar_merge_mm=params.cigar_match_mismatch)
                if line:
                    gaf_f.write(line + "\n")
            if json_f:
                json_f.write(gam.alignment_json(g, aln) + "\n")
            if corr_f:
                c = corrected_read(aln, model.gx, clipped=False)
                if c:
                    corr_f.write(f">{aln.name}\n{c}\n")
            if clip_f:
                c = corrected_read(aln, model.gx, clipped=True)
                if c:
                    clip_f.write(f">{aln.name}\n{c}\n")
        if rows:
            totals += merge_stats(np.asarray(rows, dtype=np.int64), devices)

    try:
        while True:
            batch = batch_q.get()
            if batch is None:
                break
            futures.append(pool.submit(model.align_batch, batch))
            for alns in drain():
                consume(alns)
        for alns in drain(block_all=True):
            consume(alns)
    finally:
        pool.shutdown()
        rt.join()
        if gam_w:
            gam_w.close()
        for f in (gaf_f, json_f, corr_f, clip_f):
            if f:
                f.close()
    stats.seconds = time.time() - t0
    if npx > 1:
        totals = multihost.merge_stats_global(totals)
    (stats.reads, stats.bp_in_reads, stats.seeds_found,
     stats.reads_with_a_seed, stats.reads_with_an_alignment,
     stats.alignments, stats.bp_in_alignments) = (int(x) for x in totals)
    if params.verbose:
        print(f"Input reads: {stats.reads} ({stats.bp_in_reads}bp)")
        print(f"Seeds found: {stats.seeds_found}")
        print(f"Reads with a seed: {stats.reads_with_a_seed}")
        print(f"Reads with an alignment: {stats.reads_with_an_alignment}")
        print(f"Alignments: {stats.alignments} "
              f"({stats.bp_in_alignments}bp)")
        print(f"Wall-clock: {stats.seconds:.2f}s")
        if timers.snapshot():
            print(timers.report())
            rc = timers.report_counters()
            if rc:
                print(rc)
        from graphchainer_torch.ops import _cuda
        launched = {k: v for k, v in _cuda.launches().items() if v}
        if launched:
            print("Kernel launches: " + ", ".join(
                f"{k} {v}" for k, v in launched.items()))
    return stats

"""Command-line interface of the PyTorch port (CLC, GA and optimal modes).

  python -m graphchainer_torch -g graph.gfa -f reads.fa -a out.gaf \
      [--mode ga|optimal] [--seedless-DP] [-t N] [--batch-size N] \
      [--verbose] [--device cuda]

The flags are graphchainer_tpu's, every one of them, with its defaults;
-a takes .gaf, .gam and .json, and -g .gfa and .vg.
"""
from __future__ import annotations

import argparse
import math
import sys

from graphchainer_torch import constants
from graphchainer_torch.models.chainer import ChainerConfig
from graphchainer_torch.graph.simulate import generate_path
from graphchainer_torch.pipeline import (PipelineParams, align_reads,
                                         load_graph)

# the alignment selection flags and the method each picks
_SELECTION = [("all_alignments", "--all-alignments", "All"),
              ("greedy_length", "--greedy-length", "GreedyLength"),
              ("greedy_e", "--greedy-E", "GreedyE"),
              ("greedy_score", "--greedy-score", "GreedyScore"),
              ("sched_score", "--schedule-score", "ScheduleScore"),
              ("sched_length", "--schedule-length", "ScheduleLength"),
              ("sched_e_sum", "--schedule-inverse-E-sum",
               "ScheduleInverseESum"),
              ("sched_e_product", "--schedule-inverse-E-product",
               "ScheduleInverseEProduct")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphchainer-torch",
        description="Long-read to variation-graph aligner with co-linear "
                    "chaining (PyTorch / CUDA port of graphchainer-tpu, "
                    "CLC, GA and optimal modes)")
    m = p.add_argument_group("mandatory")
    m.add_argument("-g", "--graph", required=True,
                   help="input graph (.gfa / .gfa.gz / .vg)")
    m.add_argument("-f", "--reads", action="append", default=[],
                   help="input reads (fasta or fastq, optionally gzipped); "
                        "may repeat")
    m.add_argument("-a", "--alignments-out", action="append", default=[],
                   help="output file (.gam / .gaf / .json); may repeat")
    clc = p.add_argument_group("colinear chaining")
    clc.add_argument("--colinear-split-len", type=int,
                     default=constants.DEFAULT_COLINEAR_SPLIT_LEN)
    clc.add_argument("--colinear-split-gap", type=int, default=None)
    clc.add_argument("--sampling-step", type=float, default=None,
                     help="split-gap = ceil(arg * split-len)")
    clc.add_argument("--colinear-gap", type=int,
                     default=constants.DEFAULT_COLINEAR_GAP)
    clc.add_argument("--fast-mode", action="store_true",
                     help="skip the base-level polish alignment")
    clc.add_argument("--mode", choices=["clc", "ga", "optimal"],
                     default="clc",
                     help="clc = co-linear chaining (default); ga = plain "
                          "whole-read seed-and-extend (GraphAligner-style); "
                          "optimal = exact minimal edit distance over "
                          "whole components")
    clc.add_argument("--no-colinear-chaining", action="store_true",
                     help="alias for --mode ga")
    clc.add_argument("--optimal-alignment", action="store_true",
                     help="alias for --mode optimal")
    clc.add_argument("--seedless-DP", dest="seedless_dp",
                     action="store_true",
                     help="no seeding: discover alignment starts with a "
                          "free-start DP scan over the whole graph "
                          "(implies --mode ga)")
    clc.add_argument("--DP-restart-stride", dest="dp_restart_stride",
                     type=int, default=0,
                     help="with --seedless-DP, re-scan at this read-offset "
                          "stride to recover coverage after clips")
    clc.add_argument("--global-alignment", action="store_true",
                     help="align the read end to end even where the score "
                          "is poor (GA mode)")
    clc.add_argument("--compare-baseline", action="store_true",
                     help="in clc mode, also run the whole-read baseline on "
                          "every read and keep the better alignment")
    gen = p.add_argument_group("general")
    gen.add_argument("--device", default="cuda",
                     help="torch device: cuda runs the CUDA kernels, cpu "
                          "their plain torch versions; a comma-separated "
                          "list (cuda:0,cuda:1) splits the device stages' "
                          "rows over its devices (default cuda)")
    gen.add_argument("-t", "--threads", type=int, default=None,
                     help="batches aligned concurrently (default 3)")
    gen.add_argument("--verbose", action="store_true")
    gen.add_argument("--num-processes", type=int, default=1,
                     help="multi-process execution: total process count "
                          "(all processes run the same command; reads "
                          "stripe by index, outputs get .partI suffixes)")
    gen.add_argument("--process-id", type=int, default=0,
                     help="this process's id in [0, num-processes)")
    gen.add_argument("--coordinator", default="127.0.0.1:43231",
                     help="torch.distributed rendezvous host:port "
                          "(process 0's address)")
    gen.add_argument("--batch-size", type=int, default=64)
    gen.add_argument("--mpc-index", default=None)
    gen.add_argument("--minimizer-index", default=None)
    gen.add_argument("--cigar-match-mismatch", action="store_true")
    gen.add_argument("--corrected-out", default=None,
                     help="corrected reads FASTA out")
    gen.add_argument("--corrected-clipped-out", default=None,
                     help="corrected clipped reads FASTA out")
    gen.add_argument("--generate-path", default=None, metavar="PREFIX",
                     help="generate a random source-to-sink path "
                          "(PREFIX.fasta + PREFIX.nodes) and exit")
    gen.add_argument("--generate-path-seed", type=int, default=0)
    gen.add_argument("--graph-statistics", action="store_true",
                     help="print graph statistics and exit")
    seed = p.add_argument_group("seeding")
    seed.add_argument("--seeds-mem-count", type=int, default=0,
                      help="use MEM seeds: max occurrences per match "
                           "(reference --seeds-mem-count)")
    seed.add_argument("--seeds-mum-count", type=int, default=0,
                      help="use MUM seeds (unique matches) "
                           "(reference --seeds-mum-count)")
    seed.add_argument("--seeds-mxm-length", type=int, default=20,
                      help="min MUM/MEM length (reference "
                           "--seeds-mxm-length)")
    seed.add_argument("--seeds-mxm-cache-prefix", default=None,
                      help="suffix-array cache file prefix (reference "
                           "--seeds-mxm-cache-prefix)")
    seed.add_argument("--seeds-file", default=None,
                      help="external seeds from a .gam file (reference -s)")
    seed.add_argument("--seeds-minimizer-length", type=int,
                      default=constants.DEFAULT_SEED_MINIMIZER_LENGTH)
    seed.add_argument("--seeds-minimizer-windowsize", type=int,
                      default=constants.DEFAULT_SEED_MINIMIZER_WINDOW)
    seed.add_argument("--seeds-minimizer-density", type=float,
                      default=constants.DEFAULT_SEED_MINIMIZER_DENSITY)
    seed.add_argument("--seeds-minimizer-ignore-frequent", type=float,
                      default=0.0002)
    ext = p.add_argument_group("extension")
    ext.add_argument("-b", "--bandwidth", type=int, default=None,
                     help="band slots per fragment (default 32 in CLC "
                          "mode, 48 in GA mode; max 127)")
    ext.add_argument("--polish-band", type=int, default=8,
                     help="polish band in 32-row words (default 8)")
    ext.add_argument("-B", "--ramp-bandwidth", type=int, default=0,
                     help="retry failing GA windows once with this wider "
                          "band before clipping (0 = off)")
    ext.add_argument("--X-drop", dest="x_drop", type=int, default=None,
                     help="end the extension when the X-score drops more "
                          "than arg below its max (GA mode)")
    ext.add_argument("--precise-clipping", type=float, default=None,
                     help="identity cutoff between correct and wrong "
                          "alignment ends (GA mode)")
    seed.add_argument("--seeds-clustersize", type=int, default=0,
                      help="discard seed clusters with fewer than arg "
                           "seeds (GA mode)")
    seed.add_argument("--seeds-extend-density", type=float, default=-1.0,
                      help="extend up to about the best (arg * sequence "
                           "length) seeds; -1 = default policy (GA mode)")
    seed.add_argument("--try-all-seeds", action="store_true",
                      help="extend every seed hit (GA mode)")
    sel = p.add_argument_group("alignment selection")
    for dest, flag, _ in _SELECTION:
        sel.add_argument(flag, dest=dest, action="store_true")
    sel.add_argument("--E-cutoff", dest="e_cutoff", type=float,
                     default=-1.0,
                     help="discard alignments with E-value > arg")
    sel.add_argument("--evalue-legacy-score", action="store_true",
                     help="use the reference binary's literal alignment "
                          "score sign for E-values")
    return p


def params_from_args(args) -> PipelineParams:
    mode = "ga" if args.no_colinear_chaining else args.mode
    if args.precise_clipping is not None \
            and not 0.0 < args.precise_clipping < 1.0:
        raise SystemExit("graphchainer-torch: error: --precise-clipping "
                         "must be in (0, 1)")
    if args.x_drop is not None and args.x_drop <= 1:
        raise SystemExit("graphchainer-torch: error: --X-drop score cutoff "
                         "must be > 1")
    if args.ramp_bandwidth and args.bandwidth \
            and args.ramp_bandwidth <= args.bandwidth:
        raise SystemExit("graphchainer-torch: error: ramp bandwidth must "
                         "be higher than default bandwidth")
    for flag, val in (("-b/--bandwidth", args.bandwidth),
                      ("-B/--ramp-bandwidth", args.ramp_bandwidth)):
        if val and not 0 < val <= 127:
            raise SystemExit(f"graphchainer-torch: error: {flag} must be "
                             "in [1, 127] (band slots are int8-indexed)")
    picked = [(flag, m) for dest, flag, m in _SELECTION
              if getattr(args, dest)]
    if len(picked) > 1:
        raise SystemExit("graphchainer-torch: error: only one alignment "
                         "selection method can be set ("
                         + ", ".join(f for f, _ in picked) + ")")
    if args.try_all_seeds and args.seeds_extend_density != -1.0:
        print("WARNING: --try-all-seeds and --seeds-extend-density are "
              "both set! --seeds-extend-density will be ignored",
              file=sys.stderr)
        args.seeds_extend_density = -1.0
    split_gap = args.colinear_split_gap
    if args.sampling_step is not None:
        split_gap = int(math.ceil(args.sampling_step
                                  * args.colinear_split_len))
    if split_gap is None:
        split_gap = constants.DEFAULT_COLINEAR_SPLIT_GAP
    cfg = ChainerConfig(
        colinear_split_len=args.colinear_split_len,
        colinear_split_gap=split_gap, colinear_gap=args.colinear_gap,
        band_slots=args.bandwidth or 32,
        polish_band_words=args.polish_band,
        seed_density=args.seeds_minimizer_density,
        compare_with_baseline=args.compare_baseline,
        fast_mode=args.fast_mode)
    params = PipelineParams(
        graph_file=args.graph, read_files=list(args.reads),
        batch_size=args.batch_size, mpc_index_file=args.mpc_index,
        minimizer_index_file=args.minimizer_index,
        seed_k=args.seeds_minimizer_length,
        seed_w=args.seeds_minimizer_windowsize,
        discard_fraction=args.seeds_minimizer_ignore_frequent,
        chainer=cfg, mode=mode,
        seed_file=args.seeds_file,
        mem_count=args.seeds_mem_count, mum_count=args.seeds_mum_count,
        mxm_length=args.seeds_mxm_length,
        mxm_cache_prefix=args.seeds_mxm_cache_prefix,
        num_processes=args.num_processes, process_id=args.process_id,
        coordinator=args.coordinator,
        cigar_match_mismatch=args.cigar_match_mismatch,
        device=args.device, verbose=args.verbose,
        x_drop=args.x_drop, precise_clipping=args.precise_clipping,
        ramp_band_slots=args.ramp_bandwidth, bandwidth=args.bandwidth,
        selection_method=picked[0][1] if picked else "GreedyLength",
        e_cutoff=args.e_cutoff,
        evalue_legacy_score=args.evalue_legacy_score,
        try_all_seeds=args.try_all_seeds,
        seed_extend_density=args.seeds_extend_density,
        min_cluster_size=args.seeds_clustersize,
        global_alignment=args.global_alignment,
        seedless_dp=args.seedless_dp,
        dp_restart_stride=args.dp_restart_stride,
        out_corrected=args.corrected_out,
        out_corrected_clipped=args.corrected_clipped_out,
        **({"inflight": max(args.threads, 1)}
           if args.threads is not None else {}))
    for out in args.alignments_out:
        if out.endswith(".gam"):
            params.out_gam = out
        elif out.endswith(".gaf"):
            params.out_gaf = out
        elif out.endswith(".json"):
            params.out_json = out
        else:
            raise SystemExit(f"unknown alignment output format: {out} "
                             "(use .gam/.gaf/.json)")
    return params


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.optimal_alignment:
        args.mode = "optimal"
    if args.no_colinear_chaining or args.seedless_dp:
        args.mode = "ga"
    if args.graph_statistics:
        g = load_graph(args.graph)
        for k, v in g.stats().items():
            print(f"{k}: {v}")
        return 0
    if args.generate_path:
        g = load_graph(args.graph)
        seq, nodes = generate_path(g, seed=args.generate_path_seed)
        with open(args.generate_path + ".fasta", "w") as f:
            f.write(">generated_path\n" + seq + "\n")
        with open(args.generate_path + ".nodes", "w") as f:
            f.write(" ".join(str(n) for n in nodes) + "\n")
        return 0
    if not args.reads or not (args.alignments_out or args.corrected_out
                              or args.corrected_clipped_out):
        print("error: need reads (-f) and an output (-a / --corrected-out)",
              file=sys.stderr)
        return 1
    print(count_lines(align_reads(params_from_args(args))))
    return 0


def count_lines(stats) -> str:
    """The run's statistics as the CLI prints them, one count a line."""
    return (f"Input reads: {stats.reads} ({stats.bp_in_reads}bp)\n"
            f"Reads with an alignment: {stats.reads_with_an_alignment}\n"
            f"Alignments: {stats.alignments} ({stats.bp_in_alignments}bp)")


if __name__ == "__main__":
    raise SystemExit(main())

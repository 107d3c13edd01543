"""Command-line interface of the PyTorch port (CLC mode).

  python -m graphchainer_torch -g graph.gfa -f reads.fa -a out.gaf \
      [-t N] [--batch-size N] [--verbose] [--device cuda]

The CLC flags are graphchainer_tpu's.  Flags of modes and outputs that
are not ported yet (GA and optimal modes, the GA rescue, MEM/file seeds,
multi-process runs, GAM/JSON and corrected-read outputs) are accepted by
the parser and rejected with a message that names them.
"""
from __future__ import annotations

import argparse
import math
import sys

from graphchainer_torch import constants
from graphchainer_torch.models.chainer import ChainerConfig
from graphchainer_torch.ops.polish_kernel import BAND_WORDS
from graphchainer_torch.pipeline import PipelineParams, align_reads

# (dest, flags, argparse kwargs, value meaning "not set")
_NOT_PORTED = [
    ("mode", ("--mode",), dict(choices=["clc", "ga", "optimal"],
                               default="clc"), "clc"),
    ("no_colinear_chaining", ("--no-colinear-chaining",),
     dict(action="store_true"), False),
    ("optimal_alignment", ("--optimal-alignment",),
     dict(action="store_true"), False),
    ("seedless_dp", ("--seedless-DP",), dict(action="store_true"), False),
    ("global_alignment", ("--global-alignment",),
     dict(action="store_true"), False),
    ("compare_baseline", ("--compare-baseline",),
     dict(action="store_true"), False),
    ("seeds_file", ("--seeds-file",), dict(default=None), None),
    ("seeds_mem_count", ("--seeds-mem-count",), dict(type=int, default=0),
     0),
    ("seeds_mum_count", ("--seeds-mum-count",), dict(type=int, default=0),
     0),
    ("num_processes", ("--num-processes",), dict(type=int, default=1), 1),
    ("ramp_bandwidth", ("-B", "--ramp-bandwidth"),
     dict(type=int, default=0), 0),
    ("x_drop", ("--X-drop",), dict(type=int, default=None), None),
    ("precise_clipping", ("--precise-clipping",),
     dict(type=float, default=None), None),
    ("e_cutoff", ("--E-cutoff",), dict(type=float, default=-1.0), -1.0),
    ("corrected_out", ("--corrected-out",), dict(default=None), None),
    ("corrected_clipped_out", ("--corrected-clipped-out",),
     dict(default=None), None),
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphchainer-torch",
        description="Long-read to variation-graph aligner with co-linear "
                    "chaining (PyTorch / CUDA port of graphchainer-tpu, "
                    "CLC mode)")
    m = p.add_argument_group("mandatory")
    m.add_argument("-g", "--graph", required=True,
                   help="input graph (.gfa / .gfa.gz)")
    m.add_argument("-f", "--reads", action="append", default=[],
                   help="input reads (fasta or fastq, optionally gzipped); "
                        "may repeat")
    m.add_argument("-a", "--alignments-out", action="append", default=[],
                   help="output file (.gaf)")
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
    gen = p.add_argument_group("general")
    gen.add_argument("--device", default="cuda",
                     help="torch device: cuda runs the CUDA kernels, cpu "
                          "their plain torch versions (default cuda)")
    gen.add_argument("-t", "--threads", type=int, default=None,
                     help="batches aligned concurrently (default 3)")
    gen.add_argument("--verbose", action="store_true")
    gen.add_argument("--batch-size", type=int, default=64)
    gen.add_argument("--mpc-index", default=None)
    gen.add_argument("--minimizer-index", default=None)
    gen.add_argument("--cigar-match-mismatch", action="store_true")
    seed = p.add_argument_group("seeding")
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
                     help="band slots per fragment (default 32, max 127)")
    ext.add_argument("--polish-band", type=int, default=8,
                     help="polish band in 32-row words (default 8)")
    np_ = p.add_argument_group("not ported yet (rejected when set)")
    for dest, flags, kw, _ in _NOT_PORTED:
        np_.add_argument(*flags, dest=dest, **kw)
    return p


def params_from_args(args) -> PipelineParams:
    unported = [flags[-1] for dest, flags, _, unset in _NOT_PORTED
                if getattr(args, dest) != unset]
    if unported:
        raise SystemExit("graphchainer-torch: error: not ported to the "
                         "PyTorch package yet: " + ", ".join(unported))
    if args.polish_band not in BAND_WORDS:
        raise SystemExit("graphchainer-torch: error: --polish-band must be "
                         f"one of {BAND_WORDS} (the polish kernel's bands)")
    if args.bandwidth and not 0 < args.bandwidth <= 127:
        raise SystemExit("graphchainer-torch: error: -b/--bandwidth must "
                         "be in [1, 127] (band slots are int8-indexed)")
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
        fast_mode=args.fast_mode)
    params = PipelineParams(
        graph_file=args.graph, read_files=list(args.reads),
        batch_size=args.batch_size, mpc_index_file=args.mpc_index,
        minimizer_index_file=args.minimizer_index,
        seed_k=args.seeds_minimizer_length,
        seed_w=args.seeds_minimizer_windowsize,
        discard_fraction=args.seeds_minimizer_ignore_frequent,
        chainer=cfg, cigar_match_mismatch=args.cigar_match_mismatch,
        device=args.device, verbose=args.verbose,
        **({"inflight": max(args.threads, 1)}
           if args.threads is not None else {}))
    for out in args.alignments_out:
        if out.endswith(".gaf"):
            params.out_gaf = out
        elif out.endswith((".gam", ".json")):
            raise SystemExit(f"graphchainer-torch: error: {out}: GAM / "
                             "JSON output is not ported yet (use .gaf)")
        else:
            raise SystemExit(f"unknown alignment output format: {out} "
                             "(use .gaf)")
    return params


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.reads or not args.alignments_out:
        print("error: need reads (-f) and an output (-a)", file=sys.stderr)
        return 1
    stats = align_reads(params_from_args(args))
    print(f"Input reads: {stats.reads} ({stats.bp_in_reads}bp)")
    print(f"Reads with an alignment: {stats.reads_with_an_alignment}")
    print(f"Alignments: {stats.alignments} ({stats.bp_in_alignments}bp)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

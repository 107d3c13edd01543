"""Chromosome-scale and sustained runs of the port.

  python -m graphchainer_torch.scale chromosome [--bp 20000000] [--reads N]
      [--read-len L] [--batch B] [--error-rate E] [--workers W]
      [--device cuda] [--ref-binary PATH [--ref-reads N]]
  python -m graphchainer_torch.scale sustained [--bp 40000000]
      [--reads 10000] [--steps 1,2,3] [--batch 128] [--workdir DIR]
      [--out FILE] [--device cuda]

chromosome is the counterpart of scripts/scale_test.py: the bench
generator's graph at --bp backbone bases (both strands in the graph), its
MPC and minimizer index (k=15, w=10), each build timed, then --reads reads
of ~--read-len bp through ChainerModel.align_batch in --workers threads,
one warm pass and two timed passes.  One JSON line: the build times,
graph.stats(), host RSS, the device's peak allocation, reads/s of each
pass, accuracy, the last pass's stage seconds and each pass's kernel
launches.

sustained is the counterpart of scripts/sustained_test.py: its GFA and
FASTA (the sustained mix of ~1.5, ~3 and ~9 kbp reads, 50/35/15%) in
--workdir, then python -m graphchainer_torch on them once per sampling
step, with GAM and GAF outputs and cached MPC and minimizer indices.  Per
step: wall, rc, the child's own max RSS, the GAM and GAF bytes, the CLI's
count lines, its stage seconds (--verbose; the graph's load and indices
included) and kernel launches, and the card's peak memory and mean
utilization.gpu while the child ran, over its whole life and after its
set-up (polled with nvidia-smi each second: the child's memory where
nvidia-smi lists its processes, and the whole card's).  The JSON goes
to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

COUNT_KEYS = ("Input reads", "Reads with an alignment", "Alignments")


def read_counts(text: str) -> dict:
    """The CLI's count lines in text as {input_reads, reads_with_an_alignment,
    alignments}: each value the text after its colon."""
    out = {}
    for line in text.splitlines():
        key, sep, value = line.strip().partition(":")
        if sep and key in COUNT_KEYS:
            out[key.lower().replace(" ", "_")] = value.strip()
    return out


def stage_seconds(text: str) -> dict:
    """The stage table of the CLI's --verbose output (utils.timers.report:
    "  name   1.23s  (...)" lines after "Per-stage time") as {name:
    seconds}; the graph's load and its indices are the stages load_graph
    and index."""
    out, on = {}, False
    for line in text.splitlines():
        if line.startswith("Per-stage time"):
            on = True
        elif on:
            parts = line.split()
            if len(parts) < 2 or not parts[1].endswith("s"):
                break
            out[parts[0]] = float(parts[1][:-1])
    return out


def kernel_launches(text: str) -> dict:
    """The CLI's --verbose "Kernel launches: name n, ..." line as {name:
    n} (empty where no kernel launched)."""
    for line in text.splitlines():
        if line.startswith("Kernel launches:"):
            return {k: int(v) for k, v in (
                x.split() for x in line.partition(":")[2].split(","))}
    return {}


def rss_gb() -> float:
    """This process's peak resident set, GB (ru_maxrss is in KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def nvidia_smi(*args: str) -> str:
    """nvidia-smi's output for args; "" where it is missing or fails."""
    try:
        r = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip() if r.returncode == 0 else ""


def card_name() -> str:
    """Each card's name and power limit, as nvidia-smi's csv gives them."""
    return nvidia_smi("--query-gpu=name,power.limit", "--format=csv,noheader")


def smi_rows(kind: str, query: str) -> list:
    """nvidia-smi --query-KIND=QUERY as rows of numbers without units,
    each a list of strings."""
    return [[x.strip() for x in line.split(",")] for line in nvidia_smi(
        f"--query-{kind}={query}", "--format=csv,noheader,nounits"
    ).splitlines() if line.strip()]


# ---------------------------------------------------------------- chromosome
def run_reference(bg, reads, binary, threads=1):
    """The reference binary on the same graph and reads (scale_test.py's
    protocol): its align-only reads/s, the whole run less a 1-read run's
    start-up."""
    from graphchainer_torch.workload import _write_gfa, write_fasta
    out = {"binary": binary, "threads": threads}
    with tempfile.TemporaryDirectory() as td:
        gfa = os.path.join(td, "g.gfa")
        _write_gfa(bg, gfa)
        fa1 = os.path.join(td, "one.fa")
        write_fasta(reads[:1], fa1)
        fa = os.path.join(td, "reads.fa")
        write_fasta(reads, fa)
        walls = []
        for f, o in ((fa1, "o1.gam"), (fa, "o.gam")):
            t0 = time.time()
            r = subprocess.run([binary, "-g", gfa, "-f", f, "-a",
                                os.path.join(td, o), "-t", str(threads)],
                               capture_output=True, text=True)
            walls.append(time.time() - t0)
            if r.returncode != 0:
                out["error"] = (r.stdout + r.stderr)[-500:]
                return out
        align_s = max(walls[1] - walls[0], 1e-3)
        out.update(startup_s=walls[0], full_wall_s=walls[1],
                   align_s=align_s, n_reads=len(reads),
                   reads_per_s=len(reads) / align_s)
    return out


def default_workers() -> int:
    """bench.py's in-flight batches: cores + 2, clamped to 4..8."""
    try:
        ncores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        ncores = os.cpu_count() or 4
    return max(4, min(8, ncores + 2))


def chromosome(args) -> dict:
    import torch

    from graphchainer_torch.graph.mpc import build_mpc
    from graphchainer_torch.graph.simulate import generate_path, simulate_reads
    from graphchainer_torch.index.minimizer import build_index
    from graphchainer_torch.models.chainer import ChainerConfig, ChainerModel
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.utils import timers
    from graphchainer_torch.workload import scale_graph

    cuda = torch.device(args.device).type == "cuda"
    out = {"scale_bp": args.bp, "device": args.device}
    if cuda:
        out["card"] = card_name()
        out["device_name"] = torch.cuda.get_device_name(0)
    bg, g, out["gfa_synthesis_s"], out["graph_build_s"] = scale_graph(args.bp)
    out["graph"] = g.stats()
    t = time.perf_counter()
    mpc = build_mpc(g)
    out["mpc_build_s"] = time.perf_counter() - t
    out["mpc_paths"] = int(len(mpc.path_comp))
    t = time.perf_counter()
    idx = build_index(g, k=15, w=10)
    out["minimizer_build_s"] = time.perf_counter() - t
    out["rss_after_index_gb"] = rss_gb()

    model = ChainerModel(g, mpc, idx, ChainerConfig(), device=args.device)
    path_seq, _ = generate_path(g, seed=3)
    reads = simulate_reads(path_seq, args.reads, args.read_len, seed=11,
                           error_rate=args.error_rate,
                           len_std=args.read_len // 10)
    chunks = [reads[lo:lo + args.batch]
              for lo in range(0, len(reads), args.batch)]
    out["workers"] = args.workers = args.workers or default_workers()

    def one_pass():
        aligned, scores = 0, []
        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            for chunk, alns in zip(chunks,
                                   pool.map(model.align_batch, chunks)):
                for (_, seq), a in zip(chunk, alns):
                    if not a.failed:
                        aligned += 1
                        scores.append(a.score / max(len(seq), 1))
        if cuda:
            torch.cuda.synchronize()
        return aligned, scores

    t = time.perf_counter()
    one_pass()                     # warm: builds the kernels, first uploads
    out["warmup_s"] = time.perf_counter() - t
    walls, launches = [], []
    for _ in range(2):
        timers.reset()             # the stage report covers the last pass
        _cuda.reset_launches()
        t = time.perf_counter()
        aligned, scores = one_pass()
        walls.append(time.perf_counter() - t)
        launches.append(_cuda.launches())
    n = len(reads)
    out.update(
        reads=n, pass_walls_s=walls, align_wall_s=min(walls),
        reads_per_s=n / min(walls),
        reads_per_s_by_pass=[n / w for w in walls],
        aligned_fraction=aligned / max(n, 1),
        mean_norm_edit_distance=(float(np.mean(scores)) if scores
                                 else None),
        rss_peak_gb=rss_gb(),
        device_peak_allocated_gb=(torch.cuda.max_memory_allocated() / 1e9
                                  if cuda else None),
        stage_seconds={k: v[0] for k, v in timers.snapshot().items()},
        counters=timers.counters(), launches_by_pass=launches)
    if args.ref_binary:
        if os.path.exists(args.ref_binary):
            ref = run_reference(bg, reads[:args.ref_reads or n],
                                args.ref_binary)
            out["reference"] = ref
            if "reads_per_s" in ref:
                out["vs_baseline_at_scale"] = (out["reads_per_s"]
                                               / ref["reads_per_s"])
        else:
            out["reference"] = {"error": "binary not found: "
                                         f"{args.ref_binary}"}
    return out


# ---------------------------------------------------------------- sustained
def _poll_card(pid: int, peak: dict) -> None:
    """One nvidia-smi reading into peak: the child's used memory (where
    nvidia-smi lists it) and the whole card's, MiB; the card's
    utilization.gpu (the share of the last sample period in which a
    kernel ran), appended to peak["busy"] with the seconds since the
    child started."""
    for row in smi_rows("compute-apps", "pid,used_memory"):
        if len(row) == 2 and row[0] == str(pid) and row[1].isdigit():
            peak["child"] = max(peak["child"] or 0, int(row[1]))
    for row in smi_rows("gpu", "memory.used,utilization.gpu")[:1]:
        if len(row) == 2 and row[0].isdigit() and row[1].isdigit():
            peak["card"] = max(peak["card"] or 0, int(row[0]))
            peak["busy"].append((time.perf_counter() - peak["t0"],
                                 int(row[1])))


def run_child(cmd, env, log_path: str, poll_s: float = 1.0):
    """cmd as a child process (output to log_path), the card polled every
    poll_s while it runs: (rc, wall s, the child's own max RSS in GB,
    {child, card: peak device MiB, busy: (seconds, utilization.gpu)
    samples}, its output)."""
    peak = {"child": None, "card": None, "busy": []}
    with open(log_path, "w") as log:
        t0 = peak["t0"] = time.perf_counter()
        p = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                             env=env)
        while True:
            pid, status, ru = os.wait4(p.pid, os.WNOHANG)
            if pid:
                break
            _poll_card(p.pid, peak)
            time.sleep(poll_s)
        wall = time.perf_counter() - t0
    p.returncode = os.waitstatus_to_exitcode(status)
    with open(log_path) as fh:
        text = fh.read()
    return p.returncode, wall, ru.ru_maxrss / 1e6, peak, text


def sustained(args) -> dict:
    from graphchainer_torch.workload import mix_counts, sustained_workload
    os.makedirs(args.workdir, exist_ok=True)
    prep = {"scale_bp": args.bp, "n_reads": args.reads,
            "counts": list(mix_counts(args.reads))}
    gfa = os.path.join(args.workdir, "g.gfa")
    fa = os.path.join(args.workdir, "reads.fa")
    if not (os.path.exists(gfa) and os.path.exists(fa)):
        prep["prep_s"] = sustained_workload(args.workdir, args.bp,
                                            mix_counts(args.reads))[2]
    results = {"prep": prep, "device": args.device, "card": card_name(),
               "sweep": []}
    env = dict(os.environ)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in [env.get("PYTHONPATH")] if p])
    mpc_npz = os.path.join(args.workdir, "mpc.npz")
    min_npz = os.path.join(args.workdir, "minimizer.npz")
    for step in [int(s) for s in args.steps.split(",")]:
        gam = os.path.join(args.workdir, f"out_step{step}.gam")
        gaf = os.path.join(args.workdir, f"out_step{step}.gaf")
        cmd = [sys.executable, "-m", "graphchainer_torch",
               "-g", gfa, "-f", fa, "-a", gam, "-a", gaf,
               "--sampling-step", str(step), "--batch-size", str(args.batch),
               "--mpc-index", mpc_npz, "--minimizer-index", min_npz,
               "--device", args.device, "--verbose"]
        rc, wall, maxrss, peak, text = run_child(
            cmd, env, os.path.join(args.workdir, f"step{step}.log"))
        stages = stage_seconds(text)
        setup = stages.get("load_graph", 0.0) + stages.get("index", 0.0)
        busy = [b for _, b in peak["busy"]]
        busy_aligning = [b for t, b in peak["busy"] if t > setup]
        row = {"sampling_step": step, "wall_s": wall, "rc": rc,
               "child_maxrss_gb": maxrss,
               "child_peak_device_mib": peak["child"],
               "card_peak_used_mib": peak["card"],
               "card_busy_percent_mean": (float(np.mean(busy))
                                          if busy else None),
               "card_busy_percent_mean_aligning": (
                   float(np.mean(busy_aligning)) if busy_aligning else None),
               "card_busy_samples": len(busy),
               "setup_s": setup, "stage_seconds": stages,
               "launches": kernel_launches(text),
               "gam_bytes": os.path.getsize(gam)
               if os.path.exists(gam) else 0,
               "gaf_bytes": os.path.getsize(gaf)
               if os.path.exists(gaf) else 0}
        row.update(read_counts(text))
        if rc != 0:
            row["output_tail"] = text[-2000:]
        results["sweep"].append(row)
        print(json.dumps(row), flush=True)
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m graphchainer_torch.scale",
        description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="run", required=True)
    c = sub.add_parser("chromosome", help="scripts/scale_test.py's run")
    c.add_argument("--bp", type=int, default=20_000_000,
                   help="backbone bases of the synthetic graph")
    c.add_argument("--reads", type=int, default=192)
    c.add_argument("--read-len", type=int, default=3000)
    c.add_argument("--batch", type=int, default=64)
    c.add_argument("--error-rate", type=float, default=0.10)
    c.add_argument("--workers", type=int, default=0,
                   help="in-flight batches (0 = cores + 2, clamped 4..8)")
    c.add_argument("--ref-binary", default=None,
                   help="reference GraphChainer binary: also measure it "
                        "on the same graph and reads (one thread)")
    c.add_argument("--ref-reads", type=int, default=0,
                   help="reference read subsample (0 = all --reads)")
    c.add_argument("--device", default="cuda")
    s = sub.add_parser("sustained", help="scripts/sustained_test.py's run")
    s.add_argument("--bp", type=int, default=40_000_000)
    s.add_argument("--reads", type=int, default=10_000)
    s.add_argument("--steps", default="1,2,3")
    s.add_argument("--batch", type=int, default=128)
    s.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "graphchainer_torch_sustained"))
    s.add_argument("--out", default=None,
                   help="the JSON (default: WORKDIR/sustained.json)")
    s.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.run == "chromosome":
        print(json.dumps(chromosome(args)), flush=True)
        return 0
    out = args.out or os.path.join(args.workdir, "sustained.json")
    results = sustained(args)
    with open(out, "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"wrote {out}", flush=True)
    return 0 if all(r["rc"] == 0 for r in results["sweep"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The benchmark of graphchainer_torch: one run of one cell.

  python3 gcbench/run.py --workload CELL --seed N --seconds S --trace 0|1

A cell (gcbench/workloads/CELL.json) names a configuration
(gcbench/configs/, a graph and the aligner's flags) and a traffic mix
(gcbench/traffic/).  The run:

1. makes the configuration's graph, GFA and truth walk from its fixed
   seed into gcbench/cache/<config>/ if they are not there (the first run
   of a cell in a checkout; that run also lets the program build the MPC
   and minimizer index files there);
2. starts the feeder (gcbench/traffic.py), which makes a pool of the
   mix's reads from --seed before the program starts (that time is
   printed apart and is not set-up), then writes them as FASTA into a
   named pipe in TMPDIR;
3. runs the program's own pipeline on them,
   graphchainer_torch.pipeline.align_reads, with the parameters its CLI
   builds from the command line a user would type (the GFA, the index
   files, the pipe of reads, a second pipe for the GAF);
4. reads the GAF lines as they arrive: a batch of reads is complete when
   the line of its last read, or of any later read, has arrived (lines
   come in read order; an unaligned read has none).  set-up ends when
   the warm-up batch (batch 0) is complete; the window then runs to the
   first batch completed --seconds after it;
5. closes the feed, lets the pipeline finish, checks a sample of the
   window's alignments against the plain reference (gcbench/reference/),
   and prints the metrics of BENCHMARK.json as one JSON line, unless a
   module of JAX or of the JAX package has been loaded by then.

--trace 1 also records the program's stage spans and the fragment DP's
launches from here (wrappers around the program's functions) and traces
the card with torch.profiler over a stretch of the window; it prints the
per-layer metrics instead of the end-to-end ones.

Exit codes: 0 with a result line; 1 when the run failed (no result);
3 when the card the cell asks for is missing (no result).
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import atexit  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

GCBENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(GCBENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from gcbench import graphs, traffic  # noqa: E402
from gcbench.reference import check as ref  # noqa: E402

CACHE = os.path.join(GCBENCH, "cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "graphchainer_tpu")
SETUP_LIMIT_S = 1100.0
DRAIN_LIMIT_S = 600.0
TRACE_STRETCH_S = 10.0
POOL_SLACK_S = 20.0
POOL_LIMIT_S = 120.0


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or 0 if unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = T_IMPORT - process_age_s()


def cpu_snapshot():
    """(perf_counter, this process's CPU seconds, the host's /proc/stat
    cpu jiffies: user nice system idle iowait irq softirq steal, or
    None)."""
    t, now = os.times(), time.perf_counter()
    try:
        with open("/proc/stat") as f:
            host = [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        host = None
    return now, t.user + t.system, host


def cpu_readings(a, b) -> dict:
    """CPU use between two snapshots: this process's cores busy on
    average, and the host's busy and stolen shares of its cores."""
    out = {"process_cores": (b[1] - a[1]) / max(b[0] - a[0], 1e-9)}
    if a[2] is not None and b[2] is not None:
        d = [y - x for x, y in zip(a[2], b[2])]
        total = max(sum(d), 1)
        out["host_busy_share"] = 1.0 - (d[3] + d[4]) / total
        out["host_steal_share"] = d[7] / total
    return out


def fail(msg: str, code: int = 1):
    print(f"gcbench: {msg}", file=sys.stderr)
    sys.exit(code)


def find(dirs, kind: str, name: str, ext: str = ".json") -> str:
    for d in dirs:
        p = os.path.join(d, kind, name + ext)
        if os.path.exists(p):
            return p
    fail(f"no {kind} file named {name}{ext}")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------- data cache
def ensure_data(cfg: dict) -> dict:
    """The configuration's GFA and truth walk in gcbench/cache/<name>/,
    made if missing (files written under temporary names, then moved, the
    meta file last).  Returns the paths and whether this run made them."""
    d = os.path.join(CACHE, cfg["name"])
    os.makedirs(d, exist_ok=True)
    paths = {k: os.path.join(d, v) for k, v in
             (("gfa", "graph.gfa"), ("truth", "truth.npy"),
              ("meta", "meta.json"), ("mpc", "mpc.npz"),
              ("minimizer", "minimizer.npz"))}
    made = not os.path.exists(paths["meta"])
    if made:
        t0 = time.perf_counter()
        g = graphs.build(cfg)
        graphs.write_gfa(g, paths["gfa"] + ".part")
        walk = graphs.truth_walk(g, cfg["truth_seed"])
        with open(paths["truth"] + ".part", "wb") as f:
            np.save(f, walk)
        os.replace(paths["gfa"] + ".part", paths["gfa"])
        os.replace(paths["truth"] + ".part", paths["truth"])
        meta = {"segments": len(g.names), "links": len(g.links),
                "graph_bp": int(sum(len(s) for s in g.seqs)),
                "truth_bp": int(len(walk)),
                "seconds": time.perf_counter() - t0}
        with open(paths["meta"] + ".part", "w") as f:
            json.dump(meta, f)
        os.replace(paths["meta"] + ".part", paths["meta"])
    paths["made"] = made
    return paths


def index_paths(paths: dict):
    """(mpc, minimizer) index files to hand the program: the cached ones,
    or partial names it builds and saves into, moved into place after a
    clean run."""
    out = []
    for k in ("mpc", "minimizer"):
        final = paths[k]
        if os.path.exists(final):
            out.append((final, None))
        else:
            part = final[:-len(".npz")] + ".partial.npz"
            with contextlib.suppress(FileNotFoundError):
                os.remove(part)
            out.append((part, final))
    return out


# --------------------------------------------------------------- GAF tap
class GafTap:
    """Reads the GAF pipe, times each line, and marks batches complete."""

    def __init__(self, path: str, batch: int, keep):
        self.path, self.batch, self.keep = path, batch, keep
        self.cond = threading.Condition()
        self.progress = 0              # every read below this is done
        self.batch_done: list = []     # completion time of batch k
        self.rows: list = []           # (idx, t, qlen, qstart, qend, nm,
                                       #  path span, block)
        self.kept: dict = {}           # idx -> GAF line
        self.longest: dict = {}        # batch -> (qlen, idx)
        self.eof = False
        self.error = None

    def run(self):
        try:
            with open(self.path, "rb") as f:
                for line in f:
                    t = time.perf_counter()
                    p = line.split(b"\t", 12)
                    if len(p) < 13 or not p[0].startswith(b"r"):
                        continue
                    idx = int(p[0][1:])
                    qlen = int(p[1])
                    nm = int(p[12].split(b"\t", 1)[0][5:])
                    self.rows.append((idx, t, qlen, int(p[2]), int(p[3]), nm,
                                      int(p[8]) - int(p[7]), int(p[10])))
                    b = idx // self.batch
                    if self.keep(idx) or qlen > self.longest.get(b, (0,))[0]:
                        self.kept[idx] = line
                        if qlen > self.longest.get(b, (0,))[0]:
                            self.longest[b] = (qlen, idx)
                    if idx + 1 > self.progress:
                        with self.cond:
                            self.progress = idx + 1
                            while (len(self.batch_done) + 1) * self.batch \
                                    <= self.progress:
                                self.batch_done.append(t)
                            self.cond.notify_all()
        except Exception:                      # noqa: BLE001
            self.error = traceback.format_exc()
        finally:
            with self.cond:
                self.eof = True
                self.cond.notify_all()


# ---------------------------------------------------------------- tracing
class SpanLog:
    """Wraps the program's timers.stage to keep each span's interval (the
    thread, name, start and end in perf_counter seconds)."""

    def __init__(self, timers):
        self.spans: list = []
        self._timers, self._orig = timers, timers.stage
        log = self.spans

        @contextlib.contextmanager
        def stage(name, items=0):
            t0 = time.perf_counter()
            try:
                with self._orig(name, items):
                    yield
            finally:
                log.append((threading.get_ident(), name, t0,
                            time.perf_counter()))
        timers.stage = stage

    def restore(self):
        self._timers.stage = self._orig


class LaunchLog:
    """Wraps the fragment DP's kernel entries to keep each launch's
    shapes (no device work, no synchronisation)."""

    def __init__(self, frag_kernel):
        self.launches: list = []
        log = self.launches
        fresh, carried = (frag_kernel.frag_core_cuda,
                          frag_kernel.frag_core_carried_cuda)
        self._mod, self._orig = frag_kernel, (fresh, carried)

        def fresh_w(node_eq, node_len, band_nodes, band_in, *a, **kw):
            F, B = band_nodes.shape
            log.append({"kind": "fresh", "t": time.perf_counter(), "F": F,
                        "B": B, "S": kw["S"], "max_in": kw["max_in"]})
            return fresh(node_eq, node_len, band_nodes, band_in, *a, **kw)

        def carried_w(node_eq, node_len, band_nodes, band_in, band_level,
                      seed_shift, *a, **kw):
            F, B = band_nodes.shape
            log.append({"kind": "carried", "t": time.perf_counter(),
                        "F": F, "B": B, "S": kw["S"],
                        "max_in": kw["max_in"],
                        "per_slot": seed_shift.dim() == 2,
                        "want_state": bool(kw.get("want_state")),
                        "want_xcells": bool(kw.get("want_xcells"))})
            return carried(node_eq, node_len, band_nodes, band_in,
                           band_level, seed_shift, *a, **kw)
        frag_kernel.frag_core_cuda = fresh_w
        frag_kernel.frag_core_carried_cuda = carried_w

    def restore(self):
        (self._mod.frag_core_cuda,
         self._mod.frag_core_carried_cuda) = self._orig


def device_events(prof):
    """[(name, start_ns, duration_ns)] of the device's operations in a
    finished torch.profiler session (its Kineto events; failing those, its
    exported trace)."""
    try:
        from torch.autograd import DeviceType
        out = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            out.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
        return out
    except (AttributeError, TypeError):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = load_json(path)
        finally:
            os.remove(path)
        return [(e["name"], int(e["ts"] * 1000), int(e["dur"] * 1000))
                for e in trace.get("traceEvents", [])
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def union_busy(events):
    """(busy ns, [(gap start ns, gap ns)]) of the union of the intervals."""
    iv = sorted((s, s + d) for _, s, d in events)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def name_gap(spans, t_mid: float) -> str:
    """The program's stage spans open on the host at t_mid (innermost of
    each thread), or "none"."""
    open_ = {}
    for tid, name, t0, t1 in spans:
        if t0 <= t_mid <= t1:
            prev = open_.get(tid)
            if prev is None or t0 > prev[0]:
                open_[tid] = (t0, name)
    names = sorted({n for _, n in open_.values()})
    return "+".join(names) if names else "none"


def trace_breakdown(events, spans, clock_offset_s):
    """The breakdown's device_ops (name, seconds) and idle_gaps (host
    stages open, seconds), ten each."""
    by_name: dict = {}
    for name, _, d in events:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    _, gaps = union_busy(events)
    gaps = sorted(gaps, key=lambda g: -g[1])[:10]
    idle = []
    for s, d in gaps:
        label = "unaligned clocks"
        if clock_offset_s is not None:
            label = name_gap(spans, (s + d / 2) / 1e9 + clock_offset_s)
        idle.append([label, d / 1e9])
    return ([[n[:120], v / 1e9] for n, v in ops], idle)


def clock_offset(events, marks):
    """Seconds to add to a device timestamp (ns / 1e9) to reach
    perf_counter, from the host clock the profiler's timestamps follow
    (the one its first event lies within a minute of), or None."""
    if not events:
        return None
    first = min(s for _, s, _ in events) / 1e9
    for wall, perf in marks:
        if abs(first - wall) < 60.0:
            return perf - wall
    return None


# ---------------------------------------------------------------- readers
def load_reader(dirs, name: str):
    path = find(dirs, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(f"gcbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool):
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


# ------------------------------------------------------------------ check
def keep_rule(seed: int, every: int):
    salt = int(seed) % 1000003

    def keep(idx: int) -> bool:
        return (idx * 2654435761 + salt) % 4294967291 % every == 0
    return keep


def run_check(paths, mix, seed, truth, reads_by_idx, truths_by_idx,
              window_idx, tap, limits, failed, attempted, workers: int):
    """The compared numbers, each {"value", "limit"}, and the readings."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    cand = [i for i in window_idx if i in tap.kept]
    order = [cand[j] for j in rng.permutation(len(cand))]
    longest = max((tap.longest[b] for b in
                   {i // tap.batch for i in window_idx} if b in tap.longest),
                  default=None)
    if longest is not None and longest[1] in tap.kept:
        order = [longest[1]] + [i for i in order if i != longest[1]]
    budget = float(mix["check"]["kbp2"])
    sample, cost = [], 0.0
    for i in order:
        c = (len(reads_by_idx[i]) / 1000.0) ** 2
        if sample and cost + c > budget:
            continue
        sample.append(i)
        cost += c
    g = ref.RefGraph(paths["gfa"])
    faults, jobs, meta = [], [], []
    for i in sample:
        read = reads_by_idx[i]
        rec = ref.parse_gaf(tap.kept[i])
        fault = ref.check_line(g, rec, read)
        if fault:
            faults.append(f"r{i}: {fault}")
            continue
        start, L, rev = (int(x) for x in truths_by_idx[i])
        lo, hi = max(start - 32, 0), min(start + L + 32, len(truth))
        region = traffic._LETTERS[truth[lo:hi]].tobytes()
        if rev:
            region = ref.revcomp(region)
        steps = ref._NODE.findall(rec["path"])
        jobs.append((read, g.spell(steps)))
        jobs.append((read, region))
        meta.append((i, len(read)))
    del g
    if jobs:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(workers) as pool:
            eds = pool.starmap(ref.myers_infix, jobs, chunksize=1)
    else:
        eds = []
    excess = [(eds[2 * k] - eds[2 * k + 1]) / L
              for k, (_, L) in enumerate(meta)]
    extra = sum(eds[2 * k] - eds[2 * k + 1] for k in range(len(meta)))
    numbers = {"bad_lines": len(faults),
               "unaligned_share": failed / max(attempted, 1),
               # edits above the truth walk's, per base of the sample
               "excess_ed": (extra / sum(L for _, L in meta) if meta
                             else 1.0)}
    readings = {"sample_reads": len(sample),
                "sample_kbp": sum(len(reads_by_idx[i]) for i in sample)
                / 1000.0,
                "worst_excess_ed": max(excess) if excess else None,
                "faults": faults[:5]}
    if excess:
        ex = np.asarray(excess)
        readings.update(
            excess_mean=float(ex.mean()),
            excess_median=float(np.median(ex)),
            excess_p90=float(np.quantile(ex, 0.9)),
            share_over_2pct=float((ex > 0.02).mean()),
            share_over_5pct=float((ex > 0.05).mean()))
    checked = {k: {"value": numbers[k], "limit": limits[k]}
               for k in limits}
    return checked, readings


# -------------------------------------------------------------------- run
def main(argv=None, *, dirs=None, device="cuda", require_card=True,
         control=False, out=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = out or sys.stdout
    dirs = dirs or [GCBENCH]
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = load_json(find(dirs, "workloads", args.workload))
    cfg = load_json(find(dirs, "configs", cell["config"]))
    mix_path = find(dirs, "traffic", cell["traffic"])
    mix = traffic.load_mix(mix_path)
    batch = int(mix["batch_size"])
    trace = bool(args.trace)

    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    import torch
    on_card = device.startswith("cuda")
    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        fail(f"the cell needs {cell['chips']} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
             3)

    paths = ensure_data(cfg)
    idx_files = index_paths(paths)
    tmp = tempfile.mkdtemp(prefix="gcbench-")
    reads_fifo = os.path.join(tmp, "reads.fa")
    gaf_fifo = os.path.join(tmp, "out.gaf")
    os.mkfifo(reads_fifo)
    os.mkfifo(gaf_fifo)
    chunks = traffic.pool_chunks(
        mix, args.seconds + trace * TRACE_STRETCH_S + POOL_SLACK_S)
    t_pool = time.perf_counter()
    feeder = subprocess.Popen(
        [sys.executable, os.path.join(GCBENCH, "traffic.py"), "--mix",
         mix_path, "--seed", str(args.seed), "--truth", paths["truth"],
         "--out", reads_fifo, "--chunks", str(chunks)],
        stdout=subprocess.PIPE)
    # whatever ends this process ends the feeder too
    atexit.register(lambda: feeder.poll() is None and feeder.kill())
    ready = threading.Timer(POOL_LIMIT_S, feeder.kill)
    ready.start()
    said = feeder.stdout.readline()
    ready.cancel()
    if said.strip() != b"ready":
        fail("the feeder did not make its pool of reads")
    pool_s = time.perf_counter() - t_pool
    print(f"gcbench: a pool of {chunks} batches of reads made in "
          f"{pool_s:.3f} s before the program starts (not set-up)",
          file=sys.stderr)

    from graphchainer_torch import cli
    from graphchainer_torch.ops import frag_kernel
    from graphchainer_torch.pipeline import align_reads
    from graphchainer_torch.utils import timers
    tap = GafTap(gaf_fifo, batch, keep_rule(args.seed,
                                            int(mix["check"]["keep_every"])))
    tap_thread = threading.Thread(target=tap.run, daemon=True)
    tap_thread.start()

    argv_port = (["-g", paths["gfa"], "-f", reads_fifo, "-a", gaf_fifo,
                  "--mpc-index", idx_files[0][0],
                  "--minimizer-index", idx_files[1][0],
                  "--device", device, "--batch-size", str(batch),
                  "-t", str(int(mix["inflight"]))] + list(cfg["port_flags"]))
    params = cli.params_from_args(cli.build_parser().parse_args(argv_port))
    if control:
        params.chainer = dataclasses.replace(params.chainer,
                                             **cfg["control"]["chainer"])
    spans = launches = None
    if trace:
        spans = SpanLog(timers)
        launches = LaunchLog(frag_kernel)

    errors = []

    def pipeline():
        try:
            align_reads(params)
        except BaseException:                  # noqa: BLE001
            errors.append(traceback.format_exc())
            # unblock the tap if the GAF pipe was never opened for writing
            with contextlib.suppress(OSError):
                os.close(os.open(gaf_fifo, os.O_WRONLY | os.O_NONBLOCK))

    pipe_thread = threading.Thread(target=pipeline, daemon=True)
    pipe_thread.start()

    def abort(msg):
        feeder.kill()
        feeder.wait()
        detail = errors[0] if errors else (tap.error or "")
        fail(f"{msg}\n{detail}")

    def wait_batch(k: int, deadline: float):
        with tap.cond:
            while len(tap.batch_done) <= k:
                if errors or tap.error or tap.eof:
                    abort("the pipeline ended before the window did")
                if time.perf_counter() > deadline:
                    abort(f"batch {k} not complete in time")
                tap.cond.wait(0.5)
            return tap.batch_done[k]

    t_setup_end = wait_batch(0, time.perf_counter() + SETUP_LIMIT_S)
    setup_s = (time.time() - T_PROCESS - (time.perf_counter() - t_setup_end)
               - pool_s)
    spans_0, counters_0 = timers.snapshot(), timers.counters()
    cpu_0 = cpu_snapshot()
    t0 = t_setup_end
    # the window ends at the first batch completed after t0 + seconds
    k = 1
    while True:
        tk = wait_batch(k, time.perf_counter() + DRAIN_LIMIT_S)
        if tk >= t0 + args.seconds:
            break
        k += 1
    last, t_end = k, tk
    cpu_1 = cpu_snapshot()
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9
    mem_peak = (int(max(torch.cuda.max_memory_allocated(i)
                        for i in range(torch.cuda.device_count())))
                if on_card else 0)
    spans_1, counters_1 = timers.snapshot(), timers.counters()
    prof = prof_marks = stretch = None
    if trace and on_card:
        # the card is traced after the window, with the feed still open,
        # so that the profiler's own cost stays out of the window
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        prof_marks = [(time.time(), time.perf_counter()),
                      (time.monotonic(), time.perf_counter())]
        s0 = time.perf_counter()
        while time.perf_counter() < s0 + TRACE_STRETCH_S:
            if errors or tap.eof:
                abort("the pipeline ended while the card was traced")
            time.sleep(0.05)
        torch.cuda.synchronize()
        stretch = (s0, time.perf_counter())
        prof.stop()
    t_close = time.perf_counter()
    feeder.send_signal(signal.SIGTERM)
    pipe_thread.join(DRAIN_LIMIT_S)
    if pipe_thread.is_alive() or errors:
        abort("the pipeline did not finish after the feed closed")
    tap_thread.join(60)
    feeder.wait(60)
    feeder.stdout.close()
    if trace:
        spans.restore()
        launches.restore()
    t_drained = time.perf_counter()
    for part, final in idx_files:
        if final is not None:
            os.replace(part, final)
    with contextlib.suppress(OSError):
        os.remove(reads_fifo)
        os.remove(gaf_fifo)
        os.rmdir(tmp)
    # the window's reads, made again from the seed
    truth = np.load(paths["truth"])
    reads_by_idx, truths_by_idx = {}, {}
    bases = 0
    for c in range(1, last + 1):
        codes, tr = traffic.make_chunk(mix, args.seed, c, truth)
        for j, (r, t) in enumerate(zip(codes, tr)):
            bases += len(r)
            if c * batch + j in tap.kept:
                reads_by_idx[c * batch + j] = traffic._LETTERS[r].tobytes()
                truths_by_idx[c * batch + j] = t
    lo_idx, hi_idx = batch, (last + 1) * batch
    rows = [r for r in tap.rows if lo_idx <= r[0] < hi_idx]
    window_idx = sorted(r[0] for r in rows)
    attempted = hi_idx - lo_idx
    failed = attempted - len(set(window_idx))
    window_s = t_end - t0

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, window_kbp=bases / 1000.0,
        window_reads=attempted, rows=rows, peak_rss_gb=rss_gb,
        spans_setup=spans_0,
        spans_window={k: spans_1[k][0] - spans_0.get(k, (0.0, 0))[0]
                      for k in spans_1},
        counters_window={k: counters_1[k] - counters_0.get(k, 0)
                         for k in counters_1},
        trace=None)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": mem_peak}
    breakdown = None
    if prof is not None:
        events = device_events(prof)
        busy_ns, _ = union_busy(events)
        offset = clock_offset(events, prof_marks)
        in_stretch = [r for r in tap.rows
                      if stretch[0] <= r[1] <= stretch[1]]
        ctx.trace = types.SimpleNamespace(
            device_ops=[(n, s / 1e9, d / 1e9) for n, s, d in events],
            busy_s=busy_ns / 1e9, stretch_s=stretch[1] - stretch[0],
            frag_launches=[l for l in launches.launches
                           if stretch[0] <= l["t"] <= stretch[1]],
            gaf_rows=in_stretch)
        device_info["busy_s"] = busy_ns / 1e9
        device_info["window_s"] = stretch[1] - stretch[0]
        ops, idle = trace_breakdown(events, spans.spans, offset)
        breakdown = {"device_ops": ops, "idle_gaps": idle}

    metrics = {}
    for m in metrics_for(bench, cell["name"], trace):
        v = load_reader(dirs, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    limits = cell["limits"]
    checked, readings = run_check(
        paths, mix, args.seed, truth, reads_by_idx, truths_by_idx,
        window_idx, tap, limits, failed, attempted,
        workers=max(1, min(6, (os.cpu_count() or 2) - 2)))
    correct = all(v["value"] <= v["limit"] for v in checked.values())
    readings.update(cpu_readings(cpu_0, cpu_1))
    readings["drain_s"] = t_drained - t_close
    readings["check_s"] = time.perf_counter() - t_drained
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = checked
    print(f"gcbench: {cell['name']} seed {args.seed}: window "
          f"{window_s:.3f} s, batches 1..{last}, {bases} bases; set-up "
          f"{setup_s:.3f} s{' (made the data)' if paths['made'] else ''}; "
          f"readings {json.dumps(readings)}", file=sys.stderr)
    for k, v in checked.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    # last, after the readers and the check: no result with JAX loaded
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        fail("modules of JAX or of the JAX package were loaded: "
             + ", ".join(found))
    print(json.dumps(result), file=out)
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of graphchainer_torch (the PyTorch / CUDA port) on one GPU.

  python3 chip_smoke.py            # the full run, from the repo root

Phases (any failure raises and exits non-zero before the result line):
  1. environment: torch / CUDA versions, the card, building the CUDA
     kernels (csrc/*.cu, one nvcc per source for sm_90a) and, beside
     them, the C++ host runtime (g++);
  2. each kernel against its plain torch version, exact equality, at the
     main path's shapes from real batches of the bench workload:
     frag_core on a 128-read batch as run_fragments launches it (the band
     at its own width B_eff, host-typed inputs), the same batch padded to
     B=32, the escalation shape B=96 / max_in=12 on 16 reads and the hard
     batches of workload.frag_hard_batch (B=8 / S=3 and B=128 /
     max_in=12), and nvcc's report of its registers and spills (any stack
     frame or spill fails); polish_core and polish_walk (score +
     backtrace over the fill's dump) on the main path's 128 reads against
     their stitched paths at every band width of the default ramp (8, 16,
     32: the fill's template warp entries) and of the ramp from a start of
     3 or 12 (3, 6, 12, 24, 48: the run-time-bw fill), at the edge widths 1,
     2 and 5 and at 33 and 64 (two band words a lane), each timed there
     with its bound, on a batch whose 48 bp paths force band shifts of
     several words per column and on workload.polish_hard_pairs (empty
     reads and paths, long indels, steep bands mixed with ordinary reads)
     at bw 1, 8, 12, 33 and 64 (and 16 on the hard pairs), nvcc's report
     of the run-time fill's warp entry, of the walk's warp kernel (every
     stride class; the walk is one entry for every width) and of the
     carried entry's kernel (no stack frame or spill), under an
     ops_cap that long walks overflow too (the plain
     polish versions run on the CPU, in processes of their own, and their
     dumps are compared by sha256 digest, their rows whole); and the
     carried entry of frag_core (GA mode's windows: a carried state in,
     the state and the best X cell out) on GA windows of the bench
     workload, fresh and carried, as launched and padded to B=48 and
     B=96, and on the hard batch with a random carry and per-slot trims,
     every output exact;
  3. the main path: bench.py's workload (960 reads of ~3 kbp at 10% error
     on the synthetic 60 kbp graph) through ChainerModel.align_batch on
     cuda, one warm pass and one timed pass; frag_core, the polish
     fill's warp entries and the walk (counted as polish_walk at the
     default ramp's widths) must have launched in the timed pass;
     accuracy bounds; and 8 reads run again on the CPU (the plain
     versions) must give the same alignments, and so must 4 reads with
     every read compared with the GA baseline (the rescue path, through
     the carried entry); then the whole bench pass from a polish band of
     12 words (ramp 12 -> 24 -> 48, the run-time-bw entries), its polish
     stage printed beside the default pass's;
  4. chromosome scale: the same generator's graph at a 20 Mbp backbone
     (SCALE_r05.json's: 40.4 Mbp over both strands, 2.46 M split nodes),
     built once: 128 reads of ~3 kbp, its MEM index (suffix array built,
     saved as .sa.npz and loaded back equal) and the 128 reads with MEM
     seeds; python -m graphchainer_torch on the card on 48 reads of
     scripts/sustained_test.py's mix (16 each of ~1.5, ~3 and ~9 kbp),
     its GAF lines and counts equal to the JAX package's line for line
     (tests/torch_fixtures/scale_mix.json); scripts/scale_test.py's
     1920 reads of ~3 kbp through align_batch (6 workers, batches of 64,
     one warm and one timed pass) in the accuracy bounds, the main
     path's kernels launched, peak device memory and host RSS printed;
     and a batch of 128 reads of the ~9 kbp class, whose stitched paths
     (P up to 16384) the polish fill and walk take at bw 8 and 32,
     exact against their plain versions and timed with their bounds
     (after phase 6, the plain versions running in the pool);
  5. GA mode (GraphAlignerModel on cuda) on the golden_cyclic set (36
     reads lapping cyclic graphs) and the CLC path with its GA rescue at
     the default config on the golden_badread set (80 reads), each held
     to the pins of tests/test_cyclic.py and tests/test_parity.py against
     the reference binary's edit distances (tests/data/golden_*.json),
     with each run's stage seconds (GA mode's ga_window stage: the
     carried entry's windows);
  6. frag_wide (the F-major full-start DP of optimal mode and seedless
     DP) against its plain version on the CPU, every output exact: a
     whole component of the bench graph (B=4096) with a 64-row read
     prefix, the same band cut to half its levels with a 128-row prefix
     (S=4), the seedless tiles (B=1024, S=8, three restart offsets) and
     the hard batch with and without full_start; timed there and at a
     whole 3 kbp read (S=128, held through optimal mode's reads, each the
     exact oracle's minimum); nvcc's report of its registers and
     spills; optimal mode (OptimalAlignerModel on cuda) on 4 bench reads,
     each score the exact DAG oracle's minimum; seedless DP
     (GraphAlignerModel(seedless_dp=True)) on 8 bench reads with every
     8th base substituted, without and with a restart stride, every read
     aligned; the bench pass through pipeline.align_reads with GAF, GAM
     and JSON outputs, the GAM read back to the GAF lines' alignments;
     and the golden100 set at the default config against
     tests/test_parity.py's pins.  The plain frag_wide runs and the
     optimal reads (whose exact traceback is a minute or more of host
     numpy each) run in processes of their own beside phases 2-3;
  7. the bench pass through pipeline.align_reads with MEM seeds
     (mem_count 8, mxm_length 20, the suffix array built and saved first),
     with MUM seeds (mum_count 1) and with the outputs pass's GAM as file
     seeds: reads/s, accuracy, seeds and launches, and a 16-read subset
     of each on the CPU (plain versions, in a process of its own) giving
     the card's GAF lines byte for byte; and python -m graphchainer_torch
     on the bench reads as two processes on one card (gloo at a free
     local port) against one process: the .part0 / .part1 GAF lines,
     merged and sorted, equal the one-process run's, and so do the
     reported counts;
  8. several devices in one process (parallel/device.py): the model on
     two shards of cuda:0, and on every card when there are several:
     the 128-read bench batch and a GA batch of 32 bench reads give one
     shard's alignments, every shard launching each kernel of the path;
     the bench pass on the shards and on one shard in turns (one, the
     shards, the shards, one; reads/s; aligned_fraction and mean_norm_edit_distance equal and in
     bounds), and at a polish band of 12; shard_graph_tables on
     tests/test_multichip.py's five-component graph equal to the
     replicated tables; each run's launches by shard;
  9. python -m graphchainer_torch.tools fusion-finder on the card on the
     two-gene input of tests/test_cli_tools.py: the single expected call.

--devices-only runs phases 8 and 9 alone after the build and the
workload (for a machine with several cards).

The last two lines are the card's `nvidia-smi` name and power limit and
{"ok": true, "device": {...}}.  The line before them is the kernel table.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

CHROM_BP = 20_000_000        # phase 4: the backbone of SCALE_r05.json
                             # (40.4 Mbp over both strands)
CHROM_READS = 1920           # scripts/scale_test.py's reads there
MIX_COUNTS = (16, 16, 16)    # the sustained mix's reads a length class in
                             # tests/torch_fixtures/scale_mix.json
LONG_READS = 128             # the ~9 kbp class's batch, timed polish
LONG_BANDS = (8, 32)         # its polish widths timed: start and widest
ACC_ALIGNED_MIN = 0.99       # aligned_fraction lower bound
ACC_NORM_ED_MAX = 0.095      # mean_norm_edit_distance upper bound (the
                             # reference package recorded 0.0864 here)
# the kernels the main path must launch
MAIN_PATH_KERNELS = ("frag_core", "polish_core", "polish_walk")
# the kernels GA mode must launch (its windows run the carried entry)
GA_PATH_KERNELS = ("frag_core_carried", "polish_core", "polish_walk")
# the polish entries a band ramp from outside 8 / 16 / 32 must launch
ANY_PATH_KERNELS = ("polish_core_any", "polish_walk_any")
BIG = 1 << 28


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


HOST_US_PER_CALL = 300        # what the host may take to enqueue one fn()


def cuda_ms(fn, reps: int = 1, warm: bool = True) -> float:
    """Mean milliseconds of fn() on the card over `reps` runs, after one
    warm-up run (warm=False: the caller just ran fn).  A sleep queued on
    the card first keeps it busy while the host enqueues the runs, so a
    kernel shorter than its wrapper's host time is timed as the card runs
    it, back to back, and not at the rate the host enqueues it."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * HOST_US_PER_CALL * 2000))   # ~2 GHz
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_diff(a, b) -> int:
    import torch
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


# ---------------------------------------------------------------- phase 2
def frag_inputs(model, reads, B, max_in, slack, dev, pad_to=None):
    """The arguments of frag_kernel.frag_core for one real batch, exactly
    as run_fragments hands them over (anchors.fragment_inputs): the band
    at the batch's own width B_eff, or padded with empty slots to
    `pad_to`.  Returns (args, keyword args, B_eff)."""
    import numpy as np
    from graphchainer_torch.align.anchors import (assemble_batch_cols,
                                                  fragment_inputs)
    from graphchainer_torch.models.chainer import match_masks
    jobs, _, _ = model._fragment_jobs_cols(reads)
    mm = match_masks("".join(s for _, s in reads))
    base = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s in reads], out=base[1:])
    (_, bnc, bi, ss, req, rows, S, bl) = assemble_batch_cols(
        model.gx, jobs, mm, base, B=B, max_in=max_in, slack=slack)
    b_eff = bnc.shape[1]
    if pad_to:
        pad = pad_to - b_eff
        bnc = np.pad(bnc, ((0, 0), (0, pad)), constant_values=-1)
        bi = np.pad(bi, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
        bl = np.pad(bl, ((0, 0), (0, pad)), constant_values=-1)
    args, kw = fragment_inputs(model.gx, bnc, bi, ss, req, rows, S, max_in,
                               bl, dev)
    return args, kw, b_eff


def frag_hard_inputs(dev, seed, **shape):
    """workload.frag_hard_batch on the card, in the kernel's types."""
    import numpy as np
    import torch
    from graphchainer_torch.align.anchors import level_bucket
    from graphchainer_torch.workload import frag_hard_batch
    eq, ln, bn, bi, bl, ss, req, rows = frag_hard_batch(seed, **shape)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = (t(eq.view(np.int32)), t(ln), t(bn), t(bi), t(bl), t(ss),
            t(req.view(np.int32)), t(rows))
    return args, dict(S=req.shape[1], max_in=bi.shape[2],
                      n_levels=level_bucket(bl, bn.shape[1]))


def frag_shape(args, kw) -> str:
    F, B = args[2].shape
    return f"F={F} B={B} S={kw['S']} max_in={kw['max_in']}"


def check_frag(label, args, kw, reps=50):
    """The kernel against its plain version on one batch (every output,
    max abs diff 0), then both timed.  Returns a dict of the readings."""
    import torch
    from graphchainer_torch.ops import frag_kernel
    got = frag_kernel.frag_core_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = None

    def plain():
        nonlocal ref
        ref = frag_kernel.frag_core_plain(*args, **kw)
    plain_ms = cuda_ms(plain, warm=False)
    for name, a, b in zip(("best_score", "best_slot", "best_col",
                           "best_in"), got, ref):
        e = max_abs_diff(a, b)
        if e:
            raise AssertionError(f"frag_core ({label}, {frag_shape(args, kw)})"
                                 f": {name} differs from the plain version "
                                 f"(max abs diff {e})")
    ms = cuda_ms(lambda: frag_kernel.frag_core_cuda(*args, **kw), reps=reps)
    bnd = frag_bound(args, kw, got)
    log(f"frag_core ({label}) {frag_shape(args, kw)} "
        f"n_levels={kw['n_levels']}: exact; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bnd[0]:.5f} ms by {bnd[1]} ({bnd[2]} "
        f"bytes, {bnd[3]} operations)")
    return dict(label=label, shape=frag_shape(args, kw), ms=ms,
                plain_ms=plain_ms, bound=bnd)


_TEMPLATE_ARG = r"Li(-?\d+)E|Lb([01])E|([as])"


def ptxas_report(log_text: str, kernel: str):
    """{instantiation: (registers, stack frame, spill stores, spill loads)}
    of one kernel from nvcc -Xptxas -v output; an instantiation's key
    names its template arguments (integers, bools, int8_t / int16_t), a
    kernel that is no template its name alone."""
    import re
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\S+?)'?"
                      r"(?: for|$)", line.strip())
        if m:
            fn = m.group(1)
            continue
        m = re.search(rf"\d+{kernel}(?:I(.*?)EEv|Ev|EP)", fn or "")
        if not m:
            continue
        args = [n if n else ("false", "true")[int(b)] if b
                else {"a": "int8_t", "s": "int16_t"}[c]
                for n, b, c in re.findall(_TEMPLATE_ARG, m.group(1) or "")]
        key = (f"{kernel}<{', '.join(args)}>" if m.group(1) is not None
               else kernel)
        regs, stack, st, ld = out.get(key, (None, None, None, None))
        m2 = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", line)
        if m2:
            stack, st, ld = (int(x) for x in m2.groups())
        m3 = re.search(r"Used (\d+) registers", line)
        if m3:
            regs = int(m3.group(1))
        out[key] = (regs, stack, st, ld)
    return out


def check_frag_all(model, reads, dev):
    """frag_core on the main path's batch as run_fragments hands it over
    (128 reads, the band at its own width B_eff), the same batch padded to
    B=32, the escalation shape (16 reads, B=96 padded, max_in=12) and the
    hard batches; nvcc's report of the kernel's registers and spills."""
    from graphchainer_torch.ops import _cuda
    cfg = model.cfg
    main = frag_inputs(model, reads[:128], cfg.band_slots, cfg.max_in,
                       cfg.band_slack, dev)
    wide = frag_inputs(model, reads[:16], cfg.escalate_band,
                       cfg.escalate_max_in, cfg.band_slack * 2, dev,
                       pad_to=cfg.escalate_band)
    cases = [
        check_frag(f"main path, B_eff={main[2]}", *main[:2]),
        check_frag(f"main batch padded to B={cfg.band_slots}",
                   *frag_inputs(model, reads[:128], cfg.band_slots,
                                cfg.max_in, cfg.band_slack, dev,
                                pad_to=cfg.band_slots)[:2]),
        check_frag(f"escalation, B_eff={wide[2]} padded", *wide[:2]),
        check_frag("hard batch", *frag_hard_inputs(dev, 3)),
        check_frag("hard batch, wide", *frag_hard_inputs(
            dev, 4, F=64, B=128, max_in=12, S=2)),
    ]
    ptx = check_ptxas("frag_core_kernel", 2, "fragments a block")
    return dict(cases=cases, ptxas=ptx)


def check_ptxas(kernel: str, n: int, args: str = ""):
    """nvcc's report of a kernel's n instantiations (registers, stack
    frame, spill stores and loads), logged; any stack frame or spill
    fails."""
    from graphchainer_torch.ops import _cuda
    ptx = ptxas_report(_cuda.ptxas_log(), kernel)
    log(f"ptxas, {kernel}{f'<{args}>' if args else ''} (registers, stack "
        f"frame, spill stores, spill loads bytes): {ptx}")
    if len(ptx) != n:
        raise AssertionError(f"no ptxas report of {n} {kernel} "
                             f"instantiations: {ptx}")
    for name, (_, stack, st, ld) in ptx.items():
        if stack or st or ld:
            raise AssertionError(f"{name}: {stack} bytes stack frame, "
                                 f"{st} / {ld} bytes spilled")
    return ptx


def polish_inputs(pairs, dev):
    """Lane-major polish-core inputs (planes_t, path_t, lens) of
    (read, path) pairs at the bucketed rmax / pmax of align/polish.py."""
    import numpy as np
    import torch
    from graphchainer_torch.align.polish import (_pack_rows, _round_up,
                                                 pack_codes2)
    from graphchainer_torch.ops.linear_align import (expand_codes2,
                                                     expand_planes2)
    reads = [r for r, _ in pairs]
    paths = [p for _, p in pairs]
    rl = np.array([len(r) for r in reads], dtype=np.int64)
    pl = np.array([len(p) for p in paths], dtype=np.int64)
    rmax = _round_up(int(rl.max()), 1024)
    pmax = _round_up(int(pl.max()), 1024)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(  # noqa: E731
        dev, torch.int64)
    rc = t(pack_codes2(_pack_rows(reads, rl, rmax)).astype(np.int64))
    pc = t(pack_codes2(_pack_rows(paths, pl, pmax)).astype(np.int64))
    planes_t = expand_planes2(rc).permute(2, 1, 0).contiguous()
    path_t = expand_codes2(pc).t().to(torch.int64).contiguous()
    return planes_t, path_t, t(rl), t(pl), rc, pc, rmax + pmax


def polish_kernel_args(pairs, bw, dev):
    """(int32 kernel inputs, int64 plain inputs, max_steps, ops_cap) of
    (read, path) pairs, as align/polish.py sizes them."""
    import torch
    from graphchainer_torch.align.polish import _ops_cap
    from graphchainer_torch.ops.myers import to_i32_bits
    planes_t, path_t, rl, pl, rc, _, steps = polish_inputs(pairs, dev)
    k_in = (to_i32_bits(planes_t), path_t.to(torch.int32),
            rl.to(torch.int32), pl.to(torch.int32))
    cap = _ops_cap(rc.shape[1] * 16, path_t.shape[0], bw)
    return k_in, (planes_t, path_t, rl, pl), steps, cap


def digest(t) -> str:
    """sha256 of an integer tensor's values as contiguous int64."""
    import hashlib
    import torch
    return hashlib.sha256(t.to(torch.int64).contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def polish_plain_job(pairs, bw, small_cap=0):
    """The plain fill and walk (linear_align._polish_core_t, _polish_walk_t)
    of (read, path) pairs on the CPU, in a process of its own: the digests
    of the dump's four outputs (dump_vp, dump_vn, dump_sb, dump_base), the
    packed rows of the walk under the polish's ops_cap (and small_cap), and
    the milliseconds of the fill and of the walk."""
    import torch
    torch.set_num_threads(1)
    from graphchainer_torch.ops import linear_align
    _, p_in, steps, cap = polish_kernel_args(pairs, bw, "cpu")
    t0 = time.perf_counter()
    dump = linear_align._polish_core_t(*p_in, bw)
    fill_ms = (time.perf_counter() - t0) * 1e3
    rows, walk_ms = {}, None
    for c in (cap, small_cap) if small_cap else (cap,):
        t0 = time.perf_counter()
        rows[c] = linear_align._polish_walk_t(*dump, *p_in, bw, steps,
                                              c).numpy()
        walk_ms = walk_ms or (time.perf_counter() - t0) * 1e3
    return dict(digests=[digest(x) for x in dump], rows=rows,
                fill_ms=fill_ms, walk_ms=walk_ms)


def check_polish(pairs, bw, dev, label, plain, timed=False):
    """The fill and walk kernels (the entry the band width takes) against
    the plain versions' results on the same pairs (plain: the future of
    polish_plain_job): every dump output and every packed row exact, the
    walk over the kernel's own dump, under each ops_cap the plain job ran.
    With timed, both kernels are timed and their bounds reckoned.  Returns
    a dict of the readings."""
    import torch
    from graphchainer_torch.ops import linear_align, polish_kernel
    from graphchainer_torch.ops.myers import u32
    k_in, p_in, steps, cap = polish_kernel_args(pairs, bw, dev)
    R, P = len(pairs), p_in[1].shape[0]
    entry = polish_kernel.entry_for(bw)
    got = polish_kernel.polish_core_cuda(*k_in, bw)
    torch.cuda.synchronize()
    ref = plain.result()
    names = ("dump_vp", "dump_vn", "dump_sb", "dump_base")
    for i, (name, a) in enumerate(zip(names, got)):
        if digest(u32(a) if i < 2 else a) != ref["digests"][i]:
            e = max_abs_diff(u32(a) if i < 2 else a,
                             linear_align._polish_core_t(*p_in, bw)[i])
            raise AssertionError(
                f"polish_core[{entry}] bw={bw} ({label}): {name} differs "
                f"from the plain version (max abs diff {e})")
    n_ok = []
    for c, want in ref["rows"].items():
        rows = polish_kernel.polish_walk_cuda(*got, *k_in, bw, steps, c)
        torch.cuda.synchronize()
        e = max_abs_diff(rows.cpu(), torch.from_numpy(want))
        if e:
            raise AssertionError(
                f"polish_walk[{entry}] bw={bw} ops_cap={c} ({label}): packed "
                f"rows differ from the plain version (max abs diff {e})")
        n_ok.append(int((want[:, 1] >= 0).sum()))
    out = dict(bw=bw, label=label, entry=entry, fill_plain_ms=ref["fill_ms"],
               walk_plain_ms=ref["walk_ms"], P=P)
    timing = ""
    if timed:
        out["fill_ms"] = cuda_ms(
            lambda: polish_kernel.polish_core_cuda(*k_in, bw), reps=5)
        out["walk_ms"] = cuda_ms(lambda: polish_kernel.polish_walk_cuda(
            *got, *k_in, bw, steps, cap), reps=5)
        out["fill_bound"] = fill_bound(k_in, got, bw)
        out["walk_bound"] = walk_bound(rows, k_in, P)
        timing = (f"; kernels fill {out['fill_ms']:.4f} ms (bound "
                  f"{out['fill_bound'][0]:.5f} ms by "
                  f"{out['fill_bound'][1]}), walk {out['walk_ms']:.4f} ms "
                  f"(bound {out['walk_bound'][0]:.5f} ms by "
                  f"{out['walk_bound'][1]})")
    log(f"polish bw={bw} [{entry} entries] ({label}) R={R} "
        f"RW={k_in[0].shape[1]} P={P} max_steps={steps} ops_cap="
        f"{'/'.join(map(str, ref['rows']))}: fill and walk exact "
        f"({'/'.join(map(str, n_ok))} of {R} walks complete); plain (CPU) "
        f"fill {ref['fill_ms']:.1f} ms, walk {ref['walk_ms']:.1f} ms"
        + timing)
    return out


WARP_BANDS = (8, 16, 32)            # the default ramp: the warp entries
# the run-time-bw entries: the ramp from a start of 3 (and 12), the edge
# widths 1, 2 and 5, and 33 and 64 (two band words a lane)
ANY_BANDS = (1, 2, 3, 5, 6, 12, 24, 33, 48, 64)
EDGE_BANDS = (1, 12, 33, 64)        # the band-shift batch and the hard pairs
WIDE_BAND = 100     # past 64 words: the run-time fill's thread per read,
                    # on the band-shift batch only


# ---------------------------------------------------------------- bounds
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT_OPS_PER_S = 67e12         # float32 outside the tensor cores, the
                              # nearest published rate to the int32 pipes
                              # (which run at most as fast)


def bound(bytes_moved: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    to = ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def frag_bound(args, kw, out):
    """Bytes: every input in its host type read once (the band arrays, the
    read planes, shifts and rows, a carried state), the node table's rows
    that the bands name once each (16 bytes of Eq words and 4 of length),
    every output written once.  Operations of the live slots only: ~66
    per merge candidate (33 adds and mins), ~22 per column advanced (all
    31 where the state goes out), ~6 per row of an end word scanned for
    the X cell, each slice."""
    import torch
    from graphchainer_torch.ops import frag_align
    eq, ln, bn, bi, bl, ss, req, rows = args
    slot_len = frag_align.lane_major(eq, ln, bn, bi, ss, req, rows, bl)[1]
    live = int((bl >= 0).sum())
    cands = live + int((bi >= 0).sum())
    cols = (31 * live if kw.get("want_state")
            else int(slot_len.clamp(min=0).sum()))
    x_rows = 32 * live if kw.get("want_xcells") else 0
    ops = kw["S"] * (66 * cands + 22 * cols + 6 * x_rows)
    n_rows = int(torch.unique(bn[bn >= 0]).numel())
    b = (nbytes(bn, bi, bl, ss, req, rows, *(kw.get("carry") or ()))
         + 20 * n_rows + nbytes(*(x for x in out if x is not None)))
    return bound(b, ops) + (b, ops)


def fill_bound(k_in, dump, bw):
    """Inputs once, the dump once; ~25 integer operations a band word a
    column."""
    P, _, R = dump[0].shape
    b = nbytes(*k_in) + nbytes(*dump)
    ops = 25 * P * bw * R
    return bound(b, ops) + (b, ops)


def walk_bound(rows, k_in, P):
    """What these walks need: every dump word a step's three neighbour
    cells lie in, counted once (12 bytes: vp, vn, sb), the band base and
    path mask of every column visited (8 bytes), the read's plane words
    visited (16 bytes), the lengths, and the packed rows written once;
    ~40 integer operations a step.  A failed walk counts for its score
    cell only."""
    import numpy as np
    w = rows.cpu().numpy()
    rl = k_in[2].cpu().numpy()
    pl = k_in[3].cpu().numpy()
    words = cols = planes = steps = 0
    shifts = np.arange(16, dtype=np.uint32) * 2
    for i in range(w.shape[0]):
        n = int(w[i, 1])
        if n < 0:
            words += 1
            cols += 1
            continue
        ops = ((w[i, 3:].astype(np.uint32)[:, None] >> shifts) & 3
               ).reshape(-1)[:n]
        # OP_MATCH 0 / OP_MISMATCH 3 move both, OP_DEL 1 the column,
        # OP_INS 2 the row; positions before each step and the end
        rr = int(rl[i]) - 1 - np.concatenate([[0], np.cumsum(ops != 1)])
        cc = int(pl[i]) - 1 - np.concatenate([[0], np.cumsum(ops != 2)])
        cells = np.concatenate([np.stack([rr - dr, cc - dc])
                                for dr, dc in ((0, 0), (1, 1), (0, 1),
                                               (1, 0))], axis=1)
        cells = cells[:, (cells[0] >= 0) & (cells[1] >= 0)]
        cq = np.minimum(cells[1], P - 1)
        words += len(np.unique(cq.astype(np.int64) * (1 << 20)
                               + cells[0] // 32))
        cols += len(np.unique(cq))
        planes += len(np.unique(rr[rr >= 0] // 32))
        steps += n
    b = (12 * words + 8 * cols + 16 * planes + nbytes(k_in[2], k_in[3])
         + nbytes(rows))
    return bound(b, 40 * steps) + (b, 40 * steps)


def stitched_pairs(model, reads):
    """(read, its path sequence) for the reads the model aligns: the path
    that the chain stitch (and the corridor repair) chose."""
    alns = model.align_batch(reads)
    return [(seq, model.gx.positions_seq(a.positions))
            for (_, seq), a in zip(reads, alns) if not a.failed]


# ---------------------------------------------------------------- GA mode
def ga_windows(model, reads):
    """The fragment windows of one GraphAlignerModel.align_batch as
    run_fragments receives them: dicts of the band arrays, read planes,
    shifts and carried state."""
    from graphchainer_torch.models import aligner
    calls, run = [], aligner.run_fragments

    def record(gx, bnc, bi, ss, req, rows, S, max_in, bl, device,
               carry_in=None, **kw):
        calls.append(dict(bnc=bnc, bi=bi, ss=ss, req=req, rows=rows, S=S,
                          max_in=max_in, bl=bl, carry=carry_in))
        return run(gx, bnc, bi, ss, req, rows, S, max_in, bl, device,
                   carry_in=carry_in, **kw)
    aligner.run_fragments = record
    try:
        model.align_batch(reads)
    finally:
        aligner.run_fragments = run
    return calls


def window_inputs(gx, w, dev, pad_to=None):
    """frag_core's arguments for a recorded GA window on the card, as
    run_fragments hands them over (anchors.fragment_inputs), with both
    extra outputs asked for; the band padded with empty slots to
    `pad_to`."""
    import numpy as np
    from graphchainer_torch.align.anchors import fragment_inputs
    bnc, bi, bl, ss, carry = w["bnc"], w["bi"], w["bl"], w["ss"], w["carry"]
    if pad_to:
        pad = pad_to - bnc.shape[1]
        bnc = np.pad(bnc, ((0, 0), (0, pad)), constant_values=-1)
        bi = np.pad(bi, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
        bl = np.pad(bl, ((0, 0), (0, pad)), constant_values=-1)
        if ss.ndim == 2:
            ss = np.pad(ss, ((0, 0), (0, pad)))
        if carry is not None:
            carry = (np.pad(carry[0], ((0, 0), (0, pad)),
                            constant_values=BIG),
                     np.pad(carry[1], ((0, 0), (0, pad))),
                     np.pad(carry[2], ((0, 0), (0, pad))))
    args, kw = fragment_inputs(gx, bnc, bi, ss, w["req"], w["rows"], w["S"],
                               w["max_in"], bl, dev, carry_in=carry)
    return args, dict(kw, want_state=True, want_xcells=True)


def carried_hard_inputs(dev, seed, **shape):
    """workload.frag_hard_batch with workload.frag_hard_carry's state and
    per-slot trims, on the card in the kernel's types."""
    import numpy as np
    import torch
    from graphchainer_torch.align.anchors import level_bucket
    from graphchainer_torch.workload import frag_hard_batch, frag_hard_carry
    eq, ln, bn, bi, bl, _, req, rows = frag_hard_batch(seed, **shape)
    carry, shifts = frag_hard_carry(seed, bn, ln)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = (t(eq.view(np.int32)), t(ln), t(bn), t(bi), t(bl), t(shifts),
            t(req.view(np.int32)), t(rows))
    return args, dict(S=req.shape[1], max_in=bi.shape[2],
                      n_levels=level_bucket(bl, bn.shape[1]),
                      carry=tuple(t(c.view(np.int32)) for c in carry),
                      want_state=True, want_xcells=True)


def check_carried(label, args, kw, reps=50):
    """The carried entry against the plain version on the same tensors on
    the card (all ten outputs, max abs diff 0), then both timed."""
    import torch
    from graphchainer_torch.ops import frag_kernel
    got = frag_kernel.frag_core_carried_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = None

    def plain():
        nonlocal ref
        ref = frag_kernel.frag_core_plain(*args, **kw)
    plain_ms = cuda_ms(plain, warm=False)
    err = 0
    for name in got._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if (a is None) != (b is None):
            raise AssertionError(f"frag_core carried entry ({label}): "
                                 f"{name} missing on one side")
        e = 0 if a is None else max_abs_diff(a, b)
        err = max(err, e)
        if e:
            raise AssertionError(
                f"frag_core carried entry ({label}, {frag_shape(args, kw)})"
                f": {name} differs from the plain version (max abs diff "
                f"{e})")
    ms = cuda_ms(lambda: frag_kernel.frag_core_carried_cuda(*args, **kw),
                 reps=reps)
    bnd = frag_bound(args, kw, got)
    carried = kw.get("carry") is not None
    log(f"frag_core carried entry ({label}) {frag_shape(args, kw)} "
        f"n_levels={kw['n_levels']} carry={carried}: exact (10 outputs); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.5f} "
        f"ms by {bnd[1]} ({bnd[2]} bytes, {bnd[3]} operations)")
    return dict(label=label, shape=frag_shape(args, kw), ms=ms,
                plain_ms=plain_ms, bound=bnd, err=err)


def check_carried_all(model, reads, dev):
    """The carried entry on GA windows of the bench workload: the first
    fresh window batch (want_state + want_xcells) and the first carried
    one after it, as launched (B_eff), padded to GA mode's B=48 and to a
    ramp width of 96; and on the hard batch with a random carry and
    per-slot trims (B=8 / S=3, B=48 / S=2)."""
    from graphchainer_torch.models.aligner import GraphAlignerModel
    ga = GraphAlignerModel(model.g, model.index, gx=model.gx, device=dev)
    wins = ga_windows(ga, reads)
    fresh = next(w for w in wins if w["carry"] is None)
    carried = next(w for w in wins if w["carry"] is not None)
    log(f"GA windows of {len(reads)} bench reads: {len(wins)} launches "
        f"({sum(w['carry'] is not None for w in wins)} carried)")
    cases = []
    for kind, w in (("fresh", fresh), ("carried", carried)):
        b_eff = w["bnc"].shape[1]
        cases.append(check_carried(f"GA {kind} window, B_eff={b_eff}",
                                   *window_inputs(model.gx, w, dev)))
        for width in (48, 96):
            cases.append(check_carried(
                f"GA {kind} window padded to B={width}",
                *window_inputs(model.gx, w, dev, pad_to=width)))
    cases.append(check_carried("hard batch, random carry",
                               *carried_hard_inputs(dev, 3)))
    cases.append(check_carried("hard batch, random carry, B=48",
                               *carried_hard_inputs(dev, 4, F=64, B=48,
                                                    max_in=4, S=2)))
    return cases


def golden(path):
    import os
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "data", path)) as fh:
        return json.load(fh)


def score_golden(label, gx, reads, alns, pins, n_min, delta_max):
    """Per read: aligned, and its edit distance to the alignment's path
    at or below the reference binary's pinned one; fails below the pins
    (all aligned, at least n_min at or below, mean delta <= delta_max)."""
    import numpy as np
    from graphchainer_torch.workload import nw_edit_distance
    n_aligned = n_le = 0
    deltas = []
    for (name, seq), a in zip(reads, alns):
        ref_ed = pins["reads"][name]["ref_ed"]
        if a.failed:
            continue
        n_aligned += 1
        ed = nw_edit_distance(seq, gx.positions_seq(a.positions))
        n_le += ref_ed is None or ed <= ref_ed
        if ref_ed is not None:
            deltas.append(ed - ref_ed)
    mean = float(np.mean(deltas)) if deltas else float("nan")
    log(f"{label}: aligned {n_aligned}/{len(reads)}, at or below the "
        f"reference's edit distance {n_le}/{len(reads)}, mean delta "
        f"{mean:.3f}")
    if n_aligned != len(reads) or n_le < n_min or not mean <= delta_max:
        raise AssertionError(
            f"{label}: aligned {n_aligned}/{len(reads)}, at-or-better "
            f"{n_le} (pin >= {n_min}), mean delta {mean} (pin <= "
            f"{delta_max})")
    return dict(aligned=n_aligned, at_or_better=n_le, mean_delta=mean)


def run_golden(dev):
    """golden_cyclic through GraphAlignerModel (GA mode) and
    golden_badread through ChainerModel at the default config (CLC with
    its GA rescue), both on `dev`, the launch counts of each run set to 0
    just before it and read just after.  Returns {set: readings}."""
    import tempfile
    import torch
    from graphchainer_torch.graph.mpc import build_mpc
    from graphchainer_torch.index.minimizer import build_index
    from graphchainer_torch.models.aligner import GraphAlignerModel
    from graphchainer_torch.models.chainer import ChainerModel, timers
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.workload import (golden_badread_workload,
                                             golden_cyclic_workload)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        _, gc, creads = golden_cyclic_workload(td)
        _, gb, breads = golden_badread_workload(td)
    for name, g, reads in (("golden_cyclic", gc, creads),
                           ("golden_badread", gb, breads)):
        if name == "golden_cyclic":
            model = GraphAlignerModel(g, build_index(g, k=13, w=8),
                                      device=dev)
            need, pins = GA_PATH_KERNELS, (34, 2.0)
        else:
            model = ChainerModel(g, build_mpc(g), build_index(g, k=15, w=10),
                                 device=dev)
            need, pins = MAIN_PATH_KERNELS, (72, 1.0)
        model.align_batch(reads[:4])            # warm the device tables
        torch.cuda.synchronize()
        timers.reset()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        alns = model.align_batch(reads)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _cuda.launches()
        counters = timers.counters()
        stages = {k: round(v[0], 4) for k, v in timers.snapshot().items()}
        log(f"{name}: {len(reads)} reads in {wall:.3f} s; launches "
            f"{json.dumps(launches)}; escalated reads "
            f"{counters.get('escalated_reads', 0)}, rescued reads "
            f"{counters.get('rescued_reads', 0)}; ga_window stage "
            f"{stages.get('ga_window', 0.0)} s; stage seconds "
            f"(thread-summed) {json.dumps(stages)}")
        if counters.get("rescued_reads", 0):
            need = need + ("frag_core_carried",)
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} never launched")
        out[name] = dict(score_golden(name, model.gx, reads, alns,
                                      golden(f"{name}.json"), *pins),
                         launches=launches, seconds=wall, stages=stages,
                         escalated=counters.get("escalated_reads", 0),
                         rescued=counters.get("rescued_reads", 0))
    return out


# ---------------------------------------------------------------- frag_wide
WIDE_FIELDS = ("best_score", "best_slot", "best_col", "best_in",
               "end_score", "end_col")
WIDE_SRC = "graphchainer_torch/csrc/frag_wide.cu"
WIDE_TPU = "graphchainer_tpu/ops/frag_align.py:105"


def wide_to_numpy(args, kw):
    """align_fragments' arguments as numpy arrays, for a plain run in
    another process."""
    import torch
    return ([a.cpu().numpy() for a in args],
            {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
             for k, v in kw.items()})


def wide_plain_job(arrs, kw_np):
    """The plain version of frag_wide (frag_align.align_fragments_plain)
    on the CPU, in a process of its own.  Returns (its outputs as numpy,
    milliseconds)."""
    import torch
    torch.set_num_threads(1)
    from graphchainer_torch.ops import frag_align
    kw = {k: (torch.from_numpy(v) if hasattr(v, "dtype") else v)
          for k, v in kw_np.items()}
    t0 = time.perf_counter()
    res = frag_align.align_fragments_plain(
        *(torch.from_numpy(a) for a in arrs), **kw, want_state=False)
    ms = (time.perf_counter() - t0) * 1e3
    return {k: getattr(res, k).numpy() for k in WIDE_FIELDS}, ms


def wide_hard_inputs(dev, seed, full_start=True):
    """workload.frag_wide_hard_batch on the card, as align_fragments
    takes it."""
    import numpy as np
    import torch
    from graphchainer_torch.workload import frag_wide_hard_batch
    eq, ln, bn, bi, bl, ss, req, rows, base, nl = frag_wide_hard_batch(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    args = (t(eq.view(np.int32)), t(ln), t(bn), t(bi), t(ss),
            t(req.view(np.int32)), t(rows))
    return args, dict(n_slices=req.shape[1], max_in=bi.shape[2],
                      full_start=full_start, band_level=t(bl),
                      n_levels=nl, seed_base=t(base))


def wide_shape(args, kw) -> str:
    F, B = args[2].shape
    return (f"F={F} B={B} S={kw['n_slices']} max_in={kw['max_in']} "
            f"n_levels={kw['n_levels']}")


def wide_bound(args, kw, out):
    """Bytes: the band arrays, read planes, rows and seed bases read once,
    the 20 bytes (Eq words, length) of each node row the bands name, every
    output written once.  Operations of the processed slots only: ~20 a
    column a slice (the Myers step, its boundary and state bits), ~66 a
    merge candidate a slice (33 rows, an add and a min each), and with
    full_start ~66 more for every column of slice 0, where each column's
    free-start merge runs (later slices skip it wherever the column's
    boundary score lies below the free start's, which on these inputs is
    nearly everywhere)."""
    import torch
    eq, ln, bn, bi, ss, req, rows = args
    bl, S = kw["band_level"], kw["n_slices"]
    live = (bl >= 0) & (bl < kw["n_levels"])
    slen = torch.where(bn >= 0, ln[bn.clamp(min=0).long()], 0)
    slen[:, 0] -= ss
    cols = int(slen.clamp(1, 32)[live].sum())
    cands = int(live.sum()) + int(((bi >= 0) & live[..., None]).sum())
    ops = S * (20 * cols + 66 * cands)
    if kw["full_start"]:
        ops += 66 * cols
    n_rows = int(torch.unique(bn[bn >= 0]).numel())
    extra = [kw["seed_base"]] if kw.get("seed_base") is not None else []
    b = (nbytes(bn, bi, bl, ss, req, rows, *extra) + 20 * n_rows
         + nbytes(*(getattr(out, k) for k in WIDE_FIELDS)))
    return bound(b, ops) + (b, ops)


def wide_cases(model, reads, dev):
    """The inputs of every frag_wide check: one component band of the
    bench graph at its full width with a 64-row read prefix (S = 2), the
    same band cut to its lower half of levels with a 128-row prefix
    (S = 4, B = 4096), the seedless tiles of the bench graph for three
    restart offsets of a read (S = 8), and the hard batch (pad slots,
    length-0 seed slots, slots past 32 columns, in-edges from pad slots,
    from beyond B and from the same or a higher level, levels past
    n_levels; int8 pointers at B = 64) with and without full_start.
    Returns [(label, args, kw)]."""
    import torch
    from graphchainer_torch.align.seedless import FullstartScanner
    from graphchainer_torch.models.optimal import OptimalAlignerModel
    opt = OptimalAlignerModel(model.g, model.index, gx=model.gx, device=dev)
    scan = FullstartScanner(model.g, model.gx, device=dev)
    read = reads[0][1]
    comp = opt.component_inputs(read[:64], 0)
    tiles = scan.scan_inputs(read, offsets=(0, 1000, 2000))[:2]
    # four slices at B = 4096 on half the component (its lower levels; the
    # rest pad), so that the plain version takes as long as at two slices
    cut, cut_kw = opt.component_inputs(read[:128], 0)
    bl = cut_kw["band_level"]
    keep = int(bl.max()) // 2 + 1
    cut_kw = dict(cut_kw, band_level=torch.where(bl < keep, bl, -1)
                  .contiguous())
    return [("optimal component, a 64-row prefix", *comp),
            ("optimal component cut to half its levels, a 128-row prefix",
             cut, cut_kw),
            ("seedless tiles, 3 offsets", *tiles),
            ("hard batch", *wide_hard_inputs(dev, 3)),
            ("hard batch, no full_start",
             *wide_hard_inputs(dev, 5, full_start=False))]


def check_wide(label, args, kw, plain, reps=20):
    """The kernel's outputs against the plain version's (numpy, from
    wide_plain_job), every output exact, then the kernel timed."""
    import torch
    from graphchainer_torch.ops import frag_align
    got = frag_align.align_fragments(*args, **kw)
    torch.cuda.synchronize()
    ref, plain_ms = plain
    for name in WIDE_FIELDS:
        a = getattr(got, name)
        b = torch.from_numpy(ref[name])
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"frag_wide ({label}): {name} is "
                                 f"{a.dtype} {tuple(a.shape)}, the plain "
                                 f"version's {b.dtype} {tuple(b.shape)}")
        e = max_abs_diff(a.cpu(), b)
        if e:
            raise AssertionError(f"frag_wide ({label}, {wide_shape(args, kw)}"
                                 f"): {name} differs from the plain version "
                                 f"(max abs diff {e})")
    ms = cuda_ms(lambda: frag_align.align_fragments(*args, **kw), reps=reps)
    bnd = wide_bound(args, kw, got)
    log(f"frag_wide ({label}) {wide_shape(args, kw)}: exact; kernel "
        f"{ms:.4f} ms, plain (CPU) {plain_ms:.1f} ms, bound {bnd[0]:.5f} ms "
        f"by {bnd[1]} ({bnd[2]} bytes, {bnd[3]} operations)")
    return dict(label=label, shape=wide_shape(args, kw), ms=ms,
                plain_ms=plain_ms, bound=bnd, err=0)


def ops_cost(gx, aln) -> int:
    """The edit cost of an alignment's ops along its positions' path
    sequence, which they must spell out with the whole read."""
    path = gx.positions_seq(aln["positions"])
    read = aln["seq"]
    ri = pi = cost = 0
    for op in aln["ops"]:
        if op in (0, 3):
            cost += read[ri] != path[pi]
            ri += 1
            pi += 1
        elif op == 1:
            pi += 1
            cost += 1
        else:
            ri += 1
            cost += 1
    if ri != len(read) or pi != len(path):
        raise AssertionError(f"optimal {aln['name']}: the ops spell "
                             f"{ri}/{len(read)} read and {pi}/{len(path)} "
                             "path bases")
    return int(cost)


def optimal_job(i, graph_bp, n_reads, read_len):
    """Read i of the bench workload through OptimalAlignerModel on the
    card, in a process of its own (its exact traceback is host numpy of
    a minute or more); the launch counts set to 0 just before and read
    just after."""
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from graphchainer_torch.models.optimal import OptimalAlignerModel
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.utils import timers
    from graphchainer_torch.workload import bench_workload
    g, _, index, _, reads, _ = bench_workload(graph_bp, n_reads, read_len)
    name, seq = reads[i]
    model = OptimalAlignerModel(g, index, device="cuda")
    model.gx.device_tables(model.device)
    _cuda.lib()
    torch.cuda.synchronize()
    timers.reset()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    aln = model.align_batch([(name, seq)])[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = timers.snapshot()
    return dict(name=name, seq=seq, score=int(aln.score),
                positions=np.asarray(aln.positions),
                ops=None if aln.ops is None else np.asarray(aln.ops),
                launches=_cuda.launches(), wall=wall,
                dp_s=snap.get("optimal_dp", (0.0, 0))[0],
                traceback_s=snap.get("optimal_traceback", (0.0, 0))[0])


def check_optimal(gx, results):
    """Every read aligned, its kernel score the cost of the oracle's exact
    traceback (the oracle's checkpointed-DP minimum over the component the
    kernel chose), frag_wide launched in every run."""
    for r in results:
        if r["ops"] is None or not len(r["positions"]):
            raise AssertionError(f"optimal {r['name']}: no alignment")
        cost = ops_cost(gx, r)
        if cost != r["score"]:
            raise AssertionError(f"optimal {r['name']}: kernel score "
                                 f"{r['score']} != the oracle's traceback "
                                 f"cost {cost}")
        if r["launches"]["frag_wide"] <= 0:
            raise AssertionError(f"optimal {r['name']}: frag_wide never "
                                 "launched")
        log(f"optimal {r['name']} ({len(r['seq'])} bp): score {r['score']} "
            f"== the oracle's exact minimum; {r['wall']:.2f} s, of which "
            f"the kernel stage {r['dp_s']:.3f} s ({r['launches']['frag_wide']}"
            f" launches) and the host traceback {r['traceback_s']:.2f} s")
    return dict(reads=len(results),
                launches=sum(r["launches"]["frag_wide"] for r in results),
                dp_s=[round(r["dp_s"], 4) for r in results],
                traceback_s=[round(r["traceback_s"], 3) for r in results])


def run_seedless(model, reads, dev):
    """8 bench reads with every 8th base substituted (no minimizer
    survives) through GraphAlignerModel(seedless_dp=True) on the card,
    without and with a restart stride, the launch counts of each run set
    to 0 just before it and read just after: every read aligned."""
    import torch
    from graphchainer_torch.index.minimizer import get_seeds
    from graphchainer_torch.models.aligner import (AlignerConfig,
                                                   GraphAlignerModel)
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.workload import nw_edit_distance, poisoned
    bad = [(n, poisoned(s)) for n, s in reads[:8]]
    seeded = sum(bool(get_seeds(model.index, s, -1)) for _, s in bad)
    out = {}
    for stride in (0, 1000):
        ga = GraphAlignerModel(model.g, model.index,
                               AlignerConfig(seedless_dp=True,
                                             dp_restart_stride=stride),
                               gx=model.gx, device=dev)
        ga.align_batch(bad[:1])
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        alns = ga.align_batch(bad)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _cuda.launches()
        eds = []
        for (name, seq), a in zip(bad, alns):
            if a.failed:
                raise AssertionError(f"seedless (stride {stride}): {name} "
                                     "not aligned")
            eds.append(nw_edit_distance(seq[a.seq_start:a.seq_end],
                                        model.gx.positions_seq(a.positions)))
        for k in ("frag_wide",) + GA_PATH_KERNELS:
            if launches[k] <= 0:
                raise AssertionError(f"seedless (stride {stride}): kernel {k} "
                                     "never launched")
        log(f"seedless DP, stride {stride}: {len(bad)}/{len(bad)} poisoned "
            f"reads aligned ({seeded} with any minimizer hit) in {wall:.3f} "
            f"s; edit distances {eds} over spans "
            f"{[a.seq_end - a.seq_start for a in alns]}; launches "
            f"{json.dumps(launches)}")
        out[stride] = dict(launches=launches, seconds=wall, eds=eds)
    return out


def run_outputs(graph_bp, reads, dev):
    """The bench pass through pipeline.align_reads on the card with GAF,
    GAM and JSON outputs, the launch counts set to 0 just before and read
    just after; the GAM read back with io/gam_reader must give the GAF
    lines' alignments (read names in order, node paths, path offsets and
    lengths), and the JSON one line each."""
    import os
    import tempfile
    import numpy as np
    from graphchainer_torch.io.gam_reader import load_gam_alignments
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.pipeline import PipelineParams, align_reads
    from graphchainer_torch.workload import _write_gfa, build_bench_graph
    with tempfile.TemporaryDirectory() as td:
        gfa = os.path.join(td, "bench.gfa")
        _write_gfa(build_bench_graph(np.random.default_rng(7), graph_bp), gfa)
        fa = os.path.join(td, "reads.fa")
        with open(fa, "w") as fh:
            fh.write("".join(f">{n}\n{s}\n" for n, s in reads))
        outs = {k: os.path.join(td, f"out.{k}") for k in ("gaf", "gam",
                                                           "json")}
        params = PipelineParams(graph_file=gfa, read_files=[fa],
                                out_gaf=outs["gaf"], out_gam=outs["gam"],
                                out_json=outs["json"], batch_size=128,
                                inflight=4, seed_k=15, seed_w=10,
                                device=str(dev))
        _cuda.reset_launches()
        stats = align_reads(params)
        launches = _cuda.launches()
        with open(outs["gaf"]) as fh:
            gaf = [ln.rstrip("\n").split("\t") for ln in fh]
        with open(outs["json"]) as fh:
            js = [json.loads(ln) for ln in fh]
        gam = load_gam_alignments(outs["gam"])
        with open(outs["gam"], "rb") as fh:
            gam_bytes = fh.read()
    for k in MAIN_PATH_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"outputs pass: kernel {k} never launched")
    if not (len(gam) == len(gaf) == len(js)
            == stats.reads_with_an_alignment > 0):
        raise AssertionError(f"outputs pass: {len(gaf)} GAF lines, "
                             f"{len(gam)} GAM and {len(js)} JSON records, "
                             f"{stats.reads_with_an_alignment} aligned reads")
    for a, row, j in zip(gam, gaf, js):
        path, prev = [], None
        for m in a.mappings:
            key = (m.node_key, m.is_reverse)
            if key != prev:
                path.append(("<" if m.is_reverse else ">") + m.node_key)
                prev = key
        consumed = sum(e.get("from_length", 0) for m in a.mappings
                       for e in m.edits)
        want = (row[0], row[5], int(row[7]), int(row[8]) - int(row[7]))
        got = (a.name, "".join(path), a.mappings[0].offset, consumed)
        if got != want or j.get("name") != row[0]:
            raise AssertionError(f"outputs pass: GAM record {got} (JSON "
                                 f"{j.get('name')}) != GAF line {want}")
    log(f"outputs pass: {stats.reads} reads through align_reads on {dev}; "
        f"{len(gaf)} GAF lines == {len(gam)} GAM records read back "
        f"(names, node paths, offsets, lengths) == {len(js)} JSON lines; "
        f"launches {json.dumps(launches)}")
    return dict(records=len(gam), launches=launches, gam=gam_bytes)


def run_golden100(dev):
    """The golden100 set (scripts/make_golden100.py) through ChainerModel
    at the default config on the card, held to tests/test_parity.py's pins
    (100/100 aligned, >= 95 at or below the reference binary's edit
    distance, mean delta <= 0.3)."""
    import tempfile
    import torch
    from graphchainer_torch.graph.mpc import build_mpc
    from graphchainer_torch.index.minimizer import build_index
    from graphchainer_torch.models.chainer import ChainerModel
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.workload import golden100_workload
    with tempfile.TemporaryDirectory() as td:
        _, g, reads = golden100_workload(td)
    pins = golden("golden100.json")
    if len(reads) != pins["n_reads"] or any(
            pins["reads"][n]["len"] != len(s) for n, s in reads):
        raise AssertionError("golden100: the workload differs from the "
                             "pinned one")
    model = ChainerModel(g, build_mpc(g), build_index(g, k=15, w=10),
                         device=dev)
    model.align_batch(reads[:4])
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    alns = model.align_batch(reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _cuda.launches()
    for k in MAIN_PATH_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"golden100: kernel {k} never launched")
    log(f"golden100: {len(reads)} reads in {wall:.3f} s; launches "
        f"{json.dumps(launches)}")
    return dict(score_golden("golden100", model.gx, reads, alns, pins, 95,
                             0.3), launches=launches, seconds=wall)


# ---------------------------------------------------------------- phase 7
def write_bench_inputs(td, graph_bp, reads):
    """The bench graph as GFA and `reads` as FASTA under td: (gfa, fa)."""
    import os
    import numpy as np
    from graphchainer_torch.workload import _write_gfa, build_bench_graph
    gfa = os.path.join(td, "bench.gfa")
    _write_gfa(build_bench_graph(np.random.default_rng(7), graph_bp), gfa)
    fa = os.path.join(td, f"reads{len(reads)}.fa")
    with open(fa, "w") as fh:
        fh.write("".join(f">{n}\n{s}\n" for n, s in reads))
    return gfa, fa


def seeded_params(gfa, fa, out_gaf, dev, **seeding):
    """The pipeline's parameters of the seeded passes: the bench pass's
    batches, workers and minimizer index (the rescue's seeds), and
    `seeding` (mem_count / mum_count / mxm_length / mxm_cache_prefix /
    seed_file)."""
    from graphchainer_torch.pipeline import PipelineParams
    return PipelineParams(graph_file=gfa, read_files=[fa], out_gaf=out_gaf,
                          batch_size=128, inflight=4, seed_k=15, seed_w=10,
                          device=str(dev), **seeding)


def seeds_subset_job(graph_bp, n_reads, read_len, n_sub, seeding,
                     gam=None):
    """The first n_sub bench reads through pipeline.align_reads on the CPU
    (the plain versions), in a process of its own, with `seeding` (file
    seeds: the GAM's bytes, written here).  Returns the GAF lines."""
    import os
    import tempfile
    import torch
    torch.set_num_threads(1)
    from graphchainer_torch.pipeline import align_reads
    from graphchainer_torch.workload import bench_workload
    reads = bench_workload(graph_bp, n_reads, read_len)[4][:n_sub]
    with tempfile.TemporaryDirectory() as td:
        gfa, fa = write_bench_inputs(td, graph_bp, reads)
        seeding = dict(seeding)
        if gam is not None:
            seeding["seed_file"] = os.path.join(td, "seeds.gam")
            with open(seeding["seed_file"], "wb") as fh:
                fh.write(gam)
        if seeding.get("mxm_cache_prefix"):
            seeding["mxm_cache_prefix"] = os.path.join(td, "sa")
        out = os.path.join(td, "out.gaf")
        align_reads(seeded_params(gfa, fa, out, "cpu", **seeding))
        with open(out) as fh:
            return fh.read().splitlines()


def gaf_accuracy(lines, reads):
    """(aligned_fraction, mean_norm_edit_distance) of a CLC run's GAF
    lines: one line per aligned read, its NM edit distance over the read's
    length."""
    import numpy as np
    eds = [int(next(f for f in ln.split("\t") if f.startswith("NM:i:"))[5:])
           / max(int(ln.split("\t")[1]), 1) for ln in lines]
    return len(lines) / max(len(reads), 1), (float(np.mean(eds)) if eds
                                             else None)


def run_seeded(label, graph_bp, reads, dev, sub, gam=None, **seeding):
    """The bench reads through pipeline.align_reads on the card with
    `seeding`, the launch counts set to 0 just before and read just
    after: reads/s (the wall of align_reads, set-up included), accuracy
    within the limits, every read of the workload seeded and the GAF lines
    of the subset run on the CPU (sub: the future of seeds_subset_job)
    byte-equal to the card's.  With mxm_cache_prefix the suffix array is
    built (timed) and saved first, and the pass loads it; gam: the bytes
    of a seed file for seed_file."""
    import os
    import tempfile
    import torch
    from graphchainer_torch import pipeline
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.utils import timers
    with tempfile.TemporaryDirectory() as td:
        gfa, fa = write_bench_inputs(td, graph_bp, reads)
        sa_s = None
        if gam is not None:
            seeding["seed_file"] = os.path.join(td, "seeds.gam")
            with open(seeding["seed_file"], "wb") as fh:
                fh.write(gam)
        if seeding.get("mxm_cache_prefix"):
            seeding["mxm_cache_prefix"] = os.path.join(td, "sa")
            t0 = time.perf_counter()
            pipeline.get_or_build_mem(pipeline.load_graph(gfa),
                                      seeding["mxm_cache_prefix"])
            sa_s = time.perf_counter() - t0
        out = os.path.join(td, "out.gaf")
        params = seeded_params(gfa, fa, out, dev, **seeding)
        torch.cuda.synchronize()
        timers.reset()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        stats = pipeline.align_reads(params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _cuda.launches()
        counters = timers.counters()
        stages = {k: round(v[0], 3) for k, v in timers.snapshot().items()}
        with open(out) as fh:
            lines = fh.read().splitlines()
    aligned, ned = gaf_accuracy(lines, reads)
    log(f"{label}: {stats.reads} reads in {wall:.3f} s = "
        f"{stats.reads / wall:.2f} reads/s (align_reads, set-up included)"
        + (f"; suffix array built and saved in {sa_s:.3f} s" if sa_s
           is not None else "")
        + f"; seeds found {stats.seeds_found}, reads with a seed "
        f"{stats.reads_with_a_seed}; aligned_fraction {aligned:.4f}, "
        f"mean_norm_edit_distance {ned:.4f}; escalated reads "
        f"{counters.get('escalated_reads', 0)}, rescued reads "
        f"{counters.get('rescued_reads', 0)}; launches "
        f"{json.dumps(launches)}")
    log(f"{label}: stage seconds (thread-summed) {json.dumps(stages)}")
    need = MAIN_PATH_KERNELS + (("frag_core_carried",)
                                if counters.get("rescued_reads", 0) else ())
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"{label}: kernel {k} never launched")
    if aligned < ACC_ALIGNED_MIN or ned is None or ned > ACC_NORM_ED_MAX:
        raise AssertionError(f"{label}: aligned_fraction {aligned}, "
                             f"mean_norm_edit_distance {ned}")
    cpu = sub.result()
    names = {ln.split("\t")[0] for ln in cpu}
    card = [ln for ln in lines if ln.split("\t")[0] in names]
    if card != cpu or not cpu:
        raise AssertionError(f"{label}: the {len(cpu)} GAF lines of the CPU "
                             "subset differ from the card's")
    log(f"{label}: the {len(cpu)} GAF lines of a {len(cpu)}-read subset on "
        "the CPU (plain versions) == the card's, byte for byte")
    return dict(reads=stats.reads, seconds=wall,
                reads_per_s=stats.reads / wall, aligned_fraction=aligned,
                mean_norm_edit_distance=ned, seeds=stats.seeds_found,
                sa_build_s=sa_s, launches=launches, stages=stages,
                escalated=counters.get("escalated_reads", 0),
                rescued=counters.get("rescued_reads", 0), lines=lines)


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_two_processes(graph_bp, reads, dev):
    """python -m graphchainer_torch on the bench reads as two processes on
    one card (--num-processes 2, gloo at a free local port) and as one
    process, all three at once: the merged, sorted .part0 / .part1 GAF
    lines equal the one-process GAF lines, sorted, and each of the two
    reports the one-process run's read and aligned counts."""
    import os
    import re
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as td:
        gfa, fa = write_bench_inputs(td, graph_bp, reads)
        base = [sys.executable, "-m", "graphchainer_torch", "-g", gfa, "-f",
                fa, "--device", str(dev), "--seeds-minimizer-length", "15",
                "--seeds-minimizer-windowsize", "10", "--batch-size", "128",
                "-t", "4"]
        coord = f"127.0.0.1:{free_port()}"
        runs = {"one": base + ["-a", os.path.join(td, "one.gaf")]}
        for i in range(2):
            runs[f"part{i}"] = base + [
                "-a", os.path.join(td, "two.gaf"), "--num-processes", "2",
                "--process-id", str(i), "--coordinator", coord]
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(v, cwd=here, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, v in runs.items()}
        outs = {}
        try:
            for k, p in procs.items():
                o, e = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"two processes: {k} exited "
                                         f"{p.returncode}: {e[-2000:]}")
                outs[k] = o
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0

        def lines(path):
            with open(path) as fh:
                return fh.read().splitlines()
        one = sorted(lines(os.path.join(td, "one.gaf")))
        parts = [lines(os.path.join(td, f"two.gaf.part{i}"))
                 for i in range(2)]
    merged = sorted(parts[0] + parts[1])
    if merged != one or not one:
        raise AssertionError(f"two processes: {len(merged)} merged GAF lines "
                             f"!= the {len(one)} of one process")

    def counts(o):
        return (re.search(r"Input reads: (\d+)", o).group(1),
                re.search(r"Reads with an alignment: (\d+)", o).group(1))
    if not counts(outs["part0"]) == counts(outs["part1"]) \
            == counts(outs["one"]):
        raise AssertionError(f"two processes: counts {counts(outs['part0'])}"
                             f" / {counts(outs['part1'])}, one process "
                             f"{counts(outs['one'])}")
    log(f"two processes on one card: {len(parts[0])} + {len(parts[1])} GAF "
        f"lines, merged and sorted == the one-process run's {len(one)}; "
        f"each reports (input reads, reads with an alignment) "
        f"{counts(outs['one'])} == one process; all three in {wall:.2f} s")
    return dict(parts=[len(x) for x in parts], lines=len(one), seconds=wall)


def run_big_mem(gb, mpcb, indexb, readsb, dev):
    """MEM seeds on the chromosome-scale graph: the suffix array built
    (timed), saved as PREFIX.sa.npz and loaded back equal, and 128 reads
    aligned with MEM seeds on the card."""
    import os
    import tempfile
    import numpy as np
    import torch
    from graphchainer_torch import pipeline
    from graphchainer_torch.index.mem import MemIndex, MemSeeder
    from graphchainer_torch.models.chainer import ChainerModel
    with tempfile.TemporaryDirectory() as td:
        prefix = os.path.join(td, "big")
        t0 = time.perf_counter()
        idx = pipeline.get_or_build_mem(gb, prefix)
        build_s = time.perf_counter() - t0
        size = os.path.getsize(prefix + ".sa.npz")
        t0 = time.perf_counter()
        back = MemIndex.load(prefix + ".sa.npz")
        load_s = time.perf_counter() - t0
    for k in ("text", "sa", "starts"):
        if not np.array_equal(getattr(idx, k), getattr(back, k)):
            raise AssertionError(f"big graph MEM index: {k} differs after "
                                 "the .sa.npz round trip")
    seeder = MemSeeder(gb, back, min_len=20, max_count=8)
    model = ChainerModel(gb, mpcb, indexb,
                         seed_fn=lambda n, s: seeder.get_seeds(s),
                         device=dev)
    t0 = time.perf_counter()
    alns = model.align_batch(readsb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = sum(not a.failed for a in alns)
    ned = float(np.mean([a.score / len(a.seq) for a in alns
                         if not a.failed]))
    log(f"big graph MEM: suffix array of {len(idx.text)} bases built and "
        f"saved in {build_s:.2f} s ({size} bytes), loaded back equal in "
        f"{load_s:.2f} s; {len(readsb)} reads with MEM seeds in {wall:.3f} "
        f"s = {len(readsb) / wall:.2f} reads/s; aligned {ok}/{len(readsb)},"
        f" mean_norm_edit_distance {ned:.4f}")
    if ok < 0.99 * len(readsb):
        raise AssertionError(f"big graph MEM: only {ok} reads aligned")
    return dict(text=len(idx.text), build_s=build_s, load_s=load_s,
                bytes=size, seconds=wall, aligned=ok, ned=ned)


def mix_inputs_job(workdir, graph_bp, counts):
    """The sustained mix's GFA and FASTA (workload.sustained_workload:
    scripts/sustained_test.py's bytes) in workdir, in a process of its
    own: (GFA path, FASTA path, seconds)."""
    from graphchainer_torch.workload import sustained_workload
    return sustained_workload(workdir, graph_bp, counts)


def start_mixed_cli(mix_inputs, workdir):
    """python -m graphchainer_torch on the card on the mixed reads, at the
    configuration of tests/torch_fixtures/scale_mix.json (the default,
    sampling step 1), as a child process: (child, GAF path, log path,
    start time)."""
    import os
    gfa, fa, _ = mix_inputs
    out = os.path.join(workdir, "mixed.gaf")
    log_path = os.path.join(workdir, "mixed.log")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as fh:
        child = subprocess.Popen(
            [sys.executable, "-m", "graphchainer_torch", "-g", gfa, "-f", fa,
             "-a", out, "--sampling-step", "1", "--device", "cuda"],
            stdout=fh, stderr=subprocess.STDOUT, cwd=here)
    _CHILDREN.append(child)
    return child, out, log_path, time.perf_counter()


def check_mixed_cli(started):
    """The mixed CLI run's GAF lines and count lines against the JAX
    package's (tests/torch_fixtures/scale_mix.json), line for line."""
    import os
    from graphchainer_torch.scale import read_counts
    child, out, log_path, t0 = started
    rc = child.wait(timeout=1200)
    wall = time.perf_counter() - t0
    with open(log_path) as fh:
        text = fh.read()
    if rc != 0:
        raise AssertionError(f"mixed reads CLI exited {rc}: {text[-3000:]}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "torch_fixtures", "scale_mix.json")) as fh:
        want = json.load(fh)
    with open(out) as fh:
        lines = fh.read().splitlines()
    ref = want["gaf"]
    if lines != ref:
        bad = [i for i, (a, b) in enumerate(zip(lines, ref)) if a != b]
        raise AssertionError(
            f"mixed reads CLI: {len(lines)} GAF lines against the JAX "
            f"package's {len(ref)}, lines {bad[:10]} differ (first: "
            f"{lines[bad[0]][:300] if bad else ''!r})")
    counts = read_counts(text)
    if counts != want["counts"]:
        raise AssertionError(f"mixed reads CLI: counts {counts}, the JAX "
                             f"package's {want['counts']}")
    log(f"mixed reads CLI (python -m graphchainer_torch, {CHROM_BP} bp "
        f"backbone, "
        f"{sum(MIX_COUNTS)} reads of ~1.5 / 3 / 9 kbp): {len(lines)} GAF "
        f"lines == the JAX package's (scale_mix.json), counts "
        f"{json.dumps(counts)}; child wall {wall:.1f} s (graph loaded and "
        f"indexed in the child)")
    return dict(lines=len(lines), wall=wall, counts=counts)


def run_chromosome(dev, pool, mixed):
    """Phase 4: the 20 Mbp backbone, built once: 128 reads of ~3 kbp, its
    MEM index and MEM seeds; the mixed CLI run started on it; 1920 reads
    through align_batch (scripts/scale_test.py's run: 6 workers, batches
    of 64, one warm and one timed pass) with accuracy bounds, the main
    path's launches, peak device memory and host RSS; and a batch of 128
    reads of the ~9 kbp class, whose stitched paths the plain polish
    versions take in the pool (returned: the pairs and the futures, timed
    against the kernels after phase 6)."""
    import resource
    import numpy as np
    import torch
    from graphchainer_torch.graph.mpc import build_mpc
    from graphchainer_torch.graph.simulate import (generate_path,
                                                   simulate_reads)
    from graphchainer_torch.index.minimizer import build_index
    from graphchainer_torch.models.chainer import ChainerModel, timers
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.workload import MIX_CLASSES, scale_graph
    t0 = time.perf_counter()
    _, gb, synth_s, graph_s = scale_graph(CHROM_BP)
    t1 = time.perf_counter()
    mpcb = build_mpc(gb)
    indexb = build_index(gb, k=15, w=10)
    index_s = time.perf_counter() - t1
    path_seq, _ = generate_path(gb, seed=3)
    reads = simulate_reads(path_seq, CHROM_READS, 3000, seed=11,
                           error_rate=0.10, len_std=300)
    readsb = reads[:128]
    log(f"big graph: {CHROM_BP} bp backbone, {json.dumps(gb.stats())}; "
        f"synthesis {synth_s:.2f} s, graph {graph_s:.2f} s, MPC and "
        f"minimizer index {index_s:.2f} s (host build "
        f"{time.perf_counter() - t0:.2f} s)")
    big = ChainerModel(gb, mpcb, indexb, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    tb = time.perf_counter()
    big.align_batch(readsb)
    torch.cuda.synchronize()
    first = time.perf_counter() - tb
    tb = time.perf_counter()
    alns = big.align_batch(readsb)
    torch.cuda.synchronize()
    dtb = time.perf_counter() - tb
    ok = sum(not a.failed for a in alns)
    ned = np.mean([a.score / len(a.seq) for a in alns if not a.failed])
    nb = len(readsb)
    log(f"big graph: {nb} reads in {dtb:.3f} s = {nb / dtb:.2f} reads/s "
        f"(first batch {first:.2f} s); aligned {ok}/{nb}, "
        f"mean_norm_edit_distance {ned:.4f}")
    if ok < 0.99 * nb:
        raise AssertionError(f"big graph: only {ok}/{nb} reads aligned")
    big_mem = run_big_mem(gb, mpcb, indexb, readsb, dev)

    # scripts/scale_test.py's pass: 1920 reads, batches of 64, 6 workers
    chunks = [reads[i:i + 64] for i in range(0, len(reads), 64)]
    tb = time.perf_counter()
    run_pass(big, chunks, 6)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tb
    timers.reset()
    _cuda.reset_launches()
    tb = time.perf_counter()
    af, ned = run_pass(big, chunks, 6)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tb
    launches = _cuda.launches()
    stages = {k: round(v[0], 3) for k, v in timers.snapshot().items()}
    log(f"chromosome pass: {len(reads)} reads in {wall:.3f} s = "
        f"{len(reads) / wall:.2f} reads/s (warm pass {warm_s:.2f} s, 6 "
        f"workers, batches of 64); aligned_fraction {af:.4f}, "
        f"mean_norm_edit_distance {ned:.4f}; launches {json.dumps(launches)}"
        f"; stage seconds (thread-summed) {json.dumps(stages)}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"chromosome pass: kernel {name} never "
                                 "launched")
    if af < ACC_ALIGNED_MIN or ned is None or ned > ACC_NORM_ED_MAX:
        raise AssertionError(f"chromosome pass: aligned_fraction {af}, "
                             f"mean_norm_edit_distance {ned}")

    # a batch of the ~9 kbp class (sustained_test.py's third class)
    mean, sd, seed = MIX_CLASSES[2]
    reads9 = simulate_reads(path_seq, LONG_READS, mean, seed=seed,
                            error_rate=0.10, len_std=sd)
    _cuda.reset_launches()
    tb = time.perf_counter()
    alns9 = big.align_batch(reads9)
    torch.cuda.synchronize()
    wall9 = time.perf_counter() - tb
    launches9 = _cuda.launches()
    ok9 = [a for a in alns9 if not a.failed]
    ned9 = float(np.mean([a.score / len(a.seq) for a in ok9]))
    pairs9 = [(a.seq, big.gx.positions_seq(a.positions)) for a in ok9]
    lens9 = [len(s) for _, s in reads9]
    log(f"~9 kbp batch: {LONG_READS} reads of {min(lens9)}-{max(lens9)} bp "
        f"in {wall9:.3f} s; aligned "
        f"{len(ok9)}/{LONG_READS}, mean_norm_edit_distance {ned9:.4f}; "
        f"longest stitched path {max(len(p) for _, p in pairs9)} bp; "
        f"launches {json.dumps(launches9)}")
    if len(ok9) < ACC_ALIGNED_MIN * LONG_READS or ned9 > ACC_NORM_ED_MAX:
        raise AssertionError(f"~9 kbp batch: {len(ok9)} aligned, "
                             f"mean_norm_edit_distance {ned9}")
    plain9 = {bw: pool.submit(polish_plain_job, pairs9, bw)
              for bw in LONG_BANDS}
    mixed_out = check_mixed_cli(mixed)
    peak = torch.cuda.max_memory_allocated()
    log(f"chromosome phase: peak device memory allocated {peak / 1e9:.3f} "
        "GB")
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"chromosome phase: host max RSS {rss:.3f} GB")
    return dict(graph=gb.stats(), mem=big_mem, reads=len(reads),
                reads_per_s=len(reads) / wall, aligned_fraction=af,
                mean_norm_edit_distance=ned, launches=launches,
                launches9=launches9, peak_device_gb=peak / 1e9, rss_gb=rss,
                mixed=mixed_out), pairs9, plain9


# ---------------------------------------------------------------- phase 8
def shard_sets():
    """(label, devices) of the multi-device runs: two shards of cuda:0,
    and every card when the machine has several."""
    import torch
    n = torch.cuda.device_count()
    out = [("two shards of cuda:0", ("cuda:0", "cuda:0"))]
    if n > 1:
        out.append((f"every card ({n})",
                    tuple(f"cuda:{i}" for i in range(n))))
    return out


def shard_launches(label, names, n_shards):
    """The launches of the run just made, by shard; fails unless every
    shard launched each kernel of `names`."""
    from graphchainer_torch.ops import _cuda
    per = _cuda.launches_by_shard()
    for i in range(n_shards):
        for name in names:
            if per.get(i, {}).get(name, 0) <= 0:
                raise AssertionError(f"{label}: shard {i} never launched "
                                     f"{name} ({json.dumps(per)})")
    return {str(i): {k: v for k, v in c.items() if v}
            for i, c in per.items()}


def run_multidevice(g, mpc, index, gx, reads, chunks, workers):
    """The device stages split over shards (parallel/device.py): on each
    of shard_sets(), the 128-read bench batch (CLC) and a GA batch of 32
    bench reads give one shard's alignments, every shard launching each
    kernel of its path; the bench pass on the shards against one shard's
    in turns (reads/s, accuracy equal), and at a polish band of
    12 (the run-time-bw entries on every shard); and shard_graph_tables
    on the five-component graph (four reads a component) equal to the
    replicated tables'."""
    import torch
    from graphchainer_torch.models.aligner import GraphAlignerModel
    from graphchainer_torch.models.chainer import (ChainerConfig,
                                                   ChainerModel, timers)
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.workload import component_chains_workload
    one = ChainerModel(g, mpc, index, gx=gx, device="cuda:0")
    batch = reads[:128]
    want = one.align_batch(batch)
    ga_reads = reads[:32]
    ga_want = GraphAlignerModel(g, index, gx=gx,
                                device="cuda:0").align_batch(ga_reads)
    cg, cmpc, cidx, creads = component_chains_workload(4)
    sharded_cfg = ChainerConfig(shard_graph_tables=True)
    c_want = ChainerModel(cg, cmpc, cidx, sharded_cfg,
                          device="cuda:0").align_batch(creads)
    if sum(not a.failed for a in c_want) != len(creads):
        raise AssertionError("five components: not every read aligned")

    def timed_pass(model):
        timers.reset()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        af, ned = run_pass(model, chunks, workers)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, af, ned

    out = {}
    n_reads = sum(len(c) for c in chunks)
    for label, devs in shard_sets():
        m = ChainerModel(g, mpc, index, gx=gx, device=devs)
        n = len(m.devices)
        _cuda.reset_launches()
        got = m.align_batch(batch)
        torch.cuda.synchronize()
        clc = shard_launches(f"{label}, 128 reads", MAIN_PATH_KERNELS, n)
        if not same_alignments(want, got):
            raise AssertionError(f"{label}: the 128-read batch differs from "
                                 "one shard's")
        log(f"{label}: {n} shards on {sorted({str(d) for d in m.devices})};"
            f" the 128-read batch == one shard's alignments; launches by "
            f"shard {json.dumps(clc)}")
        _cuda.reset_launches()
        ga_got = GraphAlignerModel(g, index, gx=gx,
                                   device=devs).align_batch(ga_reads)
        torch.cuda.synchronize()
        ga = shard_launches(f"{label}, GA batch", GA_PATH_KERNELS, n)
        if not same_alignments(ga_want, ga_got):
            raise AssertionError(f"{label}: the GA batch differs from one "
                                 "shard's")
        log(f"{label}: GA mode on {len(ga_reads)} reads == one shard's "
            f"alignments; launches by shard {json.dumps(ga)}")
        # in turns, one shard / the shards / the shards / one shard
        turns = {}
        for key, mm in (("one", one), ("shards", m), ("shards", m),
                        ("one", one)):
            turns.setdefault(key, []).append(timed_pass(mm))
            if key == "shards":
                bench = shard_launches(f"{label}, bench pass",
                                       MAIN_PATH_KERNELS, n)
                stages = {k: round(v[0], 3)
                          for k, v in timers.snapshot().items()}
        (_, af1, ned1), (_, af, ned) = turns["one"][0], turns["shards"][0]
        rates = {k: [n_reads / t[0] for t in v] for k, v in turns.items()}
        rate1, rate = (sum(rates[k]) / 2 for k in ("one", "shards"))
        log(f"{label}: bench pass of {n_reads} reads in turns, one shard / "
            f"the shards / the shards / one shard: "
            f"{rates['one'][0]:.2f} / {rates['shards'][0]:.2f} / "
            f"{rates['shards'][1]:.2f} / {rates['one'][1]:.2f} reads/s; "
            f"means {rate:.2f} against one shard's {rate1:.2f} = "
            f"{rate / rate1:.3f}x; aligned_fraction {af:.4f}, "
            f"mean_norm_edit_distance {ned:.4f} (one shard {af1:.4f}, "
            f"{ned1:.4f}); launches by shard {json.dumps(bench)}; stage "
            f"seconds of its last pass (thread-summed) {json.dumps(stages)}")
        if any(t[1:] != (af, ned) for v in turns.values() for t in v):
            raise AssertionError(f"{label}: the bench passes' accuracy "
                                 "differs between turns")
        if (af, ned) != (af1, ned1) or af < ACC_ALIGNED_MIN \
                or ned > ACC_NORM_ED_MAX:
            raise AssertionError(f"{label}: the bench pass's accuracy is not "
                                 "one shard's, or out of bounds")
        _cuda.reset_launches()
        run_pass(ChainerModel(g, mpc, index,
                              ChainerConfig(polish_band_words=12), gx=gx,
                              device=devs), chunks, workers)
        torch.cuda.synchronize()
        bench12 = shard_launches(f"{label}, bench pass at polish band 12",
                                 ("frag_core",) + ANY_PATH_KERNELS, n)
        log(f"{label}: bench pass at polish band 12, launches by shard "
            f"{json.dumps(bench12)}")
        sm = ChainerModel(cg, cmpc, cidx, sharded_cfg, device=devs)
        if sm.gx.shards is None:
            raise AssertionError(f"{label}: no component shards planned")
        _cuda.reset_launches()
        c_got = sm.align_batch(creads)
        torch.cuda.synchronize()
        comp = shard_launches(f"{label}, sharded tables", ("frag_core",), n)
        if not same_alignments(c_want, c_got):
            raise AssertionError(f"{label}: sharded tables differ from the "
                                 "replicated tables")
        log(f"{label}: shard_graph_tables on the five-component graph "
            f"({len(creads)} reads, {sm.gx.shards[1].rows_per_dev} rows a "
            f"block) == replicated tables; launches by shard "
            f"{json.dumps(comp)}")
        out[label] = dict(shards=n, reads_per_s=rate,
                          one_shard_reads_per_s=rate1, turns=rates,
                          aligned_fraction=af, norm_ed=ned,
                          launches_by_shard=dict(bench=bench, ga=ga,
                                                 bench12=bench12,
                                                 sharded_tables=comp))
    return out


def run_fusion():
    """python -m graphchainer_torch.tools fusion-finder on the card (the
    current card) on workload.fusion_workload's two genes: the fused read
    is the single call, with the pair (GENEA, GENEB), and GA mode's
    kernels launched."""
    import os
    import tempfile
    import torch
    from graphchainer_torch import tools
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.workload import fusion_workload
    with tempfile.TemporaryDirectory() as td:
        tsv = os.path.join(td, "fusions.tsv")
        corr = os.path.join(td, "corr.fa")
        _cuda.reset_launches()
        t0 = time.perf_counter()
        rc = tools.main(fusion_workload(td) + [
            "--fusions-out", tsv, "--corrected-out", corr, "--device",
            "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _cuda.launches()
        with open(tsv) as fh:
            calls = [ln.split("\t") for ln in fh.read().splitlines()]
        with open(corr) as fh:
            rec = fh.read().splitlines()
    if rc != 0 or len(calls) != 1 or calls[0][0] != "fused" \
            or {calls[0][1], calls[0][2]} != {"GENEA", "GENEB"} \
            or len(rec) != 2 or len(rec[1]) < 500:
        raise AssertionError(f"fusion-finder: rc {rc}, calls {calls}")
    # GA windows, then the polish at the tool's band of 4 words (the
    # run-time-bw entries)
    for name in ("frag_core_carried",) + ANY_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"fusion-finder: {name} never launched")
    log(f"fusion-finder on the card: the single call {calls[0]} in "
        f"{wall:.2f} s; launches {json.dumps(launches)}")
    return dict(call=calls[0], seconds=wall, launches=launches)


# ---------------------------------------------------------------- phase 3
def run_pass(model, chunks, workers):
    import numpy as np
    aligned, scores = 0, []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for chunk, alns in zip(chunks, pool.map(model.align_batch, chunks)):
            for (_, seq), a in zip(chunk, alns):
                if not a.failed:
                    aligned += 1
                    scores.append(a.score / max(len(seq), 1))
    n = sum(len(c) for c in chunks)
    return aligned / max(n, 1), float(np.mean(scores)) if scores else None


def profile_pass(model, chunks, workers):
    """One pass under torch.profiler: device time summed over kernels
    (they share one stream, so the sum is the busy time) against the
    pass's wall time, and the hand kernels' shares."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_pass(model, chunks, workers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    events = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
              if dev_us(e) > 0]
    busy = sum(t for t, _, _ in events) / 1e6
    if not events:
        log("profile: the profiler recorded no device time")
        return
    log(f"profile: pass wall {wall:.3f} s under the profiler, device busy "
        f"{busy:.4f} s, busy share {busy / wall:.4f} ({workers} workers, "
        f"device-stage lock)")
    for t, n, key in sorted(events, reverse=True)[:12]:
        log(f"profile:   {t / 1e3:10.3f} ms  {n:6d} x  {key[:90]}")


def same_alignments(a_list, b_list) -> bool:
    import numpy as np
    for a, b in zip(a_list, b_list):
        if not (np.array_equal(np.asarray(a.positions),
                               np.asarray(b.positions))
                and a.score == b.score and a.n_anchors == b.n_anchors
                and a.n_chained == b.n_chained
                and ((a.ops is None and b.ops is None)
                     or (a.ops is not None and b.ops is not None
                         and np.array_equal(a.ops, b.ops)))):
            return False
    return len(a_list) == len(b_list)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="a small workload (first check of a new kernel); "
                         "skips the chromosome-scale graph")
    ap.add_argument("--profile", action="store_true",
                    help="one more pass of the main path under "
                         "torch.profiler: the device's busy share and the "
                         "kernels' device time by name")
    ap.add_argument("--devices-only", action="store_true",
                    help="after the build and the workload, only phases 8 "
                         "and 9 (several devices, the fusion finder): the "
                         "run for a machine with several cards")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: error: torch.cuda.is_available() is False; this "
              "smoke run needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from graphchainer_torch import native
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.models.chainer import (ChainerConfig,
                                                   ChainerModel, timers)
    from graphchainer_torch.workload import bench_workload, polish_hard_pairs

    # ---- 1. environment + build
    smi = nvidia_smi()
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.get_lib)      # g++ beside the nvcc runs,
                                                # each under its own lock
        _cuda.lib()
        cuda_s = time.perf_counter() - t0
        host.result()
    log(f"kernels built in {cuda_s:.2f} s (nvcc {_cuda.build_seconds:.2f} "
        f"s): {_cuda.library_path()}; host runtime ready after "
        f"{time.perf_counter() - t0:.2f} s (g++ {native.build_seconds:.2f} "
        f"s, started with nvcc): {native.library_path()}")

    # ---- 3's workload first: phase 2 takes its shapes from real batches
    quick = opts.quick
    n_reads, read_len, graph_bp = ((64, 1500, 12_000) if quick
                                   else (960, 3000, 60_000))
    g, mpc, index, _, reads, build_s = bench_workload(
        graph_bp, n_reads, read_len)
    log(f"workload: {graph_bp} bp graph ({g.n_nodes} split nodes), "
        f"{n_reads} reads of ~{read_len} bp; host build {build_s:.2f} s")
    model = ChainerModel(g, mpc, index, device="cuda")
    if opts.devices_only:
        chunks = [reads[i:i + 128] for i in range(0, len(reads), 128)]
        run_pass(model, chunks, 4)                  # warm
        out = dict(multidevice=run_multidevice(g, mpc, index, model.gx,
                                               reads, chunks, 4),
                   fusion=run_fusion())
        print(json.dumps(out))
        print(smi)
        return 0

    # ---- host work in processes of its own, beside phases 2-5, in the
    # order it is needed: the plain versions of the polish kernels on the
    # CPU (10-60 s each at the main path's widths), the CPU runs of the
    # seeded passes' subsets, the plain version of frag_wide (a minute and
    # more each) and optimal mode's reads, whose exact host traceback
    # takes a minute or more each
    n_timed = 32 if quick else 128
    # the main path's batch, whole: the warp entries' grid and the
    # strides of planes and path are its read count
    pairs_all = stitched_pairs(model, reads[:n_timed])
    pairs48 = [(r, p[:48]) for r, p in pairs_all[:32]]
    hard = [(r, p) for _, r, p in polish_hard_pairs(
        5, 8, 1500 if quick else 3000)]
    small_cap = 1600 if quick else 3200
    # (label, pairs, bw, small_cap, timed): every entry at every width of
    # both ramps on the main path's batch (timed there), a batch whose
    # 48 bp paths move the band several words a column, and the hard
    # cases, under an ops_cap that long walks overflow too
    polish_cases = ([("stitched paths", pairs_all, bw, 0, True)
                     for bw in WARP_BANDS + ANY_BANDS]
                    + [("48 bp paths, multi-word shifts", pairs48, 8, 0,
                        False),
                       ("hard cases mixed in", hard, 8, small_cap, False),
                       ("hard cases mixed in", hard, 16, 0, False)]
                    + [("48 bp paths, multi-word shifts", pairs48, bw, 0,
                        False) for bw in EDGE_BANDS + (WIDE_BAND,)]
                    + [("hard cases mixed in", hard, bw,
                        small_cap if bw == 12 else 0, False)
                       for bw in EDGE_BANDS])
    global _POOL
    pool = _POOL = ProcessPoolExecutor(
        max_workers=6, mp_context=multiprocessing.get_context("spawn"))
    # phase 4's mixed reads: the GFA and FASTA written first, beside phases
    # 2-3 (the CLI run on them starts with phase 4)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    _TMPDIRS.append(workdir)
    mix_inputs = None if quick else pool.submit(mix_inputs_job, workdir,
                                                CHROM_BP, MIX_COUNTS)
    polish_plain = [pool.submit(polish_plain_job, pr, bw, c)
                    for _, pr, bw, c, _ in polish_cases]
    n_sub = 8 if quick else 16
    seed_runs = {"MEM seeds": dict(mem_count=8, mxm_length=20,
                                   mxm_cache_prefix="sa"),
                 "MUM seeds": dict(mum_count=1, mxm_length=20)}
    seed_subs = {k: pool.submit(seeds_subset_job, graph_bp, n_reads,
                                read_len, n_sub, v)
                 for k, v in seed_runs.items()}
    wide = wide_cases(model, reads, dev)
    wide_plain = [pool.submit(wide_plain_job, *wide_to_numpy(a, kw))
                  for _, a, kw in wide]
    opt_futs = [pool.submit(optimal_job, i, graph_bp, n_reads, read_len)
                for i in range(2 if quick else 4)]
    log(f"host work started: {len(polish_plain)} plain polish runs, "
        f"{len(seed_subs)} seeded CPU subsets, {len(wide)} plain frag_wide "
        f"runs, {len(opt_futs)} optimal-mode reads")

    # ---- 2. kernels vs plain versions on the card
    frag = check_frag_all(model, reads, dev)
    carried_cases = check_carried_all(model, reads[:64], dev)
    pol = [check_polish(pr, bw, dev, label, f, timed=timed)
           for (label, pr, bw, _, timed), f in zip(polish_cases,
                                                    polish_plain)]
    pol_main = {c["bw"]: c for c in pol if "fill_ms" in c}
    pptx = check_ptxas("polish_core_any_kernel", 2, "words a lane")
    wptx_walk = check_ptxas("polish_walk_tile_kernel", 4,
                            "stride class")
    cptx = check_ptxas("frag_carried_kernel", 1)

    # ---- 3. the main path
    batch = 128
    chunks = [reads[i:i + batch] for i in range(0, len(reads), batch)]
    workers = 4
    tw = time.perf_counter()
    run_pass(model, chunks, workers)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - tw
    timers.reset()
    _cuda.reset_launches()
    t1 = time.perf_counter()
    aligned_frac, norm_ed = run_pass(model, chunks, workers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = _cuda.launches()
    stages = {k: round(v[0], 3) for k, v in timers.snapshot().items()}
    counters = timers.counters()
    log(f"main path: {n_reads} reads in {wall:.3f} s = "
        f"{n_reads / wall:.2f} reads/s (warm pass {warm_s:.2f} s, "
        f"{workers} workers, batches of {batch}); aligned_fraction "
        f"{aligned_frac:.4f}, mean_norm_edit_distance {norm_ed:.4f}; "
        f"escalated reads {counters.get('escalated_reads', 0)}, rescued "
        f"reads {counters.get('rescued_reads', 0)}")
    log("stage seconds (thread-summed): " + json.dumps(stages))
    log("counters: " + json.dumps(counters))
    log(f"kernel launches in the timed pass: {json.dumps(launches)}")
    for name in MAIN_PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if aligned_frac < ACC_ALIGNED_MIN or norm_ed is None \
            or norm_ed > ACC_NORM_ED_MAX:
        raise AssertionError(
            f"accuracy out of bounds: aligned_fraction {aligned_frac} "
            f"(>= {ACC_ALIGNED_MIN}), mean_norm_edit_distance {norm_ed} "
            f"(<= {ACC_NORM_ED_MAX})")
    if opts.profile:
        profile_pass(model, chunks, workers)
    small = reads[:8]
    gpu_alns = model.align_batch(small)
    cpu_model = ChainerModel(g, mpc, index, gx=model.gx, device="cpu")
    cpu_alns = cpu_model.align_batch(small)
    if not same_alignments(gpu_alns, cpu_alns):
        raise AssertionError("8-read check: the cuda run differs from the "
                             "plain versions on the cpu")
    log("8-read check: cuda alignments == cpu plain-version alignments")
    # the rescue path: every read of a batch compared with the GA baseline
    # (compare_with_baseline), on cuda and with the plain versions
    both = ChainerConfig(compare_with_baseline=True)
    _cuda.reset_launches()
    gpu_alns = ChainerModel(g, mpc, index, both, gx=model.gx,
                            device="cuda").align_batch(small[:4])
    torch.cuda.synchronize()
    rescue_launches = _cuda.launches()
    cpu_alns = ChainerModel(g, mpc, index, both, gx=model.gx,
                            device="cpu").align_batch(small[:4])
    if not same_alignments(gpu_alns, cpu_alns):
        raise AssertionError("4-read rescue check: the cuda run differs from "
                             "the plain versions on the cpu")
    if rescue_launches["frag_core_carried"] <= 0:
        raise AssertionError("4-read rescue check: the carried entry never "
                             "launched")
    log(f"4-read rescue check (compare_with_baseline): cuda alignments == "
        f"cpu plain-version alignments; launches "
        f"{json.dumps(rescue_launches)}")
    # the bench pass again from a polish band of 12 words (ramp 12 -> 24
    # -> 48): the run-time-bw entries
    model12 = ChainerModel(g, mpc, index, ChainerConfig(polish_band_words=12),
                           gx=model.gx, device="cuda")
    timers.reset()
    _cuda.reset_launches()
    t1 = time.perf_counter()
    af12, ned12 = run_pass(model12, chunks, workers)
    torch.cuda.synchronize()
    wall12 = time.perf_counter() - t1
    launches12 = _cuda.launches()
    stages12 = {k: round(v[0], 3) for k, v in timers.snapshot().items()}
    log(f"polish band 12: {n_reads} reads in {wall12:.3f} s = "
        f"{n_reads / wall12:.2f} reads/s; aligned_fraction {af12:.4f}, "
        f"mean_norm_edit_distance {ned12:.4f}; polish stage "
        f"{stages12.get('polish', 0.0)} s (the default pass's "
        f"{stages.get('polish', 0.0)} s); launches "
        f"{json.dumps(launches12)}; stage seconds (thread-summed) "
        f"{json.dumps(stages12)}")
    for name in ("frag_core",) + ANY_PATH_KERNELS:
        if launches12[name] <= 0:
            raise AssertionError(f"polish band 12: kernel {name} never "
                                 "launched")
    if af12 < ACC_ALIGNED_MIN or ned12 is None or ned12 > ACC_NORM_ED_MAX:
        raise AssertionError(f"polish band 12: aligned_fraction {af12}, "
                             f"mean_norm_edit_distance {ned12}")

    # ---- 4. the chromosome-scale graph
    chrom, pairs9, plain9 = None, None, {}
    if not quick:
        chrom, pairs9, plain9 = run_chromosome(
            dev, pool, start_mixed_cli(mix_inputs.result(), workdir))

    # ---- 5. GA mode and the rescue on the golden sets
    gold = run_golden(dev)

    # ---- 6. frag_wide, optimal mode, seedless DP, GAM / JSON, golden100
    wide_checks = [check_wide(label, a, kw, f.result())
                   for (label, a, kw), f in zip(wide, wide_plain)]
    from graphchainer_torch.models.optimal import OptimalAlignerModel
    from graphchainer_torch.ops import frag_align
    fa, fkw = OptimalAlignerModel(g, index, gx=model.gx,
                                  device=dev).component_inputs(reads[0][1], 0)
    full_ms = cuda_ms(lambda: frag_align.align_fragments(*fa, **fkw), reps=3)
    full_bnd = wide_bound(fa, fkw, frag_align.align_fragments(*fa, **fkw))
    log(f"frag_wide (optimal component, the whole read) "
        f"{wide_shape(fa, fkw)}: kernel {full_ms:.3f} ms, bound "
        f"{full_bnd[0]:.5f} ms by {full_bnd[1]} ({full_bnd[2]} bytes, "
        f"{full_bnd[3]} operations)")
    wptx = check_ptxas("frag_wide_kernel", 2, "best_in type")
    opt = check_optimal(model.gx, [f.result() for f in opt_futs])
    seedless = run_seedless(model, reads, dev)
    outputs = run_outputs(graph_bp, reads, dev)
    g100 = run_golden100(dev)

    # ---- 4 again: the fill and walk at the ~9 kbp batch's P, timed
    pol9 = {bw: check_polish(pairs9, bw, dev, "~9 kbp batch, 20 Mbp graph",
                             plain9[bw], timed=True)
            for bw in (LONG_BANDS if pairs9 else ())}
    polish_shape9 = pol9 and pol9[LONG_BANDS[0]]["P"]

    # ---- 7. MEM, MUM and file seeds; two processes on one card
    seed_subs["file seeds"] = pool.submit(
        seeds_subset_job, graph_bp, n_reads, read_len, n_sub, {},
        outputs["gam"])
    seeded = {k: run_seeded(k, graph_bp, reads, dev, seed_subs[k], **v)
              for k, v in seed_runs.items()}
    two = run_two_processes(graph_bp, reads, dev)
    seeded["file seeds"] = run_seeded("file seeds", graph_bp, reads, dev,
                                      seed_subs["file seeds"],
                                      gam=outputs["gam"])
    if seeded["file seeds"]["aligned_fraction"] != 1.0:
        raise AssertionError("file seeds: not every read aligned")
    pool.shutdown()

    # ---- 8. several devices in one process; 9. the fusion finder
    multi = run_multidevice(g, mpc, index, model.gx, reads, chunks, workers)
    fusion = run_fusion()
    log(f"devices: {torch.cuda.device_count()} card(s) visible; shard "
        f"sets run: {json.dumps({k: v['shards'] for k, v in multi.items()})}")

    # No single PyTorch call computes any of these functions (a banded
    # bit-parallel DP over a graph band, its linear form with a dump, a
    # data-dependent backtrace), so library_ms is null throughout.  The
    # warp polish rows are for bw=8, the band the main path starts every
    # batch with, the run-time-bw rows for bw=12 (the band-12 pass's
    # start); plain_ms is the plain version's one run on the same batch,
    # on the CPU.
    def entry(name, source, replaces, err, ms, plain_ms, bnd, **more):
        return dict({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": more.pop("launches", launches[name]),
                     "max_abs_err": err, "ms": round(ms, 4),
                     "plain_ms": round(plain_ms, 4),
                     "bound_ms": round(bnd[0], 6), "bound_by": bnd[1],
                     "library_ms": None,
                     "on_main_path": name in MAIN_PATH_KERNELS,
                     "bound_bytes": bnd[2], "bound_operations": bnd[3]},
                    **more)

    def polish_entry(name, kind, bands, bw0, **more):
        src = f"graphchainer_torch/csrc/polish_{kind}.cu"
        tpu = ("graphchainer_tpu/ops/pallas_polish2.py:182" if kind == "core"
               else "graphchainer_tpu/ops/linear_align.py:444")
        key = "fill" if kind == "core" else "walk"
        c0 = pol_main[bw0]
        return entry(
            name, src, tpu, 0, c0[f"{key}_ms"], c0[f"{key}_plain_ms"],
            c0[f"{key}_bound"], reads=len(pairs_all),
            ms_by_bw={str(bw): round(pol_main[bw][f"{key}_ms"], 4)
                      for bw in bands},
            plain_ms_by_bw={str(bw): round(pol_main[bw][f"{key}_plain_ms"], 1)
                            for bw in bands},
            bound_ms_by_bw={str(bw): round(pol_main[bw][f"{key}_bound"][0], 6)
                            for bw in bands}, **more)

    def by_shard(kind, name):
        """Each shard set's launches of `name` by shard (phase 8)."""
        return {label: {i: c.get(name, 0) for i, c in
                        v["launches_by_shard"][kind].items()}
                for label, v in multi.items()}

    frag_src = "graphchainer_torch/csrc/frag_core.cu"
    frag_tpu = "graphchainer_tpu/ops/pallas_frag.py:278"
    fm = frag["cases"][0]
    cm = next(c for c in carried_cases
              if c["label"] == "GA carried window padded to B=48")
    seeded_launches = {f"{k} pass": v["launches"] for k, v in seeded.items()}
    if chrom:
        seeded_launches.update({
            "20 Mbp graph, 1920 reads (chromosome pass)": chrom["launches"],
            f"20 Mbp graph, {LONG_READS} reads of ~9 kbp":
                chrom["launches9"]})

    def long_batch(key):
        """The fill's or walk's readings at the ~9 kbp batch's P."""
        return {} if not pol9 else dict(long_batch={
            "shape": f"R={len(pairs9)}, P={polish_shape9}",
            "ms_by_bw": {str(bw): round(c[f"{key}_ms"], 4)
                         for bw, c in pol9.items()},
            "bound_ms_by_bw": {str(bw): round(c[f"{key}_bound"][0], 6)
                               for bw, c in pol9.items()},
            "bound_by_bw": {str(bw): c[f"{key}_bound"][1]
                            for bw, c in pol9.items()},
            "plain_ms_by_bw": {str(bw): round(c[f"{key}_plain_ms"], 1)
                               for bw, c in pol9.items()}})
    kernels = [
        entry("frag_core", frag_src, frag_tpu, 0, fm["ms"], fm["plain_ms"],
              fm["bound"], shape=fm["shape"] + " (the main path's batch of "
              "128 reads, as run_fragments launches it)",
              ms_by_case={c["label"]: round(c["ms"], 4)
                          for c in frag["cases"]},
              plain_ms_by_case={c["label"]: round(c["plain_ms"], 3)
                                for c in frag["cases"]},
              ptxas={k: list(v) for k, v in frag["ptxas"].items()},
              launches_by_path={k: v["frag_core"]
                                for k, v in seeded_launches.items()},
              launches_by_shard=by_shard("bench", "frag_core")),
        entry("frag_core_carried", frag_src,
              "graphchainer_tpu/ops/frag_align.py:595", cm["err"], cm["ms"],
              cm["plain_ms"], cm["bound"],
              shape=cm["shape"] + " (GA mode's carried windows of the bench "
              "workload, padded to AlignerConfig.band_slots)",
              launches=gold["golden_cyclic"]["launches"]["frag_core_carried"],
              launches_by_path={
                  "bench workload (CLC, rescue)": launches[
                      "frag_core_carried"],
                  "4 bench reads, every read compared with the baseline":
                      rescue_launches["frag_core_carried"],
                  "golden_cyclic (GA mode)": gold["golden_cyclic"][
                      "launches"]["frag_core_carried"],
                  "golden_badread (CLC, rescue)": gold["golden_badread"][
                      "launches"]["frag_core_carried"],
                  "fusion-finder": fusion["launches"]["frag_core_carried"],
                  **{k: v["frag_core_carried"]
                     for k, v in seeded_launches.items()}},
              launches_by_shard=by_shard("ga", "frag_core_carried"),
              ms_by_case={c["label"]: round(c["ms"], 4)
                          for c in carried_cases},
              plain_ms_by_case={c["label"]: round(c["plain_ms"], 3)
                                for c in carried_cases},
              bound_ms_by_case={c["label"]: round(c["bound"][0], 6)
                                for c in carried_cases},
              ptxas={k: list(v) for k, v in cptx.items()},
              on_main_path=True),
        polish_entry("polish_core", "core", WARP_BANDS, 8,
                     launches_by_path={k: v["polish_core"]
                                       for k, v in seeded_launches.items()},
                     launches_by_shard=by_shard("bench", "polish_core"),
                     **long_batch("fill")),
        polish_entry("polish_walk", "walk", WARP_BANDS, 8,
                     launches_by_path={k: v["polish_walk"]
                                       for k, v in seeded_launches.items()},
                     launches_by_shard=by_shard("bench", "polish_walk"),
                     **long_batch("walk")),
        polish_entry("polish_core_any", "core", ANY_BANDS, 12,
                     launches=launches12["polish_core_any"],
                     ptxas={k: list(v) for k, v in pptx.items()},
                     launches_by_path={"bench pass, polish band 12":
                                       launches12["polish_core_any"],
                                       "fusion-finder":
                                       fusion["launches"]["polish_core_any"]},
                     launches_by_shard=by_shard("bench12", "polish_core_any")),
        polish_entry("polish_walk_any", "walk", ANY_BANDS, 12,
                     launches=launches12["polish_walk_any"],
                     ptxas={k: list(v) for k, v in wptx_walk.items()},
                     launches_by_path={"bench pass, polish band 12":
                                       launches12["polish_walk_any"],
                                       "fusion-finder":
                                       fusion["launches"]["polish_walk_any"]},
                     launches_by_shard=by_shard("bench12", "polish_walk_any")),
    ]
    wm = wide_checks[0]
    kernels.append(entry(
        "frag_wide", WIDE_SRC, WIDE_TPU, 0, wm["ms"], wm["plain_ms"],
        wm["bound"], launches=opt["launches"],
        shape=wm["shape"] + " (a component band of the bench graph, a "
        "64-row read prefix; plain_ms is the plain version on the CPU)",
        on_main_path=False,
        launches_by_path={
            f"optimal mode, {opt['reads']} bench reads": opt["launches"],
            "seedless DP, 8 poisoned bench reads": seedless[0]["launches"][
                "frag_wide"],
            "seedless DP, stride 1000": seedless[1000]["launches"][
                "frag_wide"]},
        ms_by_case={c["label"]: round(c["ms"], 4) for c in wide_checks},
        plain_ms_by_case={c["label"]: round(c["plain_ms"], 1)
                          for c in wide_checks},
        bound_ms_by_case={c["label"]: round(c["bound"][0], 6)
                          for c in wide_checks},
        shape_by_case={c["label"]: c["shape"] for c in wide_checks},
        whole_read=dict(shape=wide_shape(fa, fkw), ms=round(full_ms, 4),
                        bound_ms=round(full_bnd[0], 6),
                        bound_by=full_bnd[1]),
        optimal=opt, ptxas={k: list(v) for k, v in wptx.items()}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


_POOL = None        # phase 6's host processes, stopped on every way out
_CHILDREN = []      # child processes (phase 4's CLI run), killed likewise
_TMPDIRS = []       # their working directories, removed likewise


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for _child in _CHILDREN:
            if _child.poll() is None:
                _child.kill()
                _child.wait()
        if _POOL is not None:
            _POOL.shutdown(wait=True, cancel_futures=True)
        import shutil
        for _d in _TMPDIRS:
            shutil.rmtree(_d, ignore_errors=True)

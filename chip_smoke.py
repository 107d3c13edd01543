#!/usr/bin/env python3
"""Smoke run of graphchainer_torch (the PyTorch / CUDA port) on one GPU.

  python3 chip_smoke.py            # the full run, from the repo root

Phases (any failure raises and exits non-zero before the result line):
  1. environment: torch / CUDA versions, the card, building the CUDA
     kernels (csrc/*.cu, one nvcc per source for sm_90a) and, beside
     them, the C++ host runtime (g++);
  2. each kernel against its plain torch version on the card, exact
     equality, at the main path's shapes from real batches of the bench
     workload: frag_core on a 128-read batch as run_fragments launches it
     (the band at its own width B_eff, host-typed inputs), the same batch
     padded to B=32, the escalation shape B=96 / max_in=12 on 16 reads and
     the hard batches of workload.frag_hard_batch (B=8 / S=3 and B=128 /
     max_in=12), and nvcc's report of its registers and spills (any
     stack frame or spill fails); both entries (warp per read, thread
     per read) of polish_core and of polish_walk
     (score + backtrace over the fill's dump) at bw 8, 16 and 32 on 32
     reads against their stitched paths, on a batch whose 48 bp paths
     force band shifts of several words per column, and on a batch that
     mixes such reads, empty ones and long indels with ordinary reads,
     once under an ops_cap that long walks overflow; then both entries of
     both polish kernels timed in turns on a 128-read batch, with the
     bound of each kernel reckoned from that batch; and the carried entry
     of frag_core (GA mode's windows: a carried state in, the state and
     the best X cell out) on GA windows of the bench workload, fresh and
     carried, as launched and padded to B=48 and B=96, and on the hard
     batch with a random carry and per-slot trims, every output exact;
  3. the main path: bench.py's workload (960 reads of ~3 kbp at 10% error
     on the synthetic 60 kbp graph) through ChainerModel.align_batch on
     cuda, one warm pass and one timed pass; frag_core and the warp
     entries of both polish kernels must have launched in the timed pass;
     accuracy bounds; and 8 reads run again on the CPU (the plain
     versions) must give the same alignments, and so must 4 reads with
     every read compared with the GA baseline (the rescue path, through
     the carried entry);
  4. a real-size graph: 128 reads on a 5 Mbp graph from the same
     generator;
  5. GA mode (GraphAlignerModel on cuda) on the golden_cyclic set (36
     reads lapping cyclic graphs) and the CLC path with its GA rescue at
     the default config on the golden_badread set (80 reads), each held
     to the pins of tests/test_cyclic.py and tests/test_parity.py against
     the reference binary's edit distances (tests/data/golden_*.json);
  6. frag_wide (the F-major full-start DP of optimal mode and seedless
     DP) against its plain version on the CPU, every output exact: a
     whole component of the bench graph (B=4096) with a 64-row read
     prefix, the seedless tiles (B=1024, S=8, three restart offsets) and
     the hard batch with and without full_start; timed there and at a
     whole 3 kbp read (S=128); nvcc's report of its registers and
     spills; optimal mode (OptimalAlignerModel on cuda) on 4 bench reads,
     each score the exact DAG oracle's minimum; seedless DP
     (GraphAlignerModel(seedless_dp=True)) on 8 bench reads with every
     8th base substituted, without and with a restart stride, every read
     aligned; the bench pass through pipeline.align_reads with GAF, GAM
     and JSON outputs, the GAM read back to the GAF lines' alignments;
     and the golden100 set at the default config against
     tests/test_parity.py's pins.  The plain frag_wide runs and the
     optimal reads (whose exact traceback is a minute or more of host
     numpy each) run in processes of their own beside phases 2-3.

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
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

BIG_GRAPH_BP = 5_000_000     # phase 4: about an MHC-region graph
ACC_ALIGNED_MIN = 0.99       # aligned_fraction lower bound
ACC_NORM_ED_MAX = 0.095      # mean_norm_edit_distance upper bound (the
                             # reference package recorded 0.0864 here)
# the kernels the main path must launch; the serial entries of the polish
# kernels serve band widths it never uses and are timed as the yardstick
MAIN_PATH_KERNELS = ("frag_core", "polish_core", "polish_walk")
# the kernels GA mode must launch (its windows run the carried entry)
GA_PATH_KERNELS = ("frag_core_carried", "polish_core", "polish_walk")
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
    names its template arguments (integers, bools, int8_t / int16_t)."""
    import re
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\S+?)'?"
                      r"(?: for|$)", line.strip())
        if m:
            fn = m.group(1)
            continue
        m = re.search(rf"\d+{kernel}I(.*?)EEv", fn or "")
        if not m:
            continue
        args = [n if n else ("false", "true")[int(b)] if b
                else {"a": "int8_t", "s": "int16_t"}[c]
                for n, b, c in re.findall(_TEMPLATE_ARG, m.group(1))]
        key = f"{kernel}<{', '.join(args)}>"
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
    ptx = ptxas_report(_cuda.ptxas_log(), "frag_core_kernel")
    log(f"ptxas, frag_core_kernel<fragments a block> (registers, stack "
        f"frame, spill stores, spill loads bytes): {ptx}")
    if not ptx:
        raise AssertionError("no ptxas report of frag_core_kernel")
    for name, (_, stack, st, ld) in ptx.items():
        if stack or st or ld:
            raise AssertionError(f"{name}: {stack} bytes stack frame, "
                                 f"{st} / {ld} bytes spilled")
    return dict(cases=cases, ptxas=ptx)


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


def check_polish(pairs, bw, dev, label, small_cap=0):
    """Both entries of the fill kernel and of the walk kernel against the
    plain torch versions on the same pairs: the dump of each fill entry,
    then the packed rows of each walk entry over its own fill's dump
    (and, with small_cap, again under an ops_cap that short walks fit
    and long ones overflow).  Returns (fill max abs err, walk max abs
    err, plain fill ms, plain walk ms): the plain versions are timed in
    their one run here."""
    import torch
    from graphchainer_torch.ops import linear_align, polish_kernel
    from graphchainer_torch.ops.myers import u32
    k_in, p_in, steps, cap = polish_kernel_args(pairs, bw, dev)
    R, P = len(pairs), p_in[1].shape[0]
    ref = None

    def plain_fill():
        nonlocal ref
        ref = linear_align._polish_core_t(*p_in, bw)
    fill_plain = cuda_ms(plain_fill, warm=False)
    fill_err, dumps = 0, {}
    for entry in polish_kernel.ENTRIES:
        got = polish_kernel.polish_core_cuda(*k_in, bw, entry=entry)
        torch.cuda.synchronize()
        dumps[entry] = got
        for name, a, b, word in zip(("dump_vp", "dump_vn", "dump_sb",
                                     "dump_base"), got, ref,
                                    (True, True, False, False)):
            e = max_abs_diff(u32(a) if word else a, b)
            fill_err = max(fill_err, e)
            if e:
                raise AssertionError(
                    f"polish_core[{entry}] bw={bw} ({label}): {name} "
                    f"differs from the plain version (max abs diff {e})")
    walk_err, walk_plain, n_ok = 0, float("nan"), []
    for c in ((cap, small_cap) if small_cap else (cap,)):
        rows = None

        def plain_walk():
            nonlocal rows
            rows = linear_align._polish_walk_t(*ref, *p_in, bw, steps, c)
        t = cuda_ms(plain_walk, warm=False)
        if c == cap:
            walk_plain = t
        for entry in polish_kernel.ENTRIES:
            got = polish_kernel.polish_walk_cuda(*dumps[entry], *k_in, bw,
                                                 steps, c, entry=entry)
            torch.cuda.synchronize()
            e = max_abs_diff(got, rows)
            walk_err = max(walk_err, e)
            if e:
                raise AssertionError(
                    f"polish_walk[{entry}] bw={bw} ops_cap={c} ({label}): "
                    f"packed rows differ from the plain version (max abs "
                    f"diff {e})")
        n_ok.append(int((rows[:, 1] >= 0).sum()))
    log(f"polish bw={bw} ({label}) R={R} RW={k_in[0].shape[1]} P={P} "
        f"max_steps={steps} ops_cap={cap}"
        + (f" and {small_cap}" if small_cap else "")
        + f": fill and walk, warp and serial entries, exact "
        f"({'/'.join(map(str, n_ok))} of {R} walks complete); plain fill "
        f"{fill_plain:.3f} ms, plain walk {walk_plain:.3f} ms")
    return fill_err, walk_err, fill_plain, walk_plain


def time_polish_entries(pairs, bw, dev, reps=5):
    """Old and new design of both polish kernels on one batch, in turns
    (warp, serial, serial, warp), `reps` launches a turn.  The rows of
    the two designs must be equal.  Returns {kernel: {entry: ms}} and the
    inputs' sizes for the bound."""
    import torch
    from graphchainer_torch.ops import polish_kernel
    k_in, _, steps, cap = polish_kernel_args(pairs, bw, dev)
    fill = {e: (lambda e=e: polish_kernel.polish_core_cuda(*k_in, bw,
                                                           entry=e))
            for e in polish_kernel.ENTRIES}
    dumps = {e: fill[e]() for e in polish_kernel.ENTRIES}
    walk = {e: (lambda e=e: polish_kernel.polish_walk_cuda(
        *dumps[e], *k_in, bw, steps, cap, entry=e))
        for e in polish_kernel.ENTRIES}
    rows = {e: walk[e]() for e in polish_kernel.ENTRIES}
    torch.cuda.synchronize()
    if not torch.equal(rows["warp"], rows["serial"]):
        raise AssertionError(f"polish bw={bw}: the warp entries' packed "
                             "rows differ from the serial entries'")
    out = {}
    for name, fns in (("polish_core", fill), ("polish_walk", walk)):
        turns = {"warp": [], "serial": []}
        for e in ("warp", "serial", "serial", "warp"):
            turns[e].append(cuda_ms(fns[e], reps=reps))
        out[name] = {e: sum(v) / len(v) for e, v in turns.items()}
        log(f"{name} bw={bw} R={len(pairs)} P={k_in[1].shape[0]} "
            f"RW={k_in[0].shape[1]}: warp {turns['warp'][0]:.4f} / "
            f"{turns['warp'][1]:.4f} ms, serial {turns['serial'][0]:.4f} / "
            f"{turns['serial'][1]:.4f} ms")
    return out, k_in, dumps["warp"], rows["warp"]


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
        log(f"{name}: {len(reads)} reads in {wall:.3f} s; launches "
            f"{json.dumps(launches)}; escalated reads "
            f"{counters.get('escalated_reads', 0)}, rescued reads "
            f"{counters.get('rescued_reads', 0)}")
        if counters.get("rescued_reads", 0):
            need = need + ("frag_core_carried",)
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"{name}: kernel {k} never launched")
        out[name] = dict(score_golden(name, model.gx, reads, alns,
                                      golden(f"{name}.json"), *pins),
                         launches=launches, seconds=wall,
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
    seedless tiles of the bench graph for three restart offsets of a read
    (S = 8), and the hard batch (pad slots, length-0 seed slots, slots
    past 32 columns, in-edges from pad slots, from beyond B and from the
    same or a higher level, levels past n_levels; int8 pointers at B = 64)
    with and without full_start.  Returns [(label, args, kw)]."""
    from graphchainer_torch.align.seedless import FullstartScanner
    from graphchainer_torch.models.optimal import OptimalAlignerModel
    opt = OptimalAlignerModel(model.g, model.index, gx=model.gx, device=dev)
    scan = FullstartScanner(model.g, model.gx, device=dev)
    read = reads[0][1]
    comp = opt.component_inputs(read[:64], 0)
    tiles = scan.scan_inputs(read, offsets=(0, 1000, 2000))[:2]
    return [("optimal component, a 64-row prefix", *comp),
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
    return dict(records=len(gam), launches=launches)


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
                         "skips the 5 Mbp graph")
    ap.add_argument("--profile", action="store_true",
                    help="one more pass of the main path under "
                         "torch.profiler: the device's busy share and the "
                         "kernels' device time by name")
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

    # ---- host work of phase 6 in processes of its own, beside phase 2:
    # the plain version of frag_wide on the CPU (a minute and more at the
    # bench graph's widths) and optimal mode's reads, whose exact host
    # traceback takes a minute or more each
    wide = wide_cases(model, reads, dev)
    global _POOL
    pool = _POOL = ProcessPoolExecutor(
        max_workers=6, mp_context=multiprocessing.get_context("spawn"))
    wide_plain = [pool.submit(wide_plain_job, *wide_to_numpy(a, kw))
                  for _, a, kw in wide]
    opt_futs = [pool.submit(optimal_job, i, graph_bp, n_reads, read_len)
                for i in range(2 if quick else 4)]
    log(f"phase 6 host work started: {len(wide)} plain frag_wide runs, "
        f"{len(opt_futs)} optimal-mode reads")

    # ---- 2. kernels vs plain versions on the card
    frag = check_frag_all(model, reads, dev)
    carried_cases = check_carried_all(model, reads[:64], dev)
    n_timed = 32 if quick else 128
    pairs_all = stitched_pairs(model, reads[:n_timed])
    # the main path's batch, whole: the warp entries' grid and the
    # strides of planes and path are its read count.  The plain versions
    # are timed here, in their one run on it
    pol = {bw: check_polish(pairs_all, bw, dev, "stitched paths")
           for bw in (8, 16, 32)}
    pairs = pairs_all[:32]
    checks = list(pol.values())
    # every path cut to 48 bp: each band moves several words a column
    checks.append(check_polish([(r, p[:48]) for r, p in pairs], 8, dev,
                               "48 bp paths, multi-word shifts"))
    # ordinary reads mixed with the hard cases (workload.polish_hard_pairs)
    hard = [(r, p) for _, r, p in polish_hard_pairs(
        5, 8, 1500 if quick else 3000)]
    checks.append(check_polish(hard, 8, dev, "hard cases mixed in",
                               small_cap=1600 if quick else 3200))
    checks.append(check_polish(hard, 16, dev, "hard cases mixed in"))
    pol_err = max(c[0] for c in checks)
    walk_err = max(c[1] for c in checks)
    # old and new design of both kernels, one call, at the main path's
    # batch size
    timed, bounds = {}, {}
    for bw in (8, 16, 32):
        timed[bw], k_in, dump, rows = time_polish_entries(
            pairs_all, bw, dev)
        bounds[bw] = {"polish_core": fill_bound(k_in, dump, bw),
                      "polish_walk": walk_bound(rows, k_in,
                                                dump[0].shape[0])}
        for name, bnd in bounds[bw].items():
            log(f"{name} bw={bw} R={len(pairs_all)}: bound {bnd[0]:.5f} ms "
                f"by {bnd[1]} ({bnd[2]} bytes, {bnd[3]} operations)")
        del k_in, dump, rows

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

    # ---- 4. a real-size graph
    if not quick:
        gb, mpcb, indexb, _, readsb, build_b = bench_workload(
            BIG_GRAPH_BP, 128, 3000)
        log(f"big graph: {BIG_GRAPH_BP} bp, {gb.n_nodes} split nodes; "
            f"host build {build_b:.2f} s")
        big = ChainerModel(gb, mpcb, indexb, device="cuda")
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
        log(f"big graph: 128 reads in {dtb:.3f} s = {128 / dtb:.2f} reads/s "
            f"(first batch {first:.2f} s); aligned {ok}/128, "
            f"mean_norm_edit_distance {ned:.4f}")
        if ok < 0.99 * 128:
            raise AssertionError(f"big graph: only {ok}/128 reads aligned")

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
    wptx = ptxas_report(_cuda.ptxas_log(), "frag_wide_kernel")
    log(f"ptxas, frag_wide_kernel (registers, stack frame, spill stores, "
        f"spill loads bytes): {wptx}")
    if len(wptx) != 2:
        raise AssertionError(f"no ptxas report of both frag_wide_kernel "
                             f"instantiations: {wptx}")
    for name, (_, stack, st, ld) in wptx.items():
        if stack or st or ld:
            raise AssertionError(f"{name}: {stack} bytes stack frame, "
                                 f"{st} / {ld} bytes spilled")
    opt = check_optimal(model.gx, [f.result() for f in opt_futs])
    pool.shutdown()
    seedless = run_seedless(model, reads, dev)
    outputs = run_outputs(graph_bp, reads, dev)
    g100 = run_golden100(dev)

    # No single PyTorch call computes any of these functions (a banded
    # bit-parallel DP over a graph band, its linear form with a dump, a
    # data-dependent backtrace), so library_ms is null throughout.  The
    # polish rows are for bw=8, the band the main path starts every batch
    # with; plain_ms is the plain version's one run on the same batch.
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

    def by_bw(name, which):
        return {str(bw): round(timed[bw][name][which], 4)
                for bw in sorted(timed)}

    frag_src = "graphchainer_torch/csrc/frag_core.cu"
    frag_tpu = "graphchainer_tpu/ops/pallas_frag.py:278"
    fm = frag["cases"][0]
    cm = next(c for c in carried_cases
              if c["label"] == "GA carried window padded to B=48")
    core_src = "graphchainer_torch/csrc/polish_core.cu"
    walk_src = "graphchainer_torch/csrc/polish_walk.cu"
    core_tpu = "graphchainer_tpu/ops/pallas_polish2.py:182"
    walk_tpu = "graphchainer_tpu/ops/linear_align.py:444"
    b8 = bounds[8]
    kernels = [
        entry("frag_core", frag_src, frag_tpu, 0, fm["ms"], fm["plain_ms"],
              fm["bound"], shape=fm["shape"] + " (the main path's batch of "
              "128 reads, as run_fragments launches it)",
              ms_by_case={c["label"]: round(c["ms"], 4)
                          for c in frag["cases"]},
              plain_ms_by_case={c["label"]: round(c["plain_ms"], 3)
                                for c in frag["cases"]},
              ptxas={k: list(v) for k, v in frag["ptxas"].items()}),
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
                      "launches"]["frag_core_carried"]},
              ms_by_case={c["label"]: round(c["ms"], 4)
                          for c in carried_cases},
              plain_ms_by_case={c["label"]: round(c["plain_ms"], 3)
                                for c in carried_cases},
              bound_ms_by_case={c["label"]: round(c["bound"][0], 6)
                                for c in carried_cases},
              on_main_path=True),
        entry("polish_core", core_src, core_tpu, pol_err,
              timed[8]["polish_core"]["warp"], pol[8][2], b8["polish_core"],
              reads=len(pairs_all), ms_by_bw=by_bw("polish_core", "warp"),
              bound_ms_by_bw={str(bw): round(bounds[bw]["polish_core"][0], 6)
                              for bw in sorted(bounds)}),
        entry("polish_walk", walk_src, walk_tpu, walk_err,
              timed[8]["polish_walk"]["warp"], pol[8][3], b8["polish_walk"],
              reads=len(pairs_all), ms_by_bw=by_bw("polish_walk", "warp"),
              bound_ms_by_bw={str(bw): round(bounds[bw]["polish_walk"][0], 6)
                              for bw in sorted(bounds)}),
        entry("polish_core_serial", core_src, core_tpu, pol_err,
              timed[8]["polish_core"]["serial"], pol[8][2],
              b8["polish_core"], reads=len(pairs_all),
              ms_by_bw=by_bw("polish_core", "serial")),
        entry("polish_walk_serial", walk_src, walk_tpu, walk_err,
              timed[8]["polish_walk"]["serial"], pol[8][3],
              b8["polish_walk"], reads=len(pairs_all),
              ms_by_bw=by_bw("polish_walk", "serial")),
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


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        if _POOL is not None:
            _POOL.shutdown(wait=True, cancel_futures=True)

#!/usr/bin/env python3
"""Smoke run of graphchainer_torch (the PyTorch / CUDA port) on one GPU.

  python3 chip_smoke.py            # the full run, from the repo root

Phases (any failure raises and exits non-zero before the result line):
  1. environment: torch / CUDA versions, the card, building both kernels
     (csrc/*.cu, nvcc for sm_90a);
  2. each kernel against its plain torch version on the card, exact
     equality, at the main path's shapes from real batches of the bench
     workload: frag_core at B=32 / S=2 / max_in=4 on a 128-read batch and
     at the escalation shape B=96 / max_in=12 on 16 reads; polish_core at
     bw 8, 16 and 32 on 32 reads against their stitched paths, plus a batch
     whose short paths force band shifts of several words per column;
     polish_walk (score + backtrace over the fill's dump) on the same;
  3. the main path: bench.py's workload (960 reads of ~3 kbp at 10% error
     on the synthetic 60 kbp graph) through ChainerModel.align_batch on
     cuda, one warm pass and one timed pass; both kernels must have
     launched in the timed pass; accuracy bounds; and 8 reads run again
     on the CPU (the plain versions) must give the same alignments;
  4. a real-size graph: 128 reads on a 5 Mbp graph from the same
     generator.

The last two lines are the card's `nvidia-smi` name and power limit and
{"ok": true, "device": {...}}.  The line before them is the kernel table.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

BIG_GRAPH_BP = 5_000_000     # phase 4: about an MHC-region graph
ACC_ALIGNED_MIN = 0.99       # aligned_fraction lower bound
ACC_NORM_ED_MAX = 0.095      # mean_norm_edit_distance upper bound (the
                             # reference package recorded 0.0864 here)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1, warm: bool = True) -> float:
    """Mean milliseconds of fn() on the card over `reps` runs, after one
    warm-up run (warm=False: the caller just ran fn)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
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
def frag_inputs(model, reads, B, max_in, slack, dev):
    """Lane-major fragment-core inputs of one real batch, bands padded to
    exactly B slots, as align_fragments_tl builds them."""
    import numpy as np
    import torch
    from graphchainer_torch.align.anchors import (assemble_batch_cols,
                                                  code0_padding,
                                                  level_bucket,
                                                  pad_rows_code0)
    from graphchainer_torch.models.chainer import match_masks
    from graphchainer_torch.ops.frag_align import lane_major
    jobs, _, _ = model._fragment_jobs_cols(reads)
    mm = match_masks("".join(s for _, s in reads))
    base = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s in reads], out=base[1:])
    (_, bnc, bi, ss, req, rows, S, bl) = assemble_batch_cols(
        model.gx, jobs, mm, base, B=B, max_in=max_in, slack=slack)
    b_eff = bnc.shape[1]
    if code0_padding(bnc, bi, req, rows, max_in):
        req = pad_rows_code0(req, rows)
    pad = B - b_eff
    bnc = np.pad(bnc, ((0, 0), (0, pad)), constant_values=-1)
    bi = np.pad(bi, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
    bl = np.pad(bl, ((0, 0), (0, pad)), constant_values=-1)
    eq, ln = model.gx.device_tables(dev)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(  # noqa: E731
        dev, torch.int64)
    args = lane_major(eq, ln, t(bnc), t(bi), t(ss),
                      t(req.astype(np.int64)), t(rows), t(bl))
    n_levels = level_bucket(bl, B)
    kw = dict(S=S, max_in=max_in, n_levels=n_levels)
    return args, kw, b_eff


def check_frag(model, reads, B, max_in, slack, dev):
    import torch
    from graphchainer_torch.ops import frag_align, frag_kernel
    from graphchainer_torch.ops.myers import to_i32_bits
    args, kw, b_eff = frag_inputs(model, reads, B, max_in, slack, dev)
    slot_eq_t, slot_len_t, band_in_t, band_level_t, req_t, fl, sb = args
    k_args = (to_i32_bits(slot_eq_t), slot_len_t.to(torch.int32),
              band_in_t.to(torch.int32), band_level_t.to(torch.int32),
              to_i32_bits(req_t), fl[0].to(torch.int32),
              sb[0].to(torch.int32))
    got = frag_kernel.frag_core_cuda(*k_args, **kw)
    torch.cuda.synchronize()
    ref = frag_align._frag_core_t(*args, **kw)
    ref = (ref[0][0], ref[1][0], ref[2][0], ref[3].permute(2, 1, 0))
    err = 0
    for name, a, b in zip(("best_score", "best_slot", "best_col",
                           "best_in"), got, ref):
        e = max_abs_diff(a, b)
        err = max(err, e)
        if e:
            raise AssertionError(f"frag_core B={B} max_in={max_in}: {name} "
                                 f"differs from the plain version (max "
                                 f"abs diff {e})")
    ms = cuda_ms(lambda: frag_kernel.frag_core_cuda(*k_args, **kw), reps=5)
    plain_ms = cuda_ms(lambda: frag_align._frag_core_t(*args, **kw),
                       warm=False)
    F = slot_eq_t.shape[2]
    log(f"frag_core B={B} (batch B_eff={b_eff}) S={kw['S']} "
        f"max_in={max_in} n_levels={kw['n_levels']} F={F}: exact; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


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


def check_polish(pairs, bw, dev, label, time_plain=True):
    import torch
    from graphchainer_torch.ops import linear_align, polish_kernel
    from graphchainer_torch.ops.myers import to_i32_bits, u32
    planes_t, path_t, rl, pl = polish_inputs(pairs, dev)[:4]
    k_args = (to_i32_bits(planes_t), path_t.to(torch.int32),
              rl.to(torch.int32), pl.to(torch.int32), bw)
    got = polish_kernel.polish_core_cuda(*k_args)
    torch.cuda.synchronize()
    ref = linear_align._polish_core_t(planes_t, path_t, rl, pl, bw)
    err = 0
    for name, a, b, word in zip(("dump_vp", "dump_vn", "dump_sb",
                                 "dump_base"), got, ref,
                                (True, True, False, False)):
        e = max_abs_diff(u32(a) if word else a, b)
        err = max(err, e)
        if e:
            raise AssertionError(f"polish_core bw={bw} ({label}): {name} "
                                 f"differs from the plain version (max abs "
                                 f"diff {e})")
    ms = cuda_ms(lambda: polish_kernel.polish_core_cuda(*k_args), reps=5)
    plain_ms = float("nan")
    if time_plain:
        plain_ms = cuda_ms(lambda: linear_align._polish_core_t(
            planes_t, path_t, rl, pl, bw), warm=False)
    log(f"polish_core bw={bw} ({label}) R={planes_t.shape[2]} "
        f"RW={planes_t.shape[1]} P={path_t.shape[0]}: exact; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


def check_walk(pairs, bw, dev, label, time_plain=True):
    """The walk kernel (score + backtrace + op packing) against its plain
    torch version, on the fill kernel's dump of the same pairs."""
    import torch
    from graphchainer_torch.align.polish import _ops_cap
    from graphchainer_torch.ops import linear_align, polish_kernel
    from graphchainer_torch.ops.myers import to_i32_bits
    planes_t, path_t, rl, pl, rc, _, steps = polish_inputs(pairs, dev)
    cap = _ops_cap(rc.shape[1] * 16, path_t.shape[0], bw)
    pi, ti = to_i32_bits(planes_t), path_t.to(torch.int32)
    rli, pli = rl.to(torch.int32), pl.to(torch.int32)
    dump = polish_kernel.polish_core_cuda(pi, ti, rli, pli, bw)
    k_args = dump + (pi, ti, rli, pli, bw, steps, cap)
    p_args = dump + (planes_t, path_t, rl, pl, bw, steps, cap)
    got = polish_kernel.polish_walk_cuda(*k_args)
    torch.cuda.synchronize()
    ref = linear_align._polish_walk_t(*p_args)
    err = max_abs_diff(got, ref)
    if err:
        raise AssertionError(f"polish_walk bw={bw} ({label}): packed rows "
                             f"differ from the plain version (max abs diff "
                             f"{err})")
    ms = cuda_ms(lambda: polish_kernel.polish_walk_cuda(*k_args), reps=5)
    plain_ms = float("nan")
    if time_plain:
        plain_ms = cuda_ms(lambda: linear_align._polish_walk_t(*p_args),
                           warm=False)
    n_ok = int((got[:, 1] >= 0).sum())
    log(f"polish_walk bw={bw} ({label}) R={len(pairs)} max_steps={steps} "
        f"ops_cap={cap}: exact ({n_ok} complete walks); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


def stitched_pairs(model, reads):
    """(read, its path sequence) for the reads the model aligns: the path
    that the chain stitch (and the corridor repair) chose."""
    alns = model.align_batch(reads)
    return [(seq, model.gx.positions_seq(a.positions))
            for (_, seq), a in zip(reads, alns) if not a.failed]


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
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: error: torch.cuda.is_available() is False; this "
              "smoke run needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from graphchainer_torch.ops import _cuda
    from graphchainer_torch.models.chainer import ChainerModel, timers
    from graphchainer_torch.workload import bench_workload

    # ---- 1. environment + build
    smi = nvidia_smi()
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.build_seconds:.2f} s): {_cuda.library_path()}")

    # ---- 3's workload first: phase 2 takes its shapes from real batches
    quick = opts.quick
    n_reads, read_len, graph_bp = ((64, 1500, 12_000) if quick
                                   else (960, 3000, 60_000))
    g, mpc, index, _, reads, build_s = bench_workload(
        graph_bp, n_reads, read_len)
    log(f"workload: {graph_bp} bp graph ({g.n_nodes} split nodes), "
        f"{n_reads} reads of ~{read_len} bp; host build {build_s:.2f} s")
    model = ChainerModel(g, mpc, index, device="cuda")

    # ---- 2. kernels vs plain versions on the card
    frag_err, frag_ms, frag_plain = check_frag(model, reads[:128], 32, 4, 8,
                                               dev)
    e2, _, _ = check_frag(model, reads[:16], 96, 12, 16, dev)
    frag_err = max(frag_err, e2)
    pairs = stitched_pairs(model, reads[:32])
    pol = {bw: check_polish(pairs, bw, dev, "stitched paths")
           for bw in (8, 16, 32)}
    short = [(r, p[:48] if i % 2 == 0 else p)
             for i, (r, p) in enumerate(pairs)]
    e3, _, _ = check_polish(short, 8, dev, "short paths, multi-word shifts",
                            False)
    pol_err = max([v[0] for v in pol.values()] + [e3])
    walk = {bw: check_walk(pairs, bw, dev, "stitched paths")
            for bw in (8, 16, 32)}
    e4, _, _ = check_walk(short, 8, dev, "short paths", False)
    walk_err = max([v[0] for v in walk.values()] + [e4])

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
        f"escalated reads {counters.get('escalated_reads', 0)}")
    log("stage seconds (thread-summed): " + json.dumps(stages))
    log("counters: " + json.dumps(counters))
    log(f"kernel launches in the timed pass: {json.dumps(launches)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    if aligned_frac < ACC_ALIGNED_MIN or norm_ed is None \
            or norm_ed > ACC_NORM_ED_MAX:
        raise AssertionError(
            f"accuracy out of bounds: aligned_fraction {aligned_frac} "
            f"(>= {ACC_ALIGNED_MIN}), mean_norm_edit_distance {norm_ed} "
            f"(<= {ACC_NORM_ED_MAX})")
    small = reads[:8]
    gpu_alns = model.align_batch(small)
    cpu_model = ChainerModel(g, mpc, index, gx=model.gx, device="cpu")
    cpu_alns = cpu_model.align_batch(small)
    if not same_alignments(gpu_alns, cpu_alns):
        raise AssertionError("8-read check: the cuda run differs from the "
                             "plain versions on the cpu")
    log("8-read check: cuda alignments == cpu plain-version alignments")

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

    kernels = [
        {"name": "frag_core", "route": "cuda",
         "source": "graphchainer_torch/csrc/frag_core.cu",
         "replaces": "graphchainer_tpu/ops/pallas_frag.py:278",
         "launches": launches["frag_core"], "max_abs_err": frag_err,
         "ms": round(frag_ms, 4), "plain_ms": round(frag_plain, 4)},
        {"name": "polish_core", "route": "cuda",
         "source": "graphchainer_torch/csrc/polish_core.cu",
         "replaces": "graphchainer_tpu/ops/pallas_polish2.py:182",
         "launches": launches["polish_core"], "max_abs_err": pol_err,
         "ms": round(pol[8][1], 4), "plain_ms": round(pol[8][2], 4)},
        {"name": "polish_walk", "route": "cuda",
         "source": "graphchainer_torch/csrc/polish_walk.cu",
         "replaces": "graphchainer_tpu/ops/linear_align.py:444",
         "launches": launches["polish_walk"], "max_abs_err": walk_err,
         "ms": round(walk[8][1], 4), "plain_ms": round(walk[8][2], 4)},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

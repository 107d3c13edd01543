"""Time two builds of the redesigned kernels in turns on one card.

  python -m graphchainer_torch.kernel_turns --other DIR [--out FILE]

DIR is the root of another checkout of this repository (an earlier
commit, unpacked with `git archive`).  Both trees' csrc/*.cu are built,
each into a library of its own, and at the shapes chip_smoke.py times
each kernel runs in turns, other - this - this - other, with the loaded
library swapped between the builds; every output of this tree's build
must equal the other's:
  - frag_wide: optimal mode's whole-component band with a 64-row prefix
    and with a whole 3 kbp read, the seedless tiles;
  - the run-time-bw polish fill polish_core_any and walk polish_walk_any
    on the 128-read bench polish batch at bw 1, 2, 3, 5, 6, 12, 24, 33,
    48 and 64 (and the walk at 100), and at 8 / 16 / 32 beside the
    template entries (the fill's of this tree, the walk's of the other
    tree where it has them);
    each tree's entries get the dump in the memory order its wrapper
    gives them (column-major in a tree without polish_kernel.read_major);
  - frag_core's carried entry on GA windows of 64 bench reads (fresh and
    carried, as launched and padded to B=48 and B=96) and on the hard
    batch, and its fresh entry at the main path's shape and padded to
    B=96, through this tree's wrappers (same C interface in both).
The times are CUDA events over a few launches (chip_smoke.cuda_ms's
method).

Prints one JSON object, with --out FILE also written there with the
ptxas report of every build.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

from graphchainer_torch.ops import _cuda


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps runs after one warm-up, behind a sleep
    queued on the card so the host's enqueue is not what is timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 300 * 2000))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def build(tag: str, sources) -> tuple:
    """(loaded library, nvcc log) of `sources` built as one library."""
    import hashlib
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as fh:
            h.update(fh.read())
    out = os.path.join(_cuda._buildlib.BUILD_DIR,
                       f"libturns_{tag}_{h.hexdigest()[:12]}.so")
    log = _cuda.compile_sources(out, sources)
    return _cuda.bind(out), log


def wide_cases(dev):
    """(label, args, kw, reps) of frag_wide's timed shapes."""
    from graphchainer_torch.align.seedless import FullstartScanner
    from graphchainer_torch.models.chainer import ChainerModel
    from graphchainer_torch.models.optimal import OptimalAlignerModel
    from graphchainer_torch.workload import bench_workload
    g, mpc, index, _, reads, _ = bench_workload(60_000, 128, 3000)
    model = ChainerModel(g, mpc, index, device="cuda")
    opt = OptimalAlignerModel(g, index, gx=model.gx, device=dev)
    scan = FullstartScanner(g, model.gx, device=dev)
    read = reads[0][1]
    return model, reads, [
        ("whole read", *opt.component_inputs(read, 0), 3),
        ("64-row prefix", *opt.component_inputs(read[:64], 0), 3),
        ("seedless tiles", *scan.scan_inputs(
            read, offsets=(0, 1000, 2000))[:2], 5)]


def polish_batch(model, reads, dev):
    """The polish fill's int32 inputs for the 128 reads against the paths
    the model stitches for them, at align/polish.py's bucketed sizes."""
    import numpy as np
    import torch
    from graphchainer_torch.align.polish import (_pack_rows, _round_up,
                                                 pack_codes2)
    from graphchainer_torch.ops.linear_align import (expand_codes2,
                                                     expand_planes2)
    from graphchainer_torch.ops.myers import to_i32_bits
    alns = model.align_batch(reads)
    rs = [seq for _, seq in reads]
    ps = [model.gx.positions_seq(a.positions) for a in alns]
    rl = np.array([len(r) for r in rs], dtype=np.int64)
    pl = np.array([len(p) for p in ps], dtype=np.int64)
    rc = torch.as_tensor(pack_codes2(_pack_rows(
        rs, rl, _round_up(int(rl.max()), 1024))).astype(np.int64)).to(dev)
    pc = torch.as_tensor(pack_codes2(_pack_rows(
        ps, pl, _round_up(int(pl.max()), 1024))).astype(np.int64)).to(dev)
    planes = expand_planes2(rc).permute(2, 1, 0).contiguous()
    path = expand_codes2(pc).t().contiguous()
    return (to_i32_bits(planes).contiguous(), path.to(torch.int32),
            torch.as_tensor(rl, dtype=torch.int32, device=dev),
            torch.as_tensor(pl, dtype=torch.int32, device=dev))


def read_major_dump(root: str) -> bool:
    """Whether the tree at root stores a run-time-bw dump read-major up to
    64 words (its polish wrapper has read_major), or column-major."""
    path = os.path.join(root, "graphchainer_torch", "ops", "polish_kernel.py")
    with open(path) as fh:
        return "def read_major(" in fh.read()


def fill_any(k_in, bw, rm):
    """The run-time-bw fill entry of the current library at any bw into a
    read-major (rm, up to 64 words; word stride bw rounded up to 4) or a
    column-major dump: the stored tensors and their (P, bw, R) / (P, R)
    views."""
    import torch
    from graphchainer_torch.ops.polish_kernel import word_stride
    planes, path, rl, pl = k_in
    _, RW, R = planes.shape
    P = path.shape[0]
    rm = rm and bw <= 64
    shape = (R, P, word_stride(bw)) if rm else (P, bw, R)
    out = [torch.empty(shape, dtype=torch.int32, device=planes.device)
           for _ in range(3)]
    out.append(torch.empty((R, P) if rm else (P, R), dtype=torch.int32,
                           device=planes.device))
    rc = _cuda.lib().polish_core_any_launch(
        planes.data_ptr(), path.data_ptr(), rl.data_ptr(), pl.data_ptr(),
        R, RW, P, bw, *(x.data_ptr() for x in out),
        _cuda.stream_ptr(planes))
    _cuda.check(rc, "polish_core_any")
    if rm:
        views = [x[..., :bw].permute(1, 2, 0) for x in out[:3]]
        views.append(out[3].permute(1, 0))
    else:
        views = out
    return out, views


def walk_args(dump, k_in, bw, rm):
    """The stored dump a walk entry reads (read-major when rm and bw <= 64,
    else column-major) from (P, bw, R) / (P, R) views, with the polish's
    max_steps and ops_cap."""
    from graphchainer_torch.align.polish import _ops_cap
    from graphchainer_torch.ops.polish_kernel import _stored
    planes, path = k_in[0], k_in[1]
    rmax, P = planes.shape[1] * 32, path.shape[0]
    if rm:
        stored = [_stored(t, bw) for t in dump]
    else:
        stored = [t.contiguous() for t in dump]
    return stored, rmax + P, _ops_cap(rmax, P, bw)


def walk(entry, stored, k_in, bw, steps, cap):
    """One launch of the current library's walk entry ("any": the
    run-time-bw walk, "warp": the template entries of a tree that has
    them, bw 8, 16, 32) into new rows."""
    import torch
    planes, path, rl, pl = k_in
    _, RW, R = planes.shape
    P = path.shape[0]
    out = torch.empty((R, 3 + cap // 16), dtype=torch.int64,
                      device=planes.device)
    L = _cuda.lib()
    fn = L.polish_walk_any_launch
    if entry == "warp":   # a tree that still has the template entries
        fn = L.polish_walk_launch
        fn.restype = ctypes.c_int
        fn.argtypes = L.polish_walk_any_launch.argtypes
    rc = fn(*(x.data_ptr() for x in stored), planes.data_ptr(),
            path.data_ptr(), rl.data_ptr(), pl.data_ptr(), R, RW, P, bw,
            steps, cap, out.data_ptr(), _cuda.stream_ptr(planes))
    _cuda.check(rc, f"polish_walk ({entry})")
    return out


def frag_cases(model, reads, dev):
    """(label, wrapper, args, kw) of frag_core's timed shapes: the carried
    entry on GA windows of 64 bench reads and on the hard batch, the
    fresh entry on the main path's batch and padded to B=96."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from graphchainer_torch.models.aligner import GraphAlignerModel
    from graphchainer_torch.ops import frag_kernel
    ga = GraphAlignerModel(model.g, model.index, gx=model.gx, device=dev)
    wins = cs.ga_windows(ga, reads[:64])
    out = []
    carried = frag_kernel.frag_core_carried_cuda
    for kind in ("fresh", "carried"):
        w = next(x for x in wins if (x["carry"] is None) == (kind == "fresh"))
        for width in (None, 48, 96):
            label = (f"GA {kind} window, B_eff={w['bnc'].shape[1]}"
                     if width is None else
                     f"GA {kind} window padded to B={width}")
            out.append((label, carried,
                        *cs.window_inputs(model.gx, w, dev, pad_to=width)))
    out.append(("hard batch, random carry", carried,
                *cs.carried_hard_inputs(dev, 3)))
    out.append(("hard batch, random carry, B=48", carried,
                *cs.carried_hard_inputs(dev, 4, F=64, B=48, max_in=4, S=2)))
    cfg = model.cfg
    fresh = frag_kernel.frag_core_cuda
    main = cs.frag_inputs(model, reads[:128], cfg.band_slots, cfg.max_in,
                          cfg.band_slack, dev)
    out.append((f"fresh entry, main path B_eff={main[2]}", fresh,
                *main[:2]))
    wide = cs.frag_inputs(model, reads[:128], cfg.band_slots, cfg.max_in,
                          cfg.band_slack, dev, pad_to=cfg.escalate_band)
    out.append((f"fresh entry, main batch padded to "
                f"B={cfg.escalate_band}", fresh, *wide[:2]))
    return out


def turns(libs, order, fn, reps):
    """{name: [ms, ...]} of fn(name) under each library, in the given
    order, rounded to 4 places."""
    out = {}
    for name in order:
        _cuda._lib = libs[name]
        out.setdefault(name, []).append(
            round(cuda_ms(lambda: fn(name), reps), 4))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", help="write the result as JSON to this file")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: needs a CUDA card", file=sys.stderr)
        return 2
    from graphchainer_torch.ops import frag_align, polish_kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    specs = [(tag, [os.path.join(root, "graphchainer_torch", "csrc", s)
                    for s in _cuda.SOURCES])
             for tag, root in (("other", opts.other), ("this", here))]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(specs)) as pool:
        built = dict(zip([t for t, _ in specs],
                         pool.map(lambda ts: build(*ts), specs)))
    libs = {k: v[0] for k, v in built.items()}
    build_s = time.perf_counter() - t0
    _cuda._lib = libs["other"]
    model, reads, cases = wide_cases(dev)
    result = {"device": smi, "build_s": round(build_s, 2), "frag_wide": []}
    names = list(libs)
    order = names + names[::-1]
    for label, args, kw, reps in cases:
        def run(_=None):
            return frag_align.align_fragments(*args, **kw)
        row = dict(label=label, F=int(args[2].shape[0]),
                   B=int(args[2].shape[1]), S=kw["n_slices"],
                   n_levels=kw["n_levels"], max_in=kw["max_in"])
        outs = {}
        for name in names:
            _cuda._lib = libs[name]
            outs[name] = [x.cpu() for x in run() if x is not None]
        row["equal"] = all(torch.equal(a, b) for a, b in
                           zip(outs["other"], outs["this"]))
        row["ms"] = turns(libs, order, run, reps)
        row["steps"] = row["B"] + min(row["S"], 128) - 1
        result["frag_wide"].append(row)
        print(json.dumps(row), flush=True)
    # the batches come from this tree's path (its wrappers and library)
    _cuda._lib = libs["this"]
    k_in = polish_batch(model, reads, dev)
    rm = {"other": read_major_dump(opts.other), "this": read_major_dump(here)}
    result["polish_core_any"] = []
    result["polish_walk_any"] = []
    for bw in (1, 2, 3, 5, 6, 8, 12, 16, 24, 32, 33, 48, 64, 100):
        views = {}
        for name in names:
            _cuda._lib = libs[name]
            views[name] = fill_any(k_in, bw, rm[name])[1]
        row = dict(bw=bw, equal=all(torch.equal(a, b) for a, b in
                                    zip(views["other"], views["this"])))
        if bw <= 64:
            def fill(name):
                return fill_any(k_in, bw, rm[name])
            row["ms"] = turns(libs, order, fill, 5)
            if polish_kernel.entry_for(bw) == "warp":
                # the template warp entry on the same batch, this tree
                _cuda._lib = libs["this"]
                warp = polish_kernel.polish_core_cuda(*k_in, bw)
                row["warp_equal"] = all(torch.equal(a, b) for a, b
                                        in zip(warp, views["this"]))
                row["warp_ms"] = round(cuda_ms(
                    lambda: polish_kernel.polish_core_cuda(*k_in, bw), 5), 4)
            result["polish_core_any"].append(row)
            print(json.dumps(row), flush=True)
        # the walk over this tree's dump, each tree's run-time entry
        # reading it in its own memory order
        wa = {name: walk_args(views["this"], k_in, bw, rm[name])
              for name in names}
        rows = {}
        for name in names:
            _cuda._lib = libs[name]
            rows[name] = walk("any", wa[name][0], k_in, bw, *wa[name][1:])
        wrow = dict(bw=bw, equal=torch.equal(rows["other"], rows["this"]),
                    complete=int((rows["this"][:, 1] >= 0).sum()))

        def walk_any(name):
            return walk("any", wa[name][0], k_in, bw, *wa[name][1:])
        wrow["ms"] = turns(libs, order, walk_any, 5)
        has_warp = hasattr(libs["other"], "polish_walk_launch")
        if polish_kernel.entry_for(bw) == "warp" and has_warp:
            # the other tree's template walk entry on the read-major dump,
            # in turns with this tree's run-time walk
            _cuda._lib = libs["other"]
            tw = walk("warp", wa["this"][0], k_in, bw, *wa["this"][1:])
            wrow["warp_equal"] = torch.equal(tw, rows["this"])
            cands = {"other warp": ("other", "warp"),
                     "this any": ("this", "any")}
            ms = {}
            for key in list(cands) + list(cands)[::-1]:
                lib_name, entry = cands[key]
                _cuda._lib = libs[lib_name]
                ms.setdefault(key, []).append(round(cuda_ms(
                    lambda: walk(entry, wa["this"][0], k_in, bw,
                                 *wa["this"][1:]), 5), 4))
            wrow["template_ms"] = ms
        result["polish_walk_any"].append(wrow)
        print(json.dumps(wrow), flush=True)
    result["frag_core"] = []
    _cuda._lib = libs["this"]
    for label, fn, args, kw in frag_cases(model, reads, dev):
        outs = {}
        for name in names:
            _cuda._lib = libs[name]
            outs[name] = [x.cpu() for x in fn(*args, **kw) if x is not None]
        row = dict(label=label, F=int(args[2].shape[0]),
                   B=int(args[2].shape[1]), S=kw["S"],
                   max_in=kw["max_in"],
                   equal=all(torch.equal(a, b) for a, b in
                             zip(outs["other"], outs["this"])))
        row["ms"] = turns(libs, order, lambda _: fn(*args, **kw), 50)
        result["frag_core"].append(row)
        print(json.dumps(row), flush=True)
    result["ptxas"] = {k: [ln.strip() for ln in v[1].splitlines()
                           if "registers" in ln or "stack frame" in ln
                           or "entry function" in ln]
                       for k, v in built.items()}
    bad = [k for k in ("frag_wide", "polish_core_any", "polish_walk_any",
                       "frag_core") for r in result[k]
           if not r["equal"] or not r.get("warp_equal", True)]
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "ptxas"}))
    print(smi)
    if bad:
        print(f"kernel_turns: outputs differ between the builds: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

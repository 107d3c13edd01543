"""Time two builds of the redesigned kernels in turns on one card.

  python -m graphchainer_torch.kernel_turns --other DIR [--out FILE]

DIR is the root of another checkout of this repository (an earlier
commit, unpacked with `git archive`).  Both trees' csrc/*.cu are built,
each into a library of its own, and at the shapes chip_smoke.py times,
frag_wide (optimal mode's whole-component band with a 64-row prefix and
with a whole 3 kbp read, the seedless tiles) and the run-time-bw polish
fill polish_core_any (the 128-read bench polish batch at bw 1, 2, 3, 5,
6, 12, 24, 33, 48 and 64, and at 8 / 16 / 32 beside the template warp
entries), each kernel runs in turns, other - this - this - other,
through this tree's wrappers, with the loaded library swapped between
the builds; every output of this tree's build must equal the other's.
The times are CUDA events over a few launches (chip_smoke.cuda_ms's
method).

Prints one JSON object, with --out FILE also written there with the
ptxas report of every build.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
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


def fill_any(k_in, bw):
    """The run-time-bw fill entry of the current library at any bw: its
    column-major dump (P, bw, R) / (P, R)."""
    import torch
    planes, path, rl, pl = k_in
    _, RW, R = planes.shape
    P = path.shape[0]
    out = [torch.empty((P, bw, R), dtype=torch.int32, device=planes.device)
           for _ in range(3)]
    out.append(torch.empty((P, R), dtype=torch.int32, device=planes.device))
    rc = _cuda.lib().polish_core_any_launch(
        planes.data_ptr(), path.data_ptr(), rl.data_ptr(), pl.data_ptr(),
        R, RW, P, bw, *(x.data_ptr() for x in out),
        _cuda.stream_ptr(planes))
    _cuda.check(rc, "polish_core_any")
    return out


def in_turns(libs, order, fn, reps):
    """{name: [ms, ...]} of fn() under each library, in the given order."""
    out = {}
    for name in order:
        _cuda._lib = libs[name]
        out.setdefault(name, []).append(cuda_ms(fn, reps))
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
        def run():
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
        ms = in_turns(libs, order, run, reps)
        row["ms"] = {k: [round(x, 4) for x in v] for k, v in ms.items()}
        row["steps"] = row["B"] + min(row["S"], 128) - 1
        result["frag_wide"].append(row)
        print(json.dumps(row), flush=True)
    k_in = polish_batch(model, reads, dev)
    result["polish_core_any"] = []
    for bw in (1, 2, 3, 5, 6, 8, 12, 16, 24, 32, 33, 48, 64):
        def fill():
            return fill_any(k_in, bw)
        outs = {}
        for name in names:
            _cuda._lib = libs[name]
            outs[name] = [x.cpu() for x in fill()]
        row = dict(bw=bw, equal=all(torch.equal(a, b) for a, b in
                                    zip(outs["other"], outs["this"])))
        row["ms"] = {k: [round(x, 4) for x in v] for k, v in
                     in_turns(libs, order, fill, 5).items()}
        if polish_kernel.entry_for(bw) == "warp":
            # the template warp entry on the same batch, this tree
            _cuda._lib = libs["this"]
            warp = polish_kernel.polish_core_cuda(*k_in, bw)
            row["warp_equal"] = all(torch.equal(a.cpu(), b) for a, b
                                    in zip(warp, outs["this"]))
            row["warp_ms"] = round(cuda_ms(
                lambda: polish_kernel.polish_core_cuda(*k_in, bw), 5), 4)
        result["polish_core_any"].append(row)
        print(json.dumps(row), flush=True)
    result["ptxas"] = {k: [ln.strip() for ln in v[1].splitlines()
                           if "registers" in ln or "stack frame" in ln]
                       for k, v in built.items()}
    if opts.out:
        with open(opts.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "ptxas"}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

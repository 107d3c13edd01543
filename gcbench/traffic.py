"""The benchmark's one read generator, driven by a traffic mix file.

A mix (gcbench/traffic/<name>.json) gives the read lengths (a normal
distribution cut to [min, max], as pbsim bounds its lengths), the error
model and its rates, the share of reads taken from the reverse strand,
and how the pipeline is fed (batch size and batches in flight).  With
"stratified", every batch holds the same lengths, the batch_size
quantiles of the cut distribution (and, for badread, the same per-read
identities), in an order drawn from the seed: each seed then gives the
window the same work in another order, and runs of different seeds
spread no more than runs of one.  Without it, each length is drawn and
redrawn until it falls in [min, max].

Reads are drawn from a configuration's truth walk (gcbench/graphs.py) in
chunks of one batch: chunk c holds reads
c * batch .. c * batch + batch - 1 and depends only on (seed, c), so the
feeder can make reads while the window runs and the harness can make the
same reads again afterwards for the check.  Chunk 0 is the warm-up batch:
its last `warmup_junk` reads are random bases, which no seed matches, so
the warm-up also builds the escalation's and the rescue's models.

Error models, vectorised with numpy (the program's own simulators
loop in Python over every base):
- "uniform": graphchainer_torch/graph/simulate.py mutate_read at
  sub = ins = del = rate / 3 (a deleted base takes no insertion after it;
  a substitution draws any of the four bases);
- "badread": mutate_read_badread: a per-read identity ~N(mean, sd)
  clipped to [lo, hi] (stratified: its quantiles), a background/burst
  Markov chain (bursts 8x the error), homopolymer-boosted indels that
  repeat the run's base.  The
  chain is drawn as alternating geometric run lengths, the same process
  as the source's step-by-step draws.

Run as a script it is the feeder: it first makes a pool of the first
--chunks chunks as FASTA records and says "ready" on its standard output,
so that no read is made while the program runs; then it writes the pool
into a named pipe until it is sent SIGTERM, finishes the record it is
writing and closes the pipe.  Should the program outrun the pool, it
makes further chunks as it writes them and says so on standard error.
"""
from __future__ import annotations

import json
import os
import signal
import sys
from statistics import NormalDist

import numpy as np

_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def load_mix(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def chunk_rng(seed: int, c: int):
    return np.random.default_rng([int(seed) % (1 << 63), int(c)])


def _lengths(rng, spec: dict, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    todo = np.arange(n)
    while len(todo):
        v = np.rint(rng.normal(spec["mean"], spec["sd"], len(todo)))
        ok = (v >= spec["min"]) & (v <= spec["max"])
        out[todo[ok]] = v[ok]
        todo = todo[~ok]
    return out


def _strata(mean: float, sd: float, lo: float, hi: float, n: int):
    """The n quantiles (j + 1/2) / n of N(mean, sd) cut to [lo, hi]."""
    nd = NormalDist(mean, sd)
    a, b = nd.cdf(lo), nd.cdf(hi)
    return np.array([nd.inv_cdf(a + (j + 0.5) / n * (b - a))
                     for j in range(n)])


def _uniform(rng, src: np.ndarray, rate: float):
    """(base kept or substituted, inserted base, keep mask, insert mask)."""
    per = rate / 3.0
    n = len(src)
    r = rng.random(n)
    keep = r >= per
    base = src.copy()
    sub = keep & (r < 2 * per)
    base[sub] = rng.integers(0, 4, int(sub.sum()))
    ins = keep & (rng.random(n) < per)
    extra = rng.integers(0, 4, n).astype(np.uint8)
    return base, extra, keep, ins


def _burst_mask(rng, n: int, enter: float, leave: float) -> np.ndarray:
    """The burst state of n positions: background runs ~Geometric(enter)
    (the first one minus one, as the chain starts outside a burst) and
    burst runs ~Geometric(leave), alternating."""
    mask = np.zeros(n, dtype=bool)
    pos = 0
    first = True
    while pos < n:
        k = max(8, int(n * enter * 2) + 8)
        bg = rng.geometric(enter, k)
        bu = rng.geometric(leave, k)
        if first:
            bg[0] -= 1
            first = False
        for a, b in zip(bg.tolist(), bu.tolist()):
            pos += a
            if pos >= n:
                break
            mask[pos:pos + b] = True
            pos += b
            if pos >= n:
                break
    return mask


def _badread(rng, src: np.ndarray, spec: dict, ident: float):
    base_err = 1.0 - ident
    n = len(src)
    enter, leave = spec["burst_enter"], spec["burst_exit"]
    burst = _burst_mask(rng, n, enter, leave)
    idx = np.arange(n)
    change = np.ones(n, dtype=bool)
    change[1:] = src[1:] != src[:-1]
    run_start = np.maximum.accumulate(np.where(change, idx, 0))
    hp = (idx - run_start + 1) >= 3
    err = base_err * np.where(burst, 8.0, 1.0 / (1.0 + 8.0 * enter / leave))
    p_ind = err * (2.0 / 3.0) * np.where(hp, spec["homopolymer_boost"], 1.0)
    p_sub = err / 3.0
    r = rng.random(n)
    keep = r >= p_ind / 2
    ins = keep & (r < p_ind)
    sub = ~ins & keep & (r < p_ind + p_sub)
    base = src.copy()
    base[sub] = rng.integers(0, 4, int(sub.sum()))
    extra = np.where(hp, src, rng.integers(0, 4, n)).astype(np.uint8)
    return base, extra, keep, ins


def _emit(base, extra, keep, ins) -> np.ndarray:
    pair = np.stack([base, extra], axis=1)
    return pair[np.stack([keep, ins], axis=1)]


def make_chunk(mix: dict, seed: int, c: int, truth: np.ndarray):
    """Chunk c's reads: (codes list (uint8 arrays, A C G T = 0..3), truth
    rows (start, source length, reverse) as an (n, 3) int64 array)."""
    n = int(mix["batch_size"])
    rng = chunk_rng(seed, c)
    ln, err = mix["length"], mix["errors"]
    if mix.get("stratified"):
        lens = np.rint(rng.permutation(_strata(ln["mean"], ln["sd"],
                                               ln["min"], ln["max"], n)))
        lens = lens.astype(np.int64)
    else:
        lens = _lengths(rng, ln, n)
    lens = np.minimum(lens, len(truth))
    starts = rng.integers(0, len(truth) - lens + 1)
    rev = rng.random(n) < mix["reverse_share"]
    if err["model"] == "badread":
        args = (err["identity_mean"], err["identity_sd"],
                err["identity_min"], err["identity_max"])
        ident = (rng.permutation(_strata(*args, n)) if mix.get("stratified")
                 else np.clip(rng.normal(args[0], args[1], n), args[2],
                              args[3]))
    reads = []
    for i in range(n):
        src = truth[starts[i]:starts[i] + lens[i]]
        if err["model"] == "uniform":
            out = _emit(*_uniform(rng, src, err["rate"]))
        elif err["model"] == "badread":
            out = _emit(*_badread(rng, src, err, float(ident[i])))
        else:
            raise ValueError(f"unknown error model {err['model']!r}")
        if rev[i]:
            out = (3 - out[::-1]).astype(np.uint8)
        reads.append(out)
    if c == 0:
        for i in range(n - int(mix.get("warmup_junk", 0)), n):
            reads[i] = rng.integers(0, 4, lens[i]).astype(np.uint8)
    return reads, np.stack([starts, lens, rev.astype(np.int64)], axis=1)


def pool_chunks(mix: dict, seconds: float) -> int:
    """Chunks enough for the warm-up and `seconds` at the mix's
    pool_kbp_per_s (a rate well above the program's)."""
    n, ln = int(mix["batch_size"]), mix["length"]
    mean = (_strata(ln["mean"], ln["sd"], ln["min"], ln["max"], n).mean()
            if mix.get("stratified") else ln["mean"])
    return 1 + int(np.ceil(mix["pool_kbp_per_s"] * seconds
                           / (mean * n / 1000.0)))


def fasta(c: int, batch: int, reads) -> list:
    """FASTA records of chunk c, read i named r<i>."""
    return [b">r%d\n" % (c * batch + i) + _LETTERS[r].tobytes() + b"\n"
            for i, r in enumerate(reads)]


def feed(mix_path: str, seed: int, truth_path: str, out: str,
         chunks: int) -> int:
    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    mix = load_mix(mix_path)
    truth = np.load(truth_path)
    batch = int(mix["batch_size"])

    def records(c: int) -> list:
        return fasta(c, batch, make_chunk(mix, seed, c, truth)[0])
    pool = [records(c) for c in range(chunks)]
    print("ready", flush=True)
    fd = os.open(out, os.O_WRONLY)
    try:
        c = 0
        while not stop:
            if c < len(pool):
                recs, pool[c] = pool[c], None
            else:
                if c == len(pool):
                    print(f"gcbench feeder: the pool of {chunks} chunks ran "
                          "out; making reads while the program runs",
                          file=sys.stderr, flush=True)
                recs = records(c)
            for rec in recs:
                view = memoryview(rec)
                while view:
                    view = view[os.write(fd, view):]
                if stop:
                    break
            c += 1
    except BrokenPipeError:
        pass
    finally:
        os.close(fd)
    return 0


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="make a pool of a mix's reads, "
                                 "then write them as FASTA into a named pipe "
                                 "until SIGTERM")
    ap.add_argument("--mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--truth", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--chunks", type=int, required=True)
    a = ap.parse_args()
    sys.exit(feed(a.mix, a.seed, a.truth, a.out, a.chunks))

"""Multi-process runs of the port (parallel/multihost.py on
torch.distributed with gloo): two processes on the CPU, joined at a free
local port, stripe tests/test_multihost.py's reads between them; their
.part0 / .part1 GAF files, merged and sorted, equal the one-process GAF,
sorted, and each process reports the merged statistics."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from graphchainer_torch.parallel import multihost

from test_torch_common import REPO

CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["graphchainer_tpu"] = None
from graphchainer_torch.pipeline import PipelineParams, align_reads
gfa, reads, out, pid, npx, coord = sys.argv[1:7]
stats = align_reads(PipelineParams(
    graph_file=gfa, read_files=[reads], out_gaf=out, device="cpu",
    num_processes=int(npx), process_id=int(pid), coordinator=coord,
    batch_size=4))
print("STATS", stats.reads, stats.reads_with_an_alignment, flush=True)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_world(tmp_path, rng):
    """tests/test_multihost.py's graph (a chain of four 300 bp segments)
    and ten 500 bp reads with 25 substitutions each."""
    segs = ["".join(rng.choice(list("ACGT"), 300)) for _ in range(4)]
    gfa = tmp_path / "g.gfa"
    with open(gfa, "w") as f:
        for i, s in enumerate(segs):
            f.write(f"S\t{i + 1}\t{s}\n")
        for i in range(3):
            f.write(f"L\t{i + 1}\t+\t{i + 2}\t+\t0M\n")
    path = "".join(segs)
    reads = tmp_path / "r.fa"
    with open(reads, "w") as f:
        for i in range(10):
            a = int(rng.integers(0, 500))
            rd = list(path[a:a + 500])
            for p in rng.choice(len(rd), 25, replace=False):
                rd[p] = rng.choice(list("ACGT"))
            f.write(f">r{i}\n{''.join(rd)}\n")
    return gfa, reads


@pytest.mark.timeout(600)
def test_two_process_pipeline_matches_single(tmp_path, rng):
    gfa, reads = multihost_world(tmp_path, rng)
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def run(out, pid, npx, coord):
        return subprocess.Popen(
            [sys.executable, "-c", CHILD, str(gfa), str(reads), str(out),
             str(pid), str(npx), coord], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    coord = f"127.0.0.1:{free_port()}"
    single = tmp_path / "single.gaf"
    two = tmp_path / "two.gaf"
    procs = [run(single, 0, 1, coord)] + [run(two, i, 2, coord)
                                          for i in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=500)
            assert p.returncode == 0, e[-2000:]
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for o in outs:
        assert "STATS 10 10" in o, o
    assert not os.path.exists(two)
    merged = sorted(sum((open(f"{two}.part{i}").readlines()
                         for i in range(2)), []))
    assert len(merged) == 10
    assert merged == sorted(open(single).readlines())
    assert len(open(f"{two}.part0").readlines()) == 5


def test_single_process_helpers():
    """Without a process group: one process of rank 0, stats unchanged,
    outputs unsuffixed; the stripe of process I is every P-th item from
    I."""
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    multihost.initialize("127.0.0.1:1", 1, 0)       # a no-op for P = 1
    assert multihost.process_count() == 1
    tot = np.arange(7, dtype=np.int64)
    np.testing.assert_array_equal(multihost.merge_stats_global(tot), tot)
    assert multihost.part_suffix("o.gaf", 0, 1) == "o.gaf"
    assert multihost.part_suffix("o.gaf", 1, 3) == "o.gaf.part1"
    assert multihost.part_suffix(None, 1, 3) is None
    assert multihost.stripe(list(range(7)), 1, 3) == [1, 4]
    multihost.finalize()

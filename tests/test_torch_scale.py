"""graphchainer_torch.scale's workload and path at a small size against
the JAX package: the sustained mix (scripts/sustained_test.py) on a
200 kbp backbone, 4 reads of each length class, through the port's
pipeline.align_reads on the CPU (every kernel as its plain version), its
GAF lines equal to the JAX CLI's (recorded: tests/torch_fixtures/
scale_mix_small.json, made by make_fixtures.py from jax_mix_inputs and
jax_cli_record below; scale_mix.json is the same at the 20 Mbp backbone
of SCALE_r05.json, which chip_smoke.py holds the card to).  The port's
GFA and FASTA writer gives sustained_test.py's bytes."""
import functools
import os
import subprocess
import sys
import tempfile

from graphchainer_torch import cli, pipeline, workload
from graphchainer_torch.scale import read_counts

from test_torch_common import REPO, load_fixture

SMALL_BP = 200_000
SMALL_COUNTS = (4, 4, 4)
# chip_smoke.py's mixed fixture: the SCALE_r05.json backbone
SCALE_BP = 20_000_000
SCALE_COUNTS = (16, 16, 16)
# the CLI's default configuration at sustained_test.py's first step
CLI_FLAGS = ["--sampling-step", "1"]


def jax_mix_inputs(workdir, graph_bp, counts):
    """scripts/sustained_test.py:55-85 with the JAX package's generator
    (bench.py's graph), counts[k] reads of the k-th length class: the GFA
    and FASTA paths it writes in workdir."""
    import numpy as np

    import bench
    from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
    from graphchainer_tpu.graph.simulate import generate_path, simulate_reads
    gfa = os.path.join(workdir, "g.gfa")
    fa = os.path.join(workdir, "reads.fa")
    bg = bench.build_bench_graph(np.random.default_rng(7), graph_bp)
    with open(gfa, "w") as f:
        f.write("H\tVN:Z:1.0\n")
        for name, seq in zip(bg.names, bg.seqs):
            f.write(f"S\t{name}\t{seq}\n")
        for a, ar, b, br, ov in bg.links:
            f.write(f"L\t{bg.names[a]}\t{'-' if ar else '+'}"
                    f"\t{bg.names[b]}\t{'-' if br else '+'}\t{ov}M\n")
    g = build_alignment_graph(bg)
    path_seq, _ = generate_path(g, seed=3)
    n1, n2, n3 = counts
    reads = (simulate_reads(path_seq, n1, 1500, seed=11,
                            error_rate=0.10, len_std=300)
             + simulate_reads(path_seq, n2, 3000, seed=12,
                              error_rate=0.10, len_std=600)
             + simulate_reads(path_seq, n3, 9000, seed=13,
                              error_rate=0.10, len_std=1500))
    with open(fa, "w") as f:
        for i, (name, seq) in enumerate(reads):
            f.write(f">r{i}_{name}\n{seq}\n")
    return gfa, fa


def jax_cli_record(graph_bp, counts):
    """python -m graphchainer_tpu.cli (on the CPU) on jax_mix_inputs with
    CLI_FLAGS: {"gaf": its GAF lines, "counts": its count lines}."""
    with tempfile.TemporaryDirectory() as td:
        gfa, fa = jax_mix_inputs(td, graph_bp, counts)
        out = os.path.join(td, "out.gaf")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        r = subprocess.run([sys.executable, "-m", "graphchainer_tpu.cli",
                            "-g", gfa, "-f", fa, "-a", out] + CLI_FLAGS,
                           capture_output=True, text=True, env=env,
                           cwd=REPO, check=True)
        with open(out) as fh:
            lines = fh.read().splitlines()
    return dict(gaf=lines, counts=read_counts(r.stdout))


@functools.lru_cache(maxsize=None)
def port_inputs():
    """The port's sustained_workload at the small size: (GFA bytes, FASTA
    bytes, GAF lines of the port's CLI run, its statistics)."""
    with tempfile.TemporaryDirectory() as td:
        gfa, fa, _ = workload.sustained_workload(td, SMALL_BP, SMALL_COUNTS)
        out = os.path.join(td, "out.gaf")
        args = cli.build_parser().parse_args(
            ["-g", gfa, "-f", fa, "-a", out, "--device", "cpu"] + CLI_FLAGS)
        stats = pipeline.align_reads(cli.params_from_args(args))
        with open(gfa, "rb") as fh:
            gfa_bytes = fh.read()
        with open(fa, "rb") as fh:
            fa_bytes = fh.read()
        with open(out) as fh:
            lines = fh.read().splitlines()
    return gfa_bytes, fa_bytes, lines, stats


def test_writer_gives_sustained_test_bytes():
    gfa_bytes, fa_bytes = port_inputs()[:2]
    with tempfile.TemporaryDirectory() as td:
        gfa, fa = jax_mix_inputs(td, SMALL_BP, SMALL_COUNTS)
        with open(gfa, "rb") as fh:
            assert fh.read() == gfa_bytes
        with open(fa, "rb") as fh:
            assert fh.read() == fa_bytes
    assert fa_bytes.count(b">") == sum(SMALL_COUNTS)


def test_mix_counts_split_as_sustained_test():
    assert workload.mix_counts(10_000) == (5000, 3500, 1500)
    assert workload.mix_counts(48) == (24, 16, 8)


def test_small_mix_gaf_matches_jax():
    want = load_fixture("scale_mix_small")
    _, _, lines, stats = port_inputs()
    assert lines == want["gaf"]
    assert read_counts(cli.count_lines(stats)) == want["counts"]

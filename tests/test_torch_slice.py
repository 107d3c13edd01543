"""The CLC main path end to end: graphchainer_torch's ChainerModel,
pipeline and CLI (on the CPU, where every kernel runs as its plain torch
version) against graphchainer_tpu's ChainerModel at the default
configuration of both — band escalation, then the GA-baseline rescue, for
reads above a normalised edit distance of 0.35.  Per read, positions,
ops, score, n_anchors and n_chained are equal and the GAF lines are
byte-equal.  The JAX side of the model comparison is recorded
(tests/torch_fixtures/slice_model.json): its run compiles the JAX
model's shapes, ~100 s on a loaded CPU."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from graphchainer_tpu.io.gfa import save_gfa
from graphchainer_tpu.models import chainer as JC
from graphchainer_torch import cli, convert
from graphchainer_torch.io import gaf as TG
from graphchainer_torch.models import chainer as TC
from graphchainer_torch.utils import timers

from test_mpc import random_dag_bigraph
from test_torch_common import (REPO, aln_record, load_fixture,
                               output_record, slice_case, slice_case_port)


def slice_reads():
    """220 bp of slice_case()'s 50%-error read (first), which escalates
    and is then rescued by the GA baseline (whose windows take two
    shapes), and three of its ~500 bp reads at 10% error."""
    reads = slice_case()[4]
    return [("noisy", reads[0][1][160:380])] + reads[1:4]


@functools.lru_cache(maxsize=None)
def port_run():
    """(torch alignments, torch counters) of slice_reads() at the JAX
    package's default configuration, carried across by convert.py."""
    timers.reset()
    tg, tmpc, tindex = slice_case_port()[:3]
    tcfg = convert.from_reference_config(
        dataclasses.asdict(JC.ChainerConfig()))
    assert tcfg == TC.ChainerConfig()
    ta = TC.ChainerModel(tg, tmpc, tindex, tcfg,
                         device="cpu").align_batch(slice_reads())
    return ta, timers.counters()


def jax_run():
    """The JAX package's run of slice_reads(), recorded: {alignments:
    [aln_record], gaf: {"False" / "True": [each alignment's GAF line]}}."""
    return load_fixture("slice_model")["slice"]


def test_align_batch_matches_jax():
    want, (ta, _) = jax_run()["alignments"], port_run()
    assert len(want) == len(ta) == len(slice_reads())
    for a, b in zip(want, ta):
        assert aln_record(b) == a, a["name"]
    assert all(not b.failed for b in ta)


@pytest.mark.parametrize("merge_mm", [False, True])
def test_gaf_lines_match_jax(merge_mm):
    tg = slice_case_port()[0]
    ta, _ = port_run()
    assert [TG.gaf_line(tg, b, cigar_merge_mm=merge_mm) for b in ta] == \
        jax_run()["gaf"][str(merge_mm)]


def test_noisy_read_escalates():
    """The 50%-error read runs the band escalation (B = 96, max_in = 12),
    stays above the threshold and is rescued by the GA baseline, and its
    result still equals the JAX package's."""
    ta, counters = port_run()
    assert counters["escalated_reads"] == counters["rescued_reads"] == 1
    assert counters["cells(frag)"] > 0
    want = jax_run()["alignments"][0]
    assert ta[0].name == want["name"] == "noisy"
    assert ta[0].score == want["score"]
    assert ta[0].score < 0.35 * len(ta[0].seq)


@pytest.mark.timeout(600)
def test_cli_gaf_matches_jax(tmp_path):
    """python -m graphchainer_torch writes the GAF lines of the JAX
    package's alignments (run with jax blocked in the child; three of the
    reads, single-threaded torch, to keep the child light)."""
    reads = slice_reads()[1:]
    rng = np.random.default_rng(2)
    save_gfa(random_dag_bigraph(rng, n_seg=24, p_edge=0.15, max_len=300),
             str(tmp_path / "g.gfa"))
    with open(tmp_path / "r.fa", "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")
    out = tmp_path / "out.gaf"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['graphchainer_torch'] + sys.argv[1:]\n"
            "runpy.run_module('graphchainer_torch', run_name='__main__')\n")
    r = subprocess.run(
        [sys.executable, "-c", code, "-g", str(tmp_path / "g.gfa"),
         "-f", str(tmp_path / "r.fa"), "-a", str(out), "--device", "cpu",
         "--seeds-minimizer-length", "11",
         "--seeds-minimizer-windowsize", "6", "--batch-size", "2",
         "-t", "2"], cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert f"Input reads: {len(reads)}" in r.stdout
    names = {n for n, _ in reads}
    jr = jax_run()
    want = sorted(line for a, line in zip(jr["alignments"], jr["gaf"]["False"])
                  if a["name"] in names and a["positions"])
    got = sorted(out.read_text().splitlines())
    assert got == [w for w in want if w] and len(got) == len(reads)


@pytest.mark.parametrize("argv,msg", [
    (["--seeds-mum-count", "3"], "--seeds-mum-count"),
    (["--seeds-mem-count", "5"], "--seeds-mem-count"),
    (["--num-processes", "2"], "--num-processes"),
    (["--seeds-file", "s.gam"], "--seeds-file"),
    (["--polish-band", "3"], "--polish-band"),
])
def test_cli_rejects_unported(argv, msg):
    """No flag of the JAX CLI is left unported: each flag that the port
    once rejected now reaches PipelineParams."""
    base = ["-g", "g.gfa", "-f", "r.fa", "-a", "o.gaf"]
    args = cli.build_parser().parse_args(base + argv)
    p = cli.params_from_args(args)
    got = {"--seeds-mum-count": p.mum_count, "--seeds-mem-count": p.mem_count,
           "--num-processes": p.num_processes, "--seeds-file": p.seed_file,
           "--polish-band": p.chainer.polish_band_words}[msg]
    assert str(got) == argv[1]


def test_parser_takes_every_jax_option():
    """Every option string of graphchainer_tpu's parser is an option of
    the port's parser, with the same default."""
    from graphchainer_tpu import cli as JCLI

    def options(p):
        return {o: a.default for a in p._actions for o in a.option_strings}
    want, got = options(JCLI.build_parser()), options(cli.build_parser())
    missing = sorted(set(want) - set(got))
    assert not missing
    assert {o: got[o] for o in want} == want
    assert set(got) - set(want) == {"--device"}


POLISH_BANDS = (3, 12)


def polish_cli_case(tmp_path, bw):
    """--polish-band bw on the CLI test's graph and three 10%-error reads:
    (GFA path, reads, flags)."""
    gfa = str(tmp_path / "g.gfa")
    save_gfa(random_dag_bigraph(np.random.default_rng(2), n_seg=24,
                                p_edge=0.15, max_len=300), gfa)
    return gfa, slice_reads()[1:], [
        "--polish-band", str(bw), "--seeds-minimizer-length", "11",
        "--seeds-minimizer-windowsize", "6"]


@pytest.mark.parametrize("bw", POLISH_BANDS)
def test_cli_polish_band_matches_jax(bw, tmp_path):
    """--polish-band widths outside the warp entries' 8, 16 and 32 run
    through the port's CLI, and its output bytes equal the JAX CLI's
    (recorded)."""
    from test_torch_optimal import run_cli
    gfa, reads, flags = polish_cli_case(tmp_path, bw)
    got = output_record(run_cli(cli.main, tmp_path, "torch", gfa, reads,
                                flags + ["--device", "cpu"]))
    want = load_fixture("polish_cli")[str(bw)]
    assert want["gaf"].count("\n") == len(reads)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k

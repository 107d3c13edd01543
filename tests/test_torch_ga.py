"""GA mode and the CLC rescue: graphchainer_torch's GraphAlignerModel, its
fragment windows (run_fragments with a carried state, the state out and
the best X cell), the GA branch of the pipeline and CLI, and
ChainerModel's GA-baseline rescue at the default config, against
graphchainer_tpu on the same inputs, with exact equality (on the CPU,
where every kernel runs as its plain torch version).

The JAX side runs once per case and module (functools.lru_cache), on
graphs and reads picked so that their windows share few shapes: every
window shape, node table size included, is a separate XLA compile of the
JAX package's lane-major core.  The windows of the dense DAG and of the
cyclic graph (padded with a linear component to the DAG's node count)
take two shapes in all, which the toy graph (padded the same way)
shares.  The JAX side of the rescue, whose CLC path compiles shapes of
its own, is recorded in tests/torch_fixtures/ga_rescue.json."""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from graphchainer_tpu import cli as JCLI
from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.graph.mpc import build_mpc
from graphchainer_tpu.graph.simulate import (generate_path, mutate_read,
                                             simulate_reads)
from graphchainer_tpu.index.minimizer import build_index
from graphchainer_tpu.io.gfa import load_gfa
from graphchainer_tpu.models import aligner as JM
from graphchainer_tpu.models import chainer as JC
from graphchainer_torch import convert
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.models import aligner as TM
from graphchainer_torch.models import chainer as TC
from graphchainer_torch.utils import timers

from conftest import TOY_READ
from test_cyclic import circular_graph
from test_mpc import random_dag_bigraph
from test_torch_common import (REPO, aln_record, load_fixture, port_graph,
                               port_index, port_mpc)

# a linear component of 48 split nodes (a strand) of random bases, which
# no read of this module reaches
PAD = "".join(np.random.default_rng(3).choice(list("ACGT"), 1536))
FRAG_FIELDS = ("best_score", "best_slot", "best_col", "best_in", "out_ssb",
               "out_hp", "out_hn", "xbest", "xslot", "xrow")


@functools.lru_cache(maxsize=None)
def graphs():
    """(name -> (JAX graph, JAX index, reads)): a dense random DAG (more
    than 2% of its nodes above max_in = 4) with three 130 bp reads at 10%
    error, and a cyclic graph of three 60 bp segments with two reads
    lapping it 1.5 times, plus a 1536 bp linear segment that gives it the
    DAG's 108 split nodes."""
    rng = np.random.default_rng(1)
    g = build_alignment_graph(random_dag_bigraph(rng, n_seg=10, p_edge=0.7,
                                                 max_len=300))
    path_seq, _ = generate_path(g, seed=5)
    dag_reads = simulate_reads(path_seq, 3, 130, seed=8, error_rate=0.10,
                               len_std=10)
    rng = np.random.default_rng(2)
    bg = circular_graph(rng, seg_bp=60, n_segs=3)
    unit = "".join(bg.seqs)
    cyc_reads = []
    for i in range(2):
        st = int(rng.integers(0, len(unit)))
        frag = (unit * 5)[st:st + int(len(unit) * 1.5)]
        cyc_reads.append((f"c{i}", mutate_read(rng, frag, sub=0.03,
                                               ins=0.03, dele=0.03)))
    bg.add_segment("pad", PAD)
    gc = build_alignment_graph(bg, allow_cycles=True)
    assert gc.cyclic and gc.n_nodes == g.n_nodes
    return {"dag": (g, build_index(g, k=11, w=6), dag_reads),
            "cyclic": (gc, build_index(gc, k=11, w=6), cyc_reads)}


@functools.lru_cache(maxsize=None)
def port_world(name):
    g, index, reads = graphs()[name]
    return port_graph(g), port_index(index), reads


class Recorder:
    """Wraps a module's function and keeps (args, kwargs, result) of
    every call."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def call(*args, **kw):
            res = fn(*args, **kw)
            self.calls.append((args, kw, res))
            return res
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


CONFIGS = {"default": {}, "ramp": dict(ramp_band_slots=96),
           "xdrop": dict(x_drop=30),
           "selection": dict(selection_method="ScheduleInverseESum")}


@functools.lru_cache(maxsize=None)
def jax_ga(name, config):
    """The JAX GraphAlignerModel's alignments of graphs()[name]'s reads
    under CONFIGS[config], and its recorded run_fragments,
    assemble_batch and assemble_carry_batch calls."""
    g, index, reads = graphs()[name]
    with Recorder(JM, "run_fragments") as rf, \
            Recorder(JM, "assemble_batch") as ab, \
            Recorder(JM, "assemble_carry_batch") as ac:
        alns = JM.GraphAlignerModel(
            g, index, JM.AlignerConfig(**CONFIGS[config])).align_batch(reads)
    return alns, rf.calls, ab.calls, ac.calls


def port_ga(name, config):
    g, index, reads = port_world(name)
    cfg = convert.from_reference_aligner_config(
        dataclasses.asdict(JM.AlignerConfig(**CONFIGS[config])))
    assert cfg == TM.AlignerConfig(**CONFIGS[config])
    return TM.GraphAlignerModel(g, index, cfg, device="cpu").align_batch(reads)


def assert_same_alignments(ja, ta):
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert a.name == b.name
        np.testing.assert_array_equal(np.asarray(a.positions),
                                      np.asarray(b.positions),
                                      err_msg=a.name)
        assert (a.ops is None) == (b.ops is None), a.name
        if a.ops is not None:
            np.testing.assert_array_equal(a.ops, b.ops, err_msg=a.name)
        assert (a.score, a.seq_start, a.seq_end, a.n_seeds, a.n_anchors,
                a.n_chained, a.is_secondary) == \
            (b.score, b.seq_start, b.seq_end, b.n_seeds, b.n_anchors,
             b.n_chained, b.is_secondary), a.name
        assert_same_alignments(a.secondary, b.secondary)


def window_call(name, carried):
    """The first recorded JAX run_fragments call of graphs()[name]'s
    default GA run, fresh or carried."""
    _, calls, _, _ = jax_ga(name, "default")
    for args, kw, res in calls:
        if (kw.get("carry_in") is not None) == carried:
            return args, kw, res
    raise AssertionError(f"no {'carried' if carried else 'fresh'} window")


CASES = [("dag", False), ("dag", True), ("cyclic", False), ("cyclic", True)]
IDS = ["dag-fresh", "dag-carried", "cyclic-fresh", "cyclic-carried"]


@pytest.mark.parametrize("name,carried", CASES, ids=IDS)
def test_run_fragments_matches_jax(name, carried):
    """The port's run_fragments on a JAX GA window's own inputs (bands of
    assemble_batch / assemble_carry_batch, seed shifts per fragment or
    per slot, the carried state) gives every output of the JAX one:
    best end cell, backtrace pointers, state out, best X cell."""
    args, kw, ref = window_call(name, carried)
    gx = TA.GraphTensors.build(port_world(name)[0])
    (_, bnc, bi, ss, req, rows, S, max_in) = args
    assert kw["want_state"] and kw["want_xcells"]
    assert ss.ndim == (2 if carried else 1)
    got = TA.run_fragments(gx, bnc, bi, ss, req, rows, S, max_in,
                           kw["band_level"], "cpu",
                           carry_in=kw.get("carry_in"), want_state=True,
                           want_xcells=True)
    for field in FRAG_FIELDS:
        a, b = getattr(ref, field), getattr(got, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (ref.out_ssb < (1 << 28)).any() and (ref.xbest > 0).any()


def _port_job(job, cls):
    return cls(**{f.name: getattr(job, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("name,carried", CASES, ids=IDS)
def test_assemble_matches_jax(name, carried):
    """assemble_batch / assemble_carry_batch of the port on the jobs of
    the JAX GA run: the same bands, shifts, slot map, carry and planes."""
    _, _, fresh, carry = jax_ga(name, "default")
    calls = carry if carried else fresh
    assert calls
    gx = TA.GraphTensors.build(port_world(name)[0])
    cls, fn = ((TA.CarryJob, TA.assemble_carry_batch) if carried
               else (TA.FragJob, TA.assemble_batch))
    for args, kw, ref in calls:
        jobs = [_port_job(j, cls) for j in args[1]]
        got = fn(gx, jobs, *args[2:], **kw)
        assert len(got) == len(ref)
        for i, (a, b) in enumerate(zip(ref, got)):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype, i
                np.testing.assert_array_equal(x, y, err_msg=str(i))


@pytest.mark.parametrize("name,config", [
    ("dag", "default"), ("dag", "ramp"), ("dag", "xdrop"),
    ("dag", "selection"), ("cyclic", "default")])
def test_align_batch_matches_jax(name, config):
    """GraphAlignerModel.align_batch: positions, ops, score, span and the
    selected secondary alignments equal the JAX package's, with -B, with
    --X-drop and with a non-default selection method."""
    ja = jax_ga(name, config)[0]
    ta = port_ga(name, config)
    assert_same_alignments(ja, ta)
    assert all(not a.failed for a in ta)


def padded_toy(toy_gfa, tmp_path):
    """The toy graph with the PAD component, which gives it the DAG's 108
    split nodes: a GFA file."""
    gfa = tmp_path / "toy_padded.gfa"
    with open(toy_gfa) as fh:
        gfa.write_text(fh.read() + f"S\tpad\t{PAD}\n")
    return str(gfa)


@functools.lru_cache(maxsize=None)
def toy_runs(gfa):
    g = build_alignment_graph(load_gfa(gfa))
    assert g.n_nodes == graphs()["dag"][0].n_nodes
    index = build_index(g, k=11, w=5)
    reads = [("read", TOY_READ)]
    ja = JM.GraphAlignerModel(g, index, JM.AlignerConfig()).align_batch(reads)
    ta = TM.GraphAlignerModel(port_graph(g), port_index(index),
                              device="cpu").align_batch(reads)
    return ja, ta


def test_align_batch_matches_jax_on_the_toy_graph(toy_gfa, tmp_path):
    ja, ta = toy_runs(padded_toy(toy_gfa, tmp_path))
    assert_same_alignments(ja, ta)
    assert not ta[0].failed and ta[0].score == 5


def rescue_case():
    """The dense DAG, its reads, and a fourth read of random bases that no
    stage can place: (JAX graph, JAX index, reads)."""
    g, index, reads = graphs()["dag"]
    rng = np.random.default_rng(9)
    return g, index, list(reads) + [
        ("random", "".join(rng.choice(list("ACGT"), 130)))]


def ga_record(a) -> dict:
    """What assert_same_alignments compares, as JSON values."""
    return dict(aln_record(a), is_secondary=bool(a.is_secondary),
                secondary=[ga_record(s) for s in a.secondary])


@functools.lru_cache(maxsize=None)
def rescue_runs():
    """ChainerModel at the port's default config on rescue_case()
    (auto_compare_dense: every read gets the GA baseline comparison): the
    random read fails, escalates and is rescued, as a failed read is.
    Returns (the port's alignments, its counters).  The JAX package's
    alignments are recorded in tests/torch_fixtures/ga_rescue.json
    (make_fixtures.py there; its run compiles the CLC path's shapes, ~30
    s on the CPU)."""
    g, index, reads = rescue_case()
    timers.reset()
    ta = TC.ChainerModel(port_graph(g), port_mpc(build_mpc(g)),
                         port_index(index), device="cpu").align_batch(reads)
    return ta, timers.counters()


def test_chainer_default_config_matches_jax():
    """The port's defaults are the JAX package's: the threshold rescue at
    0.35, the escalation threshold inherited from it, auto_compare_dense
    on; and so are GA mode's."""
    got = convert.from_reference_config(
        dataclasses.asdict(JC.ChainerConfig()))
    assert got == TC.ChainerConfig()
    assert (got.rescue_threshold, got.escalate_threshold,
            got.auto_compare_dense) == (0.35, None, True)
    assert convert.from_reference_aligner_config(
        dataclasses.asdict(JM.AlignerConfig())) == TM.AlignerConfig()


def test_rescue_on_a_dense_graph_matches_jax():
    """On a graph where more than 2% of nodes exceed max_in, the default
    ChainerModel compares every read with the GA baseline and keeps the
    better alignment; the port's alignments equal the JAX package's."""
    ta, counters = rescue_runs()
    g = port_world("dag")[0]
    assert np.mean(np.diff(g.in_ptr) > TC.ChainerConfig().max_in) > 0.02
    assert [ga_record(a) for a in ta] == load_fixture("ga_rescue")
    assert counters["rescued_reads"] == len(ta)
    assert counters["escalated_reads"] >= 1
    assert ta[-1].failed and all(not a.failed for a in ta[:-1])


def test_seedless_dp_is_refused():
    """The model refused --seedless-DP until it was ported; it takes it
    now, with the reference's restart stride, and builds its full-start
    scanner at the first read (the scans and alignments against JAX:
    tests/test_torch_seedless.py)."""
    g, index, _ = port_world("dag")
    model = TM.GraphAlignerModel(
        g, index, TM.AlignerConfig(seedless_dp=True, dp_restart_stride=100),
        device="cpu")
    assert model.cfg.seedless_dp and model.cfg.dp_restart_stride == 100
    assert model._fullstart is None


@pytest.mark.timeout(600)
def test_cli_ga_gaf_matches_jax(toy_gfa, tmp_path):
    """python -m graphchainer_torch --mode ga writes the bytes that
    graphchainer_tpu.cli --mode ga writes (the port's run in a child with
    jax blocked)."""
    fa = tmp_path / "r.fa"
    fa.write_text(f">read\n{TOY_READ}\n>rc\n{TOY_READ[::-1]}\n")
    flags = ["-g", padded_toy(toy_gfa, tmp_path), "-f", str(fa),
             "--mode", "ga",
             "--seeds-minimizer-length", "11",
             "--seeds-minimizer-windowsize", "5", "-t", "1"]
    want = tmp_path / "jax.gaf"
    assert JCLI.main(flags + ["-a", str(want)]) == 0
    got = tmp_path / "torch.gaf"
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['graphchainer_tpu'] = None\n"
            "sys.argv = ['graphchainer_torch'] + sys.argv[1:]\n"
            "runpy.run_module('graphchainer_torch', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code] + flags
                       + ["-a", str(got), "--device", "cpu"], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert "Reads with an alignment: 1" in r.stdout
    assert got.read_bytes() == want.read_bytes() and want.read_bytes()


@pytest.mark.parametrize("argv,want", [
    (["--no-colinear-chaining"], dict(mode="ga")),
    (["--mode", "ga", "-B", "64", "--X-drop", "40"],
     dict(mode="ga", ramp_band_slots=64, x_drop=40)),
    (["--mode", "ga", "--precise-clipping", "0.8", "--E-cutoff", "1e-3",
      "--schedule-score", "--global-alignment"],
     dict(precise_clipping=0.8, e_cutoff=1e-3,
          selection_method="ScheduleScore", global_alignment=True)),
    (["--compare-baseline"], dict(mode="clc"))])
def test_cli_wires_ga_flags(argv, want):
    from graphchainer_torch import cli
    args = cli.build_parser().parse_args(
        ["-g", "g.gfa", "-f", "r.fa", "-a", "o.gaf"] + argv)
    params = cli.params_from_args(args)
    for k, v in want.items():
        assert getattr(params, k) == v, k
    assert params.chainer.compare_with_baseline == ("--compare-baseline"
                                                    in argv)

"""MEM, MUM and file seeds of the port (index/mem.py, the numpy window
path of ChainerModel, the pipeline's seed branch and the CLI's seeding
flags) against the JAX package.

The host functions run live on both packages: the suffix array and
matching statistics on tests/test_mem.py's random texts, the MEM / MUM
seeds on its graphs and on the slice case's graph, GraphTensors'
find_splits, and the window path's jobs, fragments and seed counts from
MEM seeds and from GAM file seeds.  The end-to-end runs (align_batch on
the toy graph of tests/test_cli_tools.py::test_file_seeds, and the CLI's
output bytes with --seeds-mem-count / --seeds-mum-count / --seeds-file)
compare with the JAX package's outputs recorded in tests/torch_fixtures/
(each new JAX shape costs a compile of a minute on the CPU).  Equality is
exact throughout."""
import dataclasses
import gzip
import os

import numpy as np
import pytest

from graphchainer_tpu import native as JN
from graphchainer_tpu.align import anchors as JA
from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.index import mem as JMEM
from graphchainer_tpu.io import gam_reader as JGR
from graphchainer_tpu.io.gfa import Bigraph, load_gfa, save_gfa
from graphchainer_tpu.models import chainer as JC
from graphchainer_torch import cli as TCLI
from graphchainer_torch import native as TN
from graphchainer_torch import pipeline as TP
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.graph.mpc import build_mpc as t_build_mpc
from graphchainer_torch.index import mem as TMEM
from graphchainer_torch.index.minimizer import SeedHit
from graphchainer_torch.index.minimizer import build_index as t_build_index
from graphchainer_torch.io import gam_reader as TGR
from graphchainer_torch.models import chainer as TC

from conftest import TOY_READ
from test_mpc import random_dag_bigraph
from test_torch_common import (TOY_GFA_TEXT, aln_record, load_fixture,
                               output_record, port_graph, slice_case,
                               slice_case_port)
from test_torch_optimal import run_cli
from test_torch_slice import slice_reads


def _text(rng, n):
    return np.frombuffer("".join(rng.choice(list("ACGT"), n)).encode(),
                         dtype=np.uint8)


def _one_segment_graph(seq):
    bg = Bigraph()
    bg.add_segment("x", seq)
    return build_alignment_graph(bg)


# ---- the native bindings and index/mem.py, live on both packages -------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suffix_array_matches_jax(seed):
    text = _text(np.random.default_rng(seed), 300 + 97 * seed)
    sa = TN.suffix_array(text)
    np.testing.assert_array_equal(sa, JN.suffix_array(text))
    assert sa.dtype == np.int64
    suf = [bytes(text[i:]) for i in sa]
    assert suf == sorted(suf)


@pytest.mark.parametrize("seed", [0, 1])
def test_matching_stats_matches_jax(seed):
    """tests/test_mem.py's text and read (two pieces of the text around a
    base that breaks the match), and a random read."""
    rng = np.random.default_rng(seed)
    text_s = "".join(rng.choice(list("ACGT"), 200))
    for read_s in (text_s[50:70] + "T" + text_s[100:115],
                   "".join(rng.choice(list("ACGT"), 40))):
        text = np.frombuffer(text_s.encode(), dtype=np.uint8)
        read = np.frombuffer(read_s.encode(), dtype=np.uint8)
        sa = TN.suffix_array(text)
        got = TN.matching_stats(text, sa, read)
        want = JN.matching_stats(text, sa, read)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def _slice_graphs():
    """The slice case's graph in both packages and a path read."""
    g, _, _, path_seq, reads = slice_case()
    return g, slice_case_port()[0], reads


def _mem_worlds():
    """(name, JAX graph, port graph, reads, min_len, max_count) of
    tests/test_mem.py's graphs (an exact substring, a repeated core) and
    the slice case's graph with its simulated reads."""
    rng = np.random.default_rng(12345)
    seq = "".join(rng.choice(list("ACGT"), 400))
    core = "".join(rng.choice(list("ACGT"), 60))
    uniq = "".join(rng.choice(list("ACGT"), 60))
    out = []
    for name, s, reads, min_len in (
            ("substring", seq, [seq[100:200]], 25),
            ("repeat", core + uniq + core, [core, uniq + core], 20)):
        g = _one_segment_graph(s)
        out.append((name, g, port_graph(g), reads, min_len, 10))
    g, tg, reads = _slice_graphs()
    out.append(("slice", g, tg, [r for _, r in reads], 20, 8))
    return out


@pytest.mark.parametrize("unique_only", [False, True], ids=["mem", "mum"])
@pytest.mark.parametrize("world", ["substring", "repeat", "slice"])
def test_mem_seeds_match_jax(world, unique_only):
    """build_mem_index and get_mem_seeds (MEMs, and MUMs with one graph
    occurrence) equal the JAX package's on the same graph and reads."""
    name, g, tg, reads, min_len, max_count = next(
        w for w in _mem_worlds() if w[0] == world)
    jidx, tidx = JMEM.build_mem_index(g), TMEM.build_mem_index(tg)
    for f in ("text", "sa", "starts"):
        np.testing.assert_array_equal(getattr(jidx, f), getattr(tidx, f))
    n = 0
    for read in reads:
        want = JMEM.get_mem_seeds(jidx, g, read, min_len, max_count,
                                  unique_only)
        got = TMEM.MemSeeder(tg, tidx, min_len, max_count,
                             unique_only).get_seeds(read)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
        n += len(got)
    assert n > 0


def test_mem_index_roundtrip(tmp_path):
    """A saved index loads back whole, and a MemSeeder on it finds the
    same seeds."""
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), 150))
    g = port_graph(_one_segment_graph(seq))
    idx = TMEM.build_mem_index(g)
    f = str(tmp_path / "mem.npz")
    idx.save(f)
    back = TMEM.MemIndex.load(f)
    for k in ("text", "sa", "starts"):
        np.testing.assert_array_equal(getattr(idx, k), getattr(back, k))
    read = seq[20:90]
    assert [dataclasses.asdict(s) for s in
            TMEM.MemSeeder(g, back, min_len=20).get_seeds(read)] == \
        [dataclasses.asdict(s) for s in
         TMEM.MemSeeder(g, idx, min_len=20).get_seeds(read)]


def test_mum_seeds_are_unique():
    """A repeated core: its MEMs hit both copies, and every MUM occurs
    once in the graph's node sequences."""
    rng = np.random.default_rng(12345)
    core = "".join(rng.choice(list("ACGT"), 60))
    uniq = "".join(rng.choice(list("ACGT"), 60))
    g = port_graph(_one_segment_graph(core + uniq + core))
    mems = TMEM.MemSeeder(g, min_len=20).get_seeds(core)
    mums = TMEM.MemSeeder(g, min_len=20, unique_only=True).get_seeds(
        uniq + core)
    assert len({(s.di_node, s.node_offset) for s in mems
                if s.match_len == 60}) >= 2
    assert mums
    for s in mums:
        piece = (uniq + core)[s.seq_pos:s.seq_pos + s.match_len]
        assert sum(d.count(piece) for d in g.di_seqs) == 1


def test_find_splits_matches_jax():
    """Every (digraph node, offset) of the slice graph maps to the same
    split node and offset in both packages."""
    g, tg, _ = _slice_graphs()
    di = np.repeat(np.arange(g.n_digraph), [len(s) for s in g.di_seqs])
    off = np.concatenate([np.arange(len(s)) for s in g.di_seqs])
    want = JA.GraphTensors.build(g).find_splits(di, off)
    got = TA.GraphTensors.build(tg).find_splits(di, off)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---- the window path, live on both packages ----------------------------

def _slice_seed_gam(tmp_path):
    """A GAM of the slice reads' MEM-seeded alignments, written by the
    port (the JAX CLI's GAM of the toy graph names none of these nodes):
    the file seeds of the slice case."""
    from graphchainer_torch.io import gam
    tg, tmpc, tidx = slice_case_port()[:3]
    seeder = TMEM.MemSeeder(tg, min_len=20, max_count=8)
    model = TC.ChainerModel(tg, tmpc, tidx, TC.ChainerConfig(
        rescue_threshold=0.0), seed_fn=lambda n, s: seeder.get_seeds(s),
        device="cpu")
    path = str(tmp_path / "seeds.gam")
    w = gam.GamWriter(path)
    for a in model.align_batch(slice_reads()):
        if not a.failed:
            w.write(gam.alignment_message(tg, a))
    w.close()
    return path


@pytest.mark.parametrize("seeds", ["mem", "mum", "file"])
def test_window_jobs_match_jax(seeds, tmp_path):
    """_fragment_jobs_cols over MEM, MUM or file seeds (the numpy window
    path): the jobs, the fragment rows and the seed counts equal the JAX
    package's, on the slice case's reads."""
    g, mpc, index, _, _ = slice_case()
    tg, tmpc, tidx = slice_case_port()[:3]
    reads = slice_reads()
    kw = {}
    if seeds == "file":
        path = _slice_seed_gam(tmp_path)
        ids = {n: i for i, n in enumerate(g.names)}
        kw["j"] = dict(file_seeds=JGR.load_gam_seeds(path, ids))
        kw["t"] = dict(file_seeds=TGR.load_gam_seeds(path, ids))
        assert sum(map(len, kw["t"]["file_seeds"].values())) >= 3
    else:
        uniq = seeds == "mum"
        js = JMEM.MemSeeder(g, min_len=20, max_count=1 if uniq else 8,
                            unique_only=uniq)
        ts = TMEM.MemSeeder(tg, min_len=20, max_count=1 if uniq else 8,
                            unique_only=uniq)
        kw["j"] = dict(seed_fn=lambda n, s: js.get_seeds(s))
        kw["t"] = dict(seed_fn=lambda n, s: ts.get_seeds(s))
    want = JC.ChainerModel(g, mpc, index, **kw["j"])._fragment_jobs_cols(
        reads)
    got = TC.ChainerModel(tg, tmpc, tidx, **kw["t"],
                          device="cpu")._fragment_jobs_cols(reads)
    assert type(got[0]) is TN.JobCols and len(got[0]) > 0
    for f in ("seed", "trim", "rev", "read_idx", "lo", "hi"):
        a, b = getattr(got[0], f), getattr(want[0], f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_window_jobs_without_seeds():
    """Reads with no seed (and a read shorter than 5 bases) give the empty
    batch, with the seed counts of the reads that had seeds."""
    tg, tmpc, tidx = slice_case_port()[:3]
    reads = [("a", "ACGTACGTAC"), ("b", "ACG")]
    seeds = {"b": [SeedHit(di_node=0, node_offset=0, seq_pos=0,
                           match_len=3, goodness=1.0)] * 2}
    model = TC.ChainerModel(tg, tmpc, tidx, file_seeds=seeds, device="cpu")
    jobs, frags, counts = model._fragment_jobs_cols(reads)
    assert len(jobs) == 0 and frags.shape == (0, 7)
    assert counts == [0, len(seeds["b"])] and counts[1] > 0
    out = model.align_batch(reads)
    assert [a.n_seeds for a in out] == counts and all(a.failed for a in out)


def test_escalation_keeps_the_seeds():
    """The escalated sibling seeds with the same seeder and file seeds."""
    tg, tmpc, tidx = slice_case_port()[:3]

    def fn(n, s):
        return []
    m = TC.ChainerModel(tg, tmpc, tidx, file_seeds={}, seed_fn=fn,
                        device="cpu")
    e = m.escalated()
    assert e.seed_fn is fn and e.file_seeds == {}
    assert e.cfg.band_slots == m.cfg.escalate_band


# ---- end to end against the recorded JAX outputs -----------------------

SEED_CASES = ("mem", "file")


def toy_seed_world(tmp_path, case, pkg, gam_hex=None):
    """The toy graph of tests/test_cli_tools.py::test_file_seeds (k=11,
    w=5, band_slots=16, polish_band_words=4) in one package's classes
    (pkg "jax" or "torch"), its read and a seeder: MEM seeds (at least 12
    bases, up to 8 occurrences), or the file seeds of the GAM that the JAX
    CLI writes for the read (made here for the JAX side; the port reads
    the recorded bytes, gam_hex)."""
    gfa = str(tmp_path / "toy.gfa")
    with open(gfa, "w") as fh:
        fh.write(TOY_GFA_TEXT)
    reads = [("read", TOY_READ)]
    g = build_alignment_graph(load_gfa(gfa))
    w = dict(reads=reads, gam=None, file_seeds=None, seed_fn=None)
    if pkg == "torch":
        g = port_graph(g)
    if case == "file":
        path = str(tmp_path / "seeds.gam")
        if pkg == "jax":
            from graphchainer_tpu.cli import main as jax_cli
            fa = tmp_path / "seed_reads.fa"
            fa.write_text(f">read\n{TOY_READ}\n")
            assert jax_cli(["-g", gfa, "-f", str(fa), "-a", path, "-b", "16",
                            "--polish-band", "4",
                            "--seeds-minimizer-length", "11",
                            "--seeds-minimizer-windowsize", "5"]) == 0
            with gzip.open(path, "rb") as fh:
                w["gam"] = fh.read().hex()
        else:
            with gzip.open(path, "wb") as fh:
                fh.write(bytes.fromhex(gam_hex))
        load = JGR.load_gam_seeds if pkg == "jax" else TGR.load_gam_seeds
        w["file_seeds"] = load(path, {n: i for i, n in enumerate(g.names)})
    else:
        mem = JMEM if pkg == "jax" else TMEM
        seeder = mem.MemSeeder(g, min_len=12, max_count=8)
        w["seed_fn"] = lambda name, seq: seeder.get_seeds(seq)
    if pkg == "jax":
        from graphchainer_tpu.graph.mpc import build_mpc
        from graphchainer_tpu.index.minimizer import build_index
        w.update(g=g, mpc=build_mpc(g), index=build_index(g, k=11, w=5),
                 cfg=JC.ChainerConfig(band_slots=16, polish_band_words=4))
    else:
        w.update(g=g, mpc=t_build_mpc(g), index=t_build_index(g, k=11, w=5),
                 cfg=TC.ChainerConfig(band_slots=16, polish_band_words=4))
    return w


@pytest.mark.parametrize("case", SEED_CASES)
def test_align_batch_with_seeds_matches_jax(case, tmp_path):
    want = load_fixture("seeds_model")[case]
    w = toy_seed_world(tmp_path, case, "torch", want["gam"])
    got = TC.ChainerModel(w["g"], w["mpc"], w["index"], w["cfg"],
                          file_seeds=w["file_seeds"], seed_fn=w["seed_fn"],
                          device="cpu").align_batch(w["reads"])
    assert all(not a.failed and a.n_seeds > 0 for a in got)
    assert [aln_record(a) for a in got] == want["alignments"]


SEED_CLI_CASES = ("mem", "mum", "file", "mem_slice")


def seeds_cli_case(tmp_path, case):
    """The CLI with a seeding flag: (GFA path, reads, flags).  "mem" is
    tests/test_mem.py::test_mem_seeding_cli; "mum" the same with unique
    matches; "file" the toy run of test_file_seeds from the command line
    (its seeds: the JAX CLI's GAM recorded in the seeds_model fixture);
    "mem_slice" the slice case's graph and reads (the 50%-error read finds
    no MEM, escalates and is rescued) with MEM seeds of the default
    length."""
    if case == "mem_slice":
        gfa = str(tmp_path / "g.gfa")
        save_gfa(random_dag_bigraph(np.random.default_rng(2), n_seg=24,
                                    p_edge=0.15, max_len=300), gfa)
        return gfa, slice_reads(), [
            "--seeds-mem-count", "8", "--seeds-minimizer-length", "11",
            "--seeds-minimizer-windowsize", "6"]
    gfa = str(tmp_path / "toy.gfa")
    with open(gfa, "w") as fh:
        fh.write(TOY_GFA_TEXT)
    flags = ["-b", "16", "--polish-band", "4"]
    if case == "mem":
        flags += ["--seeds-mem-count", "8", "--seeds-mxm-length", "12",
                  "--seeds-mxm-cache-prefix", str(tmp_path / "sa")]
    elif case == "mum":
        flags += ["--seeds-mum-count", "1", "--seeds-mxm-length", "12"]
    else:
        path = str(tmp_path / "seeds.gam")
        with gzip.open(path, "wb") as fh:
            fh.write(bytes.fromhex(load_fixture("seeds_model")["file"]["gam"]))
        flags += ["--seeds-file", path, "--seeds-minimizer-length", "11",
                  "--seeds-minimizer-windowsize", "5"]
    return gfa, [("read", TOY_READ)], flags


@pytest.mark.parametrize("case", SEED_CLI_CASES)
def test_cli_seeds_outputs_match_jax(case, tmp_path):
    gfa, reads, flags = seeds_cli_case(tmp_path, case)
    got = output_record(run_cli(TCLI.main, tmp_path, "torch", gfa, reads,
                                flags + ["--device", "cpu"]))
    want = load_fixture("seeds_cli")[case]
    assert want["gaf"].count("\n") == len(reads)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    if case == "mem":
        assert os.path.exists(str(tmp_path / "sa") + ".sa.npz")


def test_mxm_cache_is_loaded(tmp_path, monkeypatch):
    """The suffix-array cache is written where it is missing and loaded,
    not rebuilt, where it exists."""
    g = slice_case_port()[0]
    prefix = str(tmp_path / "c")
    built = TP.get_or_build_mem(g, prefix)
    assert os.path.exists(prefix + ".sa.npz")

    def no_build(_):
        raise AssertionError("the index was rebuilt")
    monkeypatch.setattr(TMEM, "build_mem_index", no_build)
    back = TP.get_or_build_mem(g, prefix)
    for k in ("text", "sa", "starts"):
        np.testing.assert_array_equal(getattr(built, k), getattr(back, k))


def test_seed_flags_reach_the_pipeline():
    args = TCLI.build_parser().parse_args(
        ["-g", "g.gfa", "-f", "r.fa", "-a", "o.gaf", "--seeds-mem-count",
         "5", "--seeds-mxm-length", "15", "--seeds-mxm-cache-prefix", "p",
         "--seeds-file", "s.gam", "--seeds-mum-count", "2"])
    p = TCLI.params_from_args(args)
    assert (p.mem_count, p.mum_count, p.mxm_length, p.mxm_cache_prefix,
            p.seed_file) == (5, 2, 15, "p", "s.gam")

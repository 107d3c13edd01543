"""The port's own host layer against the JAX package's modules it was
copied from: constants, utils, io, native bindings, graph, index, the
read simulator, GA mode's host modules (align/correctness, evalue,
selection, stitch.path_to_positions, the GA job assembly of
align/anchors) and the golden workloads of scripts/.  The same GFA text
and the same numpy-seeded reads go through both packages, and every
output must be exactly equal.  Also convert.py, which carries the
reference's state across to the port's classes.  Also the copies of
optimal mode and its I/O: the exact DAG oracle (align/oracle.py),
anchors.backwalk, io/vg_wire, io/gam, io/vg_graph and io/gam_reader.
Also the MEM / MUM seeder (index/mem.py and its native bindings),
GraphTensors.find_splits and the multi-process helpers
(parallel/multihost.py)."""
import dataclasses
import gzip

import numpy as np
import pytest

from graphchainer_tpu import constants as JK
from graphchainer_tpu import native as JN
from graphchainer_tpu.align import anchors as JA
from graphchainer_tpu.align import correctness as JCOR
from graphchainer_tpu.align import oracle as JOR
from graphchainer_tpu.align import evalue as JEV
from graphchainer_tpu.align import selection as JSEL
from graphchainer_tpu.align import stitch as JST
from graphchainer_tpu.graph import alignment_graph as JAG
from graphchainer_tpu.graph import mpc as JMPC
from graphchainer_tpu.graph import simulate as JSIM
from graphchainer_tpu.index import mem as JMEM
from graphchainer_tpu.index import minimizer as JMIN
from graphchainer_tpu.io import fastq as JFQ
from graphchainer_tpu.io import gam as JGAM
from graphchainer_tpu.io import gam_reader as JGR
from graphchainer_tpu.io import gfa as JGFA
from graphchainer_tpu.io import vg_graph as JVG
from graphchainer_tpu.io import vg_wire as JVW
from graphchainer_tpu.models import chainer as JC
from graphchainer_tpu.parallel import multihost as JMH
from graphchainer_tpu.utils import bits as JB
from graphchainer_tpu.utils import seq as JS
from graphchainer_torch import constants as TK
from graphchainer_torch import convert
from graphchainer_torch import native as TN
from graphchainer_torch import workload as TW
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.align import correctness as TCOR
from graphchainer_torch.align import oracle as TOR
from graphchainer_torch.align import evalue as TEV
from graphchainer_torch.align import selection as TSEL
from graphchainer_torch.align import stitch as TST
from graphchainer_torch.graph import alignment_graph as TAG
from graphchainer_torch.graph import mpc as TMPC
from graphchainer_torch.graph import simulate as TSIM
from graphchainer_torch.index import mem as TMEM
from graphchainer_torch.index import minimizer as TMIN
from graphchainer_torch.io import fastq as TFQ
from graphchainer_torch.io import gam as TGAM
from graphchainer_torch.io import gam_reader as TGR
from graphchainer_torch.io import gfa as TGFA
from graphchainer_torch.io import vg_graph as TVG
from graphchainer_torch.io import vg_wire as TVW
from graphchainer_torch.models import chainer as TC
from graphchainer_torch.parallel import multihost as TMH
from graphchainer_torch.utils import bits as TB
from graphchainer_torch.utils import seq as TS

from test_mpc import random_dag_bigraph

K, WIN = 11, 6


def same(a, b, msg=""):
    """Exact equality of two results of any nesting the host layer
    returns: arrays (dtype included), dataclasses, tuples, lists,
    scalars, None."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), msg
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (msg, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=msg)
    elif dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, msg
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{msg}.{f.name}")
    elif isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), msg
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{msg}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), msg
        for k in a:
            same(a[k], b[k], f"{msg}[{k!r}]")
    else:
        assert type(a) is type(b) and a == b, (msg, a, b)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One GFA text (a random DAG with a path line, an overlap link and
    an IUPAC base), parsed and indexed by each package, and reads drawn
    from its source-to-sink path."""
    tmp = tmp_path_factory.mktemp("host")
    rng = np.random.default_rng(2)
    bg = random_dag_bigraph(rng, n_seg=24, p_edge=0.15, max_len=300)
    gfa = str(tmp / "g.gfa")
    JGFA.save_gfa(bg, gfa)
    with open(gfa, "a") as f:
        f.write("S\tx1\tACGTNACGRTAC\nS\tx2\tTACGGA\n"
                "L\tx1\t+\tx2\t-\t3M\nP\tp1\tx1+,x2-\t*\n"
                "W\ts\t0\tc\t0\t9\t>x1<x2\n")
    w = {"gfa": gfa, "tmp": tmp}
    for key, gfa_mod, ag, mpc_mod, mn in (
            ("j", JGFA, JAG, JMPC, JMIN), ("t", TGFA, TAG, TMPC, TMIN)):
        b = gfa_mod.load_gfa(gfa)
        g = ag.build_alignment_graph(b)
        w[key] = dict(bg=b, g=g, mpc=mpc_mod.build_mpc(g),
                      index=mn.build_index(g, k=K, w=WIN))
    path_seq, _ = JSIM.generate_path(w["j"]["g"], seed=5)
    w["path_seq"] = path_seq
    w["reads"] = JSIM.simulate_reads(path_seq, 4, 450, seed=8,
                                     error_rate=0.10, len_std=40)
    return w


# ------------------------------------------------------------ constants
@pytest.mark.parametrize("name", [n for n in dir(JK) if n.isupper()])
def test_constants(name):
    same(getattr(JK, name), getattr(TK, name), name)


# ------------------------------------------------------------ utils
SEQS = ["", "A", "ACGTNRYKMSWBDHV-acgtu", "GATTACA" * 9, "TTTTNNNNACGT" * 5]


@pytest.mark.parametrize("fn", ["revcomp", "encode", "match_masks",
                                "eq_bitplanes"])
def test_utils_seq(fn):
    for s in SEQS:
        args = (s, 2) if fn == "eq_bitplanes" else (s,)
        if fn == "encode":
            s = s.replace("-", "")
            args = (s,)
        same(getattr(JS, fn)(*args), getattr(TS, fn)(*args), f"{fn}({s!r})")


@pytest.mark.parametrize("fn", ["bitrev32", "reverse_eq_planes"])
def test_utils_bits(fn):
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 32, size=(50, 4), dtype=np.uint64) \
        .astype(np.uint32)
    if fn == "bitrev32":
        same(JB.bitrev32(x), TB.bitrev32(x))
    else:
        lens = rng.integers(1, 33, size=50).astype(np.int32)
        same(JB.reverse_eq_planes(x, lens), TB.reverse_eq_planes(x, lens))


# ------------------------------------------------------------ io
@pytest.mark.parametrize("what", ["bigraph", "path_sequence", "save_gfa",
                                  "parse_overlap", "steps"])
def test_io_gfa(world, what):
    jb, tb = world["j"]["bg"], world["t"]["bg"]
    if what == "bigraph":
        same(vars(jb), vars(tb))
        assert len(jb.links) > 10 and jb.paths
    elif what == "path_sequence":
        for name in jb.paths:
            same(JGFA.path_sequence(jb, name), TGFA.path_sequence(tb, name))
    elif what == "save_gfa":
        a, b = world["tmp"] / "a.gfa", world["tmp"] / "b.gfa"
        JGFA.save_gfa(jb, str(a))
        TGFA.save_gfa(tb, str(b))
        assert a.read_text() == b.read_text() and a.read_text()
    elif what == "parse_overlap":
        for c in ("*", "0M", "12M"):
            same(JGFA.parse_overlap(c), TGFA.parse_overlap(c))
        with pytest.raises(ValueError):
            TGFA.parse_overlap("3M2I4M")
    else:
        same(JGFA.parse_path_steps("a+,b-,c+"),
             TGFA.parse_path_steps("a+,b-,c+"))
        same(JGFA.parse_walk_steps(">a<b>c"), TGFA.parse_walk_steps(">a<b>c"))


@pytest.mark.parametrize("kind", ["fasta", "fastq", "fastq.gz"])
def test_io_fastq(world, kind):
    p = world["tmp"] / f"r.{kind}"
    if kind == "fasta":
        text = "".join(f">{n} d\n{s[:60]}\n{s[60:]}\n"
                       for n, s in world["reads"])
    else:
        text = "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                       for n, s in world["reads"])
    opener = gzip.open if kind.endswith(".gz") else open
    with opener(p, "wt") as f:
        f.write(text)
    got = list(TFQ.stream_reads(str(p)))
    same(list(JFQ.stream_reads(str(p))), got)
    assert [r.seq for r in got] == [s for _, s in world["reads"]]


# ------------------------------------------------------------ graph
@pytest.mark.parametrize("what", [f.name for f in
                                  dataclasses.fields(JAG.AlignmentGraph)]
                         + ["approx_linear_pos", "chains", "stats",
                            "queries"])
def test_alignment_graph(world, what):
    jg, tg = world["j"]["g"], world["t"]["g"]
    assert type(tg) is TAG.AlignmentGraph
    if what in ("approx_linear_pos", "chains", "stats"):
        same(getattr(jg, what)(), getattr(tg, what)(), what)
    elif what == "queries":
        for v in range(0, jg.n_nodes, 7):
            same(jg.node_seq(v), tg.node_seq(v))
            same(jg.gfa_name(v), tg.gfa_name(v))
            same(jg.is_reverse(v), tg.is_reverse(v))
            same(jg.out_neighbors(v), tg.out_neighbors(v))
            same(jg.in_neighbors(v), tg.in_neighbors(v))
            same(jg.reverse_position(v, 0), tg.reverse_position(v, 0))
            d, o = int(jg.orig_node[v]), int(jg.orig_offset[v])
            same(jg.find_split(d, o), tg.find_split(d, o))
        same(jg.path_seq(range(5)), tg.path_seq(range(5)))
    else:
        same(getattr(jg, what), getattr(tg, what), what)


@pytest.mark.parametrize("what", [f.name for f in
                                  dataclasses.fields(JMPC.MPCIndex)]
                         + ["queries", "check", "saved"])
def test_mpc(world, what):
    jm, tm = world["j"]["mpc"], world["t"]["mpc"]
    assert type(tm) is TMPC.MPCIndex
    if what == "queries":
        same(jm.max_width, tm.max_width)
        same(jm.paths_of_component(0), tm.paths_of_component(0))
        for v in range(0, world["j"]["g"].n_nodes, 5):
            same(jm.backwards(v), tm.backwards(v))
            same(jm.node_paths(v), tm.node_paths(v))
    elif what == "check":
        assert TMPC.check_min_path_cover(world["t"]["g"], tm)
        assert JMPC.check_min_path_cover(world["j"]["g"], jm)
    elif what == "saved":
        # each package reads the file the other wrote
        a, b = str(world["tmp"] / "ja.npz"), str(world["tmp"] / "tb.npz")
        jm.save(a)
        tm.save(b)
        same(JMPC.MPCIndex.load(b), jm)
        same(TMPC.MPCIndex.load(a), tm)
    else:
        same(getattr(jm, what), getattr(tm, what), what)


# ------------------------------------------------------------ index
@pytest.mark.parametrize("what", ["tables", "python_build", "minimizers",
                                  "lookup", "lookup_batch", "get_seeds",
                                  "cluster_seeds", "saved"])
def test_minimizer(world, what, monkeypatch):
    ji, ti = world["j"]["index"], world["t"]["index"]
    reads = [s for _, s in world["reads"]]
    assert type(ti) is TMIN.MinimizerIndex
    if what == "tables":
        same(ji, ti)
        assert len(ti.codes) > 100
    elif what == "python_build":
        monkeypatch.setenv("GCTPU_PY_INDEX", "1")
        same(TMIN.build_index(world["t"]["g"], k=K, w=WIN), ti)
    elif what == "minimizers":
        c = TMIN._encode(reads[0])
        same(JMIN._encode(reads[0]), c)
        same(JMIN.minimizers(c, K, WIN), TMIN.minimizers(c, K, WIN))
        same(JMIN.kmer_codes(c, K), TMIN.kmer_codes(c, K))
    elif what == "lookup":
        for r in reads:
            got = TMIN.get_seed_arrays(ti, r, 10.0)
            same(JMIN.get_seed_arrays(ji, r, 10.0), got)
            assert got is not None and len(got[0]) > 5
    elif what == "lookup_batch":
        same(JMIN.get_seed_arrays_batch(ji, reads, 5.0),
             TMIN.get_seed_arrays_batch(ti, reads, 5.0))
    elif what == "get_seeds":
        same(JMIN.get_seeds(ji, reads[1]), TMIN.get_seeds(ti, reads[1]))
    elif what == "cluster_seeds":
        same(JMIN.cluster_seeds(world["j"]["g"], JMIN.get_seeds(ji, reads[2])),
             TMIN.cluster_seeds(world["t"]["g"], TMIN.get_seeds(ti, reads[2])))
    else:
        a, b = str(world["tmp"] / "ji.npz"), str(world["tmp"] / "ti.npz")
        ji.save(a)
        ti.save(b)
        same(JMIN.MinimizerIndex.load(b), ji)
        same(TMIN.MinimizerIndex.load(a), ti)


# ------------------------------------------------------------ simulate
@pytest.mark.parametrize("what", ["generate_path", "simulate_reads",
                                  "mutate_read", "mutate_read_badread",
                                  "tangle_bigraph"])
def test_simulate(world, what):
    if what == "generate_path":
        same(JSIM.generate_path(world["j"]["g"], seed=5),
             TSIM.generate_path(world["t"]["g"], seed=5))
    elif what == "simulate_reads":
        got = TSIM.simulate_reads(world["path_seq"], 4, 450, seed=8,
                                  error_rate=0.10, len_std=40)
        same(world["reads"], got)
        assert len({s for _, s in got}) == 4
    elif what == "tangle_bigraph":
        a = JSIM.tangle_bigraph(np.random.default_rng(4), n_knots=3)
        b = TSIM.tangle_bigraph(np.random.default_rng(4), n_knots=3)
        same(vars(a), vars(b))
    else:
        seq = world["path_seq"][:300]
        same(getattr(JSIM, what)(np.random.default_rng(9), seq),
             getattr(TSIM, what)(np.random.default_rng(9), seq))


# ------------------------------------------------------------ native
def test_native_libraries_are_separate():
    """The port builds the shared C++ source into its own _build/ and
    never loads the JAX package's library."""
    TN.get_lib()
    JN.get_lib()
    assert "graphchainer_torch/_build/" in TN.library_path()
    assert TN.get_lib()._name == TN.library_path()
    assert JN.get_lib()._name != TN.get_lib()._name
    assert not hasattr(TN, "_SO")


@pytest.fixture(scope="module")
def native_calls(world):
    """One align_batch of the port on two reads, with the arguments and
    results of its native stage calls recorded."""
    t = world["t"]
    model = TC.ChainerModel(t["g"], t["mpc"], t["index"],
                            TC.ChainerConfig(rescue_threshold=0.0),
                            device="cpu")
    calls = {}
    names = ("seed_window_batch", "join_anchors", "stitch_batch",
             "corridor_polish_batch")
    saved = {n: getattr(TN, n) for n in names}

    def recorder(n):
        def call(*args, **kw):
            res = saved[n](*args, **kw)
            calls.setdefault(n, (args, kw, res))
            return res
        return call
    mp = pytest.MonkeyPatch()
    for n in names:
        mp.setattr(TN, n, recorder(n))
    try:
        alns = model.align_batch(world["reads"][:2])
    finally:
        mp.undo()
    assert all(not a.failed for a in alns)
    return calls


@pytest.mark.parametrize("name", ["seed_window_batch", "join_anchors",
                                  "stitch_batch", "corridor_polish_batch"])
def test_native_stage_calls(world, native_calls, name):
    """Each recorded call, replayed through the JAX package's loader with
    the JAX package's own graph tables and index, gives the same result."""
    args, kw, res = native_calls[name]
    jgx = JA.GraphTensors.build(world["j"]["g"])
    swap = {id(world["t"]["index"]): world["j"]["index"]}
    args = [jgx if isinstance(a, TA.GraphTensors) else swap.get(id(a), a)
            for a in args]
    ref = getattr(JN, name)(*args, **kw)
    if name == "seed_window_batch":
        assert type(res[0]) is TN.JobCols and len(res[0]) > 10
        same(vars(ref[0]), vars(res[0]))
        same(ref[1:], res[1:])
    else:
        same(ref, res, name)


@pytest.mark.parametrize("name", ["topo_order", "scc_order", "approx_pos",
                                  "connected_components", "mpc_build",
                                  "band_build", "band_build_multi",
                                  "find_chains", "minimizer_build",
                                  "suffix_array", "matching_stats"])
def test_native_graph_calls(world, name):
    g = world["t"]["g"]
    n = g.n_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.out_ptr))
    dst = g.out_idx.astype(np.int64)
    if name in ("topo_order", "scc_order", "connected_components"):
        args = (n, src, dst)
    elif name == "approx_pos":
        args = (n, src, dst, g.node_len)
    elif name == "mpc_build":
        args = (n, src, dst, g.comp, g.ncomp)
    elif name == "band_build":
        seeds = np.arange(0, n, 9, dtype=np.int64)
        args = (n, g.out_ptr, g.out_idx, g.node_len, seeds,
                np.ones_like(seeds), 16, 200, 4, False)
    elif name == "band_build_multi":
        # ragged multi-source jobs (an empty one too), both directions'
        # CSRs and the by_dist order of cyclic graphs
        src = np.arange(0, n, 5, dtype=np.int64)
        off = np.array([0, 3, 3, 7, len(src)], dtype=np.int64)
        for rev, by_dist in ((False, False), (True, True)):
            ptr, idx = (g.in_ptr, g.in_idx) if rev else (g.out_ptr,
                                                        g.out_idx)
            a = (n, ptr, idx, g.node_len, off, src, 24, 150, 4, rev)
            same(JN.band_build_multi(*a, by_dist=by_dist),
                 TN.band_build_multi(*a, by_dist=by_dist), name)
        return
    elif name == "find_chains":
        args = (n, g.out_ptr, g.out_idx, g.in_ptr, g.in_idx, g.node_len,
                g.di_ptr, g.di_splits)
    elif name in ("suffix_array", "matching_stats"):
        text = np.frombuffer("\0".join(g.di_seqs).encode(), dtype=np.uint8)
        args = (text,)
        if name == "matching_stats":
            read = np.frombuffer(world["reads"][0][1].encode(),
                                 dtype=np.uint8)
            args = (text, TN.suffix_array(text), read)
    else:
        seq = np.frombuffer("".join(g.di_seqs).encode(), dtype=np.uint8)
        off = np.zeros(g.n_digraph + 1, dtype=np.int64)
        np.cumsum([len(s) for s in g.di_seqs], out=off[1:])
        args = (seq, off, K, WIN, 2)
    same(getattr(JN, name)(*args), getattr(TN, name)(*args), name)


@pytest.mark.parametrize("what", ["index", "mem", "mum", "seeder"])
def test_mem(world, what):
    """index/mem.py on the world graph and its reads: the index's text,
    suffix array and node starts, MEM and MUM seeds of every read, and the
    MemSeeder's."""
    jg, tg = world["j"]["g"], world["t"]["g"]
    jidx, tidx = JMEM.build_mem_index(jg), TMEM.build_mem_index(tg)
    if what == "index":
        same(vars(jidx), vars(tidx))
        return
    for _, read in world["reads"]:
        if what == "seeder":
            want = JMEM.MemSeeder(jg, jidx, 15, 4).get_seeds(read)
            got = TMEM.MemSeeder(tg, tidx, 15, 4).get_seeds(read)
        else:
            want = JMEM.get_mem_seeds(jidx, jg, read, 20, 10, what == "mum")
            got = TMEM.get_mem_seeds(tidx, tg, read, 20, 10, what == "mum")
        assert got
        same([dataclasses.asdict(x) for x in want],
             [dataclasses.asdict(x) for x in got], what)


def test_find_splits(world):
    """GraphTensors.find_splits over every base of every digraph node."""
    jg, tg = world["j"]["g"], world["t"]["g"]
    di = np.repeat(np.arange(jg.n_digraph), [len(x) for x in jg.di_seqs])
    off = np.concatenate([np.arange(len(x)) for x in jg.di_seqs])
    same(JA.GraphTensors.build(jg).find_splits(di, off),
         TA.GraphTensors.build(tg).find_splits(di, off))


@pytest.mark.parametrize("P", [1, 2, 3])
def test_multihost_helpers(P):
    """The read stripe and the output suffix of every process."""
    items = list(range(11))
    for i in range(P):
        assert JMH.stripe(items, i, P) == TMH.stripe(items, i, P)
        for path in ("out.gaf", None):
            assert JMH.part_suffix(path, i, P) == TMH.part_suffix(path, i, P)


def test_native_topo_order_refuses_a_cycle():
    with pytest.raises(ValueError):
        TN.topo_order(2, np.array([0, 1]), np.array([1, 0]))


# ------------------------------------------------------------ GA mode
def test_correctness_hmm():
    rng = np.random.default_rng(4)
    errs = rng.integers(0, 40, 60)
    rows = rng.integers(1, 65, 60)
    same(JCOR.correctness_track(errs, rows), TCOR.correctness_track(errs,
                                                                   rows))
    js, ts = JCOR.CorrectnessState(), TCOR.CorrectnessState()
    for e, r in zip(errs, rows):
        js, ts = js.next_state(int(e), int(r)), ts.next_state(int(e), int(r))
        same(vars(js), vars(ts))
        same(js.current_is_correct(), ts.current_is_correct())


@pytest.mark.parametrize("identity", [-1.0, 0.5, 0.66, 0.9])
@pytest.mark.parametrize("legacy", [False, True])
def test_evalue(identity, legacy):
    j = JEV.EValueCalculator(identity, legacy_score=legacy)
    t = TEV.EValueCalculator(identity, legacy_score=legacy)
    same(vars(j), vars(t))
    for L, e in ((100, 0), (100, 10), (2000, 240), (35, 30)):
        same(j.alignment_score(L, e), t.alignment_score(L, e))
        same(j.evalue(60_000, 3000, L, e), t.evalue(60_000, 3000, L, e))


def _alignments(seed, n):
    """Read intervals and scores of n alignments of one 2 kbp read, as
    JAX and port ReadAlignments."""
    rng = np.random.default_rng(seed)
    out = {"j": [], "t": []}
    for i in range(n):
        a = int(rng.integers(0, 1800))
        b = int(rng.integers(a + 20, 2001))
        sc = int(rng.integers(0, (b - a) // 3 + 1))
        for key, cls in (("j", JC.ReadAlignment), ("t", TC.ReadAlignment)):
            out[key].append(cls(name=f"a{i}", seq="", positions=[],
                                ops=None, score=sc, seq_start=a,
                                seq_end=b))
    return out


@pytest.mark.parametrize("method", [m.value for m in JSEL.SelectionMethod])
def test_selection(method):
    """select_alignments picks the same alignments in the same order,
    with and without an E-value cutoff."""
    alns = _alignments(6, 14)
    for e_cutoff in (-1.0, 1e-30):
        got = {}
        for key, mod, ev in (("j", JSEL, JEV), ("t", TSEL, TEV)):
            opts = mod.SelectionOptions(
                method=mod.SelectionMethod(method), graph_size=60_000,
                read_size=2000, e_cutoff=e_cutoff,
                evalue_calc=ev.EValueCalculator(0.5))
            got[key] = [a.name for a in mod.select_alignments(alns[key],
                                                              opts)]
        same(got["j"], got["t"], method)
        assert got["t"] or e_cutoff != -1.0


def test_path_to_positions(world):
    jg, tg = world["j"]["g"], world["t"]["g"]
    rng = np.random.default_rng(7)
    for _ in range(20):
        path = rng.integers(0, jg.n_nodes, int(rng.integers(0, 6)))
        lens = jg.node_len[path] if len(path) else [1]
        fo = int(rng.integers(0, lens[0]))
        lo = int(rng.integers(0, lens[-1]))
        same(JST.path_to_positions(jg, path, fo, lo),
             TST.path_to_positions(tg, path, fo, lo))


def _ga_jobs(world, rng, carried):
    """Fresh or carried GA window jobs of both packages over the world
    graph: read rows from the world's reads, seeds anywhere, and for the
    carried ones an old band with its state, sources and shifts."""
    g = world["j"]["g"]
    jobs = {"j": [], "t": []}
    for i in range(9):
        read = world["reads"][i % 4][1]
        r0 = int(rng.integers(0, len(read) - 70))
        rmm = JS.match_masks(read[r0:r0 + int(rng.integers(1, 65))])
        rev = bool(i % 2)
        if not carried:
            v = int(rng.integers(0, g.n_nodes))
            kw = dict(rmm=rmm, seed_node=v, reverse=rev,
                      seed_trim_len=int(rng.integers(0, g.node_len[v] + 1)))
            jobs["j"].append(JA.FragJob(**kw))
            jobs["t"].append(TA.FragJob(**kw))
            continue
        B = 16
        old = np.full(B, -1, np.int64)
        k = int(rng.integers(1, B))
        old[:k] = np.sort(rng.choice(g.n_nodes, k, replace=False))
        ssb = np.where(rng.random(B) < 0.8, rng.integers(0, 90, B),
                       1 << 28).astype(np.int32)
        hp = rng.integers(0, 1 << 32, B, dtype=np.uint64).astype(np.uint32)
        kw = dict(rmm=rmm, reverse=rev, old_nodes=old, old_ssb=ssb,
                  old_hp=hp, old_hn=~hp, src_mask=rng.random(B) < 0.7,
                  old_shift=(rng.integers(0, 5, B).astype(np.int32)
                             if i % 3 else None))
        jobs["j"].append(JA.CarryJob(**kw))
        jobs["t"].append(TA.CarryJob(**kw))
    return jobs


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("B", [16, 48])
def test_assemble_ga_windows(world, carried, B):
    """assemble_batch / assemble_carry_batch: bands, shifts, slot map,
    carried state and read planes of GA windows."""
    jobs = _ga_jobs(world, np.random.default_rng(8 + B), carried)
    jfn, tfn = ((JA.assemble_carry_batch, TA.assemble_carry_batch)
                if carried else (JA.assemble_batch, TA.assemble_batch))
    jgx = JA.GraphTensors.build(world["j"]["g"])
    tgx = TA.GraphTensors.build(world["t"]["g"])
    ref = jfn(jgx, jobs["j"], B=B, max_in=4, slack=16)
    got = tfn(tgx, jobs["t"], B=B, max_in=4, slack=16)
    same(ref, got, "carried" if carried else "fresh")
    assert (ref[0] >= 0).sum() > 20


@pytest.mark.parametrize("script,which", [
    ("make_golden_cyclic.py", "golden_cyclic"),
    ("make_golden_badread.py", "golden_badread"),
    ("make_golden100.py", "golden100")], ids=["cyclic", "badread", "100"])
def test_golden_workloads(script, which, tmp_path):
    """workload's golden sets are scripts/make_golden*.py's
    build_workload, and nw_edit_distance is tests/test_polish.py's."""
    import importlib.util
    import os
    from test_polish import nw_edit_distance
    spec = importlib.util.spec_from_file_location(
        script[:-3], os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "scripts", script))
    mg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mg)
    _, jg, jreads = mg.build_workload(str(tmp_path))
    _, tg, treads = getattr(TW, f"{which}_workload")(str(tmp_path))
    same(jreads, treads)
    same(vars(jg), vars(tg))
    for (_, a), (_, b) in zip(jreads[:2], jreads[2:4]):
        same(nw_edit_distance(a[:300], b[:280]),
             TW.nw_edit_distance(a[:300], b[:280]))


# ------------------------------------------------------------ convert
@pytest.mark.parametrize("what", ["graph", "mpc", "index", "config",
                                  "config_inherits", "copies",
                                  "missing_field"])
def test_convert(world, what):
    j, t = world["j"], world["t"]
    if what == "graph":
        jg = j["g"]
        jg.approx_linear_pos()      # a cached attribute must not cross
        got = convert.from_reference_graph(vars(jg))
        assert type(got) is TAG.AlignmentGraph
        assert not hasattr(got, "_approx_pos")
        same(got, t["g"])
    elif what == "mpc":
        got = convert.from_reference_mpc(vars(j["mpc"]))
        assert type(got) is TMPC.MPCIndex
        same(got, t["mpc"])
    elif what == "index":
        got = convert.from_reference_index(vars(j["index"]))
        assert type(got) is TMIN.MinimizerIndex
        same(got, t["index"])
    elif what == "config":
        jcfg = JC.ChainerConfig(rescue_threshold=0.2,
                                escalate_threshold=0.3,
                                auto_compare_dense=False, band_slots=48)
        got = convert.from_reference_config(dataclasses.asdict(jcfg))
        assert got == TC.ChainerConfig(rescue_threshold=0.2,
                                       escalate_threshold=0.3,
                                       auto_compare_dense=False,
                                       band_slots=48)
    elif what == "config_inherits":
        # escalate_threshold=None inherits rescue_threshold in both
        got = convert.from_reference_config(
            dataclasses.asdict(JC.ChainerConfig()))
        assert got == TC.ChainerConfig()
        assert got.escalate_threshold is None
        assert got.rescue_threshold == 0.35
    elif what == "copies":
        got = convert.from_reference_graph(vars(j["g"]))
        assert not np.shares_memory(got.node_len, j["g"].node_len)
        assert got.names is not j["g"].names
    else:
        fields = dict(vars(j["mpc"]))
        del fields["back_k"]
        with pytest.raises(KeyError, match="back_k"):
            convert.from_reference_mpc(fields)


# ------------------------------------------------ optimal mode's copies
@pytest.mark.parametrize("what", ["char_graph", "dag_dp", "backtrace",
                                  "ckpt", "backtrace_ckpt",
                                  "extend_from_seed"])
def test_oracle(world, what):
    """align/oracle.py on a component of the world graph and an 80 bp
    read piece, with free start everywhere (optimal mode's injection)."""
    read = world["reads"][0][1][100:180]
    out = {}
    for key, orc in (("j", JOR), ("t", TOR)):
        g = world[key]["g"]
        nodes = np.nonzero(g.comp == 0)[0]
        cg = orc.build_char_graph(g, nodes)
        inject = np.zeros(cg.n, dtype=np.int64)
        if what == "char_graph":
            out[key] = vars(cg)
        elif what in ("dag_dp", "backtrace"):
            D = orc.dag_dp(cg, read, inject)
            end = int(np.argmin(D[:, len(read)]))
            out[key] = (D if what == "dag_dp"
                        else orc.backtrace(cg, D, read, inject, end))
        elif what in ("ckpt", "backtrace_ckpt"):
            fin, ckpts, stripe = orc.dag_dp_ckpt(cg, read, inject)
            out[key] = ((fin, ckpts, stripe) if what == "ckpt"
                        else orc.backtrace_ckpt(cg, read, inject, ckpts,
                                                stripe, int(np.argmin(fin))))
        else:
            v = int(nodes[len(nodes) // 3])
            out[key] = orc.extend_from_seed(g, read, v, 0, nodes)[1]
    same(out["j"], out["t"], what)


@pytest.mark.parametrize("dtype", [np.int8, np.int16])
def test_backwalk(dtype):
    """anchors.backwalk over best_in of either pointer width: walks that
    reach the seed, leave through a vertical step past slice 0, and break
    on IN_NONE or a cycle."""
    rng = np.random.default_rng(11)
    B, S = (64, 4) if dtype == np.int8 else (300, 4)
    for trial in range(40):
        bi = rng.integers(-3, B, (B, S)).astype(dtype)
        bn = rng.integers(-1, 1000, B).astype(np.int32)
        slot, s = int(rng.integers(0, B)), int(rng.integers(0, S))
        same(JA.backwalk(bi, bn, slot, s), TA.backwalk(bi, bn, slot, s),
             f"trial {trial}")


def test_vg_wire():
    """The protobuf helpers: varints, fields, the vg messages and their
    decoding."""
    for n in [0, 1, 127, 128, 300, 2 ** 31, 2 ** 63 - 1]:
        same(JVW.varint(n), TVW.varint(n))
    for mod in (JVW, TVW):
        assert mod.tag(3, 2) == JVW.tag(3, 2)
    msgs = {}
    for key, w in (("j", JVW), ("t", TVW)):
        pos = w.position(12, 3, True, name="s7")
        m = w.mapping(pos, [w.edit(5, 5), w.edit(1, 1, "A"),
                            w.edit(0, 2, "GT")], 0)
        msg = w.alignment("ACGTAACGT", w.path([m, w.mapping(
            w.position(13, 0, False), [w.edit(4, 4)], 1)], "p"), "read1",
            score=7, identity=0.875, mapping_quality=60, is_secondary=True)
        msgs[key] = (msg, w.f_bool(4, True), w.f_double(16, 0.25),
                     w.f_str(3, "x"), list(w.decode_fields(msg)),
                     w.to_dict(msg, {1: ("sequence", "str"),
                                     3: ("name", "str")}))
    same(msgs["j"], msgs["t"])


def _vg_bytes(bg, path_name):
    """A .vg file (gzip, one varint-framed vg.Graph) of a Bigraph: nodes
    with ids 1.., its links as edges, one embedded path."""
    w = JVW
    graph = b""
    for i, seq in enumerate(bg.seqs):
        graph += w.f_msg(1, w.f_str(1, seq) + w.f_varint(3, i + 1))
    for a, ar, b, br, ov in bg.links:
        graph += w.f_msg(2, w.f_varint(1, a + 1) + w.f_varint(2, b + 1)
                         + w.f_bool(3, ar) + w.f_bool(4, br)
                         + w.f_varint(5, ov))
    maps = b""
    for r, i in enumerate(range(0, min(len(bg.seqs), 4))):
        pos = w.f_varint(1, i + 1) + w.f_bool(4, False)
        maps += w.f_msg(2, w.f_msg(1, pos) + w.f_varint(5, r + 1))
    graph += w.f_msg(3, w.f_str(1, path_name) + maps)
    return w.varint(1) + w.varint(len(graph)) + graph


def test_vg_graph(world, tmp_path):
    """load_vg of a .vg file written with vg_wire: the same Bigraph, and
    through each package's pipeline.load_graph the same AlignmentGraph."""
    from graphchainer_tpu import pipeline as JP
    from graphchainer_torch import pipeline as TP
    p = str(tmp_path / "g.vg")
    with gzip.open(p, "wb") as fh:
        fh.write(_vg_bytes(world["j"]["bg"], "ref"))
    jb, tb = JVG.load_vg(p), TVG.load_vg(p)
    same(vars(jb), vars(tb))
    assert "ref" in tb.paths and len(tb.names) == len(world["j"]["bg"].seqs)
    same(vars(JP.load_graph(p)), vars(TP.load_graph(p)))


def _oracle_alignments(world, RA):
    """ReadAlignments (of class RA) of the world's reads from the exact
    oracle on component 0: free start, traceback from the best end, one
    with a secondary and one failed."""
    g = world["j"]["g"]
    nodes = np.nonzero(g.comp == 0)[0]
    cg = JOR.build_char_graph(g, nodes)
    inject = np.zeros(cg.n, dtype=np.int64)
    out = []
    for i, (name, seq) in enumerate(world["reads"][:3]):
        piece = seq[50:170]
        D = JOR.dag_dp(cg, piece, inject)
        end = int(np.argmin(D[:, len(piece)]))
        pos, ops = JOR.backtrace(cg, D, piece, inject, end)
        a = RA(name=name, seq=piece, positions=pos, ops=ops,
               score=int(D[end, len(piece)]), seq_start=0,
               seq_end=len(piece))
        out.append(a)
    sec = RA(name=out[0].name, seq=out[0].seq,
             positions=out[1].positions[:40], ops=out[1].ops[:40],
             score=3, seq_start=5, seq_end=45, is_secondary=True)
    out[0].secondary = [sec]
    out.append(RA(name="failed", seq="ACGT", positions=np.zeros((0, 2),
                                                                np.int64),
                  ops=None, score=4, seq_end=4))
    return out


@pytest.mark.parametrize("what", ["message", "json", "writer", "reader",
                                  "seeds"])
def test_gam(world, tmp_path, what):
    """io/gam (alignment_message, alignment_json, GamWriter, read_gam) and
    io/gam_reader on the same alignments."""
    out = {}
    for key, RA, gm, gr in (("j", JC.ReadAlignment, JGAM, JGR),
                            ("t", TC.ReadAlignment, TGAM, TGR)):
        g = world[key]["g"]
        alns = [a for a in _oracle_alignments(world, RA) if not a.failed]
        emitted = [x for a in alns for x in [a] + a.secondary]
        if what == "message":
            out[key] = [gm.alignment_message(g, a) for a in emitted]
        elif what == "json":
            out[key] = [gm.alignment_json(g, a) for a in alns]
        else:
            p = str(tmp_path / f"{key}.gam")
            w = gm.GamWriter(p, group_size=2)
            for a in emitted:
                w.write(gm.alignment_message(g, a))
            w.close()
            with gzip.open(p, "rb") as fh:
                raw = fh.read()
            if what == "writer":
                out[key] = (raw, gm.read_gam(p))
            elif what == "reader":
                out[key] = [vars(a) | {"mappings": [vars(m) for m in
                                                    a.mappings]}
                            for a in gr.load_gam_alignments(p)]
            else:
                seeds = gr.load_gam_seeds(
                    p, {n: i for i, n in enumerate(g.names)})
                out[key] = {k: [vars(s) for s in v]
                            for k, v in seeds.items()}
    same(out["j"], out["t"], what)
    assert out["t"]

"""Optimal mode of the port against the JAX package.

The same numpy inputs go through graphchainer_tpu and graphchainer_torch
(plain torch versions on the CPU) and every output must be exactly equal:
the F-major fragment DP with full_start at both pointer widths, the
optimal model's score, positions and ops, and the CLI's GAF / GAM / JSON
/ corrected-read bytes.  The JAX side runs on two compiled
shapes: the graph and read of tests/test_optimal.py's first random DAG
(int8 pointers) and one DAG of 65..128 split nodes a component (int16);
everything else is held to the port's copy of the exact DAG oracle,
which compiles nothing.  Seedless DP is tests/test_torch_seedless.py."""
import gzip

import numpy as np
import pytest
import torch

from graphchainer_tpu import cli as JCLI
from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.index.minimizer import build_index
from graphchainer_tpu.io.gfa import load_gfa, save_gfa
from graphchainer_tpu.models import optimal as JOPT
from graphchainer_tpu.ops import frag_align as JF
from graphchainer_tpu.utils.seq import match_masks
from graphchainer_torch import cli as TCLI
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.align import oracle as TOR
from graphchainer_torch.models import optimal as TOPT
from graphchainer_torch.ops import frag_align as TF

from conftest import TOY_READ
from test_mpc import random_dag_bigraph
from test_e2e import simulate
from test_optimal import long_chain_bigraph
from test_torch_common import port_graph, port_index


def _dag_world(seed):
    """tests/test_optimal.py::test_optimal_matches_exact_dp's graph, index
    and read for `seed`."""
    rng = np.random.default_rng(300 + seed)
    bg = random_dag_bigraph(rng, n_seg=8, p_edge=0.3, max_len=10)
    g = build_alignment_graph(bg)
    idx = build_index(g, k=5, w=3)
    read = "".join(rng.choice(list("ACGT"), int(rng.integers(15, 50))))
    return g, idx, read


def _toy_world(path):
    g = build_alignment_graph(load_gfa(path))
    return g, build_index(g, k=11, w=5), TOY_READ


def _wide_world():
    """A DAG whose two components (strands) have 65..128 split nodes
    (int16 pointers) and bands of one compiled shape, and a 60 bp read
    (two slices)."""
    rng = np.random.default_rng(49)
    bg = random_dag_bigraph(rng, n_seg=60, p_edge=0.06, max_len=40)
    g = build_alignment_graph(bg)
    assert 64 < int(np.sum(g.comp == 0)) <= 128
    idx = build_index(g, k=5, w=3)
    return g, idx, "".join(rng.choice(list("ACGT"), 60))


def _world(name):
    return _dag_world(0) if name == "dag" else _wide_world()


def _optimal_inputs(name):
    """The align_fragments call of optimal mode on component 0 of a world,
    exactly as the JAX model makes it (the same compiled shape)."""
    g, idx, read = _world(name)
    m = JOPT.OptimalAlignerModel(g, idx)
    bn, bi, bl, _ = m._component_band(0)
    rows = len(read)
    S = JOPT._pow2(-(-rows // 32), 2)
    mm = np.zeros(S * 32, dtype=np.uint8)
    mm[:rows] = match_masks(read)
    # the model's own device tables: numpy tables would compile anew
    eq, ln = m.gx.device_tables()
    return dict(node_eq=eq, node_len=ln, band_nodes=bn, band_in=bi,
                seed_shift=np.zeros(1, dtype=np.int32),
                req=TA.pack_row_planes(mm[None, :]).reshape(1, S, 4),
                frag_len=np.array([rows], dtype=np.int32), n_slices=S,
                max_in=bi.shape[2], full_start=True, band_level=bl,
                n_levels=TA.level_bucket(bl, bn.shape[1]))


_FIELDS = ("best_score", "best_slot", "best_col", "best_in", "end_score",
           "end_col", "out_ssb", "out_hp", "out_hn")


@pytest.mark.parametrize("world,B", [("dag", 64), ("wide", 128)],
                         ids=["B64_int8", "B128_int16"])
def test_align_fragments_full_start_matches_jax(world, B):
    kw = _optimal_inputs(world)
    assert kw["band_nodes"].shape[1] == B
    # the model's call, arguments placed as it places them (a keyword
    # where it passes a position would compile anew)
    pos = [kw.pop(k) for k in ("node_eq", "node_len", "band_nodes",
                               "band_in", "seed_shift", "req", "frag_len")]
    want = JF.align_fragments(*pos, **kw)

    def t(v):
        return torch.as_tensor(np.asarray(v).astype(np.int64))
    got = TF.align_fragments(*(t(v) for v in pos), **{
        k: (v if isinstance(v, (int, bool)) else t(v))
        for k, v in kw.items()})
    assert got.best_in.dtype == (torch.int8 if B <= 127 else torch.int16)
    for k in _FIELDS:
        a = np.asarray(getattr(want, k))
        b = getattr(got, k).numpy()
        if k in ("out_hp", "out_hn"):
            b = b.view(np.uint32)
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def _same_alignment(a, b):
    assert a.name == b.name and a.score == b.score
    np.testing.assert_array_equal(np.asarray(a.positions),
                                  np.asarray(b.positions))
    if a.ops is None:
        assert b.ops is None
    else:
        np.testing.assert_array_equal(np.asarray(a.ops), np.asarray(b.ops))


@pytest.mark.parametrize("world", ["dag", "wide"])
def test_optimal_model_matches_jax(world):
    g, idx, read = _world(world)
    ja = JOPT.OptimalAlignerModel(
        g, idx, JOPT.OptimalConfig(polish_band_words=4)).align_batch(
            [("r", read)])
    ta = TOPT.OptimalAlignerModel(
        port_graph(g), port_index(idx),
        TOPT.OptimalConfig(polish_band_words=4), device="cpu").align_batch(
            [("r", read)])
    _same_alignment(ja[0], ta[0])


def _exact_best_score(g, read):
    best = None
    for c in range(g.ncomp):
        nodes = np.nonzero(g.comp == c)[0]
        cg = TOR.build_char_graph(g, nodes)
        D = TOR.dag_dp(cg, read, np.zeros(cg.n, dtype=np.int64))
        sc = int(D[:, len(read)].min())
        best = sc if best is None else min(best, sc)
    return best


def _ops_cost(g, aln, read):
    """The edit cost of the ops along the positions' path, checking that
    they spell out the whole read against the kept path."""
    pathseq = "".join(g.node_seq(int(v))[int(o)] for v, o in aln.positions)
    ri = pi = cost = 0
    for op in aln.ops:
        if op in (0, 3):
            cost += 0 if read[ri] == pathseq[pi] else 1
            ri += 1
            pi += 1
        elif op == 1:
            pi += 1
            cost += 1
        else:
            ri += 1
            cost += 1
    assert ri == len(read) and pi == len(pathseq)
    return cost


@pytest.mark.parametrize("world", ["toy", 1, 2, 3, 4, 5])
def test_optimal_matches_oracle(toy_gfa, world):
    """Optimal mode's kernel score equals the exact free-start DAG DP of
    the port's oracle copy, and its traceback spells out that score."""
    g, idx, read = (_toy_world(toy_gfa) if world == "toy"
                    else _dag_world(world))
    g, idx = port_graph(g), port_index(idx)
    aln = TOPT.OptimalAlignerModel(
        g, idx, TOPT.OptimalConfig(polish_band_words=4),
        device="cpu").align_batch([("r", read)])[0]
    assert aln.score == _exact_best_score(g, read)
    assert _ops_cost(g, aln, read) == aln.score


def test_optimal_component_above_cap():
    """A component wider than max_component takes the exact host
    checkpointed DP and still matches the full-table oracle score."""
    rng = np.random.default_rng(11)
    g = build_alignment_graph(long_chain_bigraph(rng, 120, seg_len=8))
    idx = build_index(g, k=11, w=5)
    read, _ = simulate(rng, g, err=0.1, min_len=200)
    g, idx = port_graph(g), port_index(idx)
    aln = TOPT.OptimalAlignerModel(
        g, idx, TOPT.OptimalConfig(max_component=64, polish_band_words=4),
        device="cpu").align_batch([("r", read)])[0]
    assert aln.score == _exact_best_score(g, read)
    assert _ops_cost(g, aln, read) == aln.score


# ---- the CLI ------------------------------------------------------------

def _outputs(tmp, tag):
    return {k: str(tmp / f"{tag}.{k}") for k in ("gaf", "gam", "json")}


def _run_both(tmp_path, graph, reads, flags):
    """The JAX CLI (in this process) and the port's CLI on the CPU with
    every alignment and corrected-read output; returns the bytes of each
    output of both (GAM decompressed: gzip stamps the time)."""
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    got = {}
    for tag, main, extra in (("jax", JCLI.main, []),
                             ("torch", TCLI.main, ["--device", "cpu"])):
        outs = _outputs(tmp_path, tag)
        corr = str(tmp_path / f"{tag}.corr.fa")
        clip = str(tmp_path / f"{tag}.clip.fa")
        argv = (["-g", graph, "-f", str(fa), "--corrected-out", corr,
                 "--corrected-clipped-out", clip]
                + [x for p in outs.values() for x in ("-a", p)]
                + flags + extra)
        assert main(argv) == 0
        data = {}
        for k, p in list(outs.items()) + [("corr", corr), ("clip", clip)]:
            opener = gzip.open if k == "gam" else open
            with opener(p, "rb") as fh:
                data[k] = fh.read()
        got[tag] = data
    return got


def test_cli_optimal_outputs_match_jax(tmp_path):
    """--optimal-alignment on the graph and read of the model test."""
    _, _, read = _dag_world(0)
    rng = np.random.default_rng(300)
    gfa = str(tmp_path / "g.gfa")
    save_gfa(random_dag_bigraph(rng, n_seg=8, p_edge=0.3, max_len=10), gfa)
    got = _run_both(tmp_path, gfa, [("read", read)],
                    ["--optimal-alignment", "--polish-band", "4",
                     "--seeds-minimizer-length", "5",
                     "--seeds-minimizer-windowsize", "3"])
    assert got["jax"]["gaf"].count(b"\n") == 1
    for k in got["jax"]:
        assert got["jax"][k] == got["torch"][k], k

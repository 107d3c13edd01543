"""Optimal mode of the port against the JAX package.

The same numpy inputs go through graphchainer_tpu and graphchainer_torch
(plain torch versions on the CPU) and every output must be exactly equal:
the F-major fragment DP with full_start at both pointer widths, the
optimal model's score, positions and ops (on tests/test_optimal.py's
first random DAG, a DAG of 65..128 split nodes a component and the toy
graph), and the CLI's GAF / GAM / JSON / corrected-read bytes.  The JAX
side of each comparison is the JAX package's output recorded in
tests/torch_fixtures/ (make_fixtures.py there): each of its shapes costs
45-80 s of XLA compile on the CPU, and tests/test_torch_fixtures.py
(marked slow) holds the records to a live run.  Everything else is held
to the port's copy of the exact DAG oracle.  Seedless DP is
tests/test_torch_seedless.py."""
import gzip
import os

import numpy as np
import pytest
import torch

from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.index.minimizer import build_index
from graphchainer_tpu.io.gfa import load_gfa, save_gfa
from graphchainer_torch import cli as TCLI
from graphchainer_torch.align import oracle as TOR
from graphchainer_torch.models import optimal as TOPT
from graphchainer_torch.ops import frag_align as TF

from conftest import TOY_READ
from test_mpc import random_dag_bigraph
from test_e2e import simulate
from test_optimal import long_chain_bigraph
from test_torch_common import (TOY_GFA_TEXT, aln_record, array_record,
                               load_fixture, output_record, port_graph,
                               port_index)


def _dag_world(seed):
    """tests/test_optimal.py::test_optimal_matches_exact_dp's graph, index
    and read for `seed`."""
    rng = np.random.default_rng(300 + seed)
    bg = random_dag_bigraph(rng, n_seg=8, p_edge=0.3, max_len=10)
    g = build_alignment_graph(bg)
    idx = build_index(g, k=5, w=3)
    read = "".join(rng.choice(list("ACGT"), int(rng.integers(15, 50))))
    return g, idx, read


def _toy_world():
    """The toy graph (tests/conftest.py's toy_gfa), its index and read."""
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "toy.gfa")
        with open(path, "w") as fh:
            fh.write(TOY_GFA_TEXT)
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
    return {"dag": lambda: _dag_world(0), "wide": _wide_world,
            "toy": _toy_world}[name]()


FULL_START_CASES = {"B64_int8": "dag", "B128_int16": "wide"}


FULL_START_FIELDS = ("best_score", "best_slot", "best_col", "best_in",
                     "end_score", "end_col", "out_ssb", "out_hp", "out_hn")


@pytest.mark.parametrize("case", list(FULL_START_CASES))
def test_align_fragments_full_start_matches_jax(case):
    """align_fragments with full_start on the port model's band of
    component 0 (as the model calls it) against the JAX function on the
    JAX model's (recorded), every field with its dtype."""
    g, idx, read = _world(FULL_START_CASES[case])
    args, kw = TOPT.OptimalAlignerModel(
        port_graph(g), port_index(idx), device="cpu").component_inputs(
            read, 0)
    want = load_fixture("full_start")[case]
    assert args[2].shape[1] == want["B"]
    got = TF.align_fragments(*args, **kw)
    assert got.best_in.dtype == (torch.int8 if want["B"] <= 127
                                 else torch.int16)
    for k in FULL_START_FIELDS:
        b = getattr(got, k).numpy()
        if k in ("out_hp", "out_hn"):
            b = b.view(np.uint32)
        assert array_record(b) == want["fields"][k], k


@pytest.mark.parametrize("world", ["dag", "wide", "toy"])
def test_optimal_model_matches_jax(world):
    """The optimal model's alignment against the JAX model's (recorded),
    on both DAGs and the toy graph."""
    g, idx, read = _world(world)
    ta = TOPT.OptimalAlignerModel(
        port_graph(g), port_index(idx),
        TOPT.OptimalConfig(polish_band_words=4), device="cpu").align_batch(
            [("r", read)])
    assert not ta[0].failed
    assert aln_record(ta[0]) == load_fixture("optimal_model")[world]


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
def test_optimal_matches_oracle(world):
    """Optimal mode's kernel score equals the exact free-start DAG DP of
    the port's oracle copy, and its traceback spells out that score."""
    g, idx, read = _toy_world() if world == "toy" else _dag_world(world)
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

def run_cli(main, tmp_path, tag, graph, reads, flags):
    """One CLI (main: the JAX package's or the port's) with every
    alignment and corrected-read output; returns the bytes of each output
    (GAM decompressed: gzip stamps the time)."""
    fa = tmp_path / f"{tag}.reads.fa"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in reads))
    outs = {k: str(tmp_path / f"{tag}.{k}") for k in ("gaf", "gam", "json")}
    corr = str(tmp_path / f"{tag}.corr.fa")
    clip = str(tmp_path / f"{tag}.clip.fa")
    argv = (["-g", graph, "-f", str(fa), "--corrected-out", corr,
             "--corrected-clipped-out", clip]
            + [x for p in outs.values() for x in ("-a", p)] + flags)
    assert main(argv) == 0
    data = {}
    for k, p in list(outs.items()) + [("corr", corr), ("clip", clip)]:
        opener = gzip.open if k == "gam" else open
        with opener(p, "rb") as fh:
            data[k] = fh.read()
    return data


def optimal_cli_case(tmp_path):
    """--optimal-alignment on the graph and read of the model test:
    (GFA path, reads, flags)."""
    _, _, read = _dag_world(0)
    gfa = str(tmp_path / "g.gfa")
    save_gfa(random_dag_bigraph(np.random.default_rng(300), n_seg=8,
                                p_edge=0.3, max_len=10), gfa)
    return gfa, [("read", read)], [
        "--optimal-alignment", "--polish-band", "4",
        "--seeds-minimizer-length", "5", "--seeds-minimizer-windowsize", "3"]


def test_cli_optimal_outputs_match_jax(tmp_path):
    """--optimal-alignment: the port's CLI bytes against the JAX CLI's
    (recorded)."""
    gfa, reads, flags = optimal_cli_case(tmp_path)
    got = output_record(run_cli(TCLI.main, tmp_path, "torch", gfa, reads,
                                flags + ["--device", "cpu"]))
    want = load_fixture("optimal_cli")
    assert want["gaf"].count("\n") == 1
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k

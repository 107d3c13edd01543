"""The frozen generators against their sources, and the read generator's
rates and determinism."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from gcbench import graphs, traffic

GCBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def as_lists(bg):
    names = list(bg.names)
    links = [(names[a], ar, names[b], br) for a, ar, b, br, _ in bg.links]
    return names, list(bg.seqs), links


def ours(g):
    return (g.names, g.seqs,
            [(g.names[a], False, g.names[b], False) for a, b in g.links])


@pytest.mark.parametrize("bp", [500, 5000, 40000])
def test_bench_chain_equals_build_bench_graph(bp):
    from graphchainer_torch.workload import build_bench_graph
    src = build_bench_graph(np.random.default_rng(7), bp)
    assert ours(graphs.bench_chain(np.random.default_rng(7), bp)) \
        == as_lists(src)


@pytest.mark.parametrize("kw", [{}, {"n_knots": 40, "arms": 5},
                                {"n_knots": 7, "arms": 6, "nested": False,
                                 "spacer": 25, "arm_len": 3}])
def test_knots_equals_tangle_bigraph(kw):
    from graphchainer_torch.graph.simulate import tangle_bigraph
    src = tangle_bigraph(np.random.default_rng(11), **kw)
    assert ours(graphs.knots(np.random.default_rng(11), **kw)) \
        == as_lists(src)


def test_truth_walk_follows_links():
    g = graphs.bench_chain(np.random.default_rng(7), 3000)
    walk = graphs.truth_walk(g, 3)
    text = b"ACGT"
    seq = bytes(text[c] for c in walk).decode()
    # the walk spells spacers in order, each followed by an allele or not
    assert seq.startswith(g.seqs[0]) and seq.endswith(g.seqs[-1])
    assert len(seq) >= sum(len(s) for n, s in zip(g.names, g.seqs)
                           if n.startswith("s"))


def mix(name):
    with open(os.path.join(GCBENCH, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["clr3k", "badread15k"])
def test_chunks_repeat_from_the_seed(name):
    truth = np.random.default_rng(0).integers(0, 4, 200_000).astype(
        np.uint8)
    m = mix(name)
    a, ta = traffic.make_chunk(m, 2 ** 31 + 5, 3, truth)
    b, tb = traffic.make_chunk(m, 2 ** 31 + 5, 3, truth)
    c, _ = traffic.make_chunk(m, 2 ** 31 + 6, 3, truth)
    assert len(a) == m["batch_size"]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(ta, tb)
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(a, c))
    lens = ta[:, 1]
    assert lens.min() >= m["length"]["min"]
    assert lens.max() <= m["length"]["max"]


def edits(read: bytes, src: bytes) -> int:
    from gcbench.reference.check import myers_infix
    return myers_infix(read, src)


def test_uniform_model_rate():
    truth = np.random.default_rng(1).integers(0, 4, 100_000).astype(
        np.uint8)
    m = dict(mix("clr3k"), reverse_share=0.0,
             length={"mean": 2000, "sd": 1, "min": 1990, "max": 2010})
    reads, tr = traffic.make_chunk(m, 9, 1, truth)
    letters = traffic._LETTERS
    rates = [edits(letters[r].tobytes(),
                   letters[truth[s:s + L]].tobytes()) / L
             for r, (s, L, _) in zip(reads[:16], tr[:16])]
    # 10% drawn, a quarter of the substitutions draw the same base
    assert 0.07 < float(np.mean(rates)) < 0.10


def test_badread_model_identity_and_bursts():
    truth = np.random.default_rng(2).integers(0, 4, 100_000).astype(
        np.uint8)
    m = dict(mix("badread15k"), reverse_share=1.0,
             length={"mean": 3000, "sd": 1, "min": 2990, "max": 3010})
    reads, tr = traffic.make_chunk(m, 4, 1, truth)
    letters = traffic._LETTERS
    from gcbench.reference.check import revcomp
    rates = [edits(revcomp(letters[r].tobytes()),
                   letters[truth[s:s + L]].tobytes()) / L
             for r, (s, L, _) in zip(reads[:16], tr[:16])]
    assert 0.07 < float(np.mean(rates)) < 0.16
    mask = traffic._burst_mask(np.random.default_rng(5), 1_000_000, 0.003,
                               0.25)
    # stationary share of the chain: enter / (enter + exit)
    assert abs(mask.mean() - 0.003 / 0.253) < 0.004


def test_warmup_chunk_ends_with_junk():
    truth = np.random.default_rng(3).integers(0, 4, 50_000).astype(np.uint8)
    m = mix("clr3k")
    reads, tr = traffic.make_chunk(m, 1, 0, truth)
    letters = traffic._LETTERS
    for r, (s, L, rev) in list(zip(reads, tr))[-m["warmup_junk"]:]:
        src = letters[truth[s:s + L]].tobytes()
        assert edits(letters[r].tobytes(), src) > 0.4 * L

"""Seedless DP (--seedless-DP, --DP-restart-stride) of the port against
the JAX package.

tests/test_seedless.py's graph and poisoned reads (every 8th base
substituted: no minimizer survives) go through graphchainer_torch (plain
torch versions on the CPU): the full-start scan's synthetic seeds, the
seedless GA alignments and the CLI's GAF / GAM / JSON / corrected-read
bytes must be exactly equal to graphchainer_tpu's on the same inputs,
with and without a restart stride.  The JAX side is recorded in
tests/torch_fixtures/ (make_fixtures.py there): its scan and GA window
shapes cost 80-150 s of XLA compile each on the CPU, and
tests/test_torch_fixtures.py (marked slow) holds the records to a live
run."""
import dataclasses

import numpy as np
import pytest

from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.index.minimizer import build_index, get_seeds
from graphchainer_tpu.io.gfa import save_gfa
from graphchainer_tpu.models import aligner as JM
from graphchainer_torch import cli as TCLI
from graphchainer_torch import convert
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.align import seedless as TSL
from graphchainer_torch.models import aligner as TM

from test_e2e import bubble_graph, simulate
from test_seedless import poisoned
from test_torch_common import (aln_record, load_fixture, output_record,
                               port_graph, port_index)
from test_torch_optimal import run_cli

STRIDES = {"no_stride": 0, "stride150": 150}


_SEEDLESS_CFG = dict(band_slots=24, polish_band_words=4, seedless_dp=True)


def _seedless_world(stride):
    """tests/test_seedless.py's graph, index and poisoned read (of
    test_seedless_aligns_zero_seed_read) and its configuration, with a
    restart stride or without: one read, so both runs share the GA
    windows' compiled shapes."""
    rng = np.random.default_rng(77)
    g = build_alignment_graph(bubble_graph(rng))
    idx = build_index(g, k=13, w=10)
    read, _ = simulate(rng, g, err=0.0, min_len=400)
    read = poisoned(read, rng)
    assert get_seeds(idx, read, -1) == []
    return g, idx, read, dict(_SEEDLESS_CFG, dp_restart_stride=stride)


def scan_offsets(read, stride):
    """The scan's restart offsets and top-k, as GraphAlignerModel picks
    them."""
    offsets = ((0,) if stride <= 0
               else tuple(range(0, max(len(read) - 32, 1), stride)))
    return offsets, 3 if len(offsets) == 1 else 1


@pytest.mark.parametrize("case", list(STRIDES))
def test_seedless_scan_matches_jax(case):
    stride = STRIDES[case]
    g, _, read, _ = _seedless_world(stride)
    offsets, topk = scan_offsets(read, stride)
    assert len(offsets) == (1 if stride <= 0 else 3)
    tg = port_graph(g)
    got = TSL.FullstartScanner(tg, TA.GraphTensors.build(tg),
                               device="cpu").scan(read, offsets=offsets,
                                                  topk=topk)
    want = load_fixture("seedless_scan")[case]
    assert want["read"] == read and len(want["seeds"]) >= len(offsets)
    assert [dataclasses.asdict(s) for s in got] == want["seeds"]


@pytest.mark.parametrize("case", list(STRIDES))
def test_seedless_model_matches_jax(case):
    stride = STRIDES[case]
    g, idx, read, cfg = _seedless_world(stride)
    tcfg = convert.from_reference_aligner_config(
        dataclasses.asdict(JM.AlignerConfig(**cfg)))
    assert tcfg.seedless_dp and tcfg.dp_restart_stride == stride
    ta = TM.GraphAlignerModel(port_graph(g), port_index(idx), tcfg,
                              device="cpu").align_batch([("r", read)])[0]
    assert not ta.failed
    want = load_fixture("seedless_model")[case]
    assert want["read"] == read
    assert aln_record(ta) == want["alignment"]


def seedless_cli_case(tmp_path, stride):
    """--seedless-DP (and --DP-restart-stride) on the model tests' graph,
    read and configuration: (GFA path, reads, flags)."""
    _, _, read, _ = _seedless_world(stride)
    gfa = str(tmp_path / "g.gfa")
    save_gfa(bubble_graph(np.random.default_rng(77)), gfa)
    return gfa, [("r", read)], [
        "--seedless-DP", "--DP-restart-stride", str(stride), "-b", "24",
        "--polish-band", "4", "--seeds-minimizer-length", "13",
        "--seeds-minimizer-windowsize", "10"]


@pytest.mark.parametrize("stride", [0, 150], ids=["no_stride", "stride150"])
def test_cli_seedless_outputs_match_jax(tmp_path, stride):
    gfa, reads, flags = seedless_cli_case(tmp_path, stride)
    got = output_record(run_cli(TCLI.main, tmp_path, "torch", gfa, reads,
                                flags + ["--device", "cpu"]))
    want = load_fixture("seedless_cli")[
        "no_stride" if stride == 0 else "stride150"]
    assert want["gaf"].count("\n") >= 1
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k

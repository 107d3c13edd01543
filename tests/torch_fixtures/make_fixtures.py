"""Record the JAX package's outputs that the port's tests compare with.

  JAX_PLATFORMS=cpu python tests/torch_fixtures/make_fixtures.py [NAME ...]

Each fixture runs graphchainer_tpu on the inputs that a test of
graphchainer_torch builds (the same numpy seeds, graphs, reads and flags,
taken from the test modules) and writes the outputs to
tests/torch_fixtures/NAME.json, keyed by the test's case.  The tests
compare the port's outputs with these records instead of running the JAX
function, whose every new shape costs 45-150 s of XLA compile on the CPU.
tests/test_torch_fixtures.py (marked slow) runs every fixture again and
holds it equal to the committed file.  Rerun this script only when the
JAX package or a test's inputs change.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(HERE)
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def _tmp():
    return tempfile.TemporaryDirectory()


def seedless_scan():
    from graphchainer_tpu.align import seedless as JSL
    from graphchainer_tpu.models import aligner as JM
    from test_torch_seedless import STRIDES, _seedless_world, scan_offsets
    out = {}
    for case, stride in STRIDES.items():
        g, idx, read, cfg = _seedless_world(stride)
        offsets, topk = scan_offsets(read, stride)
        jm = JM.GraphAlignerModel(g, idx, JM.AlignerConfig(**cfg))
        seeds = JSL.FullstartScanner(g, jm.gx).scan(read, offsets=offsets,
                                                    topk=topk)
        out[case] = dict(read=read,
                         seeds=[dataclasses.asdict(s) for s in seeds])
    return out


def seedless_model():
    from graphchainer_tpu.models import aligner as JM
    from test_torch_common import aln_record
    from test_torch_seedless import STRIDES, _seedless_world
    out = {}
    for case, stride in STRIDES.items():
        g, idx, read, cfg = _seedless_world(stride)
        a = JM.GraphAlignerModel(g, idx, JM.AlignerConfig(**cfg)
                                 ).align_batch([("r", read)])[0]
        out[case] = dict(read=read, alignment=aln_record(a))
    return out


def _cli(case_fn, *args):
    from graphchainer_tpu import cli as JCLI
    from test_torch_common import output_record
    from test_torch_optimal import run_cli
    with _tmp() as td:
        gfa, reads, flags = case_fn(Path(td), *args)
        return output_record(run_cli(JCLI.main, Path(td), "jax", gfa, reads,
                                     flags))


def seedless_cli():
    from test_torch_seedless import STRIDES, seedless_cli_case
    return {case: _cli(seedless_cli_case, stride)
            for case, stride in STRIDES.items()}


def full_start():
    """align_fragments(full_start=True) on component 0 as the JAX model
    calls it (its band arrays, its device tables, its argument order)."""
    from graphchainer_tpu.align.anchors import level_bucket, pack_row_planes
    from graphchainer_tpu.models import optimal as JOPT
    from graphchainer_tpu.ops import frag_align as JF
    from graphchainer_tpu.utils.seq import match_masks
    from test_torch_common import array_record
    from test_torch_optimal import (FULL_START_CASES, FULL_START_FIELDS,
                                    _world)
    out = {}
    for case, world in FULL_START_CASES.items():
        g, idx, read = _world(world)
        m = JOPT.OptimalAlignerModel(g, idx)
        bn, bi, bl, _ = m._component_band(0)
        rows = len(read)
        S = JOPT._pow2(-(-rows // 32), 2)
        mm = np.zeros(S * 32, dtype=np.uint8)
        mm[:rows] = match_masks(read)
        eq, ln = m.gx.device_tables()
        res = JF.align_fragments(
            eq, ln, bn, bi, np.zeros(1, dtype=np.int32),
            pack_row_planes(mm[None, :]).reshape(1, S, 4),
            np.array([rows], dtype=np.int32), n_slices=S,
            max_in=bi.shape[2], full_start=True, band_level=bl,
            n_levels=level_bucket(bl, bn.shape[1]))
        out[case] = dict(B=int(bn.shape[1]), fields={
            k: array_record(np.asarray(getattr(res, k)))
            for k in FULL_START_FIELDS})
    return out


def frag_tl():
    """align_fragments_tl on tests/test_torch_common.padded_batch(B) for
    B = 16 and 32, and run_fragments on padded_batch(16), which fits the
    2-bit read-code format (tests/test_torch_frag.py)."""
    import jax.numpy as jnp
    from graphchainer_tpu.align import anchors as JA
    from graphchainer_tpu.ops import frag_align as JF
    from test_torch_common import array_record, padded_batch, slice_case
    from test_torch_frag import NAMES
    out = {}
    for B in (16, 32):
        model, bnc, bi, ss, req, rows, S, bl = padded_batch(B)
        gx = model.gx
        r = JF.align_fragments_tl(
            jnp.asarray(gx.node_eq_cat), jnp.asarray(gx.node_len_cat),
            jnp.asarray(bnc), jnp.asarray(bi), jnp.asarray(ss),
            jnp.asarray(req), jnp.asarray(rows), n_slices=S, max_in=4,
            band_level=jnp.asarray(bl),
            n_levels=JA.level_bucket(bl, bnc.shape[1]))
        out[str(B)] = {name: array_record(np.asarray(getattr(r, name)))
                       for name in NAMES}
    model, bnc, bi, ss, req, rows, S, bl = padded_batch(16)
    jgx = JA.GraphTensors.build(slice_case()[0])
    r = JA.run_fragments(jgx, bnc, bi, ss, req, rows, S, 4, band_level=bl)
    out["code0"] = {name: array_record(np.asarray(getattr(r, name)))
                    for name in NAMES}
    return out


def ga_rescue():
    """ChainerModel.align_batch at the default config on the dense DAG of
    tests/test_torch_ga.py with its unplaceable fourth read."""
    from graphchainer_tpu.graph.mpc import build_mpc
    from graphchainer_tpu.models import chainer as JC
    from test_torch_ga import ga_record, rescue_case
    g, index, reads = rescue_case()
    return [ga_record(a) for a in
            JC.ChainerModel(g, build_mpc(g), index).align_batch(reads)]


def optimal_model():
    from graphchainer_tpu.models import optimal as JOPT
    from test_torch_common import aln_record
    from test_torch_optimal import _world
    out = {}
    for world in ("dag", "wide", "toy"):
        g, idx, read = _world(world)
        a = JOPT.OptimalAlignerModel(
            g, idx, JOPT.OptimalConfig(polish_band_words=4)).align_batch(
                [("r", read)])[0]
        out[world] = aln_record(a)
    return out


def optimal_cli():
    from test_torch_optimal import optimal_cli_case
    return _cli(optimal_cli_case)


def polish_any_band():
    from graphchainer_tpu.align import polish as JP
    from test_torch_polish import ANY_BANDS, any_band_case, outcome_record
    reads, paths = any_band_case()
    return {str(bw): [outcome_record(o)
                      for o in JP.polish_batch(reads, paths, bw=bw)]
            for bw in ANY_BANDS}


def polish_cli():
    from test_torch_slice import POLISH_BANDS, polish_cli_case
    return {str(bw): _cli(polish_cli_case, bw) for bw in POLISH_BANDS}


def seeds_model():
    """ChainerModel.align_batch on the toy graph with MEM seeds (seed_fn)
    and with file seeds (tests/test_cli_tools.py::test_file_seeds)."""
    from graphchainer_tpu.models import chainer as JC
    from test_torch_common import aln_record
    from test_torch_seeds import SEED_CASES, toy_seed_world
    out = {}
    for case in SEED_CASES:
        with _tmp() as td:
            w = toy_seed_world(Path(td), case, "jax")
            a = JC.ChainerModel(w["g"], w["mpc"], w["index"], w["cfg"],
                                file_seeds=w["file_seeds"],
                                seed_fn=w["seed_fn"]).align_batch(
                                    w["reads"])
        out[case] = dict(gam=w["gam"], alignments=[aln_record(x)
                                                   for x in a])
    return out


def seeds_cli():
    from test_torch_seeds import SEED_CLI_CASES, seeds_cli_case
    return {case: _cli(seeds_cli_case, case) for case in SEED_CLI_CASES}


def slice_model():
    """ChainerModel.align_batch at the default config on slice_reads()
    (tests/test_torch_slice.py), with each alignment's GAF line with and
    without merged mismatches, and on its three 10%-error reads alone
    (tests/test_torch_multidevice.py)."""
    from graphchainer_tpu.io import gaf as JG
    from graphchainer_tpu.models import chainer as JC
    from test_torch_common import aln_record, slice_case
    from test_torch_slice import slice_reads
    g, mpc, index, _, _ = slice_case()
    a = JC.ChainerModel(g, mpc, index, JC.ChainerConfig()).align_batch(
        slice_reads())
    three = JC.ChainerModel(g, mpc, index, JC.ChainerConfig()).align_batch(
        slice_reads()[1:])
    return dict(
        slice=dict(alignments=[aln_record(x) for x in a],
                   gaf={str(m): [JG.gaf_line(g, x, cigar_merge_mm=m)
                                 for x in a] for m in (False, True)}),
        three_reads=[aln_record(x) for x in three])


def fusion_finder():
    """python -m graphchainer_tpu.tools fusion-finder on
    tests/test_torch_tools.fusion_case's inputs: its output files."""
    from graphchainer_tpu import tools as JT
    from test_torch_tools import fusion_case, fusion_record
    with _tmp() as td:
        argv, outs = fusion_case(Path(td))
        assert JT.main(argv) == 0
        return fusion_record(outs)


def scale_mix_small():
    """python -m graphchainer_tpu.cli on the sustained mix at
    tests/test_torch_scale.py's small size: its GAF lines and counts."""
    from test_torch_scale import SMALL_BP, SMALL_COUNTS, jax_cli_record
    return jax_cli_record(SMALL_BP, SMALL_COUNTS)


def scale_mix():
    """The same on the 20 Mbp backbone with 16 reads of each class
    (chip_smoke.py's mixed phase; ~3 min and ~5 GB on the CPU)."""
    from test_torch_scale import SCALE_BP, SCALE_COUNTS, jax_cli_record
    return jax_cli_record(SCALE_BP, SCALE_COUNTS)


FIXTURES = {f.__name__: f for f in (
    seedless_scan, seedless_model, seedless_cli, full_start, frag_tl,
    ga_rescue, optimal_model, optimal_cli, polish_any_band, polish_cli,
    seeds_model, seeds_cli, slice_model, fusion_finder, scale_mix_small,
    scale_mix)}


def record(name: str) -> dict:
    """The JSON value of one fixture, from a live run of the JAX package
    (round-tripped through JSON, as the tests read it)."""
    return json.loads(json.dumps(FIXTURES[name]()))


def main(argv) -> int:
    from graphchainer_tpu.utils.jaxconfig import setup
    setup()
    for name in argv or list(FIXTURES):
        path = os.path.join(HERE, name + ".json")
        value = record(name)
        with open(path, "w") as fh:
            json.dump(value, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))

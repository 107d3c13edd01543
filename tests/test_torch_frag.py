"""The fragment stage of graphchainer_torch vs graphchainer_tpu: the plain
core _frag_core_t, the align_fragments_tl front end, the host bands and
tables, and run_fragments — exact equality on the same numpy
inputs (the JAX side runs its XLA core, which tests/test_pallas_frag.py
pins to the Pallas kernel).  The JAX side of align_fragments_tl and
run_fragments is recorded in tests/torch_fixtures/frag_tl.json
(make_fixtures.py there): its three shapes cost ~80 s of XLA compile on
the CPU, and tests/test_torch_fixtures.py holds the record to a live run."""
import functools

import numpy as np
import pytest
import torch

from graphchainer_tpu.align import anchors as JA
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.ops import frag_align as TF

from test_torch_common import (frag_batch, host_args, lane_major_inputs,
                               load_fixture, padded_batch, port_graph,
                               record_array, slice_case, t64)

NAMES = ("best_score", "best_slot", "best_col", "best_in")


@functools.lru_cache(maxsize=None)
def jax_tl(B):
    """graphchainer_tpu's align_fragments_tl on padded_batch(B), as numpy
    (recorded).  Off the TPU it runs the JAX _frag_core_t (its Pallas gate
    is closed), so this is also the JAX core's result, transposed."""
    rec = load_fixture("frag_tl")[str(B)]
    return {name: record_array(rec[name]) for name in NAMES}


@pytest.mark.parametrize("B", [16, 32])
def test_frag_core_t_matches_jax(B):
    args, kw = lane_major_inputs(B)
    assert args[0].shape[1] == B and args[0].shape[2] > 100
    ref = jax_tl(B)
    got = TF._frag_core_t(*(t64(a) for a in args), **kw)
    for name, g in zip(NAMES[:3], got[:3]):
        np.testing.assert_array_equal(ref[name], g[0].numpy(), err_msg=name)
    np.testing.assert_array_equal(ref["best_in"],
                                  got[3].permute(2, 1, 0).numpy())


@pytest.mark.parametrize("B", [16, 32])
def test_align_fragments_tl_matches_jax(B):
    """The band arrays in the host types the CUDA route takes (int32 ids,
    int8 in-edges and levels, uint32 words as int32 bits), on the CPU
    route."""
    (eq, ln, bn, bi, bl, ss, req, rows), kw = host_args(B)
    got = TF.align_fragments_tl(eq, ln, bn, bi, ss, req, rows, kw["S"],
                                kw["max_in"], bl, kw["n_levels"])
    assert got.best_in.dtype == torch.int8
    ref = jax_tl(B)
    for name in NAMES:
        g = getattr(got, name).numpy()
        assert ref[name].shape == g.shape, name
        np.testing.assert_array_equal(ref[name], g, err_msg=name)


def test_align_fragments_tl_unpadded_matches_jax():
    """At the batch's own width B_eff (as run_fragments launches it) the
    result equals the JAX package's at B = 16 and 32 on their first B_eff
    slots, and their pad slots hold IN_NONE."""
    (eq, ln, bn, bi, bl, ss, req, rows), kw = host_args(32, padded=False)
    b_eff = bn.shape[1]
    assert b_eff == 8
    got = TF.align_fragments_tl(eq, ln, bn, bi, ss, req, rows, kw["S"],
                                kw["max_in"], bl, kw["n_levels"])
    for B in (16, 32):
        ref = jax_tl(B)
        for name in NAMES[:3]:
            np.testing.assert_array_equal(ref[name],
                                          getattr(got, name).numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(ref["best_in"][:, :b_eff],
                                      got.best_in.numpy())
        assert (ref["best_in"][:, b_eff:] == TF.IN_NONE).all()


def test_host_tables_and_bands_match_jax():
    """GraphTensors (build and from_numpy), the native seed+window jobs
    and assemble_batch_cols equal the JAX package's."""
    from graphchainer_tpu.models.chainer import ChainerConfig, ChainerModel
    from graphchainer_tpu.utils.seq import match_masks
    g, mpc, index, _, reads = slice_case()
    (model, jobs, frags) = frag_batch(32)[:3]
    jgx = JA.GraphTensors.build(g)
    for gx in (model.gx, TA.GraphTensors.from_numpy(
            port_graph(g), jgx.node_eq_cat, jgx.node_len_cat, jgx.out_ptr, jgx.out_idx,
            jgx.in_ptr, jgx.in_idx, jgx.seq_bytes, jgx.di_base)):
        for f in ("node_eq_rev", "node_eq_cat", "node_len_cat", "out_ptr",
                  "out_idx", "in_ptr", "in_idx", "node_len64", "seq_bytes",
                  "di_base", "orig_offset64"):
            np.testing.assert_array_equal(getattr(jgx, f), getattr(gx, f),
                                          err_msg=f)
        for a, b in zip(jgx.split_lookup(), gx.split_lookup()):
            np.testing.assert_array_equal(a, b)
    jm = ChainerModel(g, mpc, index, ChainerConfig(band_slots=32), gx=jgx)
    jjobs, jfrags, jcounts = jm._fragment_jobs_cols(reads)
    np.testing.assert_array_equal(jfrags, frags)
    for f in ("seed", "trim", "rev", "read_idx", "lo", "hi"):
        np.testing.assert_array_equal(getattr(jjobs, f), getattr(jobs, f),
                                      err_msg=f)
    mm = match_masks("".join(s for _, s in reads))
    base = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum([len(s) for _, s in reads], out=base[1:])
    ref = JA.assemble_batch_cols(jgx, jjobs, mm, base, B=32, max_in=4,
                                 slack=8)
    got = frag_batch(32)[3:]
    for i, (r, t) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(r, t, err_msg=f"output {i}")


def test_run_fragments_code0_rows_match_jax():
    """run_fragments equals the JAX package's on a batch that fits its
    2-bit read-code format (B <= 16, max_in <= 4, pure ACGT): rows past a
    fragment's end then match A, and on this batch that changes best_in."""
    model, bnc, bi, ss, req, rows, S, bl = padded_batch(16)
    assert TA.code0_padding(bnc, bi, req, rows, 4)
    ref = load_fixture("frag_tl")["code0"]
    got = TA.run_fragments(model.gx, bnc, bi, ss, req, rows, S, 4, bl,
                           "cpu")
    for name in NAMES:
        np.testing.assert_array_equal(record_array(ref[name]),
                                      getattr(got, name), err_msg=name)
    assert not np.array_equal(jax_tl(16)["best_in"], got.best_in)


def test_run_fragments_plane_rows_match_jax():
    """A batch too wide for the 2-bit format (B = 32) keeps its planes:
    run_fragments equals the JAX align_fragments_tl that the JAX
    run_fragments runs on it."""
    model, bnc, bi, ss, req, rows, S, bl = padded_batch(32)
    assert not TA.code0_padding(bnc, bi, req, rows, 4)
    got = TA.run_fragments(model.gx, bnc, bi, ss, req, rows, S, 4, bl,
                           "cpu")
    ref = jax_tl(32)
    for name in NAMES:
        np.testing.assert_array_equal(ref[name], getattr(got, name),
                                      err_msg=name)


def test_pad_rows_code0():
    req = np.zeros((3, 2, 4), np.uint32)
    rows = np.array([1, 32, 40])
    out = TA.pad_rows_code0(req, rows)
    assert out[0, 0, 0] == 0xFFFFFFFE and out[0, 1, 0] == 0xFFFFFFFF
    assert out[1, 0, 0] == 0 and out[1, 1, 0] == 0xFFFFFFFF
    assert out[2, 0, 0] == 0 and out[2, 1, 0] == 0xFFFFFF00
    assert not out[..., 1:].any()

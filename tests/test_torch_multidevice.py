"""Several devices in one process (graphchainer_torch/parallel/): the
device stages split over three shards of the CPU, ("cpu",) * 3, with row
counts that 3 does not divide, against one device and the JAX package.
Mirrors tests/test_multichip.py, whose 1-device == 8-device equality is
the contract; here the shards run in-process, each a row block on its
listed device."""
import functools

import numpy as np
import pytest
import torch

from graphchainer_tpu.parallel import mesh as JMESH
from graphchainer_tpu.parallel import sharded_graph as JSG
from graphchainer_torch.align import anchors as TA
from graphchainer_torch.align import polish as TP
from graphchainer_torch.models import aligner as TM
from graphchainer_torch.models import chainer as TC
from graphchainer_torch.ops import _cuda
from graphchainer_torch.ops import chain_scan as TCS
from graphchainer_torch.parallel import collectives, mesh
from graphchainer_torch.parallel import device as D
from graphchainer_torch.parallel import sharded_graph as TSG
from graphchainer_torch.workload import component_chains_workload

from test_polish import nw_edit_distance
from test_torch_common import aln_record, load_fixture, slice_case_port
from test_torch_ga import port_world

THREE = ("cpu",) * 3
CPU = torch.device("cpu")


def test_local_devices():
    assert D.local_devices("cpu") == (CPU,)
    assert D.local_devices(THREE) == (CPU,) * 3
    assert D.local_devices([torch.device("cpu")]) == (CPU,)
    assert D.local_devices("cpu, cpu") == (CPU,) * 2
    with pytest.raises(ValueError):
        D.local_devices(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            D.local_devices("cuda")


def test_process_device(monkeypatch):
    """With --device cuda, process I of P takes cuda:(I % count) alone;
    a single process keeps the current card, and any other device
    stays."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert D.process_device("cuda", 3, 4) == "cuda:1"
    assert D.process_device("cuda", 0, 4) == "cuda:0"
    assert D.process_device("cuda", 0, 1) == "cuda"
    assert D.process_device("cpu", 1, 2) == "cpu"
    assert D.process_device("cuda:1", 0, 2) == "cuda:1"


def test_row_blocks():
    assert D.row_blocks(5, 3) == [(0, 2), (2, 4), (4, 5)]
    assert D.row_blocks(2, 3) == [(0, 1), (1, 2), (2, 2)]
    assert D.row_blocks(0, 2) == [(0, 0), (0, 0)]


def test_shard_rows_places_a_block_on_every_device(rng):
    arr = rng.integers(0, 100, size=(7, 4))
    blocks = D.shard_rows(arr, THREE)
    assert [tuple(b.shape) for b in blocks] == [(3, 4), (2, 4), (2, 4)]
    assert all(b.device == CPU for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), arr)


def test_shard_call_returns_batch_order(rng):
    """Sharded rows of two dtypes, a replicated tensor, tuple outputs and
    an empty batch."""
    a = rng.integers(0, 100, size=(7, 2))
    b = rng.integers(0, 100, size=7).astype(np.int8)
    rep = torch.tensor([5, 7])

    def fn(x, y, r):
        return x * r, (y + 1,)
    got = D.shard_call(fn, (a, b, rep), (True, True, False), THREE)
    np.testing.assert_array_equal(got[0], a * np.array([5, 7]))
    np.testing.assert_array_equal(got[1][0], b + 1)
    empty = D.shard_call(fn, (a[:0], b[:0], rep), (True, True, False),
                         THREE)
    assert empty[0].shape == (0, 2) and empty[1][0].shape == (0,)


def test_launches_count_under_their_shard():
    """Each shard's launches count under its index in the device list."""
    _cuda.reset_launches()
    D.run_shards([(i, CPU, lambda i=i: [_cuda.count_launch("polish_core")
                                         for _ in range(i + 1)])
                  for i in (0, 2)], download=lambda x: x)
    assert _cuda.launches()["polish_core"] == 4
    per = _cuda.launches_by_shard()
    assert sorted(per) == [0, 2]
    assert per[0]["polish_core"] == 1 and per[2]["polish_core"] == 3
    _cuda.reset_launches()
    assert _cuda.launches_by_shard() == {}


def test_merge_stats(rng):
    rows = rng.integers(0, 100, size=(13, 7)).astype(np.int64)
    for devs in (THREE, "cpu"):
        np.testing.assert_array_equal(collectives.merge_stats(rows, devs),
                                      rows.sum(axis=0))
        np.testing.assert_array_equal(
            collectives.merge_stats(np.zeros((0, 7), np.int64), devs),
            np.zeros(7, np.int64))


def test_mesh(rng):
    grid = mesh.make_mesh(3, 1, THREE)
    assert grid.shape == (3, 1) and all(d == CPU for d in grid.ravel())
    assert mesh.make_mesh(devices=THREE, n_seq=3).shape == (1, 3)
    with pytest.raises(ValueError):
        mesh.make_mesh(2, 2, THREE)
    arr = rng.integers(0, 9, size=(5, 3))
    for mult, axis in ((4, 0), (3, 0), (2, 1)):
        np.testing.assert_array_equal(
            mesh.pad_to_multiple(arr, mult, axis=axis, fill=-1),
            JMESH.pad_to_multiple(arr, mult, axis=axis, fill=-1))


def test_chain_scan_sharded_equals_unsharded(monkeypatch):
    """A model on three shards runs each batch's chain scan whole, on its
    first device (the sweep's cost is per event, not per read), and the
    scan's result equals one device's; three reads, so a row block a
    shard would have split them."""
    g, mpc, index, _, reads = slice_case_port()
    seen = []

    def spy(device, **arrs):
        out = TCS.chain_scan(device=device, **arrs)
        seen.append((torch.device(device), out))
        return out
    monkeypatch.setattr(TC, "chain_scan", spy)
    for devs in (THREE, "cpu"):
        TC.ChainerModel(g, mpc, index, device=devs).align_batch(reads[1:4])
    (dev3, three), (dev1, one) = seen
    assert dev3 == dev1 == CPU and len(three.c_val) > 1
    np.testing.assert_array_equal(three.c_val, one.c_val)
    np.testing.assert_array_equal(three.c_pred, one.c_pred)
    assert (three.c_val > TCS.NEG).any()


def test_polish_sharded_row_extension(rng):
    """polish_batch on 5 reads over three shards equals one device and
    exact NW, with the reads packed per shard and gathered from a
    replicated read table."""
    reads, paths = [], []
    for _ in range(5):
        r = "".join(rng.choice(list("ACGT"), int(rng.integers(40, 90))))
        p = list(r)
        for _ in range(4):
            p[int(rng.integers(0, len(p)))] = str(rng.choice(list("ACGT")))
        reads.append(r)
        paths.append("".join(p))
    one = TP.polish_batch(reads, paths, bw=4, device="cpu")
    tbl = TP.build_read_table(reads, THREE)
    for table in (None, (tbl, np.arange(5))):
        out = TP.polish_batch(reads, paths, bw=4, table=table, device=THREE)
        for r, p, oc, o1 in zip(reads, paths, out, one):
            assert oc.score == o1.score == nw_edit_distance(r, p)
            np.testing.assert_array_equal(oc.ops, o1.ops)


def test_clc_align_batch_three_shards_matches_one_and_jax():
    """ChainerModel.align_batch on three reads over three shards: the
    same alignments as one device and as the JAX package (recorded,
    tests/torch_fixtures/slice_model.json)."""
    g, mpc, index, _, reads = slice_case_port()
    want = load_fixture("slice_model")["three_reads"]
    for devs in (THREE, "cpu"):
        got = TC.ChainerModel(g, mpc, index, device=devs).align_batch(
            reads[1:4])
        assert [aln_record(a) for a in got] == want, devs


def test_ga_align_batch_three_shards_matches_one():
    """GraphAlignerModel.align_batch (windows with carry, state and X
    cells, then the polish) on three shards equals one device."""
    g, index, reads = port_world("dag")
    one, three = (TM.GraphAlignerModel(g, index, device=devs).align_batch(
        reads) for devs in ("cpu", THREE))
    assert [aln_record(a) for a in three] == [aln_record(a) for a in one]
    assert not any(a.failed for a in one)


@functools.lru_cache(maxsize=None)
def components_case():
    """tests/test_multichip.py::test_sharded_tables_full_model_equality's
    five bubble chains (workload.component_chains_workload), one read of
    each."""
    return component_chains_workload(1)


def test_sharded_tables_equal_replicated(monkeypatch):
    """shard_graph_tables=True over three shards: each fragment runs on
    its component's table block (fragments reach several shards), and the
    alignments equal one device's replicated tables; on one device the
    flag plans nothing."""
    g, mpc, index, reads = components_case()
    assert g.ncomp >= 10
    cfg = TC.ChainerConfig(shard_graph_tables=True)
    single = TC.ChainerModel(g, mpc, index, cfg, device="cpu")
    assert single.gx.shards is None
    routed = set()
    real = TA._run_fragments_sharded

    def spy(shards, bnc, *rest):
        routed.update(TSG.route_fragments(shards[1], bnc)[0].tolist())
        return real(shards, bnc, *rest)
    monkeypatch.setattr(TA, "_run_fragments_sharded", spy)
    model = TC.ChainerModel(g, mpc, index, cfg, device=THREE)
    devs, plan, tables = model.gx.shards
    assert devs == (CPU,) * 3 and plan.n_dev == 3 and len(tables) == 3
    assert all(t[0].shape == (plan.rows_per_dev, 4) for t in tables)
    got = model.align_batch(reads)
    want = single.align_batch(reads)
    assert len(routed) > 1 and [aln_record(a) for a in got] == \
        [aln_record(a) for a in want]
    assert not any(a.failed for a in got)


def test_shard_plan_matches_jax(rng):
    """plan_component_shards, route_fragments and localize_bands equal the
    JAX module's on the five-component graph (numpy on both sides: the
    JAX module reads only the graph's component arrays)."""
    g = components_case()[0]
    for n_dev in (3, 8):
        jp, tp = JSG.plan_component_shards(g, n_dev), \
            TSG.plan_component_shards(g, n_dev)
        assert (jp.n_dev, jp.rows_per_dev) == (tp.n_dev, tp.rows_per_dev)
        for f in ("comp_dev", "node_dev", "local_id"):
            np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    N2 = 2 * g.n_nodes
    bnc = rng.integers(0, N2, size=(37, 8)).astype(np.int32)
    bnc[rng.random((37, 8)) < 0.3] = -1
    bnc[:, 0] = np.abs(bnc[:, 0])
    for a, b in zip(JSG.route_fragments(jp, bnc),
                    TSG.route_fragments(tp, bnc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JSG.localize_bands(jp, bnc),
                                  TSG.localize_bands(tp, bnc))

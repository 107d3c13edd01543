"""The chaining stage of graphchainer_torch: the host event packer and the
torch event sweep equal graphchainer_tpu's chain_scan and the host oracle
align/chaining.chain_oracle, (value, id) ties included."""
import numpy as np
import pytest

from graphchainer_tpu.align import chaining as JCH
from graphchainer_tpu.align.anchors import Anchor
from graphchainer_tpu.graph.alignment_graph import build_alignment_graph
from graphchainer_tpu.graph.mpc import build_mpc
from graphchainer_tpu.ops.chain_scan import chain_scan as jax_chain_scan
from graphchainer_torch.align import chaining as TCH
from graphchainer_torch.ops.chain_scan import chain_scan

from test_chaining import random_anchors
from test_mpc import random_dag_bigraph
from test_torch_common import port_graph, port_mpc


def make_case(seed, with_ties):
    rng = np.random.default_rng(5100 + seed)
    bg = random_dag_bigraph(rng, n_seg=11, p_edge=0.3, max_len=5)
    g = build_alignment_graph(bg)
    mpc = build_mpc(g)
    per_read = [random_anchors(rng, g, int(rng.integers(1, 20)))
                for _ in range(6)]
    if with_ties:
        # duplicated anchors and equal-length neighbours: equal chain
        # values whose predecessor id decides
        for anc in per_read:
            a = anc[0]
            anc.append(Anchor(path=list(a.path), x=a.x, y=a.y))
            anc.append(Anchor(path=list(a.path), x=a.x, y=a.y))
    return g, mpc, per_read


def flat(per_read):
    counts = np.array([len(a) for a in per_read], dtype=np.int64)
    s = np.array([a.path[0] for anc in per_read for a in anc])
    e = np.array([a.path[-1] for anc in per_read for a in anc])
    ax = np.array([a.x for anc in per_read for a in anc])
    ay = np.array([a.y for anc in per_read for a in anc])
    return counts, s, e, ax, ay


@pytest.mark.parametrize("seed,with_ties", [(0, False), (1, False),
                                            (2, True), (3, True)])
def test_chain_scan_matches_jax_and_oracle(seed, with_ties):
    g, mpc, per_read = make_case(seed, with_ties)
    counts, s, e, ax, ay = flat(per_read)
    arrs = TCH.batch_arrays_cols(port_graph(g), port_mpc(mpc), counts, s, e,
                                 ax, ay)
    got = chain_scan(**arrs, device="cpu")

    jarrs = JCH.batch_arrays_cols(g, mpc, counts, s, e, ax, ay,
                                  anchor_kmask=True)
    ref = jax_chain_scan(**{k: jarrs[k] for k in
                            ("x", "y", "valid", "ev_type", "ev_anchor",
                             "ev_k", "a_kmask", "ev_group")})
    R = len(counts)
    np.testing.assert_array_equal(got.c_val, np.asarray(ref.c_val)[:R])
    np.testing.assert_array_equal(got.c_pred, np.asarray(ref.c_pred)[:R])
    for r, anchors in enumerate(per_read):
        C, pred = JCH.chain_oracle(g, mpc, anchors)
        n = len(anchors)
        np.testing.assert_array_equal(got.c_val[r, :n], C)
        np.testing.assert_array_equal(got.c_pred[r, :n], pred)


@pytest.mark.parametrize("seed", [0, 1])
def test_event_packer_matches_jax(seed):
    """The port's packer emits the JAX packer's events (the port's event
    axis is cut to the longest read and its arrays are int32)."""
    g, mpc, per_read = make_case(seed, False)
    counts, s, e, ax, ay = flat(per_read)
    got = TCH.batch_arrays_cols(g, mpc, counts, s, e, ax, ay)
    ref = JCH.batch_arrays_cols(g, mpc, counts, s, e, ax, ay,
                                anchor_kmask=True)
    R, E = got["ev_type"].shape
    for k in ("x", "y", "valid", "a_kmask"):
        np.testing.assert_array_equal(got[k], ref[k][:R], err_msg=k)
    for k in ("ev_type", "ev_anchor", "ev_k", "ev_group"):
        np.testing.assert_array_equal(got[k], ref[k][:R, :E], err_msg=k)
    assert (ref["ev_type"][:R, E:] == -1).all()     # padding only


def test_chain_scan_packing_guard():
    """Read coverage x (A + 2) must fit the reference's int32 packing."""
    x = np.zeros((1, 64), np.int32)
    y = np.full((1, 64), 1 << 26, np.int32)
    with pytest.raises(ValueError, match="packing overflow"):
        chain_scan(x, y, np.ones((1, 64), bool), np.zeros((1, 4), np.int32),
                   np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32),
                   np.zeros((1, 64, 1), np.uint32),
                   np.zeros((1, 4), np.int32))

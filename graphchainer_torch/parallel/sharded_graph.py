"""Graph tables split by connected component, one block per shard.

Port of graphchainer_tpu/parallel/sharded_graph.py: at pan-genome scale
the node tables (Eq words and lengths, `GraphTensors.node_eq_cat`) are
split by connected component across the devices instead of copied to
each.  A fragment's band grows along edges, so every node it touches
lies in its seed's component: with whole components on one device, the
fragment kernel gathers from a local table and the only movement
between devices is each fragment's job row, routed on the host.

  plan_component_shards  greedy component -> shard balancing and the
                         global -> local node id map (numpy, a copy)
  build_sharded_tables   shard d's (eq, len) block on the d-th device of
                         the model's list; the tables are indexed by
                         shard, not by device, so two shards on one card
                         hold two blocks
  route_fragments        bucket a fragment batch by shard (a copy: its
                         padding to a common bucket height is the JAX
                         layout's; the port runs the kept rows only)
  localize_bands         band ids -> shard-local row ids (a copy)

align/anchors.run_fragments takes this route under the JAX package's
condition (anchors.py:841-851); models/chainer.py plans the shards when
ChainerConfig.shard_graph_tables is set and the model has more than one
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ShardPlan:
    n_dev: int
    comp_dev: np.ndarray     # (ncomp,) int32: device of each component
    node_dev: np.ndarray     # (2N,) int32: device of each cat-table row
    local_id: np.ndarray     # (2N,) int32: row id within the device shard
    rows_per_dev: int        # padded shard height


def plan_component_shards(g, n_dev: int) -> ShardPlan:
    """Greedy balance: components descending by node count onto the
    least-loaded device.  Both strands of a node (cat rows v and v+N)
    live in the same component, hence on the same device."""
    N = g.n_nodes
    comp = np.asarray(g.comp, dtype=np.int64)
    sizes = np.bincount(comp, minlength=g.ncomp)
    order = np.argsort(-sizes, kind="stable")
    load = np.zeros(n_dev, dtype=np.int64)
    comp_dev = np.zeros(g.ncomp, dtype=np.int32)
    for c in order:
        d = int(np.argmin(load))
        comp_dev[c] = d
        load[d] += sizes[c]
    node_dev_half = comp_dev[comp]
    node_dev = np.concatenate([node_dev_half, node_dev_half]).astype(
        np.int32)
    # local ids: ascending global order within each device (both halves)
    local_id = np.zeros(2 * N, dtype=np.int32)
    rows = 0
    for d in range(n_dev):
        sel = np.nonzero(node_dev == d)[0]
        local_id[sel] = np.arange(len(sel), dtype=np.int32)
        rows = max(rows, len(sel))
    rows = max(rows, 1)
    # pad to a multiple of 8 so gather shapes bucket coarsely
    rows = -(-rows // 8) * 8
    return ShardPlan(n_dev=n_dev, comp_dev=comp_dev, node_dev=node_dev,
                     local_id=local_id, rows_per_dev=rows)


def build_sharded_tables(gx, plan: ShardPlan, devices) -> list:
    """[(eq, len)] per shard, shard d's block (plan.rows_per_dev rows) on
    devices[d] in the format of GraphTensors.device_tables.  Padding rows
    get length 1 and zero Eq (no band ever references them)."""
    from graphchainer_torch.align.anchors import node_table
    D, R = plan.n_dev, plan.rows_per_dev
    out = []
    for d in range(D):
        sel = np.nonzero(plan.node_dev == d)[0]
        eq = np.zeros((R, 4), dtype=np.uint32)
        ln = np.ones(R, dtype=np.int32)
        eq[:len(sel)] = gx.node_eq_cat[sel]
        ln[:len(sel)] = gx.node_len_cat[sel]
        out.append(node_table(eq, ln, devices[d]))
    return out


def route_fragments(plan: ShardPlan, band_nodes_cat: np.ndarray):
    """Device routing for a fragment batch.

    Returns (frag_dev (F,), order (D*Fd,) int64 gather indices into the
    ORIGINAL batch building the device-blocked layout, keep (D*Fd,) bool,
    Fd).  Padding rows replicate fragment 0 (results discarded)."""
    F = len(band_nodes_cat)
    seed = np.clip(band_nodes_cat[:, 0], 0, len(plan.node_dev) - 1)
    frag_dev = plan.node_dev[seed]
    counts = np.bincount(frag_dev, minlength=plan.n_dev)
    Fd = int(counts.max(initial=1))
    Fd = -(-Fd // 8) * 8               # coarse buckets for compile reuse
    order = np.zeros(plan.n_dev * Fd, dtype=np.int64)
    keep = np.zeros(plan.n_dev * Fd, dtype=bool)
    for d in range(plan.n_dev):
        sel = np.nonzero(frag_dev == d)[0]
        order[d * Fd:d * Fd + len(sel)] = sel
        keep[d * Fd:d * Fd + len(sel)] = True
    return frag_dev, order, keep, Fd


def localize_bands(plan: ShardPlan, band_nodes_cat: np.ndarray):
    """Remap global cat-table ids to shard-local row ids (pad slots stay
    -1)."""
    ids = np.clip(band_nodes_cat, 0, len(plan.local_id) - 1)
    return np.where(band_nodes_cat >= 0, plan.local_id[ids],
                    -1).astype(np.int32)

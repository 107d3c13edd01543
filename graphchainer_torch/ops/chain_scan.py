"""Batched co-linear chaining event sweep in torch.

Port of graphchainer_tpu/ops/chain_scan.py (`chain_scan` / `_chain_scan`
with the per-anchor INSERT masks): the per-path search trees of the
reference's sweep are masked maxima over the anchor axis, and the events
of every read advance together, one event per loop step, on the device.
The events come from the host packer align/chaining.batch_arrays_cols
(with anchor_kmask=True); the result is bit-identical to
align/chaining.chain_oracle, (value, id) ties included.

The whole batch runs on one device, where JAX shards the read axis over
every device (ops/chain_scan.py:115-133): the sweep's cost is the host's
enqueueing of a few dozen small ops an event, whatever the number of
reads, so a row block a device would enqueue every event's ops once per
device and multiply the stage's time by the device count.

Scores combine as val * (A + 2) + (pred + 1); the reference packs that in
int32, so the host guard below rejects batches whose read coverage would
overflow it, although this port computes in int64.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphchainer_torch.parallel.device import upload

EV_SAME_START = 0
EV_SAME_END = 1
EV_INSERT = 2
EV_QUERY = 3
EV_NONE = -1

NEG = -(1 << 30)


class ChainScanResult(NamedTuple):
    c_val: np.ndarray    # (R, A) chain value per anchor
    c_pred: np.ndarray   # (R, A) chain predecessor (-1 none)


def chain_scan(x, y, valid, ev_type, ev_anchor, ev_k, a_kmask, ev_group,
               device="cuda") -> ChainScanResult:
    """Run the chaining DP for a batch of reads on `device` (the card
    unless the caller asks for the CPU).

    x, y:      (R, A) anchor read intervals;  valid: (R, A) bool
    ev_type:   (R, E) EV_* (EV_NONE padding);  ev_anchor: (R, E)
    ev_k:      (R, E) global path id of EV_QUERY events
    a_kmask:   (R, A, KW) uint32 per-anchor INSERT path bitmask
    ev_group:  (R, E) topo group id (tags the same-node scratch)"""
    A = x.shape[1]
    max_cov = int(np.max(y, initial=0)) + 1
    if max_cov * (A + 2) >= (1 << 31):
        raise ValueError(
            f"chain_scan int32 packing overflow: read coverage {max_cov} x "
            f"(A={A} + 2) >= 2^31; reduce the anchor cap or split the read")
    def t(a, dtype=np.int64):
        return np.ascontiguousarray(a, dtype=dtype)

    c_val, c_pred = _chain_scan(*upload(
        (t(x), t(y), t(valid, np.bool_), t(ev_type), t(ev_anchor), t(ev_k),
         t(a_kmask), t(ev_group)), torch.device(device)))
    return ChainScanResult(c_val=c_val.cpu().numpy(),
                           c_pred=c_pred.cpu().numpy())


def _chain_scan(x, y, valid, ev_type, ev_anchor, ev_k, a_kmask, ev_group):
    """The event sweep on int64 tensors; returns (c_val, c_pred) (R, A).

    What depends only on the events (the anchor's interval, the event
    kind, the path word and bit, the INSERT mask) is gathered for all
    events before the loop; a step then reads its column and updates the
    event's anchor in place, so each event costs a few dozen small ops."""
    R, A = x.shape
    KW = a_kmask.shape[-1]
    dev = x.device
    i64 = torch.int64
    c_val = torch.where(valid, y - x + 1, NEG)
    c_pred = torch.full((R, A), -1, dtype=i64, device=dev)
    ins = torch.zeros((R, A, KW), dtype=i64, device=dev)
    tmp_tag = torch.full((R, A), -2, dtype=i64, device=dev)
    key_id = torch.arange(1, A + 1, dtype=i64, device=dev)[None, :]

    ja = ev_anchor.clamp(0, A - 1)                      # (R, E)
    xj_e = x.gather(1, ja)
    yj_e = y.gather(1, ja)
    lnj_e = yj_e - xj_e + 1
    reach_e = torch.maximum(xj_e, yj_e)
    same_start_e = ev_type == EV_SAME_START
    query_e = same_start_e | (ev_type == EV_QUERY)
    same_end_e = ev_type == EV_SAME_END
    kc = ev_k.clamp(0, KW * 32 - 1)
    kword_e = torch.div(kc, 32, rounding_mode="floor")
    kbit_e = torch.remainder(kc, 32)
    ins_mask_e = torch.where(
        (ev_type == EV_INSERT)[..., None],
        a_kmask.gather(1, ja[..., None].expand(R, ja.shape[1], KW)), 0)

    for i in range(ev_type.shape[1]):
        j = ja[:, i, None]                               # (R, 1)
        xj = xj_e[:, i, None]
        yj = yj_e[:, i, None]
        grp = ev_group[:, i, None]
        # chaining candidates: same-node scratch on SAME_START, else the
        # anchors inserted on the queried path; the previous anchor ends
        # before this one starts (T) or overlaps it (I), y < yj in both
        ins_k = ins.gather(2, kword_e[:, i].view(R, 1, 1).expand(R, A, 1))
        ins_k = (ins_k[..., 0] >> kbit_e[:, i, None]) & 1
        cand = torch.where(same_start_e[:, i, None], tmp_tag == grp,
                           ins_k == 1)
        cand = cand & valid & (y < reach_e[:, i, None])
        gain = torch.where(y < xj, lnj_e[:, i, None], yj - y)
        comb = torch.where(cand, (c_val + gain) * (A + 2) + key_id, NEG)
        best = comb.max(dim=1, keepdim=True).values
        bval = torch.div(best, A + 2, rounding_mode="floor")
        bpred = torch.remainder(best, A + 2) - 1

        cur_val = c_val.gather(1, j)
        cur_pred = c_pred.gather(1, j)
        better = (bval > cur_val) | ((bval == cur_val) & (bpred > cur_pred))
        do_q = query_e[:, i, None] & better & (best > NEG)
        c_val.scatter_(1, j, torch.where(do_q, bval, cur_val))
        c_pred.scatter_(1, j, torch.where(do_q, bpred, cur_pred))
        tmp_tag.scatter_(1, j, torch.where(same_end_e[:, i, None], grp,
                                           tmp_tag.gather(1, j)))
        jk = j[..., None].expand(R, 1, KW)
        ins.scatter_(1, jk, ins.gather(1, jk) | ins_mask_e[:, i, None, :])
    return c_val, c_pred

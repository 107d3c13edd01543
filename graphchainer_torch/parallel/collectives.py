"""The per-read statistics summed over the local devices.

Port of graphchainer_tpu/parallel/collectives.py (`merge_stats` `:15`).
The reference's stats are shared-memory atomics
(src/Aligner.cpp:111-144); the JAX package keeps them on its devices,
sums each device's read shard and merges the partial sums with a psum
inside shard_map.  The port's per-read stats are host numpy arrays,
built by the host stages whatever devices ran the batch, so there is
nothing on a device to collect: the merge is a host sum for every
device list.
"""
from __future__ import annotations

import numpy as np


def merge_stats(per_read, devices=None) -> np.ndarray:
    """Per-read stat rows (R, K) summed into totals (K,): what
    per_read.sum(axis=0) returns, empty batch included.  `devices` is
    the JAX signature's; the rows are on the host, so it changes
    nothing."""
    return np.asarray(per_read).sum(axis=0)

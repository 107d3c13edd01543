"""A device grid.

Port of graphchainer_tpu/parallel/mesh.py: `make_mesh` lays the devices
out as a (data, seq) grid, 'data' for read batches and 'seq' for the
fragments within reads, and `pad_to_multiple` pads an axis.  The JAX
module's NamedShardings (frag_sharding, read_sharding, replicated) have
no counterpart: the port places rows with parallel/device.shard_rows and
replicates with parallel/device.replicate.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from graphchainer_torch.parallel.device import local_devices


def make_mesh(n_data: Optional[int] = None, n_seq: int = 1,
              devices: Optional[Sequence] = None) -> np.ndarray:
    """An (n_data, n_seq) object array of torch.device, row-major over
    `devices` (default: every visible card, as JAX's mesh takes every
    device); n_data defaults to as many rows as the devices fill."""
    devices = list(local_devices(
        devices if devices is not None else
        [f"cuda:{i}" for i in range(torch.cuda.device_count())]))
    if n_data is None:
        n_data = len(devices) // n_seq
    if n_data * n_seq > len(devices) or n_data * n_seq == 0:
        raise ValueError(f"a {n_data} x {n_seq} mesh needs "
                         f"{n_data * n_seq} devices; {len(devices)} given")
    grid = np.empty(n_data * n_seq, dtype=object)
    grid[:] = devices[:n_data * n_seq]
    return grid.reshape(n_data, n_seq)


def pad_to_multiple(arr: np.ndarray, mult: int, axis: int = 0,
                    fill=0) -> np.ndarray:
    n = arr.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, rem)
    return np.pad(arr, pad, constant_values=fill)

"""Multi-process execution on torch.distributed (gloo).

Port of graphchainer_tpu/parallel/multihost.py, which joins the processes
with jax.distributed.  All processes run the same command:

    --num-processes P --process-id I --coordinator HOST:PORT

Reads stripe across the processes (read i belongs to process i % P; no
coordination is needed beyond the rendezvous), each process aligns its
stripe on the device it is given, its output files get a ".partI" suffix
(GAM, GAF and JSON are record streams: concatenate them, or leave them
apart), and the statistics are summed over all processes at the end with
an all_reduce.  Process 0 listens on the coordinator's address.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str, num_processes: int,
               process_id: int) -> bool:
    """Join the process group (gloo, rendezvous at tcp://coordinator);
    nothing for a single process or a process that has joined.  Returns
    whether this call made the group (its maker leaves it: finalize)."""
    if num_processes <= 1 or dist.is_initialized():
        return False
    dist.init_process_group("gloo", init_method="tcp://" + coordinator,
                            world_size=num_processes, rank=process_id)
    return True


def finalize():
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def stripe(items: Sequence, process_id: int, num_processes: int):
    """This process's read stripe (i % P == I keeps streaming order and
    balances long and short reads across processes)."""
    return [x for i, x in enumerate(items) if i % num_processes == process_id]


def merge_stats_global(local_totals: np.ndarray) -> np.ndarray:
    """Sum a (K,) per-process stats vector over all processes (an
    all_reduce of an int64 CPU tensor).  Single process: identity."""
    if process_count() <= 1:
        return np.asarray(local_totals)
    t = torch.as_tensor(np.asarray(local_totals, dtype=np.int64)).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def part_suffix(path: Optional[str], process_id: int,
                num_processes: int) -> Optional[str]:
    """Per-process output file name (".partI" appended, so any extension
    keeps working)."""
    if path is None or num_processes <= 1:
        return path
    return f"{path}.part{process_id}"

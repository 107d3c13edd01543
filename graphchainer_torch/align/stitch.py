"""Node path -> per-character positions (reference pathToTrace,
src/Aligner.cpp:409-424).

Copy of `path_to_positions` from graphchainer_tpu/align/stitch.py: GA
mode's only need there (the CLC stitch itself runs in the native
stitch_batch)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph


def path_to_positions(g: AlignmentGraph, pos_path: Sequence[int],
                      first_off: int, last_off: int) -> np.ndarray:
    """Expand a node path into per-char (node, offset) rows from first_off
    in the first node to last_off in the last node (reference
    pathToTrace).  Vectorized."""
    nodes = np.asarray(pos_path, dtype=np.int64)
    n = len(nodes)
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64)
    starts = np.zeros(n, dtype=np.int64)
    ends = g.node_len[nodes].astype(np.int64) - 1
    starts[0] = first_off
    ends[-1] = last_off
    lens = np.maximum(ends - starts + 1, 0)
    total = int(lens.sum())
    v_rep = np.repeat(nodes, lens)
    run0 = np.cumsum(lens) - lens
    offs = (np.arange(total, dtype=np.int64) - np.repeat(run0, lens)
            + np.repeat(starts, lens))
    return np.stack([v_rep, offs], axis=1)

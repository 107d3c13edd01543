"""Build the port's objects from the fields of the JAX package's.

The two packages have distinct classes of the same names and fields.
The tests hold one against the other on the same state, so they hand the
reference's objects across as plain data: a dict of numpy arrays, lists
and Python scalars (`vars(obj)` or `dataclasses.asdict(obj)` on the
caller's side).  Nothing here imports graphchainer_tpu; arrays are
copied, so neither side sees the other's later writes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from graphchainer_torch.graph.alignment_graph import AlignmentGraph
from graphchainer_torch.graph.mpc import MPCIndex
from graphchainer_torch.index.minimizer import MinimizerIndex
from graphchainer_torch.models.aligner import AlignerConfig
from graphchainer_torch.models.chainer import ChainerConfig


def _own(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return list(v)
    return v


def _build(cls, fields: dict):
    """cls(**fields) over exactly cls's dataclass fields; what else the
    dict holds (cached attributes such as _approx_pos) is left behind,
    and a missing field raises."""
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"{cls.__name__}: fields missing: {missing}")
    return cls(**{n: _own(fields[n]) for n in names})


def from_reference_graph(fields: dict) -> AlignmentGraph:
    return _build(AlignmentGraph, fields)


def from_reference_mpc(fields: dict) -> MPCIndex:
    return _build(MPCIndex, fields)


def from_reference_index(fields: dict) -> MinimizerIndex:
    return _build(MinimizerIndex, fields)


def from_reference_config(fields: dict) -> ChainerConfig:
    return _build(ChainerConfig, fields)


def from_reference_aligner_config(fields: dict) -> AlignerConfig:
    return _build(AlignerConfig, fields)

"""Alignment selection: non-overlapping subset of per-read alignments.

Port of reference src/AlignmentSelection.{h,cpp}: greedy (by length, score
or E-value) or optimal weighted-interval scheduling, with incompatibility
defined as read-interval overlap > 5% of the shorter alignment, plus an
optional E-value cutoff filter.

Copy of graphchainer_tpu/align/selection.py."""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Sequence

from graphchainer_torch.align.evalue import EValueCalculator

OVERLAP_INCOMPATIBLE_FRACTION = 0.05


class SelectionMethod(Enum):
    GREEDY_LENGTH = "GreedyLength"
    GREEDY_SCORE = "GreedyScore"
    GREEDY_E = "GreedyE"
    SCHEDULE_INVERSE_E_SUM = "ScheduleInverseESum"
    SCHEDULE_INVERSE_E_PRODUCT = "ScheduleInverseEProduct"
    SCHEDULE_SCORE = "ScheduleScore"
    SCHEDULE_LENGTH = "ScheduleLength"
    ALL = "All"


@dataclass
class SelectionOptions:
    method: SelectionMethod = SelectionMethod.GREEDY_LENGTH
    graph_size: int = 0
    read_size: int = 0
    e_cutoff: float = -1.0
    evalue_calc: Optional[EValueCalculator] = None


def incompatible(a, b) -> bool:
    """a/b expose .seq_start/.seq_end (read interval)."""
    min_overlap = min(a.seq_end - a.seq_start,
                      b.seq_end - b.seq_start) * OVERLAP_INCOMPATIBLE_FRACTION
    ls, le, rs, re = a.seq_start, a.seq_end, b.seq_start, b.seq_end
    if ls > rs:
        ls, le, rs, re = rs, re, ls, le
    overlap = max(0, le - rs)
    return overlap > min_overlap


def _length_key(a):
    return (-(a.seq_end - a.seq_start), a.score)


def select_alignments(alignments: Sequence, options: SelectionOptions
                      ) -> List:
    """Returns the selected subset (order: best first)."""
    alns = list(alignments)
    calc = options.evalue_calc
    if options.e_cutoff != -1 and calc is not None:
        alns = [a for a in alns
                if calc.evalue(options.graph_size, options.read_size,
                               a.seq_end - a.seq_start, a.score)
                <= options.e_cutoff]
    m = options.method
    if m == SelectionMethod.ALL:
        return alns

    def aln_len(a):
        return a.seq_end - a.seq_start

    def e_of(a):
        return calc.evalue(options.graph_size, options.read_size,
                           aln_len(a), a.score)

    if m in (SelectionMethod.GREEDY_LENGTH, SelectionMethod.GREEDY_SCORE,
             SelectionMethod.GREEDY_E):
        if m == SelectionMethod.GREEDY_LENGTH:
            order = sorted(alns, key=_length_key)
        elif m == SelectionMethod.GREEDY_SCORE:
            order = sorted(alns, key=lambda a: -calc.alignment_score(
                aln_len(a), a.score))
        else:
            order = sorted(alns, key=e_of)
        result = []
        for a in order:
            if not any(incompatible(a, b) for b in result):
                result.append(a)
        return result

    # weighted interval scheduling (optimal subset)
    order = sorted(range(len(alns)), key=lambda i: alns[i].seq_end)
    if m == SelectionMethod.SCHEDULE_SCORE:
        raw = [calc.alignment_score(aln_len(alns[i]), alns[i].score)
               for i in order]
    elif m == SelectionMethod.SCHEDULE_LENGTH:
        raw = [float(aln_len(alns[i])) for i in order]
    elif m == SelectionMethod.SCHEDULE_INVERSE_E_SUM:
        raw = [1.0 / max(e_of(alns[i]), 1e-300) for i in order]
    else:  # SCHEDULE_INVERSE_E_PRODUCT
        raw = [-math.log(max(e_of(alns[i]), 1e-300)) for i in order]
    score = list(raw)
    back = [-1] * len(order)
    for i in range(len(order)):
        for j in range(i):
            if incompatible(alns[order[i]], alns[order[j]]):
                continue
            if score[j] + raw[i] > score[i]:
                score[i] = score[j] + raw[i]
                back[i] = j
    if not order:
        return []
    best = max(range(len(order)), key=lambda i: score[i])
    result = []
    i = best
    while i != -1:
        result.append(alns[order[i]])
        i = back[i]
    return result

"""Alignment correctness estimation: 2-state HMM over per-slice error
counts (port of reference src/AlignmentCorrectnessEstimation.{h,cpp}).

States {correct, false} with Gaussian log-odds emissions over the
per-slice mismatch fraction (means 0.1875 / 0.5 per base) and the
reference's transition probabilities.  Used to decide band breaks/ramps;
vectorizable over a batch (pure numpy).

Copy of graphchainer_tpu/align/correctness.py."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

CORRECT_MEAN = 0.1875
CORRECT_STD = 0.0955
WRONG_MEAN = 0.5
WRONG_STD = 0.0291

F2C_LOG = math.log(0.00001)
F2F_LOG = math.log(1.0 - 0.00001)
C2F_LOG = math.log(0.0000000001)
C2C_LOG = math.log(1.0 - 0.0000000001)


def _stddistlog(val, mean, std):
    return -(val - mean) ** 2 / (2 * std * std)


@dataclass
class CorrectnessState:
    """Log probabilities of the two states + viterbi-ish backpointers."""
    correct_log: float = math.log(0.8)
    false_log: float = math.log(0.2)
    correct_from_correct: bool = True
    false_from_correct: bool = False

    def current_is_correct(self) -> bool:
        return self.correct_log > self.false_log

    def next_state(self, errors: int, rows: int) -> "CorrectnessState":
        frac = errors / max(rows, 1)
        c_em = _stddistlog(frac, CORRECT_MEAN, CORRECT_STD)
        f_em = _stddistlog(frac, WRONG_MEAN, WRONG_STD)
        new = CorrectnessState.__new__(CorrectnessState)
        cc = self.correct_log + C2C_LOG
        fc = self.false_log + F2C_LOG
        if cc >= fc:
            new.correct_log = cc + c_em
            new.correct_from_correct = True
        else:
            new.correct_log = fc + c_em
            new.correct_from_correct = False
        cf = self.correct_log + C2F_LOG
        ff = self.false_log + F2F_LOG
        if cf >= ff:
            new.false_log = cf + f_em
            new.false_from_correct = True
        else:
            new.false_log = ff + f_em
            new.false_from_correct = False
        # normalize to avoid drift
        mx = max(new.correct_log, new.false_log)
        new.correct_log -= mx
        new.false_log -= mx
        return new


def correctness_track(errors_per_slice: np.ndarray,
                      rows_per_slice: np.ndarray) -> np.ndarray:
    """Batched: returns per-slice boolean 'correct' decisions."""
    n = len(errors_per_slice)
    out = np.zeros(n, dtype=bool)
    st = CorrectnessState()
    for i in range(n):
        st = st.next_state(int(errors_per_slice[i]),
                           int(rows_per_slice[i]))
        out[i] = st.current_is_correct()
    return out

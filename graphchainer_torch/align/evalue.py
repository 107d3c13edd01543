"""Karlin-Altschul E-values (port of reference src/EValue.{h,cpp}).

Alignments are modeled as match/mismatch sequences with P(match)=0.5,
match score +1 and mismatch score -minIdentity/(1-minIdentity); lambda is
found by bisection of E[exp(lambda*score)] = 1 and K by the series
approximation the reference uses (src/EValue.cpp:51-113).

Copy of graphchainer_tpu/align/evalue.py."""
from __future__ import annotations

import math


class EValueCalculator:
    def __init__(self, min_identity: float = -1.0,
                 legacy_score: bool = False):
        # legacy_score: reproduce the reference's LITERAL
        # getAlignmentScore (src/EValue.cpp:45-48), whose sign makes
        # more edits RAISE the score — so --E-cutoff with the same
        # threshold selects exactly the reference's alignment set.
        # Default implements the formula its comment intends
        # (edits lower the score).
        self.legacy_score = legacy_score
        if min_identity < 0:
            self.match = -1.0
            self.mismatch = -1.0
            self.lam = -1.0
            self.K = -1.0
            return
        self.match = 1.0
        self.mismatch = -min_identity / (1.0 - min_identity)
        self._init_lambda()
        self._init_k()

    def _init_lambda(self):
        lo, hi = 0.0, 0.7
        for _ in range(100):
            mid = (lo + hi) * 0.5
            val = (math.exp(mid * self.match) * 0.5
                   + math.exp(mid * self.mismatch) * 0.5 - 1.0)
            if val < 0:
                lo = mid
            elif val > 0:
                hi = mid
            else:
                lo = hi = mid
                break
            if lo == hi:
                break
        self.lam = (lo + hi) / 2

    def _init_k(self):
        lam = self.lam
        series_sum = 0.0
        triangle = [1]
        for k in range(1, 10):
            new = [0] * (len(triangle) + 1)
            for j, t in enumerate(triangle):
                new[j] += t
                new[j + 1] += t
            triangle = new
            tsum = sum(triangle)
            neg_exp = 0.0
            greater_p = 0.0
            for j, t in enumerate(triangle):
                matches = j
                mismatches = len(triangle) - 1 - j
                score = matches * self.match + mismatches * self.mismatch
                prob = t / tsum
                if score < 0:
                    neg_exp += math.exp(lam * score) * prob
                else:
                    greater_p += prob
            series_sum += (neg_exp + greater_p) / k
        expectation = (0.5 * self.match * math.exp(lam * self.match)
                       + 0.5 * self.mismatch * math.exp(lam * self.mismatch))
        cstar = math.exp(-2 * series_sum) / (lam * expectation)
        self.K = cstar * lam / (1.0 - math.exp(-lam))

    def alignment_score(self, alignment_length: int, num_edits: int) -> float:
        # (length - edits)*match + edits*mismatch.  The reference
        # (src/EValue.cpp:46-49) subtracts the (negative) score delta,
        # which makes more edits RAISE the score; its own comment states
        # the intended approximation, which the default implements.
        if self.legacy_score:
            return (alignment_length * self.match
                    - num_edits * (self.mismatch - self.match))
        return (alignment_length * self.match
                + num_edits * (self.mismatch - self.match))

    def evalue(self, database_size: int, query_size: int,
               alignment_length: int, num_edits: int) -> float:
        score = self.alignment_score(alignment_length, num_edits)
        return (self.K * database_size * query_size
                * math.exp(-self.lam * score))

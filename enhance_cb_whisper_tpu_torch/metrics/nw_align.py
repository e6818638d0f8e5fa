"""Needleman-Wunsch global sequence alignment (host-side, numpy).

Replaces the reference's dependency on ``string2string.alignment
.NeedlemanWunsch`` (src/scorer.py:2,22,67) with the same scoring scheme
(match=+1, mismatch=-1, gap=-1) and the conventional backtrace preference
(diagonal, then up/seq1-gap, then left/seq2-gap).  Instead of the
reference's '|'-joined strings (whose re-splitting logic is fragile for
tokens containing '|'), we align lists of tokens directly and mark gaps
with a sentinel.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

GAP = "[SKIP]"


def needleman_wunsch(
    seq1: Sequence[str],
    seq2: Sequence[str],
    match_weight: float = 1.0,
    mismatch_weight: float = -1.0,
    gap_weight: float = -1.0,
    gap: str = GAP,
) -> Tuple[List[str], List[str]]:
    """Globally align ``seq1`` and ``seq2``; returns the two aligned lists
    (equal length) with ``gap`` filling insertion/deletion positions."""
    n, m = len(seq1), len(seq2)
    score = np.zeros((n + 1, m + 1), dtype=np.float64)
    score[:, 0] = gap_weight * np.arange(n + 1)
    score[0, :] = gap_weight * np.arange(m + 1)

    eq = np.zeros((n, m), dtype=bool)
    for i, a in enumerate(seq1):
        for j, b in enumerate(seq2):
            eq[i, j] = a == b

    for i in range(1, n + 1):
        prev = score[i - 1]
        cur = score[i]
        sub = np.where(eq[i - 1], match_weight, mismatch_weight)
        for j in range(1, m + 1):
            cur[j] = max(prev[j - 1] + sub[j - 1], prev[j] + gap_weight, cur[j - 1] + gap_weight)

    out1: List[str] = []
    out2: List[str] = []
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and score[i, j] == score[i - 1, j - 1] + (
            match_weight if eq[i - 1, j - 1] else mismatch_weight
        ):
            out1.append(seq1[i - 1])
            out2.append(seq2[j - 1])
            i -= 1
            j -= 1
        elif i > 0 and score[i, j] == score[i - 1, j] + gap_weight:
            out1.append(seq1[i - 1])
            out2.append(gap)
            i -= 1
        else:
            out1.append(gap)
            out2.append(seq2[j - 1])
            j -= 1
    out1.reverse()
    out2.reverse()
    return out1, out2

"""The deferred band items' match counts, where they are unambiguous.

An item is a text window (the allele) and a pattern window (the read)
scored by banded affine-gap global alignment: match +2, mismatch -2, a
gap of n bases -4 - n, N matching anything; the service returns the
match count of the optimal alignment.  Where the two windows have the
same length L and differ at h <= 2 bases, the ungapped alignment scores
2L - 4h >= 2L - 8, and any alignment with a gap needs a deletion and an
insertion (2 x -5) over at most L - 1 columns, so scores at most
2L - 12: the ungapped alignment is the only optimum and its match count
is L - h.  Those items are checked; the others are counted as not
checkable."""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

MAX_MISMATCH = 2


def check(items: Iterable[Tuple[np.ndarray, np.ndarray, int]]) -> dict:
    """items: (text codes, pattern codes, the program's match count).
    Returns how many items were checkable and how many of those carry
    another match count than L - h."""
    checked = wrong = 0
    for text, pattern, got in items:
        if len(text) != len(pattern):
            continue
        if len(text) == 0:
            checked += 1
            wrong += int(got != 0)
            continue
        differ = (text != pattern) & (text < 4) & (pattern < 4)
        h = int(differ.sum())
        if h > MAX_MISMATCH:
            continue
        checked += 1
        wrong += int(got != len(text) - h)
    return {"checked": checked, "wrong": wrong}

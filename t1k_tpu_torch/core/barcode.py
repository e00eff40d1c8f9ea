"""Cell-barcode correction against a whitelist.

Behavior contract (reference BarcodeCorrector.hpp): whitelist entries are
seeded with count 1; a background pass over (up to 2M) observed barcodes
increments counts of whitelisted barcodes; correction of a non-whitelist
barcode tries every 1-Hamming neighbor, picking the highest count and
breaking ties by the lowest base quality at the mismatch position.
"""

from __future__ import annotations

from typing import Iterable, Optional

from ..constants import revcomp_str


def format_barcode(raw: str, start: int, end: int, revcomp: bool) -> str:
    if start == 0 and end == -1 and not revcomp:
        return raw
    e = len(raw) - 1 if end == -1 else end
    sub = raw[start:e + 1]
    return revcomp_str(sub) if revcomp else sub


class _TrieNode:
    __slots__ = ("next", "count")

    def __init__(self):
        self.next = {}
        self.count = 0


class BarcodeCorrector:
    """Exact mirror of the reference Trie semantics
    (BarcodeCorrector.hpp:17-100): lookups do NOT require the
    end-of-word flag, so a barcode that is a PREFIX of any whitelist
    entry resolves to an internal node (count starts at 0) and is
    accepted — observable when --barcodeStart/--barcodeEnd slice the
    barcode shorter than the whitelist entries.  Background counts
    accumulate at whichever node (internal or terminal) the formatted
    barcode reaches."""

    def __init__(self):
        self.root = _TrieNode()

    def _insert(self, s: str) -> None:
        if any(c not in "ACGT" for c in s):
            return
        p = self.root
        for c in s:
            nxt = p.next.get(c)
            if nxt is None:
                nxt = p.next[c] = _TrieNode()
            p = nxt
        p.count += 1

    def _search_update(self, s: str, weight: int) -> int:
        """Count after update; -1 when off-path or non-ACGT
        (Trie::SearchAndUpdate — no end check)."""
        if any(c not in "ACGT" for c in s):
            return -1
        p = self.root
        for c in s:
            p = p.next.get(c)
            if p is None:
                return -1
        p.count += weight
        return p.count

    def set_whitelist(self, path: str) -> None:
        with open(path) as f:
            for tok in f.read().split():
                self._insert(tok)

    def collect_background(self, barcodes: Iterable[str], start: int = 0,
                           end: int = -1, revcomp: bool = False,
                           case_cnt: int = 2000000) -> None:
        n = 0
        for raw in barcodes:
            bc = format_barcode(raw, start, end, revcomp)
            self._search_update(bc, 1)
            n += 1
            if n >= case_cnt:
                break

    def correct(self, barcode: str, qual: Optional[str]) -> Optional[str]:
        """Return the (possibly corrected) barcode, or None if
        uncorrectable (BarcodeCorrector::Correct)."""
        if self._search_update(barcode, 0) != -1:
            return barcode
        best_cnt = -1
        best = None
        best_low_qual = 255
        for i, orig in enumerate(barcode):
            for b in "ACGT":
                if b == orig:
                    continue
                cand = barcode[:i] + b + barcode[i + 1:]
                cnt = self._search_update(cand, 0)
                if cnt == -1:
                    continue
                if cnt > best_cnt:
                    best_cnt = cnt
                    best = cand
                    if qual is not None:
                        best_low_qual = ord(qual[i])
                elif cnt == best_cnt and qual is not None and ord(qual[i]) < best_low_qual:
                    best_low_qual = ord(qual[i])
                    best = cand
        return best

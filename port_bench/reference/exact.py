"""Exact occurrences of reads in the panel, and panel k-mers in reads.

A read pair "lies in" an allele when the allele holds mate 1 and the
reverse complement of mate 2, each exactly (no N).  Such a pair matches
every base of those alleles and mismatches at least one base of every
other, so any aligner that keeps the best-scoring alleles keeps exactly
these."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

ANCHOR = 32          # bases of the anchor key (2 bits each, one uint64)
CHUNK = 256          # reads verified at a time
_LUT = np.full(256, 4, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i
COMP = np.array([3, 2, 1, 0, 4], np.int8)


def encode(seq: str) -> np.ndarray:
    return _LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]


def _keys(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """2-bit keys of every k-mer of `codes` (uint64) and whether each is
    free of N."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    c = np.where(codes < 4, codes, 0).astype(np.uint64)
    key = np.zeros(n, np.uint64)
    for j in range(k):
        key = (key << np.uint64(2)) | c[j:j + n]
    bad = np.cumsum(np.concatenate([[0], (codes >= 4).astype(np.int64)]))
    return key, (bad[k:k + n] - bad[:n]) == 0


class Panel:
    """The panel's alleles concatenated (N between them), with a sorted
    index of its anchor keys."""

    def __init__(self, seqs: List[str]):
        parts, offs, pos = [], [], 0
        for s in seqs:
            offs.append(pos)
            parts.append(encode(s))
            parts.append(np.array([4], np.int8))
            pos += len(s) + 1
        self.codes = np.concatenate(parts)
        self.starts = np.asarray(offs, np.int64)
        self.total_bases = sum(len(s) for s in seqs)
        key, ok = _keys(self.codes, ANCHOR)
        where = np.flatnonzero(ok)
        order = np.argsort(key[where], kind="stable")
        self.anchor_pos = where[order]
        self.anchor_key = key[where][order]

    def holders(self, reads: np.ndarray) -> List[np.ndarray]:
        """For each read ([n, L] codes), the sorted alleles that hold it
        exactly."""
        n, L = reads.shape
        out: List[np.ndarray] = [np.zeros(0, np.int64)] * n
        head = np.zeros(n, np.uint64)
        clean = (reads < 4).all(axis=1)
        c = np.where(reads < 4, reads, 0).astype(np.uint64)
        for j in range(ANCHOR):
            head = (head << np.uint64(2)) | c[:, j]
        lo = np.searchsorted(self.anchor_key, head, "left")
        hi = np.searchsorted(self.anchor_key, head, "right")
        cols = np.arange(L)
        for a in range(0, n, CHUNK):
            b = min(n, a + CHUNK)
            cnt = np.where(clean[a:b], hi[a:b] - lo[a:b], 0)
            if not cnt.sum():
                continue
            rid = np.repeat(np.arange(a, b), cnt)
            first = np.repeat(lo[a:b], cnt)
            rank = np.arange(len(rid)) - np.repeat(
                np.cumsum(cnt) - cnt, cnt)
            pos = self.anchor_pos[first + rank]
            fits = pos + L <= len(self.codes)
            rid, pos = rid[fits], pos[fits]
            same = (self.codes[pos[:, None] + cols] == reads[rid]).all(1)
            rid, pos = rid[same], pos[same]
            allele = np.searchsorted(self.starts, pos, "right") - 1
            for r in np.unique(rid):
                out[r] = np.unique(allele[rid == r])
        return out

    def pair_holders(self, mate1: np.ndarray,
                     mate2: np.ndarray) -> List[np.ndarray]:
        """The alleles that hold mate 1 and the reverse complement of
        mate 2, for each pair."""
        h1 = self.holders(mate1)
        h2 = self.holders(COMP[mate2[:, ::-1]])
        return [np.intersect1d(a, b) for a, b in zip(h1, h2)]

    def kmer_table(self, k: int) -> np.ndarray:
        """A bitmap over the 4^k keys: the panel's k-mers."""
        key, ok = _keys(self.codes, k)
        table = np.zeros(4 ** k, bool)
        table[key[ok].astype(np.int64)] = True
        return table


def kmer_length(total_bases: int) -> int:
    """T1K's extraction k: 9, raised to the count of base-4 digits of
    the panel's length plus one."""
    digits, t = 0, total_bases
    while t:
        digits += 1
        t //= 4
    return max(9, digits + 1)


def panel_kmer_hits(table: np.ndarray, k: int, reads: np.ndarray):
    """For each read ([n, L] codes), how many of its positions start a
    k-mer that the panel holds on either strand."""
    n, L = reads.shape
    m = L - k + 1
    fwd = np.zeros((n, m), np.int64)
    rev = np.zeros((n, m), np.int64)
    rc = COMP[reads[:, ::-1]]
    for j in range(k):
        fwd = fwd * 4 + np.where(reads[:, j:j + m] < 4, reads[:, j:j + m], 0)
        rev = rev * 4 + np.where(rc[:, j:j + m] < 4, rc[:, j:j + m], 0)
    bad = np.cumsum(np.concatenate([np.zeros((n, 1), np.int64),
                                    (reads >= 4).astype(np.int64)], 1), 1)
    ok = (bad[:, k:k + m] - bad[:, :m]) == 0
    hits_f = (table[fwd] & ok).sum(1)
    hits_r = (table[rev] & ok[:, ::-1]).sum(1)
    return np.maximum(hits_f, hits_r)
